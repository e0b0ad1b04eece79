"""Image gradients with OpenCV border semantics: port of
`rgbd_odometry_tpu/ops/gradient.py`.

`sobel3` pads BORDER_REPLICATE (torch "replicate"), as cv::Canny does;
`central_gradient` pads BORDER_REFLECT_101, which is torch's "reflect"
(the edge pixel is not repeated) and NOT "replicate".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad1(img: torch.Tensor, mode: str) -> torch.Tensor:
    """Pad the last two dims by one pixel; any leading dims."""
    h, w = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, h, w), (1, 1, 1, 1), mode=mode)
    return p.reshape(*img.shape[:-2], h + 2, w + 2)


def central_gradient(img: torch.Tensor):
    """(gx, gy) with gx = 0.5 (I[y, x+1] - I[y, x-1]) under REFLECT_101."""
    p = _pad1(img, "reflect")
    gx = 0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    return gx, gy


def sobel3(img: torch.Tensor):
    """Aperture-3 Sobel (gx, gy) under BORDER_REPLICATE, in the same
    operation order as the JAX version (exact small integers on 8-bit
    input)."""
    p = _pad1(img, "replicate")
    c = p[..., 1:-1, :]
    u = p[..., :-2, :]
    d = p[..., 2:, :]
    sy = u + 2.0 * c + d
    gx = sy[..., :, 2:] - sy[..., :, :-2]
    sx = p[..., :, :-2] + 2.0 * p[..., :, 1:-1] + p[..., :, 2:]
    gy = sx[..., 2:, :] - sx[..., :-2, :]
    return gx, gy
