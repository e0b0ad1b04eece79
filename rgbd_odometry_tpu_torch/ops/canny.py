"""Canny edge detection with OpenCV-exact semantics: port of
`rgbd_odometry_tpu/ops/canny.py` (`canny`, `_grad_mag`, `_nms`,
`hysteresis`) in plain PyTorch.

The arithmetic is the JAX package's float32 emulation of OpenCV's
fixed-point TG22 sector NMS, operation for operation, so the edge maps are
bit-identical. The TPU's row bit-packing of the hysteresis masks is not
ported: here each fixpoint pass is an 8-connected dilation (3x3 max-pool) of
the current edges masked by the weak candidates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rgbd_odometry_tpu_torch.ops.gradient import sobel3

_TG22 = 13573  # round(tan(22.5 deg) * 2^15), OpenCV's fixed-point constant
_SHIFT = 15
# passes between two host reads of the changed flag: each read is a device
# sync, and extra passes past the fixpoint change nothing
_CHECK_EVERY = 8


def _grad_mag(img: torch.Tensor, low: float, high: float):
    """8-bit emulation, Sobel, L2 magnitude (exact in float32)."""
    img = torch.clamp(torch.round(img), 0.0, 255.0)
    gx, gy = sobel3(img)
    mag = gx * gx + gy * gy
    return mag, gx, gy, float(low) * float(low), float(high) * float(high)


def _nms(mag: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor, low: float) -> torch.Tensor:
    """OpenCV sector non-maximum suppression (zero-padded neighbours);
    returns the bool mask of survivors with mag > low."""
    h, w = mag.shape[-2:]
    m = F.pad(mag.reshape(-1, h, w), (1, 1, 1, 1)).reshape(*mag.shape[:-2], h + 2, w + 2)
    c = m[..., 1:-1, 1:-1]
    left = m[..., 1:-1, :-2]
    right = m[..., 1:-1, 2:]
    up = m[..., :-2, 1:-1]
    down = m[..., 2:, 1:-1]
    ul = m[..., :-2, :-2]
    ur = m[..., :-2, 2:]
    dl = m[..., 2:, :-2]
    dr = m[..., 2:, 2:]

    x = torch.abs(dx)
    y = torch.abs(dy) * float(1 << _SHIFT)
    tg22x = x * float(_TG22)
    tg67x = tg22x + x * 65536.0

    horiz = y < tg22x
    vert = (~horiz) & (y > tg67x)
    s_neg = (dx * dy) < 0

    keep_h = (c > left) & (c >= right)
    keep_v = (c > up) & (c >= down)
    keep_d_pos = (c > ul) & (c > dr)
    keep_d_neg = (c > ur) & (c > dl)
    keep = torch.where(
        horiz, keep_h, torch.where(vert, keep_v, torch.where(s_neg, keep_d_neg, keep_d_pos))
    )
    return keep & (c > low)


def hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """8-connected propagation of `strong` through `weak` to the fixpoint
    (equal to OpenCV's BFS). The changed flag is read on the host every
    `_CHECK_EVERY` passes; H*W passes bound any propagation path and are the
    backstop, as in the JAX version."""
    h, w = strong.shape[-2:]
    weak_f = weak.reshape(-1, 1, h, w).to(torch.float32)
    edges = strong.reshape(-1, 1, h, w).to(torch.float32) * weak_f
    done = 0
    while done < h * w:
        before = edges
        for _ in range(min(_CHECK_EVERY, h * w - done)):
            edges = F.max_pool2d(edges, 3, stride=1, padding=1) * weak_f
        done += _CHECK_EVERY
        if torch.equal(edges, before):
            break
    return edges.reshape(strong.shape) > 0


def canny(img: torch.Tensor, low: float = 100.0, high: float = 150.0) -> torch.Tensor:
    """Canny edge map (bool, same shape as `img`) with cv::Canny(img, edges,
    high, low, 3, L2gradient=true) semantics; `img` is 8-bit-valued float."""
    if low > high:
        low, high = high, low
    mag, gx, gy, low_t, high_t = _grad_mag(img, low, high)
    weak = _nms(mag, gx, gy, low_t)
    strong = weak & (mag > high_t)
    return hysteresis(strong, weak)
