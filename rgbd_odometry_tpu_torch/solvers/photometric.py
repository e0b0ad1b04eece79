"""The legacy dense photometric DVO: of `rgbd_odometry_tpu/solvers/photometric.py`
only `warp_image` is ported, for `viz.live`'s reprojection composite. The
solver itself (`PhotoRefLevel`, `extract_photo_ref`, `solve_pyramid`, the
`photometric` command) is ROADMAP.md Queue 1 item 8.2.
"""

from __future__ import annotations

import torch

from rgbd_odometry_tpu_torch.core.camera import Intrinsics


def warp_image(gray: torch.Tensor, depth_mm: torch.Tensor, intr: Intrinsics, R: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Dense warp render of a frame (H, W) float32 under the pose (R (3, 3),
    t (3,)) in the solver's convention p' = R^T (p - t): each pixel is
    back-projected at its depth, moved, projected, and the frame is sampled
    there bilinearly (coordinates clamped to the image, the rows mixed first
    as in the JAX package's separable gather); 0 where the point leaves the
    image or falls behind the camera. A plain bilinear gather replaces the
    JAX package's one-hot matmul."""
    h, w = gray.shape
    f32 = dict(dtype=gray.dtype, device=gray.device)
    gy, gx = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32), indexing="ij")
    z = depth_mm / 1000.0
    X = torch.stack([z * (gx - intr.cx) / intr.fx, z * (gy - intr.cy) / intr.fy, z],
                    dim=-1).reshape(-1, 3)
    xp = (X - t.to(gray.dtype)) @ R.to(gray.dtype)
    zp = xp[:, 2]
    zinv = 1.0 / torch.where(zp.abs() < 1e-12, torch.full_like(zp, 1e-12), zp)
    u = intr.fx * xp[:, 0] * zinv + intr.cx
    v = intr.fy * xp[:, 1] * zinv + intr.cy
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (zp > 0)

    def corners(c, n):
        c = torch.clamp(c, 0.0, n - 1.0)
        i0 = torch.floor(c)
        i0i = i0.long()
        return i0i, torch.clamp(i0i + 1, max=n - 1), c - i0

    r0, r1, fv = corners(v, h)
    c0, c1, fu = corners(u, w)
    row0 = (1.0 - fv) * gray[r0, c0] + fv * gray[r1, c0]
    row1 = (1.0 - fv) * gray[r0, c1] + fv * gray[r1, c1]
    vals = row0 * (1.0 - fu) + row1 * fu
    return torch.where(inside, vals, torch.zeros_like(vals)).reshape(h, w)
