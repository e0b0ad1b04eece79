"""Batched 6x6 SPD Cholesky solve: port of `rgbd_odometry_tpu/ops/linalg6.py`.

Same factorization and the same 1e-20 pivot floor as the JAX version, so a
degenerate system (no visible points) gives a finite zero step. Each column
is one vectorized update over the rows below the pivot.
"""

from __future__ import annotations

import torch


def chol_solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for SPD H (..., 6, 6), g (..., 6)."""
    L = torch.zeros_like(H)
    for j in range(6):
        s = H[..., j:, j] - (L[..., j:, :j] * L[..., j : j + 1, :j]).sum(-1)
        d = torch.sqrt(torch.clamp(s[..., 0], min=1e-20))
        L[..., j, j] = d
        L[..., j + 1 :, j] = s[..., 1:] * (1.0 / d)[..., None]
    y = torch.zeros_like(g)
    for i in range(6):
        y[..., i] = (g[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)) / L[..., i, i]
    x = torch.zeros_like(g)
    for i in reversed(range(6)):
        x[..., i] = (y[..., i] - (L[..., i + 1 :, i] * x[..., i + 1 :]).sum(-1)) / L[..., i, i]
    return x
