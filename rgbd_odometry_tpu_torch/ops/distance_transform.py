"""Squared exact-L2 distance transform, plain PyTorch: port of
`rgbd_odometry_tpu/ops/distance_transform.py`.

These are the reference versions of kernel 1 (`kernels/edt.py`): the CPU
path and what the CUDA kernel is held against, bit for bit. Every value is
an exact integer or one float32 rounding of a sum, exactly as in the JAX
functions, so the results are bitwise equal to theirs.
"""

from __future__ import annotations

import torch

_BIG = 1.0e7  # "no edge in this column" sentinel; clamped before squaring
_G_MAX = 65504.0  # column-distance clamp that keeps g^2 finite
_PAD = 4.0e9  # out-of-image candidate of the windowed row phase


def _column_distance(zero_mask: torch.Tensor) -> torch.Tensor:
    """Per-column distance to the nearest True of `zero_mask` along rows
    (two cumulative mins); edge-free columns get `_BIG`."""
    h = zero_mask.shape[-2]
    idx = torch.arange(h, dtype=torch.float32, device=zero_mask.device)[:, None]
    c = torch.where(zero_mask, 0.0, _BIG)
    fwd = idx + torch.cummin(c - idx, dim=-2).values
    bwd = -idx + torch.cummin((c + idx).flip(-2), dim=-2).values.flip(-2)
    return torch.clamp(torch.minimum(fwd, bwd), max=_BIG)


def column_g2(zero_mask: torch.Tensor) -> torch.Tensor:
    """Squared, clamped column distances G^2: the input of the row phase."""
    g = torch.clamp(_column_distance(zero_mask), max=_G_MAX)
    return g * g


def edt_l2_squared(zero_mask: torch.Tensor) -> torch.Tensor:
    """D^2[y, x] = min_i (G^2[y, i] + (x - i)^2) over the whole row.

    The (..., H, W, W) broadcast is taken a few rows at a time (about 2^26
    elements per chunk) to keep memory bounded at large batches; the
    minimum is exact either way."""
    w = zero_mask.shape[-1]
    g2 = column_g2(zero_mask)
    xs = torch.arange(w, dtype=torch.float32, device=zero_mask.device)
    cost = (xs[:, None] - xs[None, :]) ** 2
    rows = max(1, (1 << 26) // max(1, g2[..., 0, 0].numel() * w * w))
    out = torch.empty_like(g2)
    for y0 in range(0, g2.shape[-2], rows):
        blk = g2[..., y0 : y0 + rows, :]
        out[..., y0 : y0 + rows, :] = torch.amin(blk[..., :, None, :] + cost, dim=-1)
    return out


def edt_l2_squared_windowed(zero_mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Row phase restricted to |x - i| <= radius; out-of-image offsets are
    `_PAD` candidates, as in the JAX version (note 4e9 < 65504^2, so near the
    left and right borders a pad candidate can win over an edge-free
    column)."""
    g2 = column_g2(zero_mask)
    w = g2.shape[-1]
    d2 = g2
    for dx in range(1, radius + 1):
        c = float(dx * dx)
        if dx < w:
            pad = torch.full_like(g2[..., :dx], _PAD)
            left = torch.cat([pad, g2[..., : w - dx]], dim=-1)
            right = torch.cat([g2[..., dx:], pad], dim=-1)
        else:
            left = right = torch.full_like(g2, _PAD)
        d2 = torch.minimum(d2, torch.minimum(left, right) + c)
    return d2
