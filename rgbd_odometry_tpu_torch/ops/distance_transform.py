"""Squared exact-L2 distance transform, plain PyTorch: port of
`rgbd_odometry_tpu/ops/distance_transform.py`.

These are the reference versions of kernel 1 (`kernels/edt.py`): the CPU
path and what the CUDA kernel is held against, bit for bit. Every value is
an exact integer or one float32 rounding of a sum, exactly as in the JAX
functions, so the results are bitwise equal to theirs. `edt_l2`,
`normalize_minmax` and `distance_transform_of_edges` complete the JAX
module (its exact-EDT branch): on a CUDA tensor the two transforms are one
`dt_channels` call (one `dt_pyramid` launch).
"""

from __future__ import annotations

import torch

from rgbd_odometry_tpu_torch.ops.project import fma_f32

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


def edt_l2(zero_mask: torch.Tensor) -> torch.Tensor:
    """Exact L2 distance to the nearest True of `zero_mask` (B, H, W) (JAX
    `edt_l2`): the correctly rounded float32 sqrt of `edt_l2_squared`, as
    XLA takes it. A CUDA tensor goes to `dt_channels` (one `dt_pyramid`
    launch), which computes the same (`kernels/edt.py`)."""
    if zero_mask.device.type != "cpu":
        from rgbd_odometry_tpu_torch.kernels.edt import dt_channels

        return dt_channels(zero_mask.contiguous(), 0, False, False)[0]
    d2 = edt_l2_squared(zero_mask.bool())
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)


def normalize_minmax(dt: torch.Tensor, lo: float = 0.0, hi: float = 255.0) -> torch.Tensor:
    """cv::normalize(..., lo, hi, NORM_MINMAX) of each (H, W) image of `dt`
    (JAX `normalize_minmax`): (dt - min) (hi - lo) / max(max - min, 1e-12)
    + lo, the scale a true division and the last step one fused
    multiply-add, as XLA computes them on the CPU."""
    dmin = torch.amin(dt, dim=(-2, -1), keepdim=True)
    span = torch.clamp(torch.amax(dt, dim=(-2, -1), keepdim=True) - dmin, min=1e-12)
    scale = torch.full_like(span, hi - lo) / span
    return fma_f32(dt - dmin, scale, lo)


def distance_transform_of_edges(edges: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """The reference's chain (JAX `distance_transform_of_edges`): the EDT of
    the inverted edge map (B, H, W), optionally min-max normalized to
    0-255. A CUDA tensor goes to one `dt_channels` call (one `dt_pyramid`
    launch), which computes both (`kernels/edt.py`)."""
    if edges.device.type != "cpu":
        from rgbd_odometry_tpu_torch.kernels.edt import dt_channels

        return dt_channels(edges.contiguous(), 0, bool(normalize), False)[0]
    dt = edt_l2(edges)
    return normalize_minmax(dt) if normalize else dt
