"""Image sampling at reprojected points by direct indexing.

Replaces the JAX package's one-hot MXU gathers:

* bilinear, for Gauss-Newton (`ops/matmul_gather.gather_channels_mm(...,
  bilinear=True)` and `gather_bilinear_value_grad_mm`): coordinates are
  clamped to [0, n-1], i1 = min(i0+1, n-1), and the derivatives are those of
  the bilinear interpolant (exactly 0 across a clamped border). The four
  bf16 corners are read, widened to float32, and blended with float32
  weights; the TPU forms round the weights (and the matmul outputs) to bf16
  instead, a difference of the order of bf16's 2^-9 relative step;
* floor, for the reference's sub-gradient (`ops/interp.gather_floor` and
  `ops/matmul_gather.gather_floor_value_cgrads_mm`): the value at the
  integer pixel and its central-difference gradients there, REFLECT_101 at
  the borders. Every value is one read or one rounding of a difference, so
  the results are bitwise equal to the JAX versions.
"""

from __future__ import annotations

import torch


def _corners(n: int, coord: torch.Tensor):
    """(i0, i1, frac) for clamped coordinates along an axis of length n.
    NaN coordinates (points behind the camera) are mapped to 0 so the index
    stays in range; callers mask those points as invisible."""
    c = torch.clamp(torch.nan_to_num(coord, nan=0.0), 0.0, n - 1.0)
    f0 = torch.floor(c)
    i0 = f0.to(torch.long)
    return i0, torch.clamp(i0 + 1, max=n - 1), c - f0


def sample_bilinear_value_grad(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """img (B, H, W) (any float dtype; the last two dims contiguous), u, v
    (B, K) -> float32 (value, d/du, d/dv), each (B, K)."""
    b, h, w = img.shape
    flat = img.reshape(b, h * w) if img.is_contiguous() else img.contiguous().reshape(b, h * w)
    j0, j1, fu = _corners(w, u)
    i0, i1, fv = _corners(h, v)

    def at(i, j):
        return torch.gather(flat, 1, i * w + j).to(torch.float32)

    a00, a01, a10, a11 = at(i0, j0), at(i0, j1), at(i1, j0), at(i1, j1)
    row0 = (1.0 - fv) * a00 + fv * a10  # bilinear row mix at column j0
    row1 = (1.0 - fv) * a01 + fv * a11  # ... and at column j1
    val = (1.0 - fu) * row0 + fu * row1
    gu = row1 - row0
    gv = (1.0 - fu) * (a10 - a00) + fu * (a11 - a01)
    return val, gu, gv


def _floor_index(n: int, coord: torch.Tensor) -> torch.Tensor:
    """floor(clamp(coord, 0, n-1)) as an index (NaN -> 0, as `_corners`)."""
    c = torch.clamp(torch.nan_to_num(coord, nan=0.0), 0.0, n - 1.0)
    return torch.floor(c).to(torch.long)


def gather_floor(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) at (floor(v), floor(u)) with clamped indices -> (B, K)."""
    b, h, w = img.shape
    idx = _floor_index(h, v) * w + _floor_index(w, u)
    return torch.gather(img.reshape(b, h * w), 1, idx)


def gather_floor_value_cgrads(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """img (B, H, W) float32 at the integer pixel (floor(v), floor(u)) and its
    central-difference gradients there, each (B, K):
    gx = 0.5 (img[i, refl(j+1)] - img[i, refl(j-1)]), gy likewise, with
    REFLECT_101 (-1 -> 1, n -> n-2): the values of gathering the channels
    [img, central_gx, central_gy]."""
    b, h, w = img.shape
    flat = img.reshape(b, h * w)
    i0, j0 = _floor_index(h, v), _floor_index(w, u)

    def refl(idx, n):
        return torch.where(idx < 0, -idx, torch.where(idx > n - 1, 2 * (n - 1) - idx, idx))

    def at(i, j):
        return torch.gather(flat, 1, i * w + j)

    val = at(i0, j0)
    gx = 0.5 * (at(i0, refl(j0 + 1, w)) - at(i0, refl(j0 - 1, w)))
    gy = 0.5 * (at(refl(i0 + 1, h), j0) - at(refl(i0 - 1, h), j0))
    return val, gx, gy
