"""Warp and pinhole projection of reference edge points: the plain PyTorch
counterpart of `csrc/project.cuh`, shared by the plain versions of the point
kernels (`kernels/fused_iter.py`, `kernels/residual.py`,
`kernels/sg_terms.py`).
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c for float32 `a` rounded once to float32 (a fused
    multiply-add, CUDA's __fmaf_rn). a * b is exact in float64; the float64
    sum is made round-to-odd from its exact TwoSum error, after which the
    cast to float32 rounds exactly as a single rounding would. `b` and `c`
    are float32 tensors (broadcast against `a`) or scalars, which are taken
    as float32, as the kernels receive them."""
    b, c = (x.double() if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float32).item()
            for x in (b, c))
    p = a.double() * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.to(torch.float32)


def div_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, as XLA divides, on every device: on a CUDA tensor
    torch takes x / c as x times the float32 reciprocal of c (two
    roundings), so c is given as a tensor."""
    return x / torch.full_like(x, c)


def project_points(R, t, pts, valid, h, w, fx, fy, cx, cy, fma_uv=False):
    """Warp X' = R^T (X - t) of pts (B,K,3) at poses (R (B,3,3), t (B,3)) and
    project: (xn, yn, z, safe_z, u, v, visible), visibility inclusive of
    the far image edge (u <= W, v <= H) as in the JAX `_project`.

    Written as single elementwise operations in a fixed order, each rounded
    once: `csrc/project.cuh` performs exactly these operations with
    round-to-nearest intrinsics, so both give bitwise-equal per-point values
    (a one-ulp difference in u or v could move a point across a pixel
    boundary, where the interpolant gradient jumps and a floor lookup
    changes value). With `fma_uv`, u = fx * xn + cx and v likewise are one
    fused multiply-add each, as XLA computes them: the floor lookups of the
    sub-gradient then take JAX's pixel decisions at an identity start, where
    every point lands exactly on a pixel boundary."""
    d0 = pts[..., 0] - t[:, None, 0]
    d1 = pts[..., 1] - t[:, None, 1]
    d2 = pts[..., 2] - t[:, None, 2]
    Rc = [[R[:, None, i, j] for j in range(3)] for i in range(3)]
    x0 = d0 * Rc[0][0] + d1 * Rc[1][0] + d2 * Rc[2][0]
    x1 = d0 * Rc[0][1] + d1 * Rc[1][1] + d2 * Rc[2][1]
    z = d0 * Rc[0][2] + d1 * Rc[1][2] + d2 * Rc[2][2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    inv = 1.0 / zs
    xn = x0 * inv
    yn = x1 * inv
    if fma_uv:
        u, v = fma_f32(xn, fx, cx), fma_f32(yn, fy, cy)
    else:
        u, v = fx * xn + cx, fy * yn + cy
    visible = (u >= 0.0) & (u <= w) & (v >= 0.0) & (v <= h) & valid
    return xn, yn, z, zs, u, v, visible
