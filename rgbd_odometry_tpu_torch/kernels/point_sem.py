"""The per-point semantics of the two level kernels (`csrc/project.cuh`
`PointSem`), chosen from a `SolverConfig` as the JAX package's
`_jacobian_residual` and `_sample_dt` branch on it
(`rgbd_odometry_tpu/solvers/edge_dvo.py:241-398`), and the robust weight.

A launch computes one semantics for every point, so its branches are
uniform over the grid. The production semantics (`production`) are those
the kernels computed before the reference-parity configurations came to
them: bilinear bf16 samples with interpolant gradients and the textbook
Jacobian for Gauss-Newton, floor lookups with central gradients and the
"reference" Jacobian for the sub-gradient. Every other configuration
takes the operations of the port's general per-point terms
(`solvers/edge_dvo._jacobian_residual`): the projection with XLA's fused
multiply-adds (`fma_uv`, `fma_z`) and the weight 6 / (6 + (r^2 / sigma^2))
by true divisions (`div_weight`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from rgbd_odometry_tpu_torch.ops.project import div_scalar

# samplers (`PointSem.sampler`); the value, then the two DT gradients
SG_FLOOR = 0  # the float32 DT at the floor pixel and its central differences
SG_SQRT_MXU = 1  # sqrt(max(bilinear(F^2), 0)) in the interpolant's order; floor gradients
SG_SQRT_TAKE = 2  # `gather_sqrt_bilinear` (ceil far corner); floor gradients
GN_INTERP = 3  # the bilinear sample of plane 0 and its interpolant's gradients
GN_CHANNELS = 4  # the bilinear samples of planes 0, 1, 2 ([dt, dgx, dgy] channels)
GN_TAKE = 5  # `gather_bilinear` of the float32 dt, dgx, dgy


class PointSem(NamedTuple):
    """A level's per-point semantics (a launch-uniform struct on the card)."""

    sampler: int
    reference: bool  # the reference's dehomogenized Jacobian, else the textbook one
    fma_uv: bool  # u = fx xn + cx (and v) as one fused multiply-add each
    fma_z: bool  # z = fma(d2, R22, fma(d1, R12, d0 R02)), XLA's CPU dot
    div_weight: bool  # 6 / (6 + (r^2 / sigma^2)) by divisions, else 6 rcp(6 + r^2 (1 / sigma^2))


def jacobian_mode(cfg) -> str:
    """The Jacobian the configuration solves with, as JAX reads
    `jacobian_mode` (:359-361): "auto" picks "true" for Gauss-Newton and
    "reference" for the sub-gradient; any value but "reference" is "true"."""
    if cfg.jacobian_mode == "auto":
        return "true" if cfg.method == "gauss_newton" else "reference"
    return "reference" if cfg.jacobian_mode == "reference" else "true"


def production(method: str) -> PointSem:
    """The production semantics of a method."""
    if method == "gauss_newton":
        return PointSem(GN_INTERP, False, False, False, False)
    return PointSem(SG_FLOOR, True, True, False, False)


GN_PRODUCTION = production("gauss_newton")
SG_PRODUCTION = production("subgradient")


def point_sem(cfg) -> PointSem:
    """The per-point semantics of `cfg` (JAX's branches):

    * Gauss-Newton: "mxu" with "interpolant" gradients `GN_INTERP`, with
      "channels" `GN_CHANNELS` (both on the channels of `gather_dtype`),
      "take" `GN_TAKE` (float32 planes whatever `gather_dtype`); JAX's
      Gauss-Newton never reads `interpolate_dt`;
    * sub-gradient: `interpolate_dt` with "mxu" `SG_SQRT_MXU`, with "take"
      `SG_SQRT_TAKE`, else `SG_FLOOR` (JAX's "mxu" and "take" floor
      branches are bit-equal).

    The production semantics where the sampler, the Jacobian and (for
    Gauss-Newton) bf16 channels are the production ones."""
    gn = cfg.method == "gauss_newton"
    ref = jacobian_mode(cfg) == "reference"
    if gn:
        sampler = (GN_TAKE if cfg.gather_mode != "mxu" else
                   GN_INTERP if cfg.gn_gradient_mode == "interpolant" else GN_CHANNELS)
        prod = not ref and sampler == GN_INTERP and cfg.gather_dtype == "bfloat16"
    else:
        sampler = (SG_FLOOR if not cfg.interpolate_dt else
                   SG_SQRT_MXU if cfg.gather_mode == "mxu" else SG_SQRT_TAKE)
        prod = ref and sampler == SG_FLOOR
    if prod:
        return production(cfg.method)
    return PointSem(sampler, ref, True, True, True)


# The reference-parity families: name -> (method, the switches that set it
# apart from the method's production configuration, the kind of its
# residual: "float32" gathers, "bf16" gathers or "floor" lookups). The
# checks, the profiles and the tests each take them on a base of their own
# (`parity_families`).
PARITY_FAMILIES = {
    "sg_interpolate_dt_mxu": ("subgradient", {"interpolate_dt": True}, "float32"),
    "sg_interpolate_dt_take": ("subgradient", {"interpolate_dt": True, "gather_mode": "take"},
                               "float32"),
    "sg_rotationize_svd": ("subgradient", {"rotationize_method": "svd"}, "floor"),
    "sg_true_jacobian": ("subgradient", {"jacobian_mode": "true"}, "floor"),
    "gn_take": ("gauss_newton", {"gather_mode": "take"}, "float32"),
    "gn_channels_float32": ("gauss_newton", {"gn_gradient_mode": "channels",
                                             "gather_dtype": "float32"}, "float32"),
    "gn_reference_jacobian": ("gauss_newton", {"jacobian_mode": "reference",
                                               "gather_mode": "take"}, "float32"),
    "gn_rotationize_svd": ("gauss_newton", {"rotationize_method": "svd"}, "bf16"),
}


def parity_families(sg, gn) -> dict:
    """name -> (configuration, kind) of every `PARITY_FAMILIES` entry, on
    the base `sg` or `gn` (a `SolverConfig` of that method, the port's or
    the JAX package's) as its method says."""
    return {name: (dataclasses.replace(gn if method == "gauss_newton" else sg, **switches), kind)
            for name, (method, switches, kind) in PARITY_FAMILIES.items()}


def svd(cfg) -> bool:
    """True where the configuration re-orthogonalizes by the SVD."""
    return bool(cfg.rotationize) and cfg.rotationize_method == "svd"


def parity(cfg) -> bool:
    """True for a reference-parity configuration: point semantics other
    than the production ones, or the SVD."""
    return point_sem(cfg) != production(cfg.method) or svd(cfg)


def true_jacobian(g0, g1, xn, yn, z, zs, fx, fy, visible):
    """The textbook image Jacobian (B,K,6) of the right-multiplied update
    (JAX `_jacobian_residual`'s "true" mode, :382-395) from the sampled DT
    gradients g0, g1 at the projections (xn, yn, z; zs the guarded depth):
    [-GA | GA x X'] with GA = (g0 fx, g1 fy, -(g0 fx xn + g1 fy yn)) / z;
    zeros where invisible."""
    ga0 = g0 * fx / zs
    ga1 = g1 * fy / zs
    ga2 = -(g0 * fx * xn + g1 * fy * yn) / zs
    xz, yz = xn * z, yn * z
    J = torch.stack(
        [-ga0, -ga1, -ga2, ga1 * z - ga2 * yz, ga2 * xz - ga0 * z, ga0 * yz - ga1 * xz],
        dim=-1,
    )
    return torch.where(visible[..., None], J, torch.zeros_like(J))


def reference_jacobian(g0, g1, xn, yn, R, fx, fy, visible):
    """The reference's dehomogenized-coordinate Jacobian (B,K,6) (JAX
    `_jacobian_residual`'s "reference" mode, :362-380) from the sampled DT
    gradients g0, g1 at the projections (xn, yn) and the poses' R (B,3,3):
    [-R GA | GA x R^T (xn, yn, 1)] with GA = (g0 fx, g1 fy, -(g0 fx xn +
    g1 fy yn)), in the kernel's operation order; zeros where invisible."""
    ga0 = g0 * fx
    ga1 = g1 * fy
    ga2 = -(ga0 * xn + ga1 * yn)
    Rc = [[R[:, None, i, j] for j in range(3)] for i in range(3)]
    jt = [-(ga0 * Rc[j][0] + ga1 * Rc[j][1] + ga2 * Rc[j][2]) for j in range(3)]
    m = [xn * Rc[0][j] + yn * Rc[1][j] + Rc[2][j] for j in range(3)]
    jr = [ga1 * m[2] - ga2 * m[1], ga2 * m[0] - ga0 * m[2], ga0 * m[1] - ga1 * m[0]]
    J = torch.stack(jt + jr, dim=-1)
    return torch.where(visible[..., None], J, torch.zeros_like(J))


def robust_weight(eps, visible, sem: PointSem, sigma2: float, scale=None):
    """w = 6 / (6 + r^2 / sigma^2) (B,K), 0 where invisible, r = eps (DT
    units) or eps / scale (pixels, Gauss-Newton): as `level_*`'s point
    terms form it under `sem` (`div_weight`: JAX `_robust_weights` by true
    divisions; else the production kernels' reciprocal)."""
    r = eps if scale is None else eps / scale[:, None]
    zero = torch.zeros_like(eps)
    if sem.div_weight:
        return torch.where(visible, torch.full_like(eps, 6.0) / (6.0 + div_scalar(r * r, sigma2)),
                           zero)
    return torch.where(visible, 6.0 / (6.0 + r * r * (1.0 / sigma2)), zero)
