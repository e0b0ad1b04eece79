"""Kernel 4: one iteration of the reference's sub-gradient solve
(`csrc/sg_terms.cu`).

Replaces the JAX package's XLA `_jacobian_residual` in reference mode with
its floor gathers (`rgbd_odometry_tpu/solvers/edge_dvo.py:293-398`,
`ops/matmul_gather.gather_floor_value_cgrads_mm`) and the J^T W eps of
`_subgradient_step` (:780); it has no Pallas kernel. The level solver runs
a whole level in one launch instead (`kernels/level_sg.py`, whose plain
version loops over `subgradient_terms_plain`); this per-iteration kernel is
what that one is checked against, pose by pose. `subgradient_terms` is
the entry point: CPU tensors go to the plain PyTorch version
`subgradient_terms_plain`, CUDA tensors to the kernel; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.kernels.point_sem import (
    SG_PRODUCTION,
    SG_SQRT_MXU,
    SG_SQRT_TAKE,
    PointSem,
    reference_jacobian,
    robust_weight,
    true_jacobian,
)
from rgbd_odometry_tpu_torch.ops.interp import (
    gather_floor_value_cgrads,
    gather_sqrt_bilinear,
    sample_bilinear_value_grad,
)
from rgbd_odometry_tpu_torch.ops.project import project_points

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 6
)


def reference_jacobian_terms(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2):
    """Per-point (J (B,K,6), eps (B,K), wgt (B,K), visible (B,K)) of the
    JAX `_jacobian_residual` in reference mode: `sg_point_terms` under the
    production semantics (u, v by fused multiply-adds as XLA forms them,
    floor DT value and central gradients, weight 6/(6 + eps^2/sigma2), the
    dehomogenized-coordinate Jacobian [-R GA | GA x R^T (xn, yn, 1)]);
    invisible points are zeros."""
    return sg_point_terms(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2, SG_PRODUCTION)


def sample_sg(dt, u, v, sampler: int):
    """(value, d/du, d/dv) (B,K) of the float32 DT at (u, v) by a
    sub-gradient `sampler` (`point_sem`): the floor pixel's value and its
    central differences (`SG_FLOOR`), the value replaced by the
    interpolated DT (`interpolate_dt`: `SG_SQRT_MXU`, sqrt(max(., 0)) of
    the bilinear blend of F^2 in the interpolant's order, JAX's one-hot
    gather; `SG_SQRT_TAKE`, `gather_sqrt_bilinear`), as JAX
    `_jacobian_residual` (:332-350) keeps the floor gradients."""
    val, gx, gy = gather_floor_value_cgrads(dt, u, v)
    if sampler == SG_SQRT_MXU:
        s2 = torch.clamp(sample_bilinear_value_grad(dt * dt, u, v)[0], min=0.0)
        val = torch.sqrt(s2.double()).float()  # correctly rounded, as XLA's
    elif sampler == SG_SQRT_TAKE:
        val = gather_sqrt_bilinear(dt, u, v)
    return val, gx, gy


def sg_point_terms(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2, sem: PointSem):
    """Per-point (J (B,K,6), eps (B,K), wgt (B,K), visible (B,K)) of a
    sub-gradient level under any semantics `sem`, as `csrc/project.cuh`'s
    `sg_point` computes them: the projection as `sem` fuses it, `sample_sg`,
    the weight in DT units and the reference or the textbook Jacobian;
    invisible points are zeros."""
    h, w = dt.shape[-2:]
    xn, yn, z, zs, u, v, visible = project_points(R, t, pts, valid, h, w, fx, fy, cx, cy,
                                                  fma_uv=sem.fma_uv, fma_z=sem.fma_z)
    val, gx, gy = sample_sg(dt, u, v, sem.sampler)
    zero = torch.zeros_like(val)
    eps = torch.where(visible, val, zero)
    g0 = torch.where(visible, gx, zero)
    g1 = torch.where(visible, gy, zero)
    wgt = robust_weight(eps, visible, sem, sigma2)
    if sem.reference:
        J = reference_jacobian(g0, g1, xn, yn, R, fx, fy, visible)
    else:
        J = true_jacobian(g0, g1, xn, yn, z, zs, fx, fy, visible)
    return J, eps, wgt, visible


def subgradient_terms_plain(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2,
                            sem: PointSem = SG_PRODUCTION):
    """The plain PyTorch version: (g (B,6), energy (B,), n_visible (B,)
    int32, eps (B,K), visible (B,K)); the point terms are `sg_point_terms`
    under `sem`."""
    J, eps, wgt, visible = sg_point_terms(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2, sem)
    g = (J * (wgt * eps)[..., None]).sum(-2)
    energy = torch.sqrt((eps * eps).sum(-1))
    return g, energy, visible.sum(-1, dtype=torch.int32), eps, visible


def subgradient_terms(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2,
                      sem: PointSem = SG_PRODUCTION):
    """g = J^T W eps (B,6), the energy (B,), the visible count (B,) int32
    and the per-point residuals (B,K) and visibility (B,K) bool of B frame
    pairs at poses (R (B,3,3), t (B,3)) over points (pts (B,K,3) float32,
    valid (B,K) bool) against the float32 DT dt (B,H,W) (rows contiguous;
    the batch stride may be larger). sigma2 is the weight's sigma^2 in DT
    units (`SolverConfig.weight_sigma2`). `sem` is that of
    `subgradient_terms_plain`; the kernel computes the production
    semantics, and raises for any other."""
    if pts.device.type == "cpu":
        return subgradient_terms_plain(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2, sem)
    if pts.device.type != "cuda":
        raise ValueError(f"subgradient_terms: unsupported device {pts.device}")
    if sem != SG_PRODUCTION:
        raise ValueError("subgradient_terms: the kernel computes the production semantics")
    dev = pts.device
    if pts.dim() != 3 or dt.dim() != 3:
        raise ValueError("subgradient_terms: pts must be (B, K, 3) and dt (B, H, W)")
    b, k, _ = pts.shape
    h, w = dt.shape[1:]
    fn = "subgradient_terms"
    build.check_arg(fn, "R", R, (b, 3, 3), torch.float32, dev)
    build.check_arg(fn, "t", t, (b, 3), torch.float32, dev)
    build.check_arg(fn, "pts", pts, (b, k, 3), torch.float32, dev)
    build.check_arg(fn, "valid", valid, (b, k), torch.bool, dev)
    build.check_arg(fn, "dt", dt, (b, h, w), torch.float32, dev, contiguous=False)
    build.check_rows(fn, "dt", dt)
    g = torch.empty((b, 6), dtype=torch.float32, device=dev)
    e2 = torch.empty((b,), dtype=torch.float32, device=dev)
    n = torch.empty((b,), dtype=torch.int32, device=dev)
    eps = torch.empty((b, k), dtype=torch.float32, device=dev)
    vis = torch.empty((b, k), dtype=torch.bool, device=dev)
    lib = build.bind("sg_terms", fn, _ARGTYPES)
    code = lib.subgradient_terms(
        dev.index or 0, R.data_ptr(), t.data_ptr(), pts.data_ptr(), valid.data_ptr(),
        dt.data_ptr(), dt.stride(0), b, k, h, w, float(fx), float(fy), float(cx), float(cy),
        float(1.0 / sigma2), g.data_ptr(), e2.data_ptr(), n.data_ptr(), eps.data_ptr(),
        vis.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, code, "subgradient_terms launch")
    subgradient_terms.launches += 1
    return g, torch.sqrt(e2), n, eps, vis


subgradient_terms.launches = 0
