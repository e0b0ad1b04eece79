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
from rgbd_odometry_tpu_torch.ops.interp import gather_floor_value_cgrads
from rgbd_odometry_tpu_torch.ops.project import project_points

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 6
)


def reference_jacobian_terms(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2):
    """Per-point (J (B,K,6), eps (B,K), wgt (B,K), visible (B,K)) of the
    JAX `_jacobian_residual` in reference mode (u, v by fused
    multiply-adds as XLA forms them, floor DT value and central
    gradients, weight 6/(6 + eps^2/sigma2), the dehomogenized-coordinate
    Jacobian [-R GA | GA x R^T (xn, yn, 1)]), written as the kernel's
    operations in its order; invisible points are zeros."""
    h, w = dt.shape[-2:]
    xn, yn, _, _, u, v, visible = project_points(
        R, t, pts, valid, h, w, fx, fy, cx, cy, fma_uv=True
    )
    val, gx, gy = gather_floor_value_cgrads(dt, u, v)
    zero = torch.zeros_like(val)
    eps = torch.where(visible, val, zero)
    g0 = torch.where(visible, gx, zero)
    g1 = torch.where(visible, gy, zero)
    wgt = torch.where(visible, 6.0 / (6.0 + eps * eps * (1.0 / sigma2)), zero)
    ga0 = g0 * fx
    ga1 = g1 * fy
    ga2 = -(ga0 * xn + ga1 * yn)
    Rc = [[R[:, None, i, j] for j in range(3)] for i in range(3)]
    jt = [-(ga0 * Rc[j][0] + ga1 * Rc[j][1] + ga2 * Rc[j][2]) for j in range(3)]
    m = [xn * Rc[0][j] + yn * Rc[1][j] + Rc[2][j] for j in range(3)]
    jr = [ga1 * m[2] - ga2 * m[1], ga2 * m[0] - ga0 * m[2], ga0 * m[1] - ga1 * m[0]]
    J = torch.stack(jt + jr, dim=-1)
    J = torch.where(visible[..., None], J, torch.zeros_like(J))
    return J, eps, wgt, visible


def subgradient_terms_plain(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2):
    """The plain PyTorch version: (g (B,6), energy (B,), n_visible (B,)
    int32, eps (B,K), visible (B,K))."""
    J, eps, wgt, visible = reference_jacobian_terms(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2)
    g = (J * (wgt * eps)[..., None]).sum(-2)
    energy = torch.sqrt((eps * eps).sum(-1))
    return g, energy, visible.sum(-1, dtype=torch.int32), eps, visible


def subgradient_terms(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2):
    """g = J^T W eps (B,6), the energy (B,), the visible count (B,) int32
    and the per-point residuals (B,K) and visibility (B,K) bool of B frame
    pairs at poses (R (B,3,3), t (B,3)) over points (pts (B,K,3) float32,
    valid (B,K) bool) against the float32 DT dt (B,H,W) (rows contiguous;
    the batch stride may be larger). sigma2 is the weight's sigma^2 in DT
    units (`SolverConfig.weight_sigma2`)."""
    if pts.device.type == "cpu":
        return subgradient_terms_plain(R, t, pts, valid, dt, fx, fy, cx, cy, sigma2)
    if pts.device.type != "cuda":
        raise ValueError(f"subgradient_terms: unsupported device {pts.device}")
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
