"""Kernel 3: the residual pass (`csrc/residual.cu`).

Replaces the JAX package's XLA `_project_and_sample`
(`rgbd_odometry_tpu/solvers/edge_dvo.py:261-275`; it has no Pallas kernel),
batched over frame pairs: project the points at a pose, sample the DT, and
reduce to the energy and the visible count, optionally with the per-point
residual and visibility. `residual_pass` is the entry point: CPU tensors go
to the plain PyTorch version `residual_pass_plain`, CUDA tensors to the
kernel; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build, fused_iter, sg_terms
from rgbd_odometry_tpu_torch.kernels.point_sem import GN_INTERP, PointSem, production
from rgbd_odometry_tpu_torch.ops.project import project_points

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 5
)


def sample_value(img, u, v, sampler: int):
    """The DT residual (B,K) at (u, v) by a `point_sem` sampler on plane 0
    `img` (JAX `_sample_dt`, :241-258): the value of the level kernels'
    point terms under it (`fused_iter.sample_gn`, `sg_terms.sample_sg`)."""
    sample = fused_iter.sample_gn if sampler >= GN_INTERP else sg_terms.sample_sg
    return sample((img,) if sampler >= GN_INTERP else img, u, v, sampler)[0]


def _sem(bilinear: bool, sem: PointSem | None) -> PointSem:
    """The semantics of a residual pass: `sem`, else the production ones
    of the method `bilinear` names (Gauss-Newton, else the sub-gradient)."""
    return sem or production("gauss_newton" if bilinear else "subgradient")


def residual_pass_plain(R, t, pts, valid, img, fx, fy, cx, cy, bilinear, write_points=False,
                        sem: PointSem | None = None):
    """The plain PyTorch version: (energy (B,), n_visible (B,) int32,
    eps (B,K) float32 | None, visible (B,K) bool | None). The projection
    and the sample are those of the semantics (`sem`, else the production
    ones `bilinear` names: `sample_value` on plane 0 `img`)."""
    h, w = img.shape[-2:]
    sem = _sem(bilinear, sem)
    *_, u, v, visible = project_points(R, t, pts, valid, h, w, fx, fy, cx, cy,
                                       fma_uv=sem.fma_uv, fma_z=sem.fma_z)
    val = sample_value(img, u, v, sem.sampler)
    eps = torch.where(visible, val, torch.zeros_like(val))
    energy = torch.sqrt((eps * eps).sum(-1))
    n = visible.sum(-1, dtype=torch.int32)
    return (energy, n, eps, visible) if write_points else (energy, n, None, None)


def residual_pass(R, t, pts, valid, img, fx, fy, cx, cy, bilinear, write_points=False,
                  sem: PointSem | None = None):
    """Energy ||eps|| (B,) and visible count (B,) int32 of B frame pairs at
    poses (R (B,3,3), t (B,3)) over points (pts (B,K,3) float32, valid
    (B,K) bool). `bilinear` samples the bf16 DT channel img (B,H,W) with
    border-clamped bilinear interpolation (Gauss-Newton); otherwise img is
    the float32 DT, read at the integer pixel (the reference's
    sub-gradient, projected as `subgradient_terms` projects). img rows are
    contiguous; its batch stride may be larger. With `write_points`, also
    the per-point residuals eps (B,K) (0 where invisible) and visibility
    (B,K) bool; else those two are None. `sem` is that of
    `residual_pass_plain`; the kernel computes the production semantics,
    and raises for any other."""
    if pts.device.type == "cpu":
        return residual_pass_plain(R, t, pts, valid, img, fx, fy, cx, cy, bilinear, write_points,
                                   sem)
    if pts.device.type != "cuda":
        raise ValueError(f"residual_pass: unsupported device {pts.device}")
    if _sem(bilinear, sem) != _sem(bilinear, None):
        raise ValueError("residual_pass: the kernel computes the production semantics")
    dev = pts.device
    if pts.dim() != 3 or img.dim() != 3:
        raise ValueError("residual_pass: pts must be (B, K, 3) and img (B, H, W)")
    b, k, _ = pts.shape
    h, w = img.shape[1:]
    fn = "residual_pass"
    build.check_arg(fn, "R", R, (b, 3, 3), torch.float32, dev)
    build.check_arg(fn, "t", t, (b, 3), torch.float32, dev)
    build.check_arg(fn, "pts", pts, (b, k, 3), torch.float32, dev)
    build.check_arg(fn, "valid", valid, (b, k), torch.bool, dev)
    img_dtype = torch.bfloat16 if bilinear else torch.float32
    build.check_arg(fn, "img", img, (b, h, w), img_dtype, dev, contiguous=False)
    build.check_rows(fn, "img", img)
    e2 = torch.empty((b,), dtype=torch.float32, device=dev)
    n = torch.empty((b,), dtype=torch.int32, device=dev)
    eps = vis = None
    if write_points:
        eps = torch.empty((b, k), dtype=torch.float32, device=dev)
        vis = torch.empty((b, k), dtype=torch.bool, device=dev)
    lib = build.bind("residual", fn, _ARGTYPES)
    code = lib.residual_pass(
        dev.index or 0, R.data_ptr(), t.data_ptr(), pts.data_ptr(), valid.data_ptr(),
        img.data_ptr(), img.stride(0), int(bool(bilinear)), b, k, h, w, float(fx), float(fy),
        float(cx), float(cy), e2.data_ptr(), n.data_ptr(),
        eps.data_ptr() if write_points else None, vis.data_ptr() if write_points else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, code, "residual_pass launch")
    residual_pass.launches += 1
    return torch.sqrt(e2), n, eps, vis


residual_pass.launches = 0
