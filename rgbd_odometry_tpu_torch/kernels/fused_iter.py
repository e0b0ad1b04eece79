"""Kernel 2: one Gauss-Newton iteration's normal-equation terms
(`csrc/fused_gn.cu`).

Replaces `rgbd_odometry_tpu/pallas/fused_iter.py::fused_gn_terms`, batched
over frame pairs. `fused_gn_terms` is the entry point: CPU tensors go to the
plain PyTorch version `fused_gn_terms_plain`, CUDA tensors to the kernel;
anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.kernels.point_sem import (
    GN_CHANNELS,
    GN_INTERP,
    GN_PRODUCTION,
    PointSem,
    reference_jacobian,
    robust_weight,
    true_jacobian,
)
from rgbd_odometry_tpu_torch.ops.interp import gather_bilinear, sample_bilinear_value_grad
from rgbd_odometry_tpu_torch.ops.project import project_points

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
    + [ctypes.c_int] * 4 + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 7
)


def sample_gn(planes, u, v, sampler: int):
    """(value, d/du, d/dv) (B,K) float32 of a Gauss-Newton level's planes
    at (u, v) by `sampler` (`point_sem`): `GN_INTERP` the bilinear sample of
    plane 0 and its interpolant's gradients, `GN_CHANNELS` the bilinear
    samples of planes 0, 1, 2, `GN_TAKE` `gather_bilinear` of the float32
    dt, dgx, dgy (JAX `_jacobian_residual`, :318-350)."""
    if sampler == GN_INTERP:
        return sample_bilinear_value_grad(planes[0], u, v)
    if sampler == GN_CHANNELS:
        return tuple(sample_bilinear_value_grad(p, u, v)[0] for p in planes)
    return tuple(gather_bilinear(p, u, v) for p in planes)


def gn_point_terms(R, t, pts, valid, planes, fx, fy, cx, cy, sigma2, scale, sem: PointSem):
    """Per-point (J (B,K,6), eps (B,K), wgt (B,K), visible (B,K)) of a
    Gauss-Newton level under any semantics `sem` (`point_sem`), on the
    level's planes (plane 0 alone for `GN_INTERP`): the projection as
    `sem` fuses it, `sample_gn`, the weight of the residual in pixels
    (eps / scale) and the textbook or the reference Jacobian, as
    `csrc/project.cuh`'s `gn_point` computes them; invisible points are
    zeros."""
    h, w = planes[0].shape[-2:]
    xn, yn, z, zs, u, v, visible = project_points(R, t, pts, valid, h, w, fx, fy, cx, cy,
                                                  fma_uv=sem.fma_uv, fma_z=sem.fma_z)
    val, gu, gv = sample_gn(planes, u, v, sem.sampler)
    zero = torch.zeros_like(val)
    eps = torch.where(visible, val, zero)
    g0 = torch.where(visible, gu, zero)
    g1 = torch.where(visible, gv, zero)
    wgt = robust_weight(eps, visible, sem, sigma2, scale)
    if sem.reference:
        J = reference_jacobian(g0, g1, xn, yn, R, fx, fy, visible)
    else:
        J = true_jacobian(g0, g1, xn, yn, z, zs, fx, fy, visible)
    return J, eps, wgt, visible


def fused_gn_terms_plain(R, t, pts, valid, img, fx, fy, cx, cy, sigma2=1.0, scale=None,
                         write_points=False, sem: PointSem = GN_PRODUCTION, planes=None):
    """The plain PyTorch version: (H (B,6,6), g (B,6), energy (B,),
    n_visible (B,) int32), and with `write_points` also (eps (B,K),
    visible (B,K)). The point terms are `gn_point_terms` under `sem` on
    `planes` (default (img,))."""
    J, eps, wgt, visible = gn_point_terms(R, t, pts, valid, planes or (img,), fx, fy, cx, cy,
                                          sigma2, scale, sem)
    Jw = J * wgt[..., None]
    H = Jw.transpose(-1, -2) @ J
    g = (Jw * eps[..., None]).sum(-2)
    energy = torch.sqrt((eps * eps).sum(-1))
    out = (H, g, energy, visible.sum(-1, dtype=torch.int32))
    return out + (eps, visible) if write_points else out


def fused_gn_terms(R, t, pts, valid, img, fx, fy, cx, cy, sigma2=1.0, scale=None,
                   write_points=False, sem: PointSem = GN_PRODUCTION, planes=None):
    """J^T W J (B,6,6), J^T W eps (B,6), energy (B,) and the visible count
    (B,) int32 of B frame pairs at poses (R (B,3,3), t (B,3)) over points
    (pts (B,K,3) float32, valid (B,K) bool) against the DT channel img
    (B,H,W) bfloat16 (row-contiguous; the batch stride may be larger, e.g.
    `chans[:, 0]`). fx, fy, cx, cy, sigma2 are the level's scalars; `scale`
    (B,) float32 is each pair's DT units per pixel (`NowLevel.scale`; None =
    1), by which the robust weight measures the residual in pixels. With
    `write_points`, two more outputs: the per-point residuals eps (B,K) (0
    where invisible) and visibility (B,K) bool, bitwise those of the
    bilinear `residual_pass` at the same pose. `sem` and `planes` are
    those of `fused_gn_terms_plain`; the kernel computes the production
    semantics on img alone, and raises for any other."""
    if pts.device.type == "cpu":
        return fused_gn_terms_plain(R, t, pts, valid, img, fx, fy, cx, cy, sigma2, scale,
                                    write_points, sem, planes)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_gn_terms: unsupported device {pts.device}")
    if sem != GN_PRODUCTION or (planes is not None and tuple(planes) != (img,)):
        raise ValueError("fused_gn_terms: the kernel computes the production semantics on img "
                         "alone")
    dev = pts.device
    if pts.dim() != 3 or img.dim() != 3:
        raise ValueError("fused_gn_terms: pts must be (B, K, 3) and img (B, H, W)")
    b, k, _ = pts.shape
    h, w = img.shape[1:]
    if scale is None:
        scale = torch.ones((b,), dtype=torch.float32, device=dev)
    fn = "fused_gn_terms"
    build.check_arg(fn, "R", R, (b, 3, 3), torch.float32, dev)
    build.check_arg(fn, "t", t, (b, 3), torch.float32, dev)
    build.check_arg(fn, "pts", pts, (b, k, 3), torch.float32, dev)
    build.check_arg(fn, "valid", valid, (b, k), torch.bool, dev)
    build.check_arg(fn, "scale", scale, (b,), torch.float32, dev)
    build.check_arg(fn, "img", img, (b, h, w), torch.bfloat16, dev, contiguous=False)
    build.check_rows(fn, "img", img)
    H = torch.empty((b, 6, 6), dtype=torch.float32, device=dev)
    g = torch.empty((b, 6), dtype=torch.float32, device=dev)
    e2 = torch.empty((b,), dtype=torch.float32, device=dev)
    n = torch.empty((b,), dtype=torch.int32, device=dev)
    eps = vis = None
    if write_points:
        eps = torch.empty((b, k), dtype=torch.float32, device=dev)
        vis = torch.empty((b, k), dtype=torch.bool, device=dev)
    lib = build.bind("fused_gn", fn, _ARGTYPES)
    code = lib.fused_gn_terms(
        dev.index or 0, R.data_ptr(), t.data_ptr(), pts.data_ptr(), valid.data_ptr(),
        img.data_ptr(), img.stride(0), scale.data_ptr(), b, k, h, w, float(fx), float(fy),
        float(cx), float(cy), float(1.0 / sigma2), H.data_ptr(), g.data_ptr(), e2.data_ptr(),
        n.data_ptr(), eps.data_ptr() if write_points else None,
        vis.data_ptr() if write_points else None, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, code, "fused_gn_terms launch")
    fused_gn_terms.launches += 1
    out = (H, g, torch.sqrt(e2), n)
    return out + (eps, vis) if write_points else out


fused_gn_terms.launches = 0
