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
from rgbd_odometry_tpu_torch.ops.interp import sample_bilinear_value_grad

_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 5
)


def project_points(R, t, pts, valid, h, w, fx, fy, cx, cy):
    """Warp X' = R^T (X - t) of pts (B,K,3) at poses (R (B,3,3), t (B,3)) and
    project: (xn, yn, z, safe_z, u, v, visible), visibility inclusive of
    the far image edge (u <= W, v <= H) as in the JAX `_project`.

    Written as single elementwise operations in a fixed order, each rounded
    once: `csrc/fused_gn.cu` performs exactly these operations with
    round-to-nearest intrinsics, so both give bitwise-equal per-point values
    (a one-ulp difference in u or v could move a point across a pixel
    boundary, where the interpolant gradient jumps)."""
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
    u = fx * xn + cx
    v = fy * yn + cy
    visible = (u >= 0.0) & (u <= w) & (v >= 0.0) & (v <= h) & valid
    return xn, yn, z, zs, u, v, visible


def jacobian_terms(R, t, pts, valid, img, fx, fy, cx, cy, sigma2):
    """Per-point (J (B,K,6), eps (B,K), wgt (B,K), visible (B,K)) at pose
    (R (B,3,3), t (B,3)), with the same math as the kernel (operation for
    operation) and as the JAX `_jacobian_residual` in production mode;
    invisible points are zeros."""
    h, w = img.shape[-2:]
    xn, yn, z, zs, u, v, visible = project_points(R, t, pts, valid, h, w, fx, fy, cx, cy)
    val, gu, gv = sample_bilinear_value_grad(img, u, v)
    zero = torch.zeros_like(val)
    eps = torch.where(visible, val, zero)
    g0 = torch.where(visible, gu, zero)
    g1 = torch.where(visible, gv, zero)
    wgt = torch.where(visible, 6.0 / (6.0 + eps * eps * (1.0 / sigma2)), zero)
    ga0 = g0 * fx / zs
    ga1 = g1 * fy / zs
    ga2 = -(g0 * fx * xn + g1 * fy * yn) / zs
    xz, yz = xn * z, yn * z
    J = torch.stack(
        [-ga0, -ga1, -ga2, ga1 * z - ga2 * yz, ga2 * xz - ga0 * z, ga0 * yz - ga1 * xz],
        dim=-1,
    )
    J = torch.where(visible[..., None], J, torch.zeros_like(J))
    return J, eps, wgt, visible


def fused_gn_terms_plain(R, t, pts, valid, img, fx, fy, cx, cy, sigma2=1.0):
    """The plain PyTorch version: (H (B,6,6), g (B,6), energy (B,),
    n_visible (B,) int32)."""
    J, eps, wgt, visible = jacobian_terms(R, t, pts, valid, img, fx, fy, cx, cy, sigma2)
    Jw = J * wgt[..., None]
    H = Jw.transpose(-1, -2) @ J
    g = (Jw * eps[..., None]).sum(-2)
    energy = torch.sqrt((eps * eps).sum(-1))
    return H, g, energy, visible.sum(-1, dtype=torch.int32)


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_gn")
    if lib.fused_gn_terms.argtypes is None:
        lib.fused_gn_terms.argtypes = _ARGTYPES
        lib.fused_gn_terms.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"fused_gn_terms: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"fused_gn_terms: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"fused_gn_terms: {name} must be {shape}, got {tuple(x.shape)}")


def fused_gn_terms(R, t, pts, valid, img, fx, fy, cx, cy, sigma2=1.0):
    """J^T W J (B,6,6), J^T W eps (B,6), energy (B,) and the visible count
    (B,) int32 of B frame pairs at poses (R (B,3,3), t (B,3)) over points
    (pts (B,K,3) float32, valid (B,K) bool) against the DT channel img
    (B,H,W) bfloat16 (row-contiguous; the batch stride may be larger, e.g.
    `chans[:, 0]`). fx, fy, cx, cy, sigma2 are the level's scalars."""
    if pts.device.type == "cpu":
        return fused_gn_terms_plain(R, t, pts, valid, img, fx, fy, cx, cy, sigma2)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_gn_terms: unsupported device {pts.device}")
    dev = pts.device
    if pts.dim() != 3 or img.dim() != 3:
        raise ValueError("fused_gn_terms: pts must be (B, K, 3) and img (B, H, W)")
    b, k, _ = pts.shape
    h, w = img.shape[1:]
    _check("R", R, (b, 3, 3), torch.float32, dev)
    _check("t", t, (b, 3), torch.float32, dev)
    _check("pts", pts, (b, k, 3), torch.float32, dev)
    _check("valid", valid, (b, k), torch.bool, dev)
    _check("img", img, (b, h, w), torch.bfloat16, dev)
    for name, x in (("R", R), ("t", t), ("pts", pts), ("valid", valid)):
        if not x.is_contiguous():
            raise ValueError(f"fused_gn_terms: {name} must be contiguous")
    if img.stride(2) != 1 or img.stride(1) != w:
        raise ValueError("fused_gn_terms: img rows must be contiguous")
    H = torch.empty((b, 6, 6), dtype=torch.float32, device=dev)
    g = torch.empty((b, 6), dtype=torch.float32, device=dev)
    e2 = torch.empty((b,), dtype=torch.float32, device=dev)
    n = torch.empty((b,), dtype=torch.int32, device=dev)
    lib = _lib()
    code = lib.fused_gn_terms(
        dev.index or 0, R.data_ptr(), t.data_ptr(), pts.data_ptr(), valid.data_ptr(),
        img.data_ptr(), img.stride(0), b, k, h, w, float(fx), float(fy), float(cx),
        float(cy), float(1.0 / sigma2), H.data_ptr(), g.data_ptr(), e2.data_ptr(), n.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, code, "fused_gn_terms launch")
    fused_gn_terms.launches += 1
    return H, g, torch.sqrt(e2), n


fused_gn_terms.launches = 0
