"""Kernel 8: a whole sub-gradient pyramid level in one launch
(`csrc/level_sg.cu`).

Replaces the sub-gradient branch of the JAX package's `lax.scan` level loop
(`rgbd_odometry_tpu/solvers/edge_dvo.py:493-622`, scan at `:586`) with
`_subgradient_step` (`:775-794`) and `geo.se3_log`
(`rgbd_odometry_tpu/core/geometry.py:169`): XLA code, no Pallas kernel.
`level_sg` is the entry point: CPU tensors go to the plain PyTorch version
`level_sg_plain` (the level loop, one iteration at a time, over
`subgradient_terms_plain`), CUDA tensors to the kernel; anything else
raises. `se3_log_device` runs the kernel's `se3_log` device function
(`csrc/se3.cuh`) on a batch of poses, to hold it against its plain twin
`kernels/se3_plain.se3_log`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.core import geometry as geo
from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.kernels.level_lm import SMEM_BYTES, sel, trust_region
from rgbd_odometry_tpu_torch.kernels.sg_terms import subgradient_terms_plain

THREADS = (128, 256, 512, 1024)  # the block sizes the kernel may be launched with
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
    + [ctypes.c_float] * 12 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
)


class LevelSG(NamedTuple):
    """One level's result for B pairs."""

    R: torch.Tensor  # (B, 3, 3) the best iterate (re-orthogonalized with rotationize)
    t: torch.Tensor  # (B, 3)
    energy: torch.Tensor  # (B, n_iters) energy entering each iteration, 0 after done
    best_iter: torch.Tensor  # (B,) int32, -1 if no iterate was evaluated
    best_energy: torch.Tensor  # (B,) the energy at the best iterate
    eps: torch.Tensor  # (B, K) residuals at the best iterate
    visible: torch.Tensor  # (B, K) bool
    visible_ratio: torch.Tensor  # (B,) visible / max(count, 1)


def subgradient_step(R, t, g, descent, itr: int, cfg, precond: torch.Tensor):
    """The reference's damped, projected sub-gradient step (JAX
    `_subgradient_step`, :775-794): g = J^T W eps plus the L2 pull toward
    the unit log-pose, momentum, the preconditioner, the square-summable
    step 9e-2/(itr-4) past iteration 5 and the trust-region projection.
    Returns (psi (B,6), descent (B,6))."""
    if cfg.enable_l2_regularization:
        cpsi = geo.se3_log(R, t)
        norm = torch.linalg.vector_norm(cpsi, dim=-1, keepdim=True)
        cpsi = torch.where(norm > 0, cpsi / torch.clamp(norm, min=1e-30), cpsi)
        g = g + cfg.l2_lambda * cpsi
    descent = (1.0 - cfg.momentum) * g + cfg.momentum * descent
    # float32 division, as JAX divides the float32 step by float32 (itr - 4)
    step = float(np.float32(cfg.step_length) / np.float32(itr - 4 if itr > 5 else 1))
    return trust_region(-step * precond * descent, cfg.trust_region_radius), descent


def level_sg_plain(R0, t0, pts, valid, count, dt, fx, fy, cx, cy, cfg, n_iters: int) -> LevelSG:
    """The plain PyTorch version of `level_sg` (the JAX `lax.scan` body,
    :493-622, sub-gradient branch): `subgradient_terms_plain` on every point
    at the pose entering each iteration, then the damped, projected step.
    The best iterate (<=, later ties win) is returned with its per-point
    residuals and visibility; early termination freezes the pair and zeroes
    its remaining energy entries."""
    dev, dtype = R0.device, R0.dtype
    b, k = R0.shape[0], pts.shape[1]
    precond = torch.tensor([1.0, 1.0, 1.0] + [cfg.precondition_rot] * 3, dtype=dtype, device=dev)
    n_valid = torch.clamp(count, min=1).to(dtype)
    R, t = R0, t0
    descent = torch.zeros((b, 6), dtype=dtype, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    best_energy = torch.full((b,), 1.0e10, dtype=dtype, device=dev)
    best_R = torch.eye(3, dtype=dtype, device=dev).expand(b, 3, 3).contiguous()
    best_t = torch.zeros((b, 3), dtype=dtype, device=dev)
    best_iter = torch.full((b,), -1, dtype=torch.int32, device=dev)
    best_vis = torch.ones((b,), dtype=dtype, device=dev)
    best_eps = torch.zeros((b, k), dtype=dtype, device=dev)
    best_visible = torch.zeros((b, k), dtype=torch.bool, device=dev)
    energies = []
    for itr in range(n_iters):
        g, energy, n_vis, eps, visible = subgradient_terms_plain(
            R, t, pts, valid, dt, fx, fy, cx, cy, cfg.weight_sigma2
        )
        is_better = (energy <= best_energy) & (~done)
        best_energy = torch.where(is_better, energy, best_energy)
        best_R, best_t = sel(is_better, R, best_R), sel(is_better, t, best_t)
        best_iter = torch.where(is_better, torch.full_like(best_iter, itr), best_iter)
        best_vis = torch.where(is_better, n_vis.to(dtype) / n_valid, best_vis)
        best_eps = sel(is_better, eps, best_eps)
        best_visible = sel(is_better, visible, best_visible)

        psi, descent_new = subgradient_step(R, t, g, descent, itr, cfg, precond)
        psi_norm = torch.linalg.vector_norm(psi, dim=-1)
        xR, xt = geo.se3_exp(psi)
        new_t = t + (R @ xt[..., None])[..., 0]
        new_R = R @ xR
        if cfg.rotationize:
            new_R = geo.rotationize_newton(new_R)
        newly_done = psi_norm < cfg.psi_norm_termination
        do_update = (~done) & (~newly_done)
        descent = sel(done, descent, descent_new)

        energies.append(torch.where(done, torch.zeros_like(energy), energy))
        R, t = sel(do_update, new_R, R), sel(do_update, new_t, t)
        done = done | newly_done

    if cfg.rotationize:
        best_R = geo.rotationize_newton(best_R)
    return LevelSG(best_R.contiguous(), best_t.contiguous(), torch.stack(energies, dim=-1),
                   best_iter, best_energy, best_eps, best_visible, best_vis)


def block_threads(k: int) -> int:
    """The block size for a level of `k` points: 1024 threads above 4096
    points, else 512. Measured on an H100 at B = 1 and B = 64 (`chip_smoke.
    check_level_sg` times every size in `THREADS`): 512 threads are the
    fastest or within 2% of it at K = 1024, 2048 and 4096 (a coarse level is
    the serial step and the barriers, and 128 or 256 threads leave the pass
    4-16 points a thread), 1024 at K = 8192 (8 points a thread)."""
    return 1024 if k > 4096 else 512


def level_sg(R0, t0, pts, valid, count, dt, fx, fy, cx, cy, cfg, n_iters: int,
             threads: int | None = None, trace: torch.Tensor | None = None) -> LevelSG:
    """The `n_iters` sub-gradient iterations of one pyramid level for B
    frame pairs from the start poses (R0 (B,3,3), t0 (B,3)), over every
    point of the level (pts (B,K,3) float32, valid (B,K) bool, count (B,)
    int32) against the float32 DT dt (B,H,W) (rows contiguous; the batch
    stride may be larger) with the level's intrinsics fx, fy, cx, cy. `cfg`
    (a `SolverConfig`) supplies `weight_sigma2`, `enable_l2_regularization`,
    `l2_lambda`, `momentum`, `step_length`, `precondition_rot`,
    `trust_region_radius`, `psi_norm_termination` and `rotationize`. On a
    CUDA tensor, `threads` overrides the block size (`block_threads`) and
    `trace`, a (B, n_iters, 18) float32 tensor, receives for every iteration
    a pair runs the pose entering it (R 9, t 3) and its J^T W eps (6); rows
    after a pair is done keep what they held.
    Arguments are checked before anything is built or launched."""
    if pts.device.type == "cpu":
        return level_sg_plain(R0, t0, pts, valid, count, dt, fx, fy, cx, cy, cfg, n_iters)
    dev = pts.device
    if pts.dim() != 3 or dt.dim() != 3:
        raise ValueError("level_sg: pts must be (B, K, 3) and dt (B, H, W)")
    b, k, _ = pts.shape
    h, w = dt.shape[1:]
    fn = "level_sg"
    R0, t0 = R0.contiguous(), t0.contiguous()
    build.check_arg(fn, "R0", R0, (b, 3, 3), torch.float32, dev)
    build.check_arg(fn, "t0", t0, (b, 3), torch.float32, dev)
    build.check_arg(fn, "pts", pts, (b, k, 3), torch.float32, dev)
    build.check_arg(fn, "valid", valid, (b, k), torch.bool, dev)
    build.check_arg(fn, "count", count, (b,), torch.int32, dev)
    build.check_arg(fn, "dt", dt, (b, h, w), torch.float32, dev, contiguous=False)
    build.check_rows(fn, "dt", dt)
    if trace is not None:
        build.check_arg(fn, "trace", trace, (b, n_iters, 18), torch.float32, dev)
    if n_iters < 1:
        raise ValueError(f"level_sg: n_iters must be >= 1, got {n_iters}")
    threads = block_threads(k) if threads is None else int(threads)
    if threads not in THREADS:
        raise ValueError(f"level_sg: threads must be one of {THREADS}, got {threads}")
    smem = k * 16  # the points, staged once as float4
    if smem > SMEM_BYTES:
        raise ValueError(f"level_sg: {k} points of one level need {smem} bytes of shared "
                         f"memory, more than a block's {SMEM_BYTES}")
    if dev.type != "cuda":
        raise ValueError(f"level_sg: unsupported device {dev}")
    R = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, 3), dtype=torch.float32, device=dev)
    energy = torch.empty((b, n_iters), dtype=torch.float32, device=dev)
    best_iter = torch.empty((b,), dtype=torch.int32, device=dev)
    best_energy = torch.empty((b,), dtype=torch.float32, device=dev)
    eps = torch.empty((b, k), dtype=torch.float32, device=dev)
    vis = torch.empty((b, k), dtype=torch.bool, device=dev)
    ratio = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = build.bind("level_sg", "level_sg_solve", _ARGTYPES)
    with build.traced("level_sg"):
        code = lib.level_sg_solve(
            dev.index or 0, R0.data_ptr(), t0.data_ptr(), pts.data_ptr(), valid.data_ptr(),
            count.data_ptr(), dt.data_ptr(), dt.stride(0), b, k, int(n_iters), h, w, threads,
            float(fx), float(fy), float(cx), float(cy), float(1.0 / cfg.weight_sigma2),
            float(cfg.l2_lambda), float(1.0 - cfg.momentum), float(cfg.momentum),
            float(cfg.step_length), float(cfg.precondition_rot), float(cfg.trust_region_radius),
            float(cfg.psi_norm_termination), int(bool(cfg.enable_l2_regularization)),
            int(bool(cfg.rotationize)), R.data_ptr(), t.data_ptr(), energy.data_ptr(),
            best_iter.data_ptr(), best_energy.data_ptr(), eps.data_ptr(), vis.data_ptr(),
            ratio.data_ptr(), None if trace is None else trace.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "level_sg launch")
    level_sg.launches += 1
    return LevelSG(R, t, energy, best_iter, best_energy, eps, vis, ratio)


level_sg.launches = 0


def se3_log_device(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The twists (n,6) of poses (R (n,3,3), t (n,3), float32 CUDA tensors)
    by the device function `se3_log` of `csrc/se3.cuh`, one thread a pose."""
    dev = R.device
    if dev.type != "cuda":
        raise ValueError(f"se3_log_device: unsupported device {dev}")
    n = R.shape[0]
    build.check_arg("se3_log_device", "R", R, (n, 3, 3), torch.float32, dev)
    build.check_arg("se3_log_device", "t", t, (n, 3), torch.float32, dev)
    psi = torch.empty((n, 6), dtype=torch.float32, device=dev)
    lib = build.bind("level_sg", "se3_log_batch",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])
    code = lib.se3_log_batch(dev.index or 0, R.data_ptr(), t.data_ptr(), n, psi.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "se3_log_batch launch")
    return psi
