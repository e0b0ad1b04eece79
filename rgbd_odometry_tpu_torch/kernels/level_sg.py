"""Kernel 8: a whole sub-gradient pyramid in one launch (`csrc/level_sg.cu`).

Replaces the sub-gradient branch of the JAX package's `lax.scan` level loop
(`rgbd_odometry_tpu/solvers/edge_dvo.py:493-622`, scan at `:586`) with
`_subgradient_step` (`:775-794`) and `geo.se3_log`
(`rgbd_odometry_tpu/core/geometry.py:169`), and `solve_pyramid`'s level
loop (`:824`): XLA code, no Pallas kernel. `level_sg_pyramid` is the entry
point: CPU tensors go to the plain PyTorch version `level_sg_pyramid_plain`
(`level_sg_plain` a level: the level loop, one iteration at a time, over
`subgradient_terms_plain`), CUDA tensors to the kernel; anything else
raises. `level_sg` is one level, a pyramid of one. A level runs on
`level_ranks` blocks a pair, a thread-block cluster where its points are
many. `se3_log_device` runs the step's `warp_se3_log` (`csrc/warp.cuh`) on
a batch of poses, to hold it against its plain twin
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

THREADS = (128, 256, 512, 1024)  # the working threads a block may be given
CLUSTERS = (1, 2, 4, 8)  # the blocks a pair's level may run on
POINTS_A_RANK = 4096  # points a rank takes before the rule splits a level further
RANK_THREADS = 512  # a block's working threads (a warp for the step comes beside them)
MAX_LEVELS = 8  # levels of one launch
_LL, _INT, _FLT = (ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_float))
_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [_LL, _LL, _INT, _FLT]
             + [ctypes.c_float] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


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
    """The threads a pair of a level of `k` points runs its pass on:
    `RANK_THREADS` on each of its `level_ranks` blocks, so 1024 at K = 8192
    (two blocks) and 512 below. Measured on an H100 at B = 1 and B = 64
    (`chip_smoke.check_level_sg` times every route and block size): one
    block of 512 threads is the fastest or within 2% of it at K = 1024,
    2048 and 4096 (a coarse level is the serial step and the barriers, and
    128 or 256 threads leave the pass 4-16 points a thread); at K = 8192
    two blocks of 512 (and a step warp beside them) beat one of 1024, and
    a block of 544 threads keeps 120 registers a thread where one of 1024
    has 64."""
    return RANK_THREADS * level_ranks(k)


def level_ranks(k: int, cluster=None) -> int:
    """The route rule: the blocks (ranks of a thread-block cluster) one
    pair's level of `k` points runs on, a function of `k` alone, never of
    the batch, so that a pair's bits are the same alone and in any batch:
    one rank for every `POINTS_A_RANK` points (1, 2, 4 or 8), and as many as
    its share of the points needs to fit a block's shared memory. `cluster`
    forces that many ranks for checks and profiles."""
    if cluster is not None:
        if cluster not in CLUSTERS:
            raise ValueError(f"level_sg: cluster must be one of {CLUSTERS}, got {cluster}")
        ranks = cluster
    else:
        ranks = 1
        while ranks < CLUSTERS[-1] and (k > POINTS_A_RANK * ranks
                                        or _rank_smem(k, ranks, RANK_THREADS) > SMEM_BYTES):
            ranks *= 2
    return ranks


def _rank_smem(k: int, ranks: int, threads: int) -> int:
    """Shared memory of one rank (bytes): its share of the points as float4."""
    return min(k, -(-k // (threads * ranks)) * threads) * 16


class SgLevel(NamedTuple):
    """One level of a `level_sg_pyramid` launch (arguments as `level_sg`'s)."""

    pts: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    dt: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    n_iters: int


def level_sg_pyramid_plain(R0, t0, levels, cfg) -> tuple:
    """The plain version of `level_sg_pyramid`: `level_sg_plain` on each
    level in turn, each from the pose the one before returned."""
    out, R, t = [], R0, t0
    for lv in levels:
        res = level_sg_plain(R, t, lv.pts, lv.valid, lv.count, lv.dt, lv.fx, lv.fy, lv.cx, lv.cy,
                             cfg, lv.n_iters)
        out.append(res)
        R, t = res.R, res.t
    return tuple(out)


def _check_level(fn: str, lv: SgLevel, b: int, dev, trace, threads, cluster) -> tuple:
    """The checks of one level's arguments; returns (k, h, w, ranks, threads)."""
    if lv.pts.dim() != 3 or lv.dt.dim() != 3:
        raise ValueError(f"{fn}: pts must be (B, K, 3) and dt (B, H, W)")
    k = lv.pts.shape[1]
    h, w = lv.dt.shape[1:]
    build.check_arg(fn, "pts", lv.pts, (b, k, 3), torch.float32, dev)
    build.check_arg(fn, "valid", lv.valid, (b, k), torch.bool, dev)
    build.check_arg(fn, "count", lv.count, (b,), torch.int32, dev)
    build.check_arg(fn, "dt", lv.dt, (b, h, w), torch.float32, dev, contiguous=False)
    build.check_rows(fn, "dt", lv.dt)
    if trace is not None:
        build.check_arg(fn, "trace", trace, (b, lv.n_iters, 18), torch.float32, dev)
    if lv.n_iters < 1:
        raise ValueError(f"{fn}: n_iters must be >= 1, got {lv.n_iters}")
    ranks = level_ranks(k, cluster)
    threads = RANK_THREADS if threads is None else int(threads)
    if threads not in THREADS:
        raise ValueError(f"{fn}: threads must be one of {THREADS}, got {threads}")
    smem = _rank_smem(k, ranks, threads)
    if smem > SMEM_BYTES:
        raise ValueError(f"{fn}: {k} points of one level need {smem} bytes of shared memory "
                         f"on each of {ranks} block(s), more than a block's {SMEM_BYTES}")
    return k, h, w, ranks, threads


def level_sg_pyramid(R0, t0, levels, cfg, cluster=None, threads=None, traces=None,
                     clocks=None) -> tuple:
    """Every level of a sub-gradient pyramid for B frame pairs in one
    launch: `levels` (`SgLevel`s, in solve order, coarsest first), each run
    as `level_sg` runs it from the pose the level before returned, the first
    from (R0 (B,3,3), t0 (B,3)). Returns one `LevelSG` a level, in the order
    given. A level runs on `level_ranks` blocks a pair with `RANK_THREADS`
    working threads each and a warp for the step beside them; `cluster` forces every level onto that many blocks,
    `threads` their threads, and `traces` (a (B, n_iters, 18) float32
    tensor or None a level) receive the levels' traces (see `level_sg`);
    `clocks`, a (levels, 64, 8) int64 tensor, pair 0's clock64() at the
    phases of its first 64 iterations a level (`csrc/level_sg.cu`).
    CPU tensors go to `level_sg_pyramid_plain`. Arguments are checked before
    anything is built or launched."""
    levels = tuple(levels)
    if not levels:
        raise ValueError("level_sg_pyramid: no level")
    if levels[0].pts.device.type == "cpu":
        return level_sg_pyramid_plain(R0, t0, levels, cfg)
    fn = "level_sg"
    dev = levels[0].pts.device
    b = levels[0].pts.shape[0] if levels[0].pts.dim() == 3 else -1
    R0, t0 = R0.contiguous(), t0.contiguous()
    build.check_arg(fn, "R0", R0, (b, 3, 3), torch.float32, dev)
    build.check_arg(fn, "t0", t0, (b, 3), torch.float32, dev)
    traces = (None,) * len(levels) if traces is None else tuple(traces)
    if len(levels) > MAX_LEVELS or len(traces) != len(levels):
        raise ValueError(f"{fn}: at most {MAX_LEVELS} levels a launch and a trace (or None) "
                         f"each, got {len(levels)} and {len(traces)}")
    shapes = [_check_level(fn, lv, b, dev, tr, threads, cluster)
              for lv, tr in zip(levels, traces)]
    if clocks is not None:
        build.check_arg(fn, "clocks", clocks, (len(levels), 64, 8), torch.int64, dev)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    ks = [k for k, _, _, _, _ in shapes]
    per = [14 + lv.n_iters + k for lv, k in zip(levels, ks)]
    flt = torch.empty((b * sum(per),), dtype=torch.float32, device=dev)
    ints = torch.empty((len(levels), b), dtype=torch.int32, device=dev)
    vis = torch.empty((b * sum(ks),), dtype=torch.bool, device=dev)
    outs, ptrs, rows, fl = [], [], [], []
    fo = vo = 0
    for i, (lv, (k, h, w, r, nt), tr) in enumerate(zip(levels, shapes, traces)):
        n = lv.n_iters
        take = []
        for size in (9, 3, n, 1, k, 1):  # R, t, energy, best energy, eps, ratio
            take.append(flt[fo:fo + b * size])
            fo += b * size
        R, t, energy, best_energy, eps, ratio = take
        v = vis[vo:vo + b * k]
        vo += b * k
        outs.append(LevelSG(R.view(b, 3, 3), t.view(b, 3), energy.view(b, n), ints[i],
                            best_energy, eps.view(b, k), v.view(b, k), ratio))
        ptrs += [lv.pts.data_ptr(), lv.valid.data_ptr(), lv.count.data_ptr(), lv.dt.data_ptr(),
                 R.data_ptr(), t.data_ptr(), energy.data_ptr(), ints[i].data_ptr(),
                 best_energy.data_ptr(), eps.data_ptr(), v.data_ptr(), ratio.data_ptr(),
                 0 if tr is None else tr.data_ptr(),
                 0 if clocks is None else clocks[i].data_ptr()]
        rows += [k, int(n), h, w, r, nt]
        fl += [float(lv.fx), float(lv.fy), float(lv.cx), float(lv.cy)]
    nl = len(levels)
    lib = build.bind("level_sg", "level_sg_pyramid", _ARGTYPES)
    with build.traced("level_sg"):
        code = lib.level_sg_pyramid(
            dev.index or 0, nl, b, max(r for _, _, _, r, _ in shapes), R0.data_ptr(),
            t0.data_ptr(), (ctypes.c_longlong * len(ptrs))(*ptrs),
            (ctypes.c_longlong * nl)(*(lv.dt.stride(0) for lv in levels)),
            (ctypes.c_int * len(rows))(*rows), (ctypes.c_float * len(fl))(*fl),
            float(1.0 / cfg.weight_sigma2), float(cfg.l2_lambda), float(1.0 - cfg.momentum),
            float(cfg.momentum), float(cfg.step_length), float(cfg.precondition_rot),
            float(cfg.trust_region_radius), float(cfg.psi_norm_termination),
            int(bool(cfg.enable_l2_regularization)), int(bool(cfg.rotationize)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "level_sg launch")
    level_sg_pyramid.launches += 1
    return tuple(outs)


level_sg_pyramid.launches = 0


def level_sg(R0, t0, pts, valid, count, dt, fx, fy, cx, cy, cfg, n_iters: int,
             threads: int | None = None, trace: torch.Tensor | None = None,
             cluster=None) -> LevelSG:
    """The `n_iters` sub-gradient iterations of one pyramid level for B
    frame pairs from the start poses (R0 (B,3,3), t0 (B,3)), over every
    point of the level (pts (B,K,3) float32, valid (B,K) bool, count (B,)
    int32) against the float32 DT dt (B,H,W) (rows contiguous; the batch
    stride may be larger) with the level's intrinsics fx, fy, cx, cy. `cfg`
    (a `SolverConfig`) supplies `weight_sigma2`, `enable_l2_regularization`,
    `l2_lambda`, `momentum`, `step_length`, `precondition_rot`,
    `trust_region_radius`, `psi_norm_termination` and `rotationize`. On a
    CUDA tensor it is a pyramid of one level (`level_sg_pyramid`):
    `cluster` forces its blocks a pair (`level_ranks`), `threads` their
    working threads (`THREADS`; 1024 leaves no room for the step warp), and
    `trace`, a (B, n_iters, 18)
    float32 tensor, receives for every iteration a pair runs the pose
    entering it (R 9, t 3) and its J^T W eps (6); rows after a pair is done
    keep what they held. Arguments are checked before anything is built or
    launched."""
    level = SgLevel(pts, valid, count, dt, fx, fy, cx, cy, n_iters)
    return level_sg_pyramid(R0, t0, (level,), cfg, cluster, threads, (trace,))[0]


def se3_log_device(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The twists (n,6) of poses (R (n,3,3), t (n,3), float32 CUDA tensors)
    by the step's device function `warp_se3_log` (`csrc/warp.cuh`), one
    warp a pose."""
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
