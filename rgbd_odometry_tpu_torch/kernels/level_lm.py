"""Kernel 5: a whole Levenberg-Marquardt pyramid in one launch
(`csrc/level_lm.cu`).

Replaces the JAX package's `lax.scan` level loops of the Gauss-Newton
method (`rgbd_odometry_tpu/solvers/edge_dvo.py:586`, standard LM, and
`:754`, deferred accept), each iteration of which is the Pallas kernel
`fused_gn_terms` (`rgbd_odometry_tpu/pallas/fused_iter.py:159`) plus the
residual pass (`edge_dvo.py:261`) and the LM step, and `solve_pyramid`'s
level loop (`:824`). `level_lm_pyramid` is the entry point: CPU tensors go
to the plain PyTorch version `level_lm_pyramid_plain` (`level_lm_plain` a
level: the level loops, one iteration at a time, over `fused_gn_terms_plain`
and `residual_pass_plain`), CUDA tensors to the kernel; anything else
raises. `level_lm` is one level, a pyramid of one. Each level returns its
diagnostics too: where they are not the best iterate's own (deferred
accept, or a Jacobian stride > 1) the kernel's all-point tail computes them
at the returned pose, in place of the residual pass (`edge_dvo.py:593-609`,
`:758-771`) that ran after the level before. A level runs on `level_ranks`
blocks a pair, a thread-block cluster where its points are many.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from rgbd_odometry_tpu_torch.core import geometry as geo
from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.kernels.fused_iter import fused_gn_terms_plain
from rgbd_odometry_tpu_torch.kernels.residual import residual_pass_plain
from rgbd_odometry_tpu_torch.ops.linalg6 import chol_solve6

SMEM_BYTES = 232448 - 8192  # a block's shared memory on Hopper, less the static part
CLUSTERS = (1, 2, 4, 8)  # the blocks a pair's level may run on
# Jacobian points a rank takes in a pass before the rule splits a level
# further: measured on an H100 (`profile_paths.py --paths solve`), no level
# of the production profiles or the `dvo` defaults gains from a split (the
# `dvo` defaults' level 0, 2048 points, loses 6% at B = 1 and 9% at B = 64
# on 2 blocks: a cluster barrier a sum costs more than the halved pass)
POINTS_A_RANK = 8192
MAX_LEVELS = 8  # levels of one launch
_LL, _INT, _FLT = (ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_float))
_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [_LL, _LL, _INT, _FLT]
             + [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


class LevelLM(NamedTuple):
    """One level's result for B pairs."""

    R: torch.Tensor  # (B, 3, 3) the best iterate (re-orthogonalized with rotationize)
    t: torch.Tensor  # (B, 3)
    energy: torch.Tensor  # (B, n_iters) energy entering each iteration, 0 after done
    best_iter: torch.Tensor  # (B,) int32, -1 if no iterate was evaluated
    best_energy: torch.Tensor  # (B,) the Gauss-Newton pass's energy at the best iterate
    # the level's diagnostics over all K points: with track (standard LM,
    # jstride 1) the best iterate's, else the all-point pass's at (R, t)
    final_energy: torch.Tensor  # (B,) ||eps||
    eps: torch.Tensor  # (B, K) residuals, 0 where invisible
    visible: torch.Tensor  # (B, K) bool
    visible_ratio: torch.Tensor  # (B,) visible / max(count, 1)


def sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-pair (B,) mask broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def trust_region(psi: torch.Tensor, radius: float) -> torch.Tensor:
    """psi (B,6) scaled back onto the ball |psi| <= radius."""
    norm = torch.linalg.vector_norm(psi, dim=-1)
    scale = torch.where(norm > radius, radius / torch.clamp(norm, min=1e-30), torch.ones_like(norm))
    return psi * scale[:, None]


def lm_psi(H: torch.Tensor, g: torch.Tensor, lam: torch.Tensor, radius: float) -> torch.Tensor:
    """Levenberg-Marquardt step psi = -(H + lam diag(H))^-1 g, projected
    onto the trust region (JAX `_lm_psi`, edge_dvo.py:797-816)."""
    damp = torch.diag_embed(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-8))
    return trust_region(-chol_solve6(H + lam[:, None, None] * damp, g), radius)


def _strided(x: torch.Tensor, s: int) -> torch.Tensor:
    return x[:, ::s].contiguous() if s > 1 else x


def _deferred_plain(R0, t0, pj, vj, img, scale, f, cfg, n_iters):
    """Deferred-accept LM (JAX `:625-772`): each iteration is one
    Gauss-Newton pass at the current pose, whose energy is the verdict on
    the pending proposal. On reject the pose reverts to the backup and the
    step is recomputed from the backup's carried (H, g, energy) with raised
    lambda: the JAX carry of per-point (J, eps, wgt), which the body uses
    only through H and g."""
    dev, dt = R0.device, R0.dtype
    b = R0.shape[0]
    R, t = R0, t0
    Rb, tb = R0, t0
    Hb = torch.zeros((b, 6, 6), dtype=dt, device=dev)
    gb = torch.zeros((b, 6), dtype=dt, device=dev)
    eb = torch.full((b,), float("inf"), dtype=dt, device=dev)
    pending = torch.zeros((b,), dtype=torch.bool, device=dev)
    lam = torch.full((b,), cfg.lm_damping, dtype=dt, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    best_energy = torch.full((b,), 1.0e10, dtype=dt, device=dev)
    best_R, best_t = R0, t0
    best_iter = torch.full((b,), -1, dtype=torch.int32, device=dev)
    energies = []
    for itr in range(n_iters):
        H, g, energy, _ = fused_gn_terms_plain(R, t, pj, vj, img, *f, cfg.gn_weight_sigma2_px,
                                               scale)
        accept = (~pending) | (energy < eb)
        worse = pending & (energy > eb)
        lam = torch.where(done, lam, torch.where(
            pending & accept, torch.clamp(lam / 3.0, min=1e-8),
            torch.where(worse, torch.clamp(lam * 4.0, max=1e6), lam),
        ))
        R_cur, t_cur = sel(accept, R, Rb), sel(accept, t, tb)
        H_use, g_use = sel(accept, H, Hb), sel(accept, g, gb)
        e_use = torch.where(accept, energy, eb)

        is_better = (energy <= best_energy) & (~done)
        best_energy = torch.where(is_better, energy, best_energy)
        best_R, best_t = sel(is_better, R, best_R), sel(is_better, t, best_t)
        best_iter = torch.where(is_better, torch.full_like(best_iter, itr), best_iter)

        psi = lm_psi(H_use, g_use, lam, cfg.lm_trust_region)
        newly_done = accept & pending & (
            torch.linalg.vector_norm(psi, dim=-1) < cfg.psi_norm_termination
        )
        do_update = (~done) & (~newly_done)

        xR, xt = geo.se3_exp(psi)
        R_prop = R_cur @ xR
        if cfg.rotationize:
            R_prop = geo.rotationize_newton(R_prop)
        t_prop = t_cur + (R_cur @ xt[..., None])[..., 0]

        energies.append(torch.where(done, torch.zeros_like(energy), energy))
        R, t = sel(do_update, R_prop, R_cur), sel(do_update, t_prop, t_cur)
        Rb, tb = sel(do_update, R_cur, Rb), sel(do_update, t_cur, tb)
        Hb, gb = sel(do_update, H_use, Hb), sel(do_update, g_use, gb)
        eb = torch.where(do_update, e_use, eb)
        pending = torch.where(done | newly_done, torch.zeros_like(pending), do_update)
        done = done | newly_done
    return best_R, best_t, energies, best_iter, best_energy, None, None, None


def _standard_plain(R0, t0, pj, vj, ps, vs, count, stride, track, img, scale, f, cfg, n_iters):
    """The standard LM (the JAX `lax.scan` body's Gauss-Newton branch,
    :493-622): the Gauss-Newton pass on the Jacobian subset at the current
    pose, then the residual pass on the proposal subset at the proposal. A
    decrease accepts it and lowers lambda, an exact tie neither moves nor
    raises lambda, an increase raises it; a rejected step never terminates.
    With `track` (Jacobian stride 1) the Gauss-Newton pass's per-point
    outputs at the best iterate are kept."""
    dev, dt = R0.device, R0.dtype
    b, k = R0.shape[0], pj.shape[1]
    n_valid = torch.clamp(count, min=1).to(dt)
    R, t = R0, t0
    lam = torch.full((b,), cfg.lm_damping, dtype=dt, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    best_energy = torch.full((b,), 1.0e10, dtype=dt, device=dev)
    best_R = torch.eye(3, dtype=dt, device=dev).expand(b, 3, 3).contiguous()
    best_t = torch.zeros((b, 3), dtype=dt, device=dev)
    best_iter = torch.full((b,), -1, dtype=torch.int32, device=dev)
    best_vis = torch.ones((b,), dtype=dt, device=dev)
    best_eps = torch.zeros((b, k), dtype=dt, device=dev)
    best_visible = torch.zeros((b, k), dtype=torch.bool, device=dev)
    energies = []
    for itr in range(n_iters):
        H, g, energy, n_vis, *pts_out = fused_gn_terms_plain(
            R, t, pj, vj, img, *f, cfg.gn_weight_sigma2_px, scale, write_points=track)
        is_better = (energy <= best_energy) & (~done)
        best_energy = torch.where(is_better, energy, best_energy)
        best_R, best_t = sel(is_better, R, best_R), sel(is_better, t, best_t)
        best_iter = torch.where(is_better, torch.full_like(best_iter, itr), best_iter)
        if track:
            eps, visible = pts_out
            best_vis = torch.where(is_better, n_vis.to(dt) / n_valid, best_vis)
            best_eps = sel(is_better, eps, best_eps)
            best_visible = sel(is_better, visible, best_visible)

        psi = lm_psi(H, g, lam, cfg.lm_trust_region)
        psi_norm = torch.linalg.vector_norm(psi, dim=-1)
        xR, xt = geo.se3_exp(psi)
        new_t = t + (R @ xt[..., None])[..., 0]
        new_R = R @ xR
        if cfg.rotationize:
            new_R = geo.rotationize_newton(new_R)

        e_new = residual_pass_plain(new_R, new_t, ps, vs, img, *f, True)[0]
        # the current energy over the same subset, by the same pass: an
        # exact tie at an unchanged pose stays a tie (JAX :529-532)
        e_cur = energy if stride == 1 else residual_pass_plain(R, t, ps, vs, img, *f, True)[0]
        accept = e_new < e_cur
        worse = e_new > e_cur
        lam_next = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8), torch.where(
            worse, torch.clamp(lam * 4.0, max=1e6), lam))
        newly_done = accept & (psi_norm < cfg.psi_norm_termination)
        do_update = (~done) & (~newly_done) & accept
        lam = torch.where(done, lam, lam_next)

        energies.append(torch.where(done, torch.zeros_like(energy), energy))
        R, t = sel(do_update, new_R, R), sel(do_update, new_t, t)
        done = done | newly_done
    if not track:
        return best_R, best_t, energies, best_iter, best_energy, None, None, None
    return best_R, best_t, energies, best_iter, best_energy, best_eps, best_visible, best_vis


def level_lm_plain(R0, t0, pts, valid, count, img, scale, fx, fy, cx, cy, cfg, n_iters: int,
                   jstride: int, stride: int = 1) -> LevelLM:
    """The plain PyTorch version of `level_lm`: the level loops one
    iteration at a time over `fused_gn_terms_plain` and
    `residual_pass_plain`, then, unless the best iterate's own diagnostics
    were tracked, one all-point `residual_pass_plain` at the returned pose."""
    f = (fx, fy, cx, cy)
    pj, vj = _strided(pts, jstride), _strided(valid, jstride)
    track = not cfg.lm_deferred_accept and jstride == 1
    if cfg.lm_deferred_accept:
        out = _deferred_plain(R0, t0, pj, vj, img, scale, f, cfg, n_iters)
    else:
        ps, vs = _strided(pj, stride), _strided(vj, stride)
        out = _standard_plain(R0, t0, pj, vj, ps, vs, count, stride, track, img, scale, f, cfg,
                              n_iters)
    best_R, best_t, energies, best_iter, best_energy, eps, visible, vis = out
    if cfg.rotationize:
        best_R = geo.rotationize_newton(best_R)
    best_R, best_t = best_R.contiguous(), best_t.contiguous()
    final = best_energy
    if not track:
        final, n, eps, visible = residual_pass_plain(best_R, best_t, pts, valid, img, *f, True,
                                                     write_points=True)
        vis = n.to(final.dtype) / torch.clamp(count, min=1).to(final.dtype)
    return LevelLM(best_R, best_t, torch.stack(energies, dim=-1), best_iter, best_energy, final,
                   eps, visible, vis)


def level_lm_pyramid_plain(R0, t0, levels, cfg) -> tuple:
    """The plain version of `level_lm_pyramid`: `level_lm_plain` on each
    level in turn, each from the pose the one before returned."""
    out, R, t = [], R0, t0
    for lv in levels:
        res = level_lm_plain(R, t, lv.pts, lv.valid, lv.count, lv.img, lv.scale, lv.fx, lv.fy,
                             lv.cx, lv.cy, cfg, lv.n_iters, lv.jstride, lv.stride)
        out.append(res)
        R, t = res.R, res.t
    return tuple(out)


def _rank_smem(k: int, jstride: int, track: bool, ranks: int) -> int:
    """Shared memory of one rank of a level (bytes): its share of the
    Jacobian subset as float4 points, and with `track` their residuals and
    visibility."""
    k_jac = -(-k // jstride)
    n_local = min(k_jac, -(-k_jac // (256 * ranks)) * 256)
    return n_local * (16 + (5 if track else 0))


def level_ranks(k: int, jstride: int, stride: int, deferred: bool, cluster=None) -> int:
    """The route rule: the blocks (ranks of a thread-block cluster) one
    pair's level of capacity `k` runs on, a function of the level's shape
    and solver alone, never of the batch, so that a pair's bits are the
    same alone and in any batch. A level whose Jacobian subset has more
    than `POINTS_A_RANK` points a rank, or whose share does not fit a
    block's shared memory, doubles its ranks up to 8; a proposal stride
    > 1 keeps one rank. `cluster` forces that many ranks (1, 2, 4, 8) for
    checks and profiles; a level that cannot take it raises."""
    track = not deferred and jstride == 1
    k_jac = -(-k // jstride)
    if cluster is not None:
        if cluster not in CLUSTERS:
            raise ValueError(f"level_lm: cluster must be one of {CLUSTERS}, got {cluster}")
        if cluster > 1 and stride > 1:
            raise ValueError(f"level_lm: a level with proposal stride {stride} runs on one "
                             f"block, not {cluster}")
        ranks = cluster
    else:
        ranks = 1
        while ranks < CLUSTERS[-1] and stride == 1 and (
                k_jac > POINTS_A_RANK * ranks or _rank_smem(k, jstride, track, ranks) > SMEM_BYTES):
            ranks *= 2
    smem = _rank_smem(k, jstride, track, ranks)
    if smem > SMEM_BYTES:
        raise ValueError(f"level_lm: {k_jac} points of one level need {smem} bytes of shared "
                         f"memory on each of {ranks} block(s), more than a block's {SMEM_BYTES}")
    return ranks


class LmLevel(NamedTuple):
    """One level of a `level_lm_pyramid` launch (arguments as `level_lm`'s)."""

    pts: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    img: torch.Tensor
    scale: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    n_iters: int
    jstride: int
    stride: int = 1


def _check_level(fn: str, lv: LmLevel, b: int, dev, deferred: bool) -> tuple:
    """The checks of one level's arguments; returns (k, h, w, k_jac)."""
    if lv.pts.dim() != 3 or lv.img.dim() != 3:
        raise ValueError(f"{fn}: pts must be (B, K, 3) and img (B, H, W)")
    k = lv.pts.shape[1]
    h, w = lv.img.shape[1:]
    build.check_arg(fn, "pts", lv.pts, (b, k, 3), torch.float32, dev)
    build.check_arg(fn, "valid", lv.valid, (b, k), torch.bool, dev)
    build.check_arg(fn, "count", lv.count, (b,), torch.int32, dev)
    build.check_arg(fn, "scale", lv.scale, (b,), torch.float32, dev)
    build.check_arg(fn, "img", lv.img, (b, h, w), torch.bfloat16, dev, contiguous=False)
    build.check_rows(fn, "img", lv.img)
    jstride, stride = lv.jstride, lv.stride
    if jstride < 1 or stride < 1 or (stride > 1 and (jstride > 1 or deferred)):
        raise ValueError(f"{fn}: jstride {jstride} and stride {stride} are not a level's "
                         "strides (stride > 1 needs the standard LM at jstride 1)")
    if lv.n_iters < 1:
        raise ValueError(f"{fn}: n_iters must be >= 1, got {lv.n_iters}")
    return k, h, w, -(-k // jstride)


def level_lm_pyramid(R0, t0, levels, cfg, cluster=None, clocks=None) -> tuple:
    """Every level of a Levenberg-Marquardt pyramid for B frame pairs in one
    launch: `levels` (`LmLevel`s, in solve order, coarsest first), each run
    as `level_lm` runs it from the pose the level before returned, the first
    from (R0 (B,3,3), t0 (B,3)). Returns one `LevelLM` a level, in the
    order given. A level runs on `level_ranks` blocks a pair (the launch's
    cluster is the largest); `cluster` forces every level onto that many.
    `clocks`, a (levels, 64, 8) int64 tensor, receives pair 0's clock64()
    at the phases of its first 64 iterations a level (`csrc/level_lm.cu`).
    CPU tensors go to `level_lm_pyramid_plain`. Arguments are checked before
    anything is built or launched."""
    levels = tuple(levels)
    if not levels:
        raise ValueError("level_lm_pyramid: no level")
    if levels[0].pts.device.type == "cpu":
        return level_lm_pyramid_plain(R0, t0, levels, cfg)
    fn = "level_lm"
    dev = levels[0].pts.device
    b = levels[0].pts.shape[0] if levels[0].pts.dim() == 3 else -1
    R0, t0 = R0.contiguous(), t0.contiguous()
    build.check_arg(fn, "R0", R0, (b, 3, 3), torch.float32, dev)
    build.check_arg(fn, "t0", t0, (b, 3), torch.float32, dev)
    deferred = bool(cfg.lm_deferred_accept)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"{fn}: at most {MAX_LEVELS} levels a launch, got {len(levels)}")
    shapes = [_check_level(fn, lv, b, dev, deferred) for lv in levels]
    if clocks is not None:
        build.check_arg(fn, "clocks", clocks, (len(levels), 64, 8), torch.int64, dev)
    ranks = [level_ranks(k, lv.jstride, lv.stride, deferred, cluster)
             for lv, (k, _, _, _) in zip(levels, shapes)]
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    # the outputs of every level in one float32, one int32 and one bool buffer
    ks = [k for k, _, _, _ in shapes]
    per = [15 + lv.n_iters + k for lv, k in zip(levels, ks)]
    flt = torch.empty((b * sum(per),), dtype=torch.float32, device=dev)
    ints = torch.empty((len(levels), b), dtype=torch.int32, device=dev)
    vis = torch.empty((b * sum(ks),), dtype=torch.bool, device=dev)
    outs, ptrs, rows, fl = [], [], [], []
    fo = vo = 0
    for i, (lv, (k, h, w, k_jac), r) in enumerate(zip(levels, shapes, ranks)):
        n = lv.n_iters
        take = []
        for size in (9, 3, n, 1, 1, k, 1):  # R, t, energy, best energy, final, eps, ratio
            take.append(flt[fo:fo + b * size])
            fo += b * size
        R, t, energy, best_energy, final, eps, ratio = take
        v = vis[vo:vo + b * k]
        vo += b * k
        outs.append(LevelLM(R.view(b, 3, 3), t.view(b, 3), energy.view(b, n), ints[i],
                            best_energy, final, eps.view(b, k), v.view(b, k), ratio))
        ptrs += [lv.pts.data_ptr(), lv.valid.data_ptr(), lv.count.data_ptr(), lv.img.data_ptr(),
                 lv.scale.data_ptr(), R.data_ptr(), t.data_ptr(), energy.data_ptr(),
                 ints[i].data_ptr(), best_energy.data_ptr(), final.data_ptr(), eps.data_ptr(),
                 v.data_ptr(), ratio.data_ptr(),
                 0 if clocks is None else clocks[i].data_ptr()]
        rows += [k, k_jac, int(lv.jstride), int(lv.stride), int(n), h, w, r]
        fl += [float(lv.fx), float(lv.fy), float(lv.cx), float(lv.cy)]
    nl = len(levels)
    lib = build.bind("level_lm", "level_lm_pyramid", _ARGTYPES)
    with build.traced("level_lm"):
        code = lib.level_lm_pyramid(
            dev.index or 0, nl, b, max(ranks), R0.data_ptr(), t0.data_ptr(),
            (ctypes.c_longlong * len(ptrs))(*ptrs),
            (ctypes.c_longlong * nl)(*(lv.img.stride(0) for lv in levels)),
            (ctypes.c_int * len(rows))(*rows), (ctypes.c_float * len(fl))(*fl),
            float(1.0 / cfg.gn_weight_sigma2_px), float(cfg.lm_damping),
            float(cfg.lm_trust_region), float(cfg.psi_norm_termination), int(deferred),
            int(bool(cfg.rotationize)), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "level_lm launch")
    level_lm_pyramid.launches += 1
    return tuple(outs)


level_lm_pyramid.launches = 0


def level_lm(R0, t0, pts, valid, count, img, scale, fx, fy, cx, cy, cfg, n_iters: int,
             jstride: int, stride: int = 1, cluster=None) -> LevelLM:
    """The `n_iters` Levenberg-Marquardt iterations of one pyramid level for
    B frame pairs from the start poses (R0 (B,3,3), t0 (B,3)), over the
    level's points (pts (B,K,3) float32, valid (B,K) bool, count (B,) int32)
    against the bf16 DT channel img (B,H,W) (rows contiguous; the batch
    stride may be larger, e.g. `chans[:, 0]`) with each pair's DT units per
    pixel `scale` (B,) float32 and the level's intrinsics fx, fy, cx, cy.
    The Gauss-Newton passes use every `jstride`-th point; the standard LM's
    proposal passes every `stride`-th point of those (stride > 1 only with
    jstride 1). `cfg` (a `SolverConfig`) supplies `lm_deferred_accept`,
    `gn_weight_sigma2_px`, `lm_damping`, `lm_trust_region`,
    `psi_norm_termination` and `rotationize`. The level's diagnostics over
    all K points come with it: with the standard LM at jstride 1 the best
    iterate's (`track`), otherwise those of one more pass at the returned
    pose. On the card it is a pyramid of one level (`level_lm_pyramid`);
    `cluster` forces its blocks a pair. Arguments are checked before
    anything is built or launched."""
    level = LmLevel(pts, valid, count, img, scale, fx, fy, cx, cy, n_iters, jstride, stride)
    return level_lm_pyramid(R0, t0, (level,), cfg, cluster)[0]
