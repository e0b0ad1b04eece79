"""Kernel 5: a whole Levenberg-Marquardt pyramid level in one launch
(`csrc/level_lm.cu`).

Replaces the JAX package's `lax.scan` level loops of the Gauss-Newton
method (`rgbd_odometry_tpu/solvers/edge_dvo.py:586`, standard LM, and
`:754`, deferred accept), each iteration of which is the Pallas kernel
`fused_gn_terms` (`rgbd_odometry_tpu/pallas/fused_iter.py:159`) plus the
residual pass (`edge_dvo.py:261`) and the LM step. `level_lm` is the entry
point: CPU tensors go to the plain PyTorch version `level_lm_plain` (the
level loops, one iteration at a time, over `fused_gn_terms_plain` and
`residual_pass_plain`), CUDA tensors to the kernel; anything else raises.
It returns the level's diagnostics too: where they are not the best
iterate's own (deferred accept, or a Jacobian stride > 1) the kernel's
all-point tail computes them at the returned pose, in place of the residual
pass (`edge_dvo.py:593-609`, `:758-771`) that ran after the level before.
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

SMEM_BYTES = 232448 - 4096  # a block's shared memory on Hopper, less the static part
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
    + [ctypes.c_int] * 8 + [ctypes.c_float] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
)


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


def level_lm(R0, t0, pts, valid, count, img, scale, fx, fy, cx, cy, cfg, n_iters: int,
             jstride: int, stride: int = 1) -> LevelLM:
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
    pose. Arguments are checked before anything is built or launched."""
    if pts.device.type == "cpu":
        return level_lm_plain(R0, t0, pts, valid, count, img, scale, fx, fy, cx, cy, cfg,
                              n_iters, jstride, stride)
    dev = pts.device
    if pts.dim() != 3 or img.dim() != 3:
        raise ValueError("level_lm: pts must be (B, K, 3) and img (B, H, W)")
    b, k, _ = pts.shape
    h, w = img.shape[1:]
    fn = "level_lm"
    R0, t0 = R0.contiguous(), t0.contiguous()
    build.check_arg(fn, "R0", R0, (b, 3, 3), torch.float32, dev)
    build.check_arg(fn, "t0", t0, (b, 3), torch.float32, dev)
    build.check_arg(fn, "pts", pts, (b, k, 3), torch.float32, dev)
    build.check_arg(fn, "valid", valid, (b, k), torch.bool, dev)
    build.check_arg(fn, "count", count, (b,), torch.int32, dev)
    build.check_arg(fn, "scale", scale, (b,), torch.float32, dev)
    build.check_arg(fn, "img", img, (b, h, w), torch.bfloat16, dev, contiguous=False)
    build.check_rows(fn, "img", img)
    deferred = bool(cfg.lm_deferred_accept)
    if jstride < 1 or stride < 1 or (stride > 1 and (jstride > 1 or deferred)):
        raise ValueError(f"level_lm: jstride {jstride} and stride {stride} are not a level's "
                         "strides (stride > 1 needs the standard LM at jstride 1)")
    if n_iters < 1:
        raise ValueError(f"level_lm: n_iters must be >= 1, got {n_iters}")
    track = (not deferred) and jstride == 1
    k_jac = -(-k // jstride)
    smem = k_jac * 16 + (k_jac * 5 if track else 0)
    if smem > SMEM_BYTES:
        raise ValueError(f"level_lm: {k_jac} points of one level need {smem} bytes of shared "
                         f"memory, more than a block's {SMEM_BYTES}")
    if dev.type != "cuda":
        raise ValueError(f"level_lm: unsupported device {dev}")
    R = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, 3), dtype=torch.float32, device=dev)
    energy = torch.empty((b, n_iters), dtype=torch.float32, device=dev)
    best_iter = torch.empty((b,), dtype=torch.int32, device=dev)
    best_energy = torch.empty((b,), dtype=torch.float32, device=dev)
    final = torch.empty((b,), dtype=torch.float32, device=dev)
    eps = torch.empty((b, k), dtype=torch.float32, device=dev)
    vis = torch.empty((b, k), dtype=torch.bool, device=dev)
    ratio = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = build.bind("level_lm", "level_lm_solve", _ARGTYPES)
    with build.traced("level_lm"):
        code = lib.level_lm_solve(
            dev.index or 0, R0.data_ptr(), t0.data_ptr(), pts.data_ptr(), valid.data_ptr(),
            count.data_ptr(), img.data_ptr(), img.stride(0), scale.data_ptr(), b, k, k_jac,
            int(jstride), int(stride), int(n_iters), h, w, float(fx), float(fy), float(cx),
            float(cy), float(1.0 / cfg.gn_weight_sigma2_px), float(cfg.lm_damping),
            float(cfg.lm_trust_region),
            float(cfg.psi_norm_termination), int(deferred), int(bool(cfg.rotationize)), int(track),
            R.data_ptr(), t.data_ptr(), energy.data_ptr(), best_iter.data_ptr(),
            best_energy.data_ptr(), final.data_ptr(), eps.data_ptr(), vis.data_ptr(),
            ratio.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "level_lm launch")
    level_lm.launches += 1
    return LevelLM(R, t, energy, best_iter, best_energy, final, eps, vis, ratio)


level_lm.launches = 0
