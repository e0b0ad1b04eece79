"""The edge-alignment DVO solver: port of
`rgbd_odometry_tpu/solvers/edge_dvo.py`.

Reference-keyframe edge points are aligned coarse-to-fine against the
distance transform of the current frame's edge map. Every function takes a
leading batch dimension of frame pairs where the JAX version is `vmap`ped.
Every `SolverConfig` the JAX package accepts runs here; `check_config`
rejects only an unknown `method`. Three level solvers:

* deferred-accept Levenberg-Marquardt (`profiles.production_320`);
* standard LM with an accept/reject residual pass per iteration (the
  `dvo` command's defaults), optionally on a 0-255 normalized DT;
* the reference's damped, projected sub-gradient method (`profiles.
  parity_320`, `SolverConfig()`): momentum, preconditioner, L2 pull on the
  normalized log-pose, the "reference" Jacobian.

The hot loops run through the hand-written CUDA kernels on a CUDA tensor,
for every configuration:
a frame's edge maps are one `canny_pyramid` call over all levels
(`kernels/canny.py`, hysteresis fixpoints on the device), then one
`dt_pyramid` call over all levels (`kernels/edt.py`: EDT, sqrt,
normalization, gradients, channels, one launch); a keyframe's edge points of every level in one
launch (`kernels/extract.py`: selection and back-projection, whose plain
version is `extract_ref_level`); a whole Gauss-Newton pyramid, both LM
loops and every level's all-point diagnostics, in one launch
(`kernels/level_lm.py`); a whole sub-gradient pyramid in one launch
(`kernels/level_sg.py`). Besides the production semantics (bilinear bf16
gathers with interpolant gradients and the textbook Jacobian for
Gauss-Newton; floor gathers of the float32 DT and the "reference" Jacobian
for the sub-gradient; Newton-Schulz re-orthogonalization) the kernels
compute every reference-parity branch JAX accepts (`interpolate_dt`,
`take` gathers for Gauss-Newton, the "channels" gradients, float32
channels, the swapped Jacobians, the SVD `rotationize`), chosen by
`kernels/point_sem.point_sem` and launch-uniform. `run_level_loop`, JAX's
level loops as PyTorch ops over the plain point terms (`_jacobian_residual`,
`_project_and_sample`), is reached by no route: the tests hold the
kernels' plain twins against it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import SolverConfig
from rgbd_odometry_tpu_torch.core import geometry as geo
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.kernels.canny import canny, canny_pyramid
from rgbd_odometry_tpu_torch.kernels.edt import dt_channels, dt_pyramid
from rgbd_odometry_tpu_torch.kernels.extract import RefLevel, extract_pyramid
from rgbd_odometry_tpu_torch.kernels.fused_iter import gn_point_terms
from rgbd_odometry_tpu_torch.kernels.level_lm import (
    POSE,
    LmLevel,
    level_lm,
    level_lm_pyramid,
    lm_psi,
    sel,
)
from rgbd_odometry_tpu_torch.kernels.level_sg import SgLevel, level_sg, level_sg_pyramid
from rgbd_odometry_tpu_torch.kernels.level_sg import subgradient_step
from rgbd_odometry_tpu_torch.kernels.point_sem import GN_CHANNELS, GN_TAKE, point_sem
from rgbd_odometry_tpu_torch.kernels.residual import residual_pass_plain
from rgbd_odometry_tpu_torch.kernels.sg_terms import sg_point_terms
from rgbd_odometry_tpu_torch.ops.project import div_scalar

_METHODS = ("gauss_newton", "subgradient")
_subgradient_step = subgradient_step  # the JAX module's name for it


class NowLevel(NamedTuple):
    """Distance-transform target of the current frame at one level."""

    dt: torch.Tensor  # (B, H, W) float32 (0-255 when cfg.normalize_dt, else pixels)
    dgx: torch.Tensor  # (B, H, W)
    dgy: torch.Tensor  # (B, H, W)
    edges: torch.Tensor  # (B, H, W) bool
    scale: torch.Tensor  # (B,) DT units per pixel (1.0: not normalized)
    chans: torch.Tensor  # (B, 3, H, W) stacked [dt, dgx, dgy], bf16 for GN else float32


class LevelDiagnostics(NamedTuple):
    """Per-level solve diagnostics (the JAX `LevelDiagnostics`, batched)."""

    energy: torch.Tensor  # (B, n_iters) energy per iteration (0 after early stop)
    best_energy: torch.Tensor  # (B,) all-point energy at the returned pose
    best_iter: torch.Tensor  # (B,) int32
    visible_ratio: torch.Tensor  # (B,)
    final_epsilons: torch.Tensor  # (B, K) all-point residuals at the returned pose
    final_valid: torch.Tensor  # (B, K) visibility at the returned pose
    num_points: torch.Tensor  # (B,) int32


def check_config(cfg: SolverConfig) -> None:
    """Raise ValueError unless `cfg.method` is one of the two solvers,
    "gauss_newton" or "subgradient". Every other setting the JAX package
    accepts runs, on the level kernels."""
    if cfg.method not in _METHODS:
        raise ValueError(f"SolverConfig.method must be one of {_METHODS}, got {cfg.method!r}")


def kernel_route(cfg: SolverConfig) -> bool:
    """The routing rule: the level kernels (`level_lm`, `level_sg`, their
    plain twins on CPU tensors) solve the levels of every configuration
    `check_config` accepts, so this is True for each of them (and raises
    ValueError for an unknown method). No configuration reaches
    `run_level_loop`, and nothing falls back to it."""
    check_config(cfg)
    return True


def lm_planes(now: "NowLevel", cfg: SolverConfig):
    """A Gauss-Newton level's planes for `level_lm` under `cfg`: (plane 0,
    (planes 1, 2) or ()): the float32 dt, dgx, dgy for "take" gathers, the
    three channels for "channels" gradients, else the DT channel alone
    (`chans[:, 0]`, bf16 or float32 as `gather_dtype`)."""
    sampler = point_sem(cfg).sampler
    if sampler == GN_TAKE:
        return now.dt, (now.dgx, now.dgy)
    if sampler == GN_CHANNELS:
        return now.chans[:, 0], (now.chans[:, 1], now.chans[:, 2])
    return now.chans[:, 0], ()


# --------------------------------------------------------------------------
# Reference keyframe features and now-frame DT targets
# --------------------------------------------------------------------------


def prepare_now_level(
    gray: torch.Tensor, cfg: SolverConfig, edges: torch.Tensor | None = None
) -> NowLevel:
    """Edge map (`canny`, kernel 6) -> `dt_channels` (kernel 7): squared EDT
    (+-cfg.edt_window, or the full row when 0) -> sqrt -> optional per-image
    0-255 min-max normalization -> central gradients -> channels (bf16 for
    Gauss-Newton with gather_dtype="bfloat16", else float32), (B, H, W) in.

    With `normalize_dt` each image gets its own scale = 255 / max(dmax -
    dmin, 1e-12), DT units per pixel; an edge-free or all-edge image has
    dmax == dmin, so its DT is all 0 at scale 255e12, as in JAX."""
    check_config(cfg)
    if edges is None:
        edges = canny(gray, cfg.canny_low, cfg.canny_high)
    return _now_level(edges, dt_channels(edges, *_dt_flags(cfg)))


def _dt_flags(cfg: SolverConfig):
    """`dt_channels` / `dt_pyramid`'s (radius, normalize, bf16) for `cfg`:
    bf16 channels for Gauss-Newton with gather_dtype="bfloat16"."""
    gn_bf16 = cfg.method == "gauss_newton" and cfg.gather_dtype == "bfloat16"
    return int(cfg.edt_window), bool(cfg.normalize_dt), gn_bf16


def _now_level(edges: torch.Tensor, target) -> NowLevel:
    dt, dgx, dgy, scale, chans = target
    return NowLevel(dt=dt, dgx=dgx, dgy=dgy, edges=edges, scale=scale, chans=chans)


def extract_ref_features(
    gray_pyr: Tuple[torch.Tensor, ...],
    depth_pyr: Tuple[torch.Tensor, ...],
    intr: Intrinsics,
    cfg: SolverConfig,
    max_points: Tuple[int, ...],
    edges_pyr: Tuple[torch.Tensor, ...] | None = None,
) -> Tuple[RefLevel, ...]:
    """`extract_ref_level` over all levels in one `extract_pyramid` call
    (one launch on the card); ``edges_pyr`` (a keyframe's own
    `NowLevel.edges`) skips Canny with bit-identical features, else the edge
    maps are one `_pyramid_edges` call."""
    if edges_pyr is None:
        edges_pyr = _pyramid_edges(gray_pyr, cfg)
    return extract_pyramid(tuple(edges_pyr), tuple(depth_pyr), intr, cfg, max_points)


def _pyramid_edges(gray_pyr: Tuple[torch.Tensor, ...], cfg: SolverConfig):
    """Per-level Canny edge maps of a pyramid in one `canny_pyramid` call
    (JAX `_pyramid_edges`, whose two forms, per-level `canny` and the
    stacked `canny_multi` under `cfg.fuse_level_canny`, are bit-identical
    to each other and to it)."""
    return canny_pyramid(tuple(gray_pyr), cfg.canny_low, cfg.canny_high)


def prepare_now_targets(
    gray_pyr: Tuple[torch.Tensor, ...], cfg: SolverConfig
) -> Tuple[NowLevel, ...]:
    """`prepare_now_level` on every level: the pyramid's edge maps
    (`_pyramid_edges`, one `canny_pyramid` call), then every level's target
    in one `dt_pyramid` call (one launch on the card)."""
    check_config(cfg)
    edges = _pyramid_edges(gray_pyr, cfg)
    targets = dt_pyramid(tuple(edges), *_dt_flags(cfg))
    return tuple(_now_level(e, t) for e, t in zip(edges, targets))


# --------------------------------------------------------------------------
# Per-point terms (JAX :227-398), for every branch
# --------------------------------------------------------------------------


def _robust_weights(eps, visible, now: NowLevel, cfg: SolverConfig) -> torch.Tensor:
    """w = 6 / (6 + r^2 / sigma^2) (JAX `_robust_weights`, :278-290), r in
    pixels (eps / scale) for Gauss-Newton, in DT units for the
    sub-gradient; 0 where invisible."""
    if cfg.method == "gauss_newton":
        r = eps / now.scale[:, None]
        sigma2 = cfg.gn_weight_sigma2_px
    else:
        r, sigma2 = eps, cfg.weight_sigma2
    six = torch.full_like(eps, 6.0)
    return torch.where(visible, six / (6.0 + div_scalar(r * r, sigma2)), torch.zeros_like(eps))


def _energy_and_ratio(eps, visible, count):
    """||eps|| (B,) and the visible share of the tracked points (B,)."""
    n_valid = torch.clamp(count, min=1).to(eps.dtype)
    return torch.sqrt((eps * eps).sum(-1)), visible.sum(-1).to(eps.dtype) / n_valid


def _project_and_sample(R, t, ref: RefLevel, now: NowLevel, intr: Intrinsics,
                        cfg: SolverConfig):
    """The residual pass without the Jacobian (JAX `_project_and_sample`,
    :261-275): (eps (B,K), wgt (B,K), visible (B,K), energy (B,),
    vis_ratio (B,)). The projection and the sample are the configuration's
    point semantics (`point_sem`) on plane 0 of its planes, as in
    `_jacobian_residual`."""
    gn = cfg.method == "gauss_newton"
    img = lm_planes(now, cfg)[0] if gn else now.dt
    _, _, eps, visible = residual_pass_plain(R, t, ref.pts3d, ref.valid, img, *intr, gn,
                                             write_points=True, sem=point_sem(cfg))
    wgt = _robust_weights(eps, visible, now, cfg)
    energy, vis_ratio = _energy_and_ratio(eps, visible, ref.count)
    return eps, wgt, visible, energy, vis_ratio


def _jacobian_residual(R, t, ref: RefLevel, now: NowLevel, intr: Intrinsics,
                       cfg: SolverConfig):
    """Warp, project, gather the residuals and the DT gradients, and build
    each point's 6-vector Jacobian (JAX `_jacobian_residual`, :293-398),
    every branch: (J (B,K,6), eps (B,K), wgt (B,K), visible (B,K), energy
    (B,), vis_ratio (B,)). The point terms are the level kernels' plain ones
    under the configuration's semantics (`point_sem`): `gn_point_terms` on
    its planes (`lm_planes`) for Gauss-Newton, `sg_point_terms` on the
    float32 DT for the sub-gradient (JAX's one-hot MXU gathers are direct
    indexing there)."""
    sem = point_sem(cfg)
    if cfg.method == "gauss_newton":
        img, grads = lm_planes(now, cfg)
        J, eps, wgt, visible = gn_point_terms(R, t, ref.pts3d, ref.valid, (img, *grads), *intr,
                                              cfg.gn_weight_sigma2_px, now.scale, sem)
    else:
        J, eps, wgt, visible = sg_point_terms(R, t, ref.pts3d, ref.valid, now.dt, *intr,
                                              cfg.weight_sigma2, sem)
    energy, vis_ratio = _energy_and_ratio(eps, visible, ref.count)
    return J, eps, wgt, visible, energy, vis_ratio


# --------------------------------------------------------------------------
# Level solve
# --------------------------------------------------------------------------


def level_strides(cfg: SolverConfig, cap: int) -> Tuple[int, int]:
    """(jstride, stride) of a Gauss-Newton level of capacity `cap` (JAX
    `run_level`, :467-482): the normal equations on every jstride-th point,
    the standard LM's proposals on every stride-th (stride > 1 only at
    jstride 1; the deferred accept has no proposal pass)."""
    jstride = max(1, min(int(cfg.lm_jacobian_stride), cap // 512))
    stride = 1
    if jstride == 1 and not cfg.lm_deferred_accept:
        stride = max(1, min(int(cfg.lm_proposal_stride), cap // 512))
    return jstride, stride


def _standard(cfg: SolverConfig) -> SolverConfig:
    """`cfg` with the standard LM: `collect_trajectory` runs it even where
    `lm_deferred_accept` is set (JAX :483)."""
    if cfg.method == "gauss_newton" and cfg.lm_deferred_accept:
        return dataclasses.replace(cfg, lm_deferred_accept=False)
    return cfg


def _trajectory(traj: torch.Tensor):
    """A (B, n, 12) trajectory output -> (Rs (B,n,3,3), ts (B,n,3))."""
    b, n = traj.shape[:2]
    return traj[..., :9].reshape(b, n, 3, 3), traj[..., 9:]


def run_level(
    ref: RefLevel,
    now: NowLevel,
    intr_level: Intrinsics,
    R0: torch.Tensor,
    t0: torch.Tensor,
    cfg: SolverConfig,
    n_iters: int,
    collect_trajectory: bool = False,
):
    """One pyramid level (JAX `run_level`, :421-622), under every
    configuration with its point semantics (`point_sem`) and
    re-orthogonalization. Gauss-Newton runs the whole level in one
    `level_lm` launch (deferred or standard LM): it forms the normal
    equations on every Nth
    point, N = jstride = max(1, min(lm_jacobian_stride, K // 512)) (:467);
    when N == 1 the standard LM tests proposals on every Mth point, M =
    max(1, min(lm_proposal_stride, K // 512)), else on the Jacobian's own
    subset. With a stride-1 standard LM the diagnostics are the level's own
    at the best iterate; otherwise the launch's all-point pass at the
    returned pose (JAX `_project_and_sample`, :593-609, :758-771). A
    sub-gradient level is one `level_sg` launch over every point, with the
    diagnostics of its best iterate. Returns (R (B,3,3), t (B,3),
    LevelDiagnostics), and with `collect_trajectory` also (Rs (B,n,3,3), ts (B,n,3)), the pose
    after each iteration (the frozen pose once a pair is done); the
    kernels write it as their trajectory output, and Gauss-Newton then runs
    the standard LM (JAX :483)."""
    check_config(cfg)
    b = ref.pts3d.shape[0]
    traj = None
    if collect_trajectory:
        cfg = _standard(cfg)
        traj = torch.empty((b, n_iters, POSE), dtype=torch.float32, device=ref.pts3d.device)
    if cfg.method != "gauss_newton":
        out = level_sg(R0, t0, ref.pts3d, ref.valid, ref.count, now.dt, *intr_level, cfg, n_iters,
                       traj=traj)
    else:
        jstride, stride = level_strides(cfg, ref.pts3d.shape[1])
        img, grads = lm_planes(now, cfg)
        out = level_lm(R0, t0, ref.pts3d, ref.valid, ref.count, img, now.scale,
                       *intr_level, cfg, n_iters, jstride, stride, traj=traj, grads=grads)
    result = (out.R, out.t, _diagnostics(out, ref.count))
    return result + (_trajectory(traj),) if collect_trajectory else result


def _diagnostics(out, count: torch.Tensor) -> LevelDiagnostics:
    """A level's `LevelDiagnostics` from its `LevelLM` (the all-point energy
    at the returned pose) or `LevelSG` (the best iterate's)."""
    return LevelDiagnostics(
        energy=out.energy, best_energy=getattr(out, "final_energy", out.best_energy),
        best_iter=out.best_iter, visible_ratio=out.visible_ratio, final_epsilons=out.eps,
        final_valid=out.visible, num_points=count,
    )


def _strided(ref: RefLevel, s: int) -> RefLevel:
    """Every s-th point of a level, its count max(count // s, 1) (JAX
    `run_level._strided`)."""
    if s == 1:
        return ref
    return RefLevel(pts3d=ref.pts3d[:, ::s].contiguous(), uv=ref.uv[:, ::s],
                    valid=ref.valid[:, ::s].contiguous(),
                    count=torch.clamp(torch.div(ref.count, s, rounding_mode="floor"), min=1))


def _rotationize(R: torch.Tensor, cfg: SolverConfig) -> torch.Tensor:
    return geo.rotationize(R, cfg.rotationize_method) if cfg.rotationize else R


def _update(R, t, psi, cfg: SolverConfig):
    """(R, t) exp(psi), re-orthogonalized as configured (JAX :514-518)."""
    xR, xt = geo.se3_exp(psi)
    return _rotationize(R @ xR, cfg), t + (R @ xt[..., None])[..., 0]


def _normal_equations(J, eps, wgt):
    """J^T W J (B,6,6) and J^T W eps (B,6)."""
    Jw = J * wgt[..., None]
    return Jw.transpose(-1, -2) @ J, (Jw * eps[..., None]).sum(-2)


def _lambda(lam, accept, worse):
    """Marquardt's lambda after a verdict: /3 (min 1e-8) on accept, x4 (max
    1e6) on an increase, kept on a tie."""
    return torch.where(accept, torch.clamp(div_scalar(lam, 3.0), min=1e-8), torch.where(
        worse, torch.clamp(lam * 4.0, max=1e6), lam))


def run_level_loop(ref: RefLevel, now: NowLevel, intr_level: Intrinsics, R0, t0,
                   cfg: SolverConfig, n_iters: int, collect_trajectory: bool = False):
    """The general level loop, the tests' op-for-op mirror of JAX: JAX
    `run_level` (:421-622) and `_run_level_lm_deferred` (:625-772), one
    iteration at a time in PyTorch ops over `_jacobian_residual` and
    `_project_and_sample`, with the LM step `lm_psi` or the reference's
    `subgradient_step` and `rotationize(., cfg.rotationize_method)` at
    JAX's sites. It runs every configuration, and no route reaches it:
    `run_level` and `solve_pyramid` send every level to the level kernels
    (their plain twins on the CPU), which the tests hold against it.
    Returns what `run_level` returns."""
    gn = cfg.method == "gauss_newton"
    dev, dtype = R0.device, R0.dtype
    b, cap = ref.pts3d.shape[:2]
    jstride, stride = level_strides(_standard(cfg) if collect_trajectory else cfg, cap)
    if not gn:
        jstride, stride = 1, 1
    ref_jac = _strided(ref, jstride)
    if gn and cfg.lm_deferred_accept and not collect_trajectory:
        return _loop_deferred(ref, ref_jac, now, intr_level, R0, t0, cfg, n_iters)
    ref_sub = ref_jac if jstride > 1 else _strided(ref, stride)
    k = ref_jac.pts3d.shape[1]
    precond = torch.tensor([1.0, 1.0, 1.0] + [cfg.precondition_rot] * 3, dtype=dtype, device=dev)
    R, t = R0, t0
    descent = torch.zeros((b, 6), dtype=dtype, device=dev)
    lam = torch.full((b,), cfg.lm_damping, dtype=dtype, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    best_energy = torch.full((b,), 1.0e10, dtype=dtype, device=dev)
    best_R = torch.eye(3, dtype=dtype, device=dev).expand(b, 3, 3).contiguous()
    best_t = torch.zeros((b, 3), dtype=dtype, device=dev)
    best_iter = torch.full((b,), -1, dtype=torch.int32, device=dev)
    best_vis = torch.ones((b,), dtype=dtype, device=dev)
    best_eps = torch.zeros((b, k), dtype=dtype, device=dev)
    best_visible = torch.zeros((b, k), dtype=torch.bool, device=dev)
    energies, Rs, ts = [], [], []
    for itr in range(n_iters):
        J, eps, wgt, visible, energy, vis_ratio = _jacobian_residual(R, t, ref_jac, now,
                                                                     intr_level, cfg)
        is_better = (energy <= best_energy) & (~done)
        best_energy = torch.where(is_better, energy, best_energy)
        best_R, best_t = sel(is_better, R, best_R), sel(is_better, t, best_t)
        best_iter = torch.where(is_better, torch.full_like(best_iter, itr), best_iter)
        best_vis = torch.where(is_better, vis_ratio, best_vis)
        best_eps, best_visible = sel(is_better, eps, best_eps), sel(is_better, visible,
                                                                    best_visible)
        if gn:
            psi = lm_psi(*_normal_equations(J, eps, wgt), lam, cfg.lm_trust_region)
            descent_new = descent
        else:
            g = (J * (wgt * eps)[..., None]).sum(-2)
            psi, descent_new = subgradient_step(R, t, g, descent, itr, cfg, precond)
        psi_norm = torch.linalg.vector_norm(psi, dim=-1)
        new_R, new_t = _update(R, t, psi, cfg)
        if gn:
            e_new = _project_and_sample(new_R, new_t, ref_sub, now, intr_level, cfg)[3]
            e_cur = (torch.sqrt((eps[:, ::stride] * eps[:, ::stride]).sum(-1)) if stride > 1
                     else energy)
            accept, worse = e_new < e_cur, e_new > e_cur
            newly_done = accept & (psi_norm < cfg.psi_norm_termination)
            do_update = (~done) & (~newly_done) & accept
            lam = torch.where(done, lam, _lambda(lam, accept, worse))
        else:
            newly_done = psi_norm < cfg.psi_norm_termination
            do_update = (~done) & (~newly_done)
        R, t = sel(do_update, new_R, R), sel(do_update, new_t, t)
        descent = sel(done, descent, descent_new)
        energies.append(torch.where(done, torch.zeros_like(energy), energy))
        Rs.append(R)
        ts.append(t)
        done = done | newly_done
    best_R = _rotationize(best_R, cfg)  # the reference re-rotationizes the returned best
    if jstride > 1:
        best_eps, _, best_visible, best_energy, best_vis = _project_and_sample(
            best_R, best_t, ref, now, intr_level, cfg)
    diag = LevelDiagnostics(torch.stack(energies, dim=-1), best_energy, best_iter, best_vis,
                            best_eps, best_visible, ref.count)
    if collect_trajectory:
        return best_R, best_t, diag, (torch.stack(Rs, dim=1), torch.stack(ts, dim=1))
    return best_R, best_t, diag


def _loop_deferred(ref, ref_jac, now, intr_level, R0, t0, cfg, n_iters):
    """Deferred-accept LM (JAX `_run_level_lm_deferred`, :625-772): each
    iteration's Jacobian pass is the verdict on the pending proposal; on
    reject the pose reverts to the backup and the step is recomputed from
    the backup's carried normal equations (JAX carries its (J, eps, wgt),
    used only through them) with raised lambda. The diagnostics are an
    all-point residual pass at the returned pose."""
    dev, dtype = R0.device, R0.dtype
    b = R0.shape[0]
    R, t, Rb, tb = R0, t0, R0, t0
    Hb = torch.zeros((b, 6, 6), dtype=dtype, device=dev)
    gb = torch.zeros((b, 6), dtype=dtype, device=dev)
    eb = torch.full((b,), float("inf"), dtype=dtype, device=dev)
    pending = torch.zeros((b,), dtype=torch.bool, device=dev)
    lam = torch.full((b,), cfg.lm_damping, dtype=dtype, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    best_energy = torch.full((b,), 1.0e10, dtype=dtype, device=dev)
    best_R, best_t = R0, t0
    best_iter = torch.full((b,), -1, dtype=torch.int32, device=dev)
    energies = []
    for itr in range(n_iters):
        J, eps, wgt, _, energy, _ = _jacobian_residual(R, t, ref_jac, now, intr_level, cfg)
        H, g = _normal_equations(J, eps, wgt)
        accept = (~pending) | (energy < eb)
        worse = pending & (energy > eb)
        lam = torch.where(done, lam, _lambda(lam, pending & accept, worse))
        R_cur, t_cur = sel(accept, R, Rb), sel(accept, t, tb)
        H_use, g_use = sel(accept, H, Hb), sel(accept, g, gb)
        e_use = torch.where(accept, energy, eb)
        is_better = (energy <= best_energy) & (~done)
        best_energy = torch.where(is_better, energy, best_energy)
        best_R, best_t = sel(is_better, R, best_R), sel(is_better, t, best_t)
        best_iter = torch.where(is_better, torch.full_like(best_iter, itr), best_iter)
        psi = lm_psi(H_use, g_use, lam, cfg.lm_trust_region)
        newly_done = accept & pending & (
            torch.linalg.vector_norm(psi, dim=-1) < cfg.psi_norm_termination)
        do_update = (~done) & (~newly_done)
        R_prop, t_prop = _update(R_cur, t_cur, psi, cfg)
        energies.append(torch.where(done, torch.zeros_like(energy), energy))
        R, t = sel(do_update, R_prop, R_cur), sel(do_update, t_prop, t_cur)
        Rb, tb = sel(do_update, R_cur, Rb), sel(do_update, t_cur, tb)
        Hb, gb = sel(do_update, H_use, Hb), sel(do_update, g_use, gb)
        eb = torch.where(do_update, e_use, eb)
        pending = torch.where(done | newly_done, torch.zeros_like(pending), do_update)
        done = done | newly_done
    best_R = _rotationize(best_R, cfg)
    eps_f, _, visible_f, energy_f, vis_f = _project_and_sample(best_R, best_t, ref, now,
                                                               intr_level, cfg)
    diag = LevelDiagnostics(torch.stack(energies, dim=-1), energy_f, best_iter, vis_f, eps_f,
                            visible_f, ref.count)
    return best_R, best_t, diag


def solve_pyramid(
    ref_levels: Tuple[RefLevel, ...],
    now_levels: Tuple[NowLevel, ...],
    intr: Intrinsics,
    cfg: SolverConfig,
    R0: torch.Tensor | None = None,
    t0: torch.Tensor | None = None,
):
    """Coarse-to-fine over all levels (coarsest first), each warm-starting
    the next, levels with no iteration skipped: one `level_lm_pyramid`
    launch (Gauss-Newton) or `level_sg_pyramid` launch (sub-gradient) for
    the whole pyramid, each level as `run_level` runs it, under every
    configuration. Returns (R (B,3,3), t (B,3), per-level diagnostics,
    finest first)."""
    check_config(cfg)
    pts = ref_levels[0].pts3d
    b, dev, dt = pts.shape[0], pts.device, pts.dtype
    R = torch.eye(3, dtype=dt, device=dev).expand(b, 3, 3) if R0 is None else R0
    t = torch.zeros((b, 3), dtype=dt, device=dev) if t0 is None else t0
    R, t = R.contiguous(), t.contiguous()
    order = []  # (level, iterations), coarsest first
    for level in range(len(ref_levels) - 1, -1, -1):
        n_iters = cfg.iterations[level] if level < len(cfg.iterations) else cfg.iterations[-1]
        if n_iters > 0:
            order.append((level, n_iters))
    if not order:
        return R, t, ()
    gn = cfg.method == "gauss_newton"
    levels = []
    for level, n_iters in order:
        ref, now, li = ref_levels[level], now_levels[level], intr.at_level(level)
        if gn:
            jstride, stride = level_strides(cfg, ref.pts3d.shape[1])
            img, grads = lm_planes(now, cfg)
            levels.append(LmLevel(ref.pts3d, ref.valid, ref.count, img, now.scale,
                                  *li, n_iters, jstride, stride, grads))
        else:
            levels.append(SgLevel(ref.pts3d, ref.valid, ref.count, now.dt, *li, n_iters))
    outs = (level_lm_pyramid if gn else level_sg_pyramid)(R, t, levels, cfg)
    diags = {level: _diagnostics(out, ref_levels[level].count)
             for (level, _), out in zip(order, outs)}
    return outs[-1].R, outs[-1].t, tuple(diags[level] for level in sorted(diags))


def pose_information(ref_level: RefLevel, now_level: NowLevel, intr_level: Intrinsics,
                     cfg: SolverConfig, R: torch.Tensor, t: torch.Tensor):
    """The 6x6 information matrix J^T W J (B,6,6) of the edge-alignment cost
    at poses (R (B,3,3), t (B,3)), the weighted residual variance sigma2 =
    sum(w eps^2) / sum(w) (B,) and the effective point count n_eff =
    sum(w) (B,), over all points of the level (JAX `pose_information`): the
    per-point terms of the solver's own Jacobian (`_jacobian_residual`, the
    level kernels' plain point terms under the configuration's semantics).
    Twist layout (translation, rotation)."""
    check_config(cfg)
    J, eps, wgt, *_ = _jacobian_residual(R, t, ref_level, now_level, intr_level, cfg)
    info = (J * wgt[..., None]).transpose(-1, -2) @ J
    n_eff = wgt.sum(-1)
    sigma2 = (wgt * eps * eps).sum(-1) / torch.clamp(n_eff, min=1e-6)
    return info, sigma2, n_eff


def pose_covariance(info, sigma2, n_eff=None, ridge: float = 1e-9) -> np.ndarray:
    """Covariance sigma^2 (J^T W J)^-1 from `pose_information` outputs of
    one pair (host float64), with the n/(n - 6) degrees-of-freedom
    correction when `n_eff` is given and a ridge for rank-deficient
    directions."""
    info = np.asarray(info, np.float64)
    scale = float(sigma2)
    if n_eff is not None:
        n = float(n_eff)
        scale *= n / max(n - 6.0, 1.0)
    return scale * np.linalg.inv(info + ridge * np.eye(6))


def align_pair(
    ref_gray_pyr: Tuple[torch.Tensor, ...],
    ref_depth_pyr: Tuple[torch.Tensor, ...],
    now_gray_pyr: Tuple[torch.Tensor, ...],
    intr: Intrinsics,
    cfg: SolverConfig,
    max_points: Tuple[int, ...] = (8192, 4096, 2048, 1024),
    R0: torch.Tensor | None = None,
    t0: torch.Tensor | None = None,
):
    """End-to-end for B frame pairs: per-level (B, H, W) pyramids ->
    relative poses (R (B,3,3), t (B,3)) + per-level diagnostics."""
    check_config(cfg)
    ref_levels = extract_ref_features(ref_gray_pyr, ref_depth_pyr, intr, cfg, max_points)
    now_levels = prepare_now_targets(now_gray_pyr, cfg)
    return solve_pyramid(ref_levels, now_levels, intr, cfg, R0, t0)
