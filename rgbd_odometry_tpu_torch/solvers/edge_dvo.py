"""The edge-alignment DVO solver on the production path: port of
`rgbd_odometry_tpu/solvers/edge_dvo.py`.

Reference-keyframe edge points are aligned coarse-to-fine against the
distance transform of the current frame's edge map with deferred-accept
Levenberg-Marquardt. Every function takes a leading batch dimension of frame
pairs where the JAX version is `vmap`ped. The two hot loops run through the
hand-written CUDA kernels on a CUDA tensor: the EDT (`kernels/edt.py`) in
`prepare_now_level`, and the per-iteration normal equations
(`kernels/fused_iter.py`) in `_run_level_lm_deferred`.

Only the production semantics are ported (`profiles.production_320`):
Gauss-Newton with deferred-accept LM, pixel-unit DT, interpolant gradients,
textbook Jacobian, bf16 DT channel, Newton-Schulz re-orthogonalization. Any
other configuration raises `NotImplementedError` naming the ROADMAP item
that will port it (`check_config`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rgbd_odometry_tpu.config import SolverConfig
from rgbd_odometry_tpu_torch.core import geometry as geo
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.kernels.edt import edt_squared
from rgbd_odometry_tpu_torch.kernels.fused_iter import fused_gn_terms, project_points
from rgbd_odometry_tpu_torch.ops.canny import canny
from rgbd_odometry_tpu_torch.ops.gradient import central_gradient
from rgbd_odometry_tpu_torch.ops.interp import sample_bilinear_value_grad
from rgbd_odometry_tpu_torch.ops.linalg6 import chol_solve6

_PARITY = "ROADMAP.md Queue 1, 'reference-parity mode'"


class RefLevel(NamedTuple):
    """Fixed-capacity edge-point set of the reference keyframe at one level."""

    pts3d: torch.Tensor  # (B, K, 3) metres, camera frame
    uv: torch.Tensor  # (B, K, 2) pixel coords at this level
    valid: torch.Tensor  # (B, K) bool
    count: torch.Tensor  # (B,) int32 number of tracked points


class NowLevel(NamedTuple):
    """Distance-transform target of the current frame at one level."""

    dt: torch.Tensor  # (B, H, W) float32, pixel units
    dgx: torch.Tensor  # (B, H, W)
    dgy: torch.Tensor  # (B, H, W)
    edges: torch.Tensor  # (B, H, W) bool
    scale: torch.Tensor  # (B,) DT units per pixel (1.0: not normalized)
    chans: torch.Tensor  # (B, 3, H, W) bfloat16 stacked [dt, dgx, dgy]


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
    """Raise NotImplementedError for a configuration outside the production
    semantics this package ports. (`fuse_level_canny` and `edt_backend`
    select between bit-identical implementations and are accepted.)"""
    unsupported = [
        (cfg.method != "gauss_newton", f"method={cfg.method!r}"),
        (not cfg.lm_deferred_accept, "lm_deferred_accept=False (standard LM)"),
        (cfg.normalize_dt, "normalize_dt=True"),
        (cfg.jacobian_mode == "reference", "jacobian_mode='reference'"),
        (cfg.gather_mode != "mxu", f"gather_mode={cfg.gather_mode!r}"),
        (cfg.gn_gradient_mode != "interpolant", f"gn_gradient_mode={cfg.gn_gradient_mode!r}"),
        (cfg.gather_dtype != "bfloat16", f"gather_dtype={cfg.gather_dtype!r}"),
        (cfg.rotationize and cfg.rotationize_method != "newton",
         f"rotationize_method={cfg.rotationize_method!r}"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to rgbd_odometry_tpu_torch yet; see {_PARITY}"
            )


# --------------------------------------------------------------------------
# Reference keyframe features and now-frame DT targets
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _priority(n: int, device: str) -> torch.Tensor:
    """The fixed pseudo-random extraction priority of an n-pixel level:
    the JAX package's `np.random.default_rng(n)` permutation, computed once
    per (shape, device) on the host and uploaded once."""
    pri = (np.random.default_rng(n).permutation(n).astype(np.float32) + 0.5) / n
    return torch.from_numpy(pri.astype(np.float32)).to(device)


def extract_ref_level(
    gray: torch.Tensor,
    depth_mm: torch.Tensor,
    intr_level: Intrinsics,
    k_max: int,
    cfg: SolverConfig,
    edges: torch.Tensor | None = None,
) -> RefLevel:
    """Edge-point selection + back-projection at one level, (B, H, W) in.

    Top-k of (edge & depth > min) + priority: the exact branch is one top-k
    over all pixels; the segmented branch (production) takes the top 32 of
    every 256-pixel segment, then the top k of the candidates, and is used
    only when H*W >= 8k. `count` follows the JAX semantics of each branch.
    """
    if edges is None:
        edges = canny(gray, cfg.canny_low, cfg.canny_high)
    mask = edges & (depth_mm > cfg.min_depth_mm)
    b, h, w = mask.shape
    n = h * w
    flat = mask.reshape(b, n)
    k = min(k_max, n)
    flat_score = flat.to(torch.float32) + _priority(n, str(mask.device))
    if cfg.extract_selection == "segmented" and n >= 8 * k:
        seg_len = 256
        s = -(-n // seg_len)
        sc = F.pad(flat_score, (0, s * seg_len - n))
        v, i = torch.topk(sc.reshape(b, s, seg_len), 32, dim=-1)
        base = torch.arange(s, device=mask.device)[:, None] * seg_len
        gi = (base + i).reshape(b, -1)
        score, sel = torch.topk(v.reshape(b, -1), k, dim=-1)
        idx = torch.clamp(torch.gather(gi, 1, sel), max=n - 1)
        valid = score > 1.0
        count = valid.sum(-1, dtype=torch.int32)
    else:
        score, idx = torch.topk(flat_score, k, dim=-1)
        valid = score > 1.0
        count = torch.clamp(flat.sum(-1, dtype=torch.int32), max=k)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    z_raw = torch.gather(depth_mm.reshape(b, n), 1, idx)
    z = torch.where(valid, z_raw, torch.zeros_like(z_raw)) / 1000.0
    x3 = z * (xs - intr_level.cx) / intr_level.fx
    y3 = z * (ys - intr_level.cy) / intr_level.fy
    pts3d = torch.stack([x3, y3, z], dim=-1)
    uv = torch.stack([xs, ys], dim=-1)
    return RefLevel(pts3d=pts3d, uv=uv, valid=valid, count=count)


def prepare_now_level(
    gray: torch.Tensor, cfg: SolverConfig, edges: torch.Tensor | None = None
) -> NowLevel:
    """Edge map -> squared EDT (kernel 1; +-cfg.edt_window, or the full row
    when 0) -> sqrt -> central gradients -> bf16 channels, (B, H, W) in."""
    check_config(cfg)
    if edges is None:
        edges = canny(gray, cfg.canny_low, cfg.canny_high)
    # sqrt in float64, rounded once to float32: the correctly rounded
    # float32 sqrt that XLA computes (torch's vectorized CPU float32 sqrt is
    # not always correctly rounded, which would break exactness with JAX)
    d2 = edt_squared(edges, int(cfg.edt_window))
    dt = torch.sqrt(d2.to(torch.float64)).to(torch.float32)
    dgx, dgy = central_gradient(dt)
    chans = torch.stack([dt, dgx, dgy], dim=1).to(torch.bfloat16)
    scale = torch.ones(dt.shape[0], dtype=dt.dtype, device=dt.device)
    return NowLevel(dt=dt, dgx=dgx, dgy=dgy, edges=edges, scale=scale, chans=chans)


def extract_ref_features(
    gray_pyr: Tuple[torch.Tensor, ...],
    depth_pyr: Tuple[torch.Tensor, ...],
    intr: Intrinsics,
    cfg: SolverConfig,
    max_points: Tuple[int, ...],
    edges_pyr: Tuple[torch.Tensor, ...] | None = None,
) -> Tuple[RefLevel, ...]:
    """`extract_ref_level` over all levels; ``edges_pyr`` (a keyframe's own
    `NowLevel.edges`) skips Canny with bit-identical features."""
    if edges_pyr is None:
        edges_pyr = tuple(canny(g, cfg.canny_low, cfg.canny_high) for g in gray_pyr)
    return tuple(
        extract_ref_level(g, d, intr.at_level(lvl), max_points[lvl], cfg, edges=e)
        for lvl, (g, d, e) in enumerate(zip(gray_pyr, depth_pyr, edges_pyr))
    )


def prepare_now_targets(
    gray_pyr: Tuple[torch.Tensor, ...], cfg: SolverConfig
) -> Tuple[NowLevel, ...]:
    """`prepare_now_level` over all levels."""
    return tuple(prepare_now_level(g, cfg) for g in gray_pyr)


# --------------------------------------------------------------------------
# Level solve
# --------------------------------------------------------------------------


def _project_and_sample(R, t, ref: RefLevel, now: NowLevel, intr: Intrinsics):
    """All-point residual pass at one pose: (eps, visible, energy, vis_ratio).
    The diagnostics of a level at its returned pose (plain PyTorch; a
    kernel in a later PR)."""
    h, w = now.dt.shape[-2:]
    *_, u, v, visible = project_points(
        R, t, ref.pts3d, ref.valid, h, w, intr.fx, intr.fy, intr.cx, intr.cy
    )
    val, _, _ = sample_bilinear_value_grad(now.chans[:, 0], u, v)
    eps = torch.where(visible, val, torch.zeros_like(val))
    energy = torch.sqrt((eps * eps).sum(-1))
    n_valid = torch.clamp(ref.count, min=1).to(eps.dtype)
    vis_ratio = visible.sum(-1).to(eps.dtype) / n_valid
    return eps, visible, energy, vis_ratio


def _strided(r: RefLevel, s: int) -> RefLevel:
    return RefLevel(
        pts3d=r.pts3d[:, ::s].contiguous(),
        uv=r.uv[:, ::s],
        valid=r.valid[:, ::s].contiguous(),
        count=torch.clamp(r.count // s, min=1),
    )


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-pair (B,) mask broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _run_level_lm_deferred(
    ref: RefLevel,
    ref_jac: RefLevel,
    now: NowLevel,
    intr_level: Intrinsics,
    R0: torch.Tensor,
    t0: torch.Tensor,
    cfg: SolverConfig,
    n_iters: int,
):
    """Deferred-accept Levenberg-Marquardt level solve (JAX `:625-772`).

    Each iteration is one pass of kernel 2 over the strided point set at the
    current pose; its energy is the verdict on the pending proposal. On
    reject the pose reverts to the backup and the step is recomputed from
    the backup's carried (H, g, energy) with raised lambda — the same math
    as the JAX carry of per-point (J, eps, wgt), which the body uses only
    through H and g. The best iterate over evaluated poses is returned, with
    all-point diagnostics at that pose.
    """
    dev, dt = R0.device, R0.dtype
    b = R0.shape[0]
    img = now.chans[:, 0]
    f = (intr_level.fx, intr_level.fy, intr_level.cx, intr_level.cy)
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
        H, g, energy, _ = fused_gn_terms(
            R, t, ref_jac.pts3d, ref_jac.valid, img, *f, cfg.gn_weight_sigma2_px
        )
        accept = (~pending) | (energy < eb)
        worse = pending & (energy > eb)
        lam = torch.where(done, lam, torch.where(
            pending & accept, torch.clamp(lam / 3.0, min=1e-8),
            torch.where(worse, torch.clamp(lam * 4.0, max=1e6), lam),
        ))
        R_cur, t_cur = _sel(accept, R, Rb), _sel(accept, t, tb)
        H_use, g_use = _sel(accept, H, Hb), _sel(accept, g, gb)
        e_use = torch.where(accept, energy, eb)

        is_better = (energy <= best_energy) & (~done)
        best_energy = torch.where(is_better, energy, best_energy)
        best_R, best_t = _sel(is_better, R, best_R), _sel(is_better, t, best_t)
        best_iter = torch.where(is_better, torch.full_like(best_iter, itr), best_iter)

        damp = torch.diag_embed(torch.clamp(torch.diagonal(H_use, dim1=-2, dim2=-1), min=1e-8))
        psi = -chol_solve6(H_use + lam[:, None, None] * damp, g_use)
        norm = torch.linalg.vector_norm(psi, dim=-1)
        tr = cfg.lm_trust_region
        scale = torch.where(norm > tr, tr / torch.clamp(norm, min=1e-30), torch.ones_like(norm))
        psi = psi * scale[:, None]
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
        R, t = _sel(do_update, R_prop, R_cur), _sel(do_update, t_prop, t_cur)
        Rb, tb = _sel(do_update, R_cur, Rb), _sel(do_update, t_cur, tb)
        Hb, gb = _sel(do_update, H_use, Hb), _sel(do_update, g_use, gb)
        eb = torch.where(do_update, e_use, eb)
        pending = torch.where(done | newly_done, torch.zeros_like(pending), do_update)
        done = done | newly_done

    if cfg.rotationize:
        best_R = geo.rotationize_newton(best_R)
    eps_f, visible_f, energy_f, vis_f = _project_and_sample(best_R, best_t, ref, now, intr_level)
    diag = LevelDiagnostics(
        energy=torch.stack(energies, dim=-1),
        best_energy=energy_f,
        best_iter=best_iter,
        visible_ratio=vis_f,
        final_epsilons=eps_f,
        final_valid=visible_f,
        num_points=ref.count,
    )
    return best_R.contiguous(), best_t.contiguous(), diag


def run_level(
    ref: RefLevel,
    now: NowLevel,
    intr_level: Intrinsics,
    R0: torch.Tensor,
    t0: torch.Tensor,
    cfg: SolverConfig,
    n_iters: int,
):
    """One pyramid level. The normal equations use every Nth point,
    N = max(1, min(lm_jacobian_stride, K // 512)) (JAX `:467`): at the
    production capacities that is K = 512 points per iteration at every
    level."""
    check_config(cfg)
    cap = ref.pts3d.shape[1]
    jstride = max(1, min(int(cfg.lm_jacobian_stride), cap // 512))
    ref_jac = _strided(ref, jstride) if jstride > 1 else ref
    return _run_level_lm_deferred(ref, ref_jac, now, intr_level, R0, t0, cfg, n_iters)


def solve_pyramid(
    ref_levels: Tuple[RefLevel, ...],
    now_levels: Tuple[NowLevel, ...],
    intr: Intrinsics,
    cfg: SolverConfig,
    R0: torch.Tensor | None = None,
    t0: torch.Tensor | None = None,
):
    """Coarse-to-fine over all levels (coarsest first), each warm-starting
    the next. Returns (R (B,3,3), t (B,3), per-level diagnostics, finest
    first)."""
    pts = ref_levels[0].pts3d
    b, dev, dt = pts.shape[0], pts.device, pts.dtype
    R = torch.eye(3, dtype=dt, device=dev).expand(b, 3, 3) if R0 is None else R0
    t = torch.zeros((b, 3), dtype=dt, device=dev) if t0 is None else t0
    R, t = R.contiguous(), t.contiguous()
    diags = [None] * len(ref_levels)
    for level in range(len(ref_levels) - 1, -1, -1):
        n_iters = cfg.iterations[level] if level < len(cfg.iterations) else cfg.iterations[-1]
        if n_iters <= 0:
            continue
        R, t, diags[level] = run_level(
            ref_levels[level], now_levels[level], intr.at_level(level), R, t, cfg, n_iters
        )
    return R, t, tuple(d for d in diags if d is not None)


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
