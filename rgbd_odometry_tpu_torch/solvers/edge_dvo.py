"""The edge-alignment DVO solver: port of
`rgbd_odometry_tpu/solvers/edge_dvo.py`.

Reference-keyframe edge points are aligned coarse-to-fine against the
distance transform of the current frame's edge map. Every function takes a
leading batch dimension of frame pairs where the JAX version is `vmap`ped.
Three level solvers are ported:

* deferred-accept Levenberg-Marquardt (`profiles.production_320`);
* standard LM with an accept/reject residual pass per iteration (the
  `dvo` command's defaults), optionally on a 0-255 normalized DT;
* the reference's damped, projected sub-gradient method (`profiles.
  parity_320`, `SolverConfig()`): momentum, preconditioner, L2 pull on the
  normalized log-pose, floor gathers of a float32 DT, the "reference"
  Jacobian.

The hot loops run through the hand-written CUDA kernels on a CUDA tensor:
a frame's edge maps are one `canny_pyramid` call over all levels
(`kernels/canny.py`, hysteresis fixpoints on the device), then per level
one `dt_channels` call (`kernels/edt.py`: EDT, sqrt, normalization,
gradients, channels); a keyframe's edge points of every level in one
launch (`kernels/extract.py`: selection and back-projection, whose plain
version is `extract_ref_level`); a whole Gauss-Newton level, both LM loops
and the all-point diagnostics, in one launch (`kernels/level_lm.py`); a
whole sub-gradient level in one launch (`kernels/level_sg.py`). Configurations
outside these raise `NotImplementedError` naming the ROADMAP item that will
port them (`check_config`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import SolverConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.kernels.canny import canny, canny_pyramid
from rgbd_odometry_tpu_torch.kernels.edt import dt_channels
from rgbd_odometry_tpu_torch.kernels.extract import RefLevel, extract_pyramid
from rgbd_odometry_tpu_torch.kernels.fused_iter import jacobian_terms
from rgbd_odometry_tpu_torch.kernels.level_lm import level_lm
from rgbd_odometry_tpu_torch.kernels.level_sg import level_sg
from rgbd_odometry_tpu_torch.kernels.level_sg import subgradient_step as _subgradient_step  # noqa: F401
from rgbd_odometry_tpu_torch.kernels.sg_terms import reference_jacobian_terms

_PARITY = "ROADMAP.md Queue 1, item 5 'reference-parity mode'"


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
    """Raise NotImplementedError for a configuration outside the semantics
    this package ports. Accepted: `method` gauss_newton (bilinear bf16
    gathers with interpolant gradients, textbook Jacobian) or subgradient
    (floor gathers of a float32 DT, "reference" Jacobian; `gather_mode`
    "mxu" and "take" are both floor semantics, bit-equal), deferred or
    standard LM, `normalize_dt` either way. (`fuse_level_canny` and
    `edt_backend` select between bit-identical JAX implementations; the
    port has one implementation for either value.)"""
    gn = cfg.method == "gauss_newton"
    jac = cfg.jacobian_mode if cfg.jacobian_mode != "auto" else ("true" if gn else "reference")
    unsupported = [
        (cfg.method not in ("gauss_newton", "subgradient"), f"method={cfg.method!r}"),
        (cfg.interpolate_dt, "interpolate_dt=True"),
        (jac != ("true" if gn else "reference"),
         f"jacobian_mode={cfg.jacobian_mode!r} with method={cfg.method!r}"),
        (gn and cfg.gather_mode != "mxu", f"gather_mode={cfg.gather_mode!r} for gauss_newton"),
        (not gn and cfg.gather_mode not in ("mxu", "take"), f"gather_mode={cfg.gather_mode!r}"),
        (gn and cfg.gn_gradient_mode != "interpolant",
         f"gn_gradient_mode={cfg.gn_gradient_mode!r}"),
        (gn and cfg.gather_dtype != "bfloat16", f"gather_dtype={cfg.gather_dtype!r} for gauss_newton"),
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
    gn_bf16 = cfg.method == "gauss_newton" and cfg.gather_dtype == "bfloat16"
    dt, dgx, dgy, scale, chans = dt_channels(
        edges, int(cfg.edt_window), bool(cfg.normalize_dt), gn_bf16
    )
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
    """The pyramid's edge maps (`_pyramid_edges`), then `prepare_now_level`
    on each level's."""
    edges = _pyramid_edges(gray_pyr, cfg)
    return tuple(prepare_now_level(g, cfg, edges=e) for g, e in zip(gray_pyr, edges))


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
    """One pyramid level (JAX `run_level`, :421-622). Gauss-Newton runs
    the whole level in one `level_lm` launch (deferred or standard LM): it
    forms the normal equations on every Nth point, N = jstride = max(1,
    min(lm_jacobian_stride, K // 512)) (:467); when N == 1 the standard LM
    tests proposals on every Mth point, M = max(1, min(lm_proposal_stride,
    K // 512)), else on the Jacobian's own subset. With a stride-1 standard
    LM the diagnostics are the level's own at the best iterate; otherwise
    the launch's all-point pass at the returned pose (JAX
    `_project_and_sample`, :593-609, :758-771). A sub-gradient level
    is one `level_sg` launch over every point, with the diagnostics of its
    best iterate. Returns (R (B,3,3), t (B,3), LevelDiagnostics)."""
    check_config(cfg)
    if collect_trajectory:
        raise NotImplementedError(
            f"collect_trajectory is not ported to rgbd_odometry_tpu_torch yet; see {_PARITY}"
        )
    if cfg.method != "gauss_newton":
        out = level_sg(R0, t0, ref.pts3d, ref.valid, ref.count, now.dt, *intr_level, cfg, n_iters)
        diag = LevelDiagnostics(
            energy=out.energy, best_energy=out.best_energy, best_iter=out.best_iter,
            visible_ratio=out.visible_ratio, final_epsilons=out.eps, final_valid=out.visible,
            num_points=ref.count,
        )
        return out.R, out.t, diag
    jstride, stride = level_strides(cfg, ref.pts3d.shape[1])
    out = level_lm(R0, t0, ref.pts3d, ref.valid, ref.count, now.chans[:, 0], now.scale,
                   *intr_level, cfg, n_iters, jstride, stride)
    diag = LevelDiagnostics(
        energy=out.energy, best_energy=out.final_energy, best_iter=out.best_iter,
        visible_ratio=out.visible_ratio, final_epsilons=out.eps, final_valid=out.visible,
        num_points=ref.count,
    )
    return out.R, out.t, diag


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


def pose_information(ref_level: RefLevel, now_level: NowLevel, intr_level: Intrinsics,
                     cfg: SolverConfig, R: torch.Tensor, t: torch.Tensor):
    """The 6x6 information matrix J^T W J (B,6,6) of the edge-alignment cost
    at poses (R (B,3,3), t (B,3)), the weighted residual variance sigma2 =
    sum(w eps^2) / sum(w) (B,) and the effective point count n_eff =
    sum(w) (B,), over all points of the level (JAX `pose_information`): the
    per-point terms of the solver's own Jacobian, bilinear on the bf16 DT
    channel for Gauss-Newton, floor gathers with the "reference" Jacobian
    for the sub-gradient. Twist layout (translation, rotation)."""
    check_config(cfg)
    if cfg.method == "gauss_newton":
        J, eps, wgt, _ = jacobian_terms(R, t, ref_level.pts3d, ref_level.valid,
                                        now_level.chans[:, 0], *intr_level,
                                        cfg.gn_weight_sigma2_px, now_level.scale)
    else:
        J, eps, wgt, _ = reference_jacobian_terms(R, t, ref_level.pts3d, ref_level.valid,
                                                  now_level.dt, *intr_level, cfg.weight_sigma2)
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
