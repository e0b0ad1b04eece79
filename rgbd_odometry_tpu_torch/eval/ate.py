"""Trajectory evaluation: drift statistics, ATE, RPE. The port's own copy of
`rgbd_odometry_tpu/eval/ate.py`, numpy only.

Rebuilds the reference's ground-truth comparison tooling:
  * per-frame drift vs GT with mean/median/RMS normalized per second
    (`getDriftFromPose` / `analyzeDriftVector`,
    reference src/SolveDVO.cpp:1371-1390 — normalization ÷ (n/30) at
    :1383-1388),
  * the TUM-tooling ATE/RPE metrics the reference exports trajectories for
    (est/gt pose files, reference include/SolveDVO.h:84-86).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class DriftStats:
    mean: float
    median: float
    rms: float


def drift_stats(
    est_t: np.ndarray,
    gt_t: np.ndarray,
    fps: float = 30.0,
    duration_s: float | None = None,
) -> DriftStats:
    """Per-frame positional drift vs GT, normalized per second of trajectory
    (reference divides by v.size()/30.0, src/SolveDVO.cpp:1383-1388).

    Pass `duration_s` (e.g. from real frame timestamps) to normalize by the
    actual elapsed time instead of the reference's 30 fps assumption."""
    n = min(len(est_t), len(gt_t))
    d = np.linalg.norm(est_t[:n] - gt_t[:n], axis=-1)
    dur = max(duration_s if duration_s is not None else n / fps, 1e-9)
    return DriftStats(
        mean=float(d.mean() / dur),
        median=float(np.median(d) / dur),
        rms=float(np.sqrt((d**2).mean()) / dur),
    )


def align_umeyama(est_t: np.ndarray, gt_t: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) alignment est -> gt
    (Horn/Umeyama) — the alignment step of the TUM ATE tool."""
    mu_e = est_t.mean(0)
    mu_g = gt_t.mean(0)
    xe = est_t - mu_e
    xg = gt_t - mu_g
    cov = xg.T @ xe / len(est_t)
    U, S, Vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        sgn[2, 2] = -1.0
    R = U @ sgn @ Vt
    if with_scale:
        var_e = (xe**2).sum() / len(est_t)
        s = float(np.trace(np.diag(S) @ sgn) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE (TUM definition) over positions."""
    n = min(len(est_t), len(gt_t))
    est = np.asarray(est_t[:n], np.float64)
    gt = np.asarray(gt_t[:n], np.float64)
    if align and n >= 3:
        s, R, t = align_umeyama(est, gt)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(((est - gt) ** 2).sum(-1).mean()))


def rpe(
    est_R: np.ndarray,
    est_t: np.ndarray,
    gt_R: np.ndarray,
    gt_t: np.ndarray,
    delta: int = 1,
) -> Tuple[float, float]:
    """Relative pose error over `delta`-frame intervals (TUM definition).

    Returns (translational RMSE [m], rotational RMSE [rad]).
    """
    n = min(len(est_t), len(gt_t))
    terrs, rerrs = [], []
    for i in range(n - delta):
        # relative motions
        dR_e = est_R[i].T @ est_R[i + delta]
        dt_e = est_R[i].T @ (est_t[i + delta] - est_t[i])
        dR_g = gt_R[i].T @ gt_R[i + delta]
        dt_g = gt_R[i].T @ (gt_t[i + delta] - gt_t[i])
        E_R = dR_g.T @ dR_e
        E_t = dt_e - dt_g  # after rotating into frame i; standard approx
        terrs.append(np.linalg.norm(E_t))
        ang = np.arccos(np.clip((np.trace(E_R) - 1) / 2, -1.0, 1.0))
        rerrs.append(ang)
    if not terrs:
        return 0.0, 0.0
    return (
        float(np.sqrt(np.mean(np.square(terrs)))),
        float(np.sqrt(np.mean(np.square(rerrs)))),
    )


def associate_trajectories(
    est_R: np.ndarray,
    est_t: np.ndarray,
    est_ts: np.ndarray,
    gt_R: np.ndarray,
    gt_t: np.ndarray,
    gt_ts: np.ndarray,
    max_dt: float = 0.02,
    rebase: bool = True,
):
    """Pair estimate and ground-truth poses by nearest timestamp.

    TUM groundtruth.txt is ~100 Hz mocap while frames arrive at ~30 Hz;
    index-by-index comparison pairs wrong poses. This applies the TUM
    associate.py greedy nearest-neighbour matching (io.tum.associate), then
    optionally rebases both matched sub-trajectories to their first pose
    (the reference registers GT against the first frame,
    reference src/SolveDVO.cpp:1983-2014).

    Returns (est_R, est_t, gt_R, gt_t, duration_s) over matched pairs, or
    None when nothing associates within `max_dt`.
    """
    from rgbd_odometry_tpu_torch.io.tum import associate

    pairs = associate(np.asarray(est_ts, np.float64), np.asarray(gt_ts, np.float64), max_dt)
    if not pairs:
        return None
    ie = np.asarray([i for i, _ in pairs])
    ig = np.asarray([j for _, j in pairs])
    R_e, t_e = est_R[ie], est_t[ie]
    R_g, t_g = gt_R[ig], gt_t[ig]
    if rebase:
        R_e, t_e = rebase_to_first(R_e, t_e)
        R_g, t_g = rebase_to_first(R_g, t_g)
    duration = float(np.asarray(est_ts)[ie[-1]] - np.asarray(est_ts)[ie[0]])
    return R_e, t_e, R_g, t_g, duration


def rebase_to_first(R: np.ndarray, t: np.ndarray):
    """Rebase a trajectory so the first pose is identity — the reference's GT
    registration against the first frame (reference src/SolveDVO.cpp:
    1983-2014; loadGTPath.cpp:125-143)."""
    R0, t0 = R[0], t[0]
    R_out = np.einsum("ij,tjk->tik", R0.T, R)
    t_out = np.einsum("ij,tj->ti", R0.T, t - t0)
    return R_out, t_out
