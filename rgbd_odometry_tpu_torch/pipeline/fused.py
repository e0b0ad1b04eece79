"""Fused odometry: IMU-seeded edge DVO with a sparse-PnP fallback, port of
`rgbd_odometry_tpu/pipeline/fused.py` (BASELINE.json config 5, "ImuDeadReckon
init + edge DVO + SolvePnP fallback").

- Between frames an IMU window dead-reckons an inter-frame motion prior
  (`solvers/imu.propagate_batch`, one `imu_scan` launch on the card) that
  warm-starts the edge-DVO solve.
- Each solve's quality signals (the Laplacian b-hat and the visible ratio,
  the reference's own triggers, src/SolveDVO.cpp:2129-2152) gate a sparse
  fallback: Harris features matched against the current keyframe
  (`match_mutual`) and RANSAC PnP (`ransac_pnp`) replace the edge estimate
  for that frame.
- The trajectory and keyframe policy stay those of `EdgeDvoOdometry`.

`refine_trajectory_with_imu` polishes a trajectory with preintegrated IMU
edges in a pose graph (the windows of one length preintegrated in one
`imu_scan` launch). RANSAC draws come from `_uniforms`, a seeded
`torch.Generator` on the device, as in `pipeline/kf_matcher.py`; the JAX
package's threefry stream is not reproduced (tests replay it through
`_uniforms`). The host reads the fallback's two counts and the prior's
pose, as the JAX module does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import PipelineConfig
from rgbd_odometry_tpu_torch.ops import features as feat
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry
from rgbd_odometry_tpu_torch.solvers import imu as imu_mod
from rgbd_odometry_tpu_torch.solvers import pnp


@dataclass
class FusedConfig:
    # fallback triggers (reference constants, src/SolveDVO.cpp:21-23)
    laplacian_b_thresh: float = 3.0
    min_visible_ratio: float = 0.8
    max_keypoints: int = 512
    ransac_hypotheses: int = 64
    min_pnp_matches: int = 12
    use_imu_prior: bool = True


class FusedOdometry:
    """EdgeDvoOdometry + IMU prior + sparse-PnP fallback, on `device`
    (default: the current CUDA device; `device="cpu"` runs the plain
    versions)."""

    def __init__(self, config: PipelineConfig | None = None, fused: FusedConfig | None = None,
                 seed: int = 0, imu_intrinsics: imu_mod.ImuIntrinsics | None = None, device=None):
        self.odo = EdgeDvoOdometry(config, device=device)
        self.device = self.odo.device
        self.fcfg = fused or FusedConfig()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # the sensor's noise and bias model: it drives the preintegrated
        # covariance and so the IMU edges' weights in refine_with_imu (zero
        # noise, the default, suits ideal synthetic windows)
        self._imu_intr = imu_intrinsics or imu_mod.ImuIntrinsics.from_scalars(device=self.device)
        self._kf_kps: Optional[feat.Keypoints] = None
        self._kf_pts3d: Optional[torch.Tensor] = None
        self._kf_pts_valid: Optional[torch.Tensor] = None
        self.fallback_frames: List[int] = []
        self._prev_frame: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # frame n -> raw (accels, gyros, dt) window covering motion n-1 -> n,
        # kept for the optional post-run visual-inertial refinement
        self._imu_windows: dict = {}

    def _uniforms(self, s: int, k: int) -> torch.Tensor:
        """(s, k) float32 uniforms in [0, 1) for one RANSAC call."""
        return torch.rand((s, k), generator=self._gen, device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    # ------------------------------------------------------------------
    def _imu_prior(self, accels, gyros, dt):
        """The inter-frame IMU window integrated into a relative-motion prior
        (gravity-free: the odometry prior needs only the relative delta)."""
        st = imu_mod.ImuState.identity(device=self.device)
        final, _ = imu_mod.propagate_batch(st, self._tensor(accels), self._tensor(gyros),
                                           self._imu_intr, dt=dt, gravity=(0.0, 0.0, 0.0))
        R, t = imu_mod.pose_of(final)
        return R.cpu().numpy().astype(np.float64), t.cpu().numpy().astype(np.float64)

    def _refresh_kf_features(self, gray, depth_mm):
        """Keypoints of the new keyframe and their points at its depth
        (invalid below 100 mm)."""
        self._kf_kps, self._kf_pts3d, self._kf_pts_valid = feat.detect_describe_backproject(
            self._tensor(gray), self._tensor(depth_mm), self.odo.intr, self.fcfg.max_keypoints,
            100.0)

    def _pnp_fallback(self, gray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Sparse relative pose against the current keyframe (PnPOdometry's
        role), or None with too few matches or inliers."""
        if self._kf_kps is None:
            return None
        kn = feat.detect_and_describe(self._tensor(gray), self.fcfg.max_keypoints)
        m = feat.match(self._kf_kps, kn)
        obj = self._kf_pts3d[m.ref_idx]
        valid = m.good & self._kf_pts_valid[m.ref_idx] & kn.valid
        if int(valid.sum()) < self.fcfg.min_pnp_matches:
            return None
        imn = pnp.normalize_image_points(kn.uv, self.odo.intr)
        res = pnp.ransac_pnp(self._uniforms(self.fcfg.ransac_hypotheses, obj.shape[0]),
                             obj.contiguous(), imn.contiguous(), valid.contiguous())
        if int(res.num_inliers) < self.fcfg.min_pnp_matches:
            return None
        return res.R.cpu().numpy().astype(np.float64), res.t.cpu().numpy().astype(np.float64)

    # ------------------------------------------------------------------
    def process_frame(self, gray: np.ndarray, depth_mm: np.ndarray, timestamp: float = 0.0,
                      imu_window: Optional[Tuple[np.ndarray, np.ndarray, float]] = None):
        """One fused step; `imu_window` = (accels (T,3), gyros (T,3), dt).
        Returns the current global pose (R, t)."""
        prior = None
        if imu_window is not None and self.fcfg.use_imu_prior:
            prior = self._imu_prior(*imu_window)
        frame_is_first = self.odo._frame_num < 0
        last_ref_before = self.odo._last_ref_frame
        pose = self.odo.process_frame(gray, depth_mm, timestamp, pose_prior=prior)
        if imu_window is not None:
            self._imu_windows[self.odo._frame_num] = imu_window
        if frame_is_first:
            self._refresh_kf_features(gray, depth_mm)
            self._prev_frame = (gray, depth_mm)
            return pose
        if self.odo._last_ref_frame != last_ref_before:
            # keyframe switched: with rollback the new reference is frame n-1
            # (anchor the sparse features to the cached previous frame); with
            # the naive update the current frame is the reference
            if self.odo._last_ref_frame == self.odo._frame_num:
                kf_gray, kf_depth = gray, depth_mm
            else:
                kf_gray, kf_depth = (self._prev_frame if self._prev_frame is not None
                                     else (gray, depth_mm))
            self._refresh_kf_features(kf_gray, kf_depth)
            self._prev_frame = (gray, depth_mm)
            return pose
        self._prev_frame = (gray, depth_mm)
        m = self.odo.metrics[-1]
        bad = (m.b_cap > self.fcfg.laplacian_b_thresh
               or m.visible_ratio < self.fcfg.min_visible_ratio)
        if bad:
            fb = self._pnp_fallback(gray)
            if fb is not None:
                R, t = fb
                # the sparse estimate replaces the last trajectory entry
                self.odo._R = R
                self.odo._t = t
                gop = self.odo.gop
                el = gop.elements[-1]
                el.R, el.t = gop.last_key_R @ R, gop.last_key_t + gop.last_key_R @ t
                self.fallback_frames.append(m.frame_num)
                return gop.global_pose(-1)
        return pose

    def trajectory(self):
        return self.odo.trajectory()

    def refine_with_imu(self, gravity, velocities=None, imu_weight: float = 3.0,
                        iterations: int = 10, information_weighted: bool = True):
        """The recorded IMU windows as preintegrated pose-graph edges beside
        the visual chain (`refine_trajectory_with_imu`). `gravity` is
        required: real IMU windows embed it (`imu.DEFAULT_GRAVITY`), the
        synthetic windows of the `fused` command are gravity-free. Returns
        (R, t, stamps) of the refined trajectory."""
        R, t, stamps = self.trajectory()
        Rr, tr = refine_trajectory_with_imu(
            R, t, stamps, self._imu_windows, self._imu_intr, gravity=gravity,
            velocities=velocities, imu_weight=imu_weight, iterations=iterations,
            information_weighted=information_weighted, device=self.device)
        return Rr, tr, stamps


def refine_trajectory_with_imu(R: np.ndarray, t: np.ndarray, stamps: np.ndarray, windows: dict,
                               intr: imu_mod.ImuIntrinsics, gravity, velocities=None,
                               imu_weight: float = 3.0, iterations: int = 10,
                               information_weighted: bool = True, device=None):
    """Polish a visual trajectory (R (N,3,3), t (N,3), stamps (N,)) with
    preintegrated IMU edges: consecutive-frame odometry edges of the
    trajectory (zero residual: they encode its shape) plus one IMU edge a
    frame n in 1..N-1 with a window (frame n -> (accels, gyros, dt) covering
    n-1 -> n), solved as one pose graph on `device` (default: the current
    CUDA device). `gravity` is required (see
    `FusedOdometry.refine_with_imu`); `velocities` (N, 3) world-frame
    velocities, None for central differences of the trajectory itself.
    With `information_weighted` each IMU edge is whitened by its own
    preintegrated covariance (translation and rotation blocks normalized
    apart) and `imu_weight` scales the IMU block against the weight-1
    visual edges. Returns (R, t) refined, float64."""
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.solvers import pose_graph as pg

    dev = resolve_device(device)
    n = len(t)
    Rj = torch.as_tensor(np.asarray(R), dtype=torch.float32).to(dev)
    tj = torch.as_tensor(np.asarray(t), dtype=torch.float32).to(dev)
    dvo = pg.odometry_edges(Rj, tj, weight=1.0)
    frames = sorted(k for k in windows if 1 <= k < n)
    if not frames:
        return np.asarray(R, np.float64), np.asarray(t, np.float64)
    # the windows of one (length, dt) preintegrate in one launch
    groups: dict = {}
    for k in frames:
        a, _, d = windows[k]
        groups.setdefault((np.asarray(a).shape[0], float(d)), []).append(k)
    pres_by_frame: dict = {}
    for (_, d), ks in groups.items():
        A = torch.as_tensor(np.stack([np.asarray(windows[k][0]) for k in ks]),
                            dtype=torch.float32).to(dev)
        W = torch.as_tensor(np.stack([np.asarray(windows[k][1]) for k in ks]),
                            dtype=torch.float32).to(dev)
        batch = imu_mod.preintegrate(A, W, intr, dt=d)
        for idx, k in enumerate(ks):
            pres_by_frame[k] = imu_mod.Preintegrated(*(x[idx] for x in batch))
    pres = imu_mod.Preintegrated(*(torch.stack(xs) for xs in
                                   zip(*(pres_by_frame[k] for k in frames))))
    idx_j = torch.as_tensor(frames, dtype=torch.int64, device=dev)
    idx_i = idx_j - 1
    if velocities is None:
        v_i = imu_mod.velocities_from_trajectory(
            tj, torch.as_tensor(np.asarray(stamps), dtype=torch.float32).to(dev))[idx_i]
    else:
        v_i = torch.as_tensor(np.asarray(velocities), dtype=torch.float32).to(dev)[idx_i]
    imu_edges = imu_mod.imu_relative_pose_edges(idx_i, idx_j, Rj[idx_i], v_i, pres,
                                                gravity=gravity, weight=imu_weight)
    if information_weighted:
        info = imu_mod.preintegrated_pose_information(pres)
        # translation and rotation information differ by ~1e7 for a quiet
        # gyro: one scale would zero the translation constraints
        imu_edges = imu_edges._replace(
            sqrt_info=pg.normalized_information_sqrt(info, block_normalize=True))
    edges = pg.concat_edges(dvo, imu_edges)
    Rr, tr, _ = pg.refine_pose_graph(Rj, tj, edges, iterations=iterations)
    return Rr.cpu().numpy().astype(np.float64), tr.cpu().numpy().astype(np.float64)
