"""Sparse feature visual odometry (the reference's `PnPOdometry` node), port of
`rgbd_odometry_tpu/pipeline/feature_vo.py`.

Reference flow (src/PnPOdometry.cpp): detect and describe on the keyframe
and the current frame, match, filter the matches by an epipolar RANSAC
(`ransacTest`, :463, :500-535), back-project the keyframe's keypoints at
their depth (`evalRef3dPoints`, :412-428), RANSAC PnP with the previous
pose as the initial guess (:571), keyframe switch when the good matches
fall below the threshold (:89-102), global pose = keyframe o relative
(:154-168). Here: Harris + patch descriptors and mutual matching
(`ops/features`, `match_mutual` on the card), the 8-point fundamental
RANSAC (`ops/epipolar`) and RANSAC PnP (`ransac_pnp` on the card); the host
reads the good-match count and the pose of every frame, as the JAX module
does. RANSAC draws come from `_uniforms`, a seeded `torch.Generator` on
the device (tests replay JAX's draws through it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import CameraConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics, backproject_points
from rgbd_odometry_tpu_torch.device import resolve_device
from rgbd_odometry_tpu_torch.ops import features as feat
from rgbd_odometry_tpu_torch.ops.epipolar import ransac_fundamental_filter
from rgbd_odometry_tpu_torch.pipeline.gop import Gop, REASON_FIRST_FRAME, REASON_TOO_FEW_REPROJECTIONS
from rgbd_odometry_tpu_torch.solvers import pnp


@dataclass
class FeatureVoConfig:
    max_keypoints: int = 512
    min_good_matches: int = 70  # keyframe-switch threshold (PnPOdometry.cpp:89)
    ransac_hypotheses: int = 64
    inlier_thresh: float = 0.01
    min_depth_mm: float = 100.0
    # epipolar match filter (ransacTest, PnPOdometry.cpp:463, 500-535): an
    # F-matrix RANSAC over the descriptor matches before PnP, 3 px
    epipolar_filter: bool = True
    epipolar_threshold_px: float = 3.0
    epipolar_hypotheses: int = 64


@dataclass
class FeatureVo:
    """Streaming sparse VO over (gray, depth) frames on `device` (default:
    the current CUDA device; "cpu" runs the plain versions)."""

    camera: CameraConfig
    config: FeatureVoConfig = field(default_factory=FeatureVoConfig)
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        self.intr = Intrinsics.from_config(self.camera)
        self.device = resolve_device(self.device)
        self.gop = Gop()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self._ref: Optional[feat.Keypoints] = None
        self._ref_pts3d: Optional[torch.Tensor] = None
        self._ref_pts_valid: Optional[torch.Tensor] = None
        self._frame = -1
        self._R = np.eye(3)
        self._t = np.zeros(3)
        self.match_counts: List[int] = []

    def _uniforms(self, s: int, k: int) -> torch.Tensor:
        """(s, k) float32 uniforms in [0, 1) for one RANSAC call."""
        return torch.rand((s, k), generator=self._gen, device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(self.device)

    # ------------------------------------------------------------------
    def _backproject_ref(self, kps: feat.Keypoints, depth_mm: torch.Tensor):
        """`evalRef3dPoints` (PnPOdometry.cpp:412-428): each keyframe
        keypoint at its depth, invalid below `min_depth_mm`."""
        h, w = depth_mm.shape
        ui = torch.clamp(kps.uv[:, 0].long(), 0, w - 1)
        vi = torch.clamp(kps.uv[:, 1].long(), 0, h - 1)
        z_mm = depth_mm.reshape(-1)[vi * w + ui]
        valid = kps.valid & (z_mm > self.config.min_depth_mm)
        return backproject_points(kps.uv, z_mm, self.intr), valid

    def _set_ref(self, gray: torch.Tensor, depth_mm: torch.Tensor):
        self._ref = feat.detect_and_describe(gray, self.config.max_keypoints)
        self._ref_pts3d, self._ref_pts_valid = self._backproject_ref(self._ref, depth_mm)
        self._R = np.eye(3)
        self._t = np.zeros(3)

    # ------------------------------------------------------------------
    def process_frame(self, gray: np.ndarray, depth_mm: np.ndarray, timestamp: float = 0.0):
        """Feed one frame; returns the current global pose (R, t)."""
        self._frame += 1
        g, d = self._tensor(gray), self._tensor(depth_mm)
        if self._frame == 0:
            self._set_ref(g, d)
            self.gop.push_keyframe(0, REASON_FIRST_FRAME, np.eye(3), np.zeros(3), timestamp)
            self.match_counts.append(int(self._ref.count))
            return self.gop.global_pose(0)

        now = feat.detect_and_describe(g, self.config.max_keypoints)
        m = feat.match(self._ref, now)
        n_good = int(m.num_good)
        self.match_counts.append(n_good)
        # for each good now keypoint: the matched keyframe point and the
        # now frame's normalized image point
        obj = self._ref_pts3d[m.ref_idx].contiguous()
        valid = m.good & self._ref_pts_valid[m.ref_idx] & now.valid
        k = obj.shape[0]
        if self.config.epipolar_filter:
            # the geometric gate before PnP: descriptor-similar but
            # epipolar-inconsistent matches are rejected
            uv_ref = self._ref.uv[m.ref_idx]
            epi = ransac_fundamental_filter(
                self._uniforms(self.config.epipolar_hypotheses, k), now.uv, uv_ref, valid,
                threshold_px=self.config.epipolar_threshold_px)
            valid = epi.inliers
        imn = pnp.normalize_image_points(now.uv, self.intr).contiguous()
        res = pnp.ransac_pnp(
            self._uniforms(self.config.ransac_hypotheses, k), obj, imn, valid.contiguous(),
            inlier_thresh=self.config.inlier_thresh,
            R0=self._tensor(self._R), t0=self._tensor(self._t),
        )
        self._R = res.R.cpu().numpy().astype(np.float64)
        self._t = res.t.cpu().numpy().astype(np.float64)
        self.gop.push_ordinary(self._frame, self._R, self._t, timestamp)

        # keyframe switch on match starvation (PnPOdometry.cpp:89-102)
        if n_good < self.config.min_good_matches:
            self.gop.update_most_recent_to_keyframe(REASON_TOO_FEW_REPROJECTIONS)
            self._set_ref(g, d)
        return self.gop.global_pose(-1)

    def trajectory(self):
        return self.gop.poses()
