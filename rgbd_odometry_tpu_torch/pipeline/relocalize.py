"""Relocalization after tracking loss: port of
`rgbd_odometry_tpu/pipeline/relocalize.py`.

Every healthy tracking keyframe is registered, with its global pose, in the
device-resident appearance store of `pipeline/kf_matcher.py`. When the
driver declares tracking lost (`pipeline/odometry.py`), the current frame is
matched against the whole database in one launch; the top candidates are
verified (epipolar RANSAC, then RANSAC PnP on the stored keyframe's 3D
points), and the best verified pose re-anchors the trajectory:
global_new = global_keyframe o rel(PnP), in the GOP composition convention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.pipeline.kf_matcher import KeyframeMatcher, MatcherConfig


@dataclass(frozen=True)
class RelocResult:
    R: np.ndarray  # (3,3) recovered global rotation (GOP convention)
    t: np.ndarray  # (3,) recovered global translation
    keyframe: int  # database index the pose was recovered against
    num_inliers: int


class Relocalizer:
    """Appearance database of (keyframe, global pose); recovery queries.
    `config` is a `config.RelocalizeConfig`; `device` defaults to the current
    CUDA device ("cpu" runs the plain versions)."""

    def __init__(self, intr: Intrinsics, config, seed: int = 0, device=None):
        self.cfg = config
        self.matcher = KeyframeMatcher(
            intr,
            MatcherConfig(
                max_keypoints=config.max_keypoints,
                epipolar_threshold_px=config.epipolar_threshold_px,
                ransac_hypotheses=config.ransac_hypotheses,
                min_depth_mm=config.min_depth_mm,
                slot_capacity=config.slot_capacity,
                dist_gate_floor=config.dist_gate_floor,
            ),
            seed=seed,
            device=device,
        )
        self.poses: List[Tuple[np.ndarray, np.ndarray]] = []  # global (R, t)
        # trajectory node of each stored keyframe (None when not given), so
        # that `update_poses` can follow an online pose-graph refinement
        self.nodes: List[Optional[int]] = []
        self.attempts: int = 0
        self.successes: int = 0

    def __len__(self) -> int:
        return len(self.poses)

    def add_keyframe(self, gray, depth_mm, R_global, t_global, node: Optional[int] = None) -> bool:
        """Register a healthy tracking keyframe and its global pose. Frames
        with fewer keypoints than `min_matches` or fewer depth-valid
        keypoints than `min_inliers` can never anchor a recovery and are
        rejected. At `max_keyframes` the stored entry whose anchor pose is
        nearest to the incoming one is replaced. Returns whether stored."""
        sk = self.matcher.describe(gray, depth_mm)
        if int(sk.kps.count) < self.cfg.min_matches:
            return False
        if int(sk.pts_valid.sum()) < self.cfg.min_inliers:
            return False
        R_g = np.asarray(R_global, np.float64).copy()
        t_g = np.asarray(t_global, np.float64).copy()
        cap = getattr(self.cfg, "max_keyframes", 0)
        if cap and len(self.poses) >= cap:
            s = int(np.argmin([np.linalg.norm(t_g - ts) for _, ts in self.poses]))
            self.matcher.replace(s, sk)
            self.poses[s] = (R_g, t_g)
            self.nodes[s] = None if node is None else int(node)
            return True
        self.matcher.store(sk)
        self.poses.append((R_g, t_g))
        self.nodes.append(None if node is None else int(node))
        return True

    def update_poses(self, gop) -> int:
        """Re-read every stored entry's global pose from the (refined)
        trajectory by its node; entries without a node stay as stored.
        Returns the number refreshed."""
        n = 0
        for k, node in enumerate(self.nodes):
            if node is not None and node < len(gop):
                R, t = gop.global_pose(node)
                self.poses[k] = (np.asarray(R, np.float64).copy(), np.asarray(t, np.float64).copy())
                n += 1
        return n

    def relocalize(self, gray) -> Optional[RelocResult]:
        """Recover the global pose of `gray` against the database: one
        batched match, up to `max_candidates` verifications; the verified
        candidate with the most PnP inliers (the first among equals), or
        None."""
        self.attempts += 1
        if not self.poses:
            return None
        kps = self.matcher.detect(gray)
        all_m, goods = self.matcher.match_all(kps)
        candidates = [s for s in range(len(self.poses)) if int(goods[s]) >= self.cfg.min_matches]
        candidates.sort(key=lambda s: -int(goods[s]))
        best: Optional[RelocResult] = None
        for s in candidates[: self.cfg.max_candidates]:
            v = self.matcher.verify(s, kps, all_m, self.cfg.min_matches, self.cfg.min_inliers)
            if v is None or (best is not None and v.num_inliers <= best.num_inliers):
                continue
            R_k, t_k = self.poses[s]
            best = RelocResult(R=R_k @ v.R, t=t_k + R_k @ v.t, keyframe=s,
                               num_inliers=v.num_inliers)
        if best is not None:
            self.successes += 1
        return best
