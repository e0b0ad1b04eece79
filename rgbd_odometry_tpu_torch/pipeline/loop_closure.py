"""Loop-closure detection and trajectory refinement: port of
`rgbd_odometry_tpu/pipeline/loop_closure.py`.

Each new keyframe is matched against every stored keyframe in one launch
(`pipeline/kf_matcher.py`); candidates with enough matches are verified
(epipolar RANSAC, RANSAC PnP) into relative-pose closure edges. `refine`
then either re-anchors the trajectory rigidly at each revisit (the default,
host float64) or runs the pose-graph Gauss-Newton over odometry and closure
edges (`solvers/pose_graph.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.pipeline.kf_matcher import KeyframeMatcher, MatcherConfig
from rgbd_odometry_tpu_torch.solvers.pose_graph import (
    PoseGraphEdges,
    concat_edges,
    odometry_edges,
    refine_pose_graph,
)


@dataclass
class LoopClosureConfig:
    """The JAX `LoopClosureConfig` (see its field notes)."""

    max_keypoints: int = 384
    min_matches: int = 30  # descriptor matches to consider a candidate
    min_inliers: int = 20  # PnP inliers to accept the closure
    min_separation: int = 3  # skip temporally adjacent keyframes
    # verify only the top-N candidates by match count; the rest are counted
    # in `skipped_candidates`
    max_candidates_per_keyframe: int = 4
    ransac_hypotheses: int = 64
    epipolar_threshold_px: float = 3.0
    edge_weight: float = 3.0  # closures weigh more than single odometry steps
    min_depth_mm: float = 100.0
    slot_capacity: int = 64  # initial keyframe-slot capacity (doubles when full)
    # only closures spanning at least this many nodes are applied by
    # `reanchor` (all are recorded)
    min_loop_separation: int = 8


@dataclass
class KeyframeRecord:
    node: int  # index into the trajectory being refined
    pts3d: torch.Tensor  # (K, 3) back-projected keypoints (camera frame)
    pts_valid: torch.Tensor  # (K,)


class LoopCloser:
    """Accumulates keyframes, detects closures, refines trajectories, on
    `device` (default: the current CUDA device; "cpu" runs the plain
    versions)."""

    def __init__(self, intr: Intrinsics, config: LoopClosureConfig | None = None, seed: int = 0,
                 device=None):
        self.intr = intr
        self.cfg = config or LoopClosureConfig()
        self.matcher = KeyframeMatcher(
            intr,
            MatcherConfig(
                max_keypoints=self.cfg.max_keypoints,
                epipolar_threshold_px=self.cfg.epipolar_threshold_px,
                ransac_hypotheses=self.cfg.ransac_hypotheses,
                min_depth_mm=self.cfg.min_depth_mm,
                slot_capacity=self.cfg.slot_capacity,
            ),
            seed=seed,
            device=device,
        )
        # grows in lockstep with matcher.stored (same tensors, no copies)
        self.keyframes: List[KeyframeRecord] = []
        self.closures: List[Tuple[int, int, np.ndarray, np.ndarray, int]] = []
        self.skipped_candidates: int = 0

    def _num_slots(self) -> int:
        return self.matcher.num_slots()

    def add_keyframe(self, node: int, gray, depth_mm) -> List[int]:
        """Register the keyframe at trajectory index `node`; returns the
        nodes of the loop closures found against earlier keyframes."""
        sk = self.matcher.describe(gray, depth_mm)
        found = []
        all_m, goods = self.matcher.match_all(sk.kps)
        candidates = [
            s for s, old in enumerate(self.keyframes)
            if abs(node - old.node) >= self.cfg.min_separation
            and int(goods[s]) >= self.cfg.min_matches
        ]
        cap = self.cfg.max_candidates_per_keyframe
        if len(candidates) > cap:
            candidates.sort(key=lambda s: -int(goods[s]))
            self.skipped_candidates += len(candidates) - cap
            candidates = candidates[:cap]
        for s in candidates:
            v = self.matcher.verify(s, sk.kps, all_m, self.cfg.min_matches, self.cfg.min_inliers)
            if v is None:
                continue
            # the new camera's pose in the old keyframe's frame: the
            # old->new relative-pose edge
            old = self.keyframes[s]
            self.closures.append((old.node, node, v.R, v.t, v.num_inliers))
            found.append(old.node)
        self.matcher.store(sk)
        self.keyframes.append(KeyframeRecord(node=node, pts3d=sk.pts3d, pts_valid=sk.pts_valid))
        return found

    def closure_edges(self, device=None) -> Optional[PoseGraphEdges]:
        if not self.closures:
            return None
        dev = self.matcher.device if device is None else device
        f32 = dict(dtype=torch.float32, device=dev)
        return PoseGraphEdges(
            i=torch.tensor([c[0] for c in self.closures], device=dev),
            j=torch.tensor([c[1] for c in self.closures], device=dev),
            R_rel=torch.as_tensor(np.stack([c[2] for c in self.closures]), **f32),
            t_rel=torch.as_tensor(np.stack([c[3] for c in self.closures]), **f32),
            weight=torch.full((len(self.closures),), self.cfg.edge_weight, **f32),
        )

    def reanchor(self, R: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rigid segment re-anchoring (host float64): for each applied
        closure (i -> j) the discrepancy between node j's pose and the
        closure-implied pose T_i * rel is applied rigidly to every node >=
        j. Closures shorter than `min_loop_separation` are not applied; of
        several onto one target node the one with the most PnP inliers
        wins. Returns (R, t, translation norm of each applied correction, in
        target-node order). See the JAX docstring for the measurements
        behind this default."""
        R = np.array(R, np.float64, copy=True)
        t = np.array(t, np.float64, copy=True)
        n = len(t)
        best: dict = {}
        for c in self.closures:
            ni, nj, _, _, inl = c
            if nj - ni < self.cfg.min_loop_separation or nj >= n or ni < 0:
                continue
            if nj not in best or inl > best[nj][4]:
                best[nj] = c
        applied = []
        for nj in sorted(best):
            ni, _, Rc, tc, _ = best[nj]
            Rd = R[ni] @ np.asarray(Rc, np.float64)
            td = t[ni] + R[ni] @ np.asarray(tc, np.float64)
            dR = Rd @ R[nj].T
            dt = td - dR @ t[nj]
            applied.append(float(np.linalg.norm(td - t[nj])))
            t[nj:] = t[nj:] @ dR.T + dt
            R[nj:] = np.einsum("ij,njk->nik", dR, R[nj:])
        return R, t, np.asarray(applied)

    def refine(
        self,
        R: np.ndarray,
        t: np.ndarray,
        iterations: int = 10,
        odo_sqrt_info: Optional[np.ndarray] = None,
        robust: Optional[str] = None,
        robust_delta: float = 1.0,
        edge_traj: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        mode: str = "reanchor",
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Refine an absolute trajectory with the detected closures.
        ``mode`` "reanchor" (default; norms = applied corrections) or
        "graph": pose-graph Gauss-Newton over odometry + closure edges, the
        odometry edges derived from ``edge_traj`` (the raw odometry chain,
        for repeated online refinement) or else from (R, t), optionally
        whitened by ``odo_sqrt_info`` (N-1, 6, 6), with an optional IRLS
        ``robust`` kernel against false closures."""
        if mode == "reanchor":
            return self.reanchor(R, t)
        if mode != "graph":
            raise ValueError(f"unknown refine mode {mode!r} (reanchor|graph)")
        f32 = dict(dtype=torch.float32, device=self.matcher.device)
        R_e, t_e = edge_traj if edge_traj is not None else (R, t)
        edges = odometry_edges(
            torch.as_tensor(np.asarray(R_e), **f32), torch.as_tensor(np.asarray(t_e), **f32),
            sqrt_info=None if odo_sqrt_info is None else torch.as_tensor(np.asarray(odo_sqrt_info),
                                                                         **f32),
        )
        lc = self.closure_edges()
        if lc is not None:
            edges = concat_edges(edges, lc)
        R_f, t_f, norms = refine_pose_graph(
            torch.as_tensor(np.asarray(R), **f32), torch.as_tensor(np.asarray(t), **f32), edges,
            iterations=iterations, robust=robust, robust_delta=robust_delta,
        )
        return (R_f.cpu().numpy().astype(np.float64), t_f.cpu().numpy().astype(np.float64),
                norms.cpu().numpy())

    def refine_inplace(self, gop, **kw) -> Optional[np.ndarray]:
        """Online refinement: refine the trajectory logged so far and write
        it back into the live Gop (its last-keyframe state included), so
        that later frames compose from the refined anchor. Returns the
        norms, or None with no closures or a trivial trajectory."""
        if not self.closures or len(gop) < 2:
            return None
        R, t, _ = gop.poses()
        R_f, t_f, norms = self.refine(R, t, **kw)
        gop.set_poses(R_f, t_f)
        return norms
