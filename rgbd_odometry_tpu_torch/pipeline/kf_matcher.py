"""Device-resident keyframe appearance store with batched matching and
geometric verification: port of `rgbd_odometry_tpu/pipeline/kf_matcher.py`.

The shared core of loop-closure detection (`pipeline/loop_closure.py`) and
relocalization (`pipeline/relocalize.py`): Harris/patch keypoints per
keyframe (`ops/features.py`) in a growable stacked slot store; a query is
matched against every stored keyframe in one launch of kernel A
(`kernels/match.py`), and a candidate is verified by the epipolar RANSAC
filter (`ops/epipolar.py`) and RANSAC PnP (`solvers/pnp.py`, kernel B)
against the stored keyframe's back-projected 3D points. The host only
selects candidates and reads back two counts per verification.

Random draws: every RANSAC call takes (S, K) uniforms from `_uniforms`,
which draws them from this matcher's own `torch.Generator` on its device,
seeded by `seed` (its state goes into checkpoints). The port cannot
reproduce JAX's threefry stream; the tests replace `_uniforms` with a replay
of the JAX matcher's draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.device import resolve_device
from rgbd_odometry_tpu_torch.kernels.match import match_mutual
from rgbd_odometry_tpu_torch.ops import features as feat
from rgbd_odometry_tpu_torch.ops.epipolar import ransac_fundamental_filter
from rgbd_odometry_tpu_torch.solvers import pnp

# the JAX matcher runs the epipolar filter at its default hypothesis count,
# whatever `ransac_hypotheses` (which sizes RANSAC PnP) says
EPIPOLAR_HYPOTHESES = 64


@dataclass(frozen=True)
class MatcherConfig:
    """Geometry/appearance knobs shared by both matcher consumers (the JAX
    `MatcherConfig`; see its field notes)."""

    max_keypoints: int = 384
    epipolar_threshold_px: float = 3.0
    ransac_hypotheses: int = 64
    min_depth_mm: float = 100.0
    # lower bound on the match distance gate: 1e-3 for loop closure, ~0.2
    # for relocalization, whose success case is a near-duplicate frame
    dist_gate_floor: float = 1e-3
    # initial slot capacity; the store doubles when full
    slot_capacity: int = 64


class StoredKeyframe(NamedTuple):
    kps: feat.Keypoints
    pts3d: torch.Tensor  # (K, 3) back-projected keypoints (camera frame, m)
    pts_valid: torch.Tensor  # (K,) bool


class StoredPoints(NamedTuple):
    """What the store keeps per keyframe beside the slot buffer: the 3D
    points of verification's PnP stage (the keypoints live only in the
    slot buffer)."""

    pts3d: torch.Tensor  # (K, 3)
    pts_valid: torch.Tensor  # (K,)


class Verification(NamedTuple):
    R: np.ndarray  # (3,3) stored->query relative pose (solver convention)
    t: np.ndarray  # (3,)
    num_inliers: int


class KeyframeMatcher:
    """Growable device keypoint store with batched query and verification,
    on `device` (default: the current CUDA device; "cpu" runs the plain
    versions)."""

    def __init__(self, intr: Intrinsics, config: MatcherConfig | None = None, seed: int = 0,
                 device=None):
        self.intr = intr
        self.cfg = config or MatcherConfig()
        self.device = resolve_device(device)
        self.seed = seed
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.stored: List[StoredPoints] = []
        # slot s holds keyframe s's Keypoints; unused slots are all-invalid
        self._slots: Optional[feat.Keypoints] = None

    def _uniforms(self, s: int, k: int) -> torch.Tensor:
        """(s, k) float32 uniforms in [0, 1) for one RANSAC call."""
        return torch.rand((s, k), generator=self._gen, device=self.device)

    # ---- store -----------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def describe(self, gray, depth_mm) -> StoredKeyframe:
        """Keypoints, descriptors and back-projected 3D points of one frame
        (numpy or tensor, (H, W)); not stored yet. Detection and
        back-projection are one call (the JAX `_detect_bp`): one launch of
        kernel C on the card."""
        kps, pts3d, pvalid = feat.detect_describe_backproject(
            self._tensor(gray), self._tensor(depth_mm), self.intr, self.cfg.max_keypoints,
            self.cfg.min_depth_mm)
        return StoredKeyframe(kps=kps, pts3d=pts3d, pts_valid=pvalid)

    def detect(self, gray) -> feat.Keypoints:
        """Query-side keypoints only (verification uses the stored
        keyframe's 3D points)."""
        return feat.detect_and_describe(self._tensor(gray), self.cfg.max_keypoints)

    def num_slots(self) -> int:
        return 0 if self._slots is None else self._slots.valid.shape[0]

    def store(self, sk: StoredKeyframe) -> int:
        """Append to the slot store (doubling when full); returns the slot."""
        idx = len(self.stored)
        if self._slots is None:
            self._slots = feat.Keypoints(*(
                torch.zeros((self.cfg.slot_capacity,) + x.shape, dtype=x.dtype, device=x.device)
                for x in sk.kps
            ))
        if idx == self.num_slots():
            self._slots = feat.Keypoints(*(torch.cat([b, torch.zeros_like(b)]) for b in self._slots))
        for buf, x in zip(self._slots, sk.kps):
            buf[idx] = x
        self.stored.append(StoredPoints(pts3d=sk.pts3d, pts_valid=sk.pts_valid))
        return idx

    def replace(self, slot: int, sk: StoredKeyframe) -> None:
        """Overwrite a used slot in place (eviction policies live in the
        consumers); the slot buffer does not grow."""
        if not 0 <= slot < len(self.stored):
            raise IndexError(f"slot {slot} not in use (0..{len(self.stored) - 1})")
        for buf, x in zip(self._slots, sk.kps):
            buf[slot] = x
        self.stored[slot] = StoredPoints(pts3d=sk.pts3d, pts_valid=sk.pts_valid)

    def slot_kps(self, slot: int) -> feat.Keypoints:
        """Keypoints of stored keyframe `slot`, sliced from the slot buffer."""
        return feat.Keypoints(*(buf[slot] for buf in self._slots))

    # ---- checkpoint hooks (utils/checkpoint.py) ---------------------------
    def generator_state(self) -> torch.Tensor:
        """The RANSAC generator's state (a CPU uint8 tensor; a CUDA
        generator's differs in kind from a CPU one's)."""
        return self._gen.get_state()

    def set_generator_state(self, state: torch.Tensor) -> None:
        self._gen.set_state(state)

    def restore_store(self, kps: feat.Keypoints, pts3d: torch.Tensor,
                      pts_valid: torch.Tensor) -> None:
        """Replace the store with n keyframes given stacked along a leading
        axis (on this matcher's device): the slot buffer at the capacity that
        n successive `store` calls reach (`slot_capacity` doubled until it
        holds n), filled in one copy per field."""
        n = pts3d.shape[0]
        self.stored = [StoredPoints(pts3d=pts3d[s], pts_valid=pts_valid[s]) for s in range(n)]
        if n == 0:
            self._slots = None
            return
        cap = self.cfg.slot_capacity
        while cap < n:
            cap *= 2
        self._slots = feat.Keypoints(*(
            torch.cat([x, torch.zeros((cap - n,) + x.shape[1:], dtype=x.dtype, device=x.device)])
            for x in kps))

    # ---- query -----------------------------------------------------------
    def match_all(self, kps: feat.Keypoints):
        """Match `kps` against every stored keyframe in one launch: (matches
        with a leading slot axis, per-slot good counts on the host), or
        (None, empty) when nothing is stored."""
        n = len(self.stored)
        if n == 0:
            return None, np.zeros((0,), np.int64)
        ref_idx, dist, good, num_good = match_mutual(
            self._slots.desc[:n], self._slots.valid[:n], kps.desc.contiguous(),
            kps.valid.contiguous(), dist_gate_floor=self.cfg.dist_gate_floor,
        )
        all_m = feat.Matches(ref_idx=ref_idx, dist=dist, good=good, num_good=num_good)
        return all_m, num_good.cpu().numpy().astype(np.int64)

    def verify(self, slot: int, kps: feat.Keypoints, all_m, min_epi_inliers: int,
               min_pnp_inliers: int) -> Optional[Verification]:
        """Epipolar RANSAC on the matched pixel pairs, then RANSAC PnP of the
        stored keyframe's 3D points against the query image: the
        stored->query relative pose (p_query = R (p_stored - t)), or None
        if either stage falls short."""
        old = self.stored[slot]
        old_kps = self.slot_kps(slot)
        ref_idx, good = all_m.ref_idx[slot], all_m.good[slot]
        uv_old = old_kps.uv[ref_idx]
        valid = good & kps.valid & old_kps.valid[ref_idx]
        k = kps.uv.shape[0]
        epi = ransac_fundamental_filter(
            self._uniforms(EPIPOLAR_HYPOTHESES, k), kps.uv, uv_old, valid,
            threshold_px=self.cfg.epipolar_threshold_px,
        )
        if int(epi.num_inliers) < min_epi_inliers:
            return None
        obj = old.pts3d[ref_idx]
        ov = old.pts_valid[ref_idx]
        imn = pnp.normalize_image_points(kps.uv, self.intr)
        res = pnp.ransac_pnp(self._uniforms(self.cfg.ransac_hypotheses, k), obj, imn,
                             epi.inliers & ov)
        n_inl = int(res.num_inliers)
        if n_inl < min_pnp_inliers:
            return None
        return Verification(R=res.R.cpu().numpy().astype(np.float64),
                            t=res.t.cpu().numpy().astype(np.float64), num_inliers=n_inl)
