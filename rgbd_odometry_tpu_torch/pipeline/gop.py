"""Keyframe pose-graph (trajectory) log: port of
`rgbd_odometry_tpu/pipeline/gop.py` (numpy only). The JAX package's module
cannot be imported without JAX (its package `__init__` imports the JAX
`EdgeDvoOdometry`), so the port carries its own copy.

Rebuild of `GOP<T>` / `GOPElement<T>`
(reference include/GOP.h:31-95, src/GOP.cpp): composes per-frame
*relative* poses (w.r.t. the last keyframe) into *global* poses, tracks
keyframe promotions with reason codes, and serves as the data source for
trajectory output and visualization.

Host-side bookkeeping (like the reference's std::vector): poses arrive from
the device solver once per frame; composition is cheap numpy in float64
(the reference deliberately uses double here too, src/SolveDVO.cpp:2042-2046).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

# keyframe reason codes (reference: GOP.cpp:159 doc + MentisVisualHandle.cpp:327-358)
REASON_FIRST_FRAME = 1
REASON_LAPLACIAN_THRESH = 2
REASON_LOW_VISIBILITY = 3
REASON_TOO_FEW_REPROJECTIONS = 4
REASON_PERIODIC = 5
# beyond-reference: trajectory re-anchored by the relocalizer after
# tracking loss (pipeline/relocalize.py)
REASON_RELOCALIZED = 6


@dataclass
class GopElement:
    """One trajectory entry (reference: GOPElement, include/GOP.h:31-60)."""

    frame_num: int
    is_keyframe: bool
    reason: int  # 0 for ordinary frames
    R: np.ndarray  # (3,3) global rotation
    t: np.ndarray  # (3,) global translation
    timestamp: float = 0.0


@dataclass
class Gop:
    """Global-pose log with last-keyframe composition state
    (reference: lastKeyFr_R/T, include/GOP.h:66-68)."""

    elements: List[GopElement] = field(default_factory=list)
    last_key_R: np.ndarray = field(default_factory=lambda: np.eye(3))
    last_key_t: np.ndarray = field(default_factory=lambda: np.zeros(3))
    last_key_index: int = -1  # element index of the current last keyframe

    def _compose(self, rel_R: np.ndarray, rel_t: np.ndarray):
        """global = lastKey ∘ rel (reference src/GOP.cpp:138-146)."""
        g_t = self.last_key_t + self.last_key_R @ np.asarray(rel_t, np.float64)
        g_R = self.last_key_R @ np.asarray(rel_R, np.float64)
        return g_R, g_t

    def push_ordinary(self, frame_num: int, rel_R, rel_t, timestamp: float = 0.0):
        """pushAsOrdinaryFrame (reference src/GOP.cpp:134-155)."""
        g_R, g_t = self._compose(rel_R, rel_t)
        self.elements.append(GopElement(frame_num, False, 0, g_R, g_t, timestamp))

    def push_keyframe(self, frame_num: int, reason: int, rel_R, rel_t, timestamp: float = 0.0):
        """pushAsKeyFrame: also advances the last-keyframe pose
        (reference src/GOP.cpp:162-186)."""
        g_R, g_t = self._compose(rel_R, rel_t)
        self.elements.append(GopElement(frame_num, True, reason, g_R, g_t, timestamp))
        self.last_key_R = g_R
        self.last_key_t = g_t
        self.last_key_index = len(self.elements) - 1

    def push_keyframe_absolute(
        self, frame_num: int, reason: int, R: np.ndarray, t: np.ndarray, timestamp: float = 0.0
    ):
        """Push a keyframe at a directly-specified GLOBAL pose (relocalizer
        re-anchor: the pose comes from PnP against a stored keyframe, not
        from composing onto the drifting last-keyframe state)."""
        g_R = np.asarray(R, np.float64).copy()
        g_t = np.asarray(t, np.float64).copy()
        self.elements.append(GopElement(frame_num, True, reason, g_R, g_t, timestamp))
        self.last_key_R = g_R
        self.last_key_t = g_t
        self.last_key_index = len(self.elements) - 1

    def update_most_recent_to_keyframe(self, reason: int):
        """Promote frame n-1 to keyframe during rollback
        (`updateMostRecentToKeyFrame`, reference src/GOP.cpp:188-196)."""
        assert self.elements, "no frame to promote"
        el = self.elements[-1]
        el.is_keyframe = True
        el.reason = reason
        self.last_key_R = el.R
        self.last_key_t = el.t
        self.last_key_index = len(self.elements) - 1

    def set_poses(self, R: np.ndarray, t: np.ndarray):
        """Replace every global pose (online pose-graph refinement write-back).

        The reference's GOP only ever composes forward; a refinement that
        corrects drift mid-run must re-anchor the whole log AND the
        last-keyframe composition state, so every subsequent frame composes
        from the REFINED keyframe pose (pipeline/loop_closure.refine_inplace).
        """
        assert len(R) == len(self.elements) == len(t)
        last_kf = None
        for el, Ri, ti in zip(self.elements, R, t):
            el.R = np.asarray(Ri, np.float64)
            el.t = np.asarray(ti, np.float64)
            if el.is_keyframe:
                last_kf = el
        if last_kf is not None:
            self.last_key_R = last_kf.R
            self.last_key_t = last_kf.t

    def global_pose(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """getGlobalPoseAt (reference include/GOP.h:84-86)."""
        el = self.elements[i]
        return el.R, el.t

    def __len__(self) -> int:
        return len(self.elements)

    def poses(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(T, 3, 3) rotations, (T, 3) translations, (T,) timestamps."""
        if not self.elements:
            return np.zeros((0, 3, 3)), np.zeros((0, 3)), np.zeros((0,))
        R = np.stack([e.R for e in self.elements])
        t = np.stack([e.t for e in self.elements])
        ts = np.asarray([e.timestamp for e in self.elements])
        return R, t, ts

    def keyframe_indices(self) -> List[int]:
        return [i for i, e in enumerate(self.elements) if e.is_keyframe]
