"""Streaming edge-DVO odometry: port of
`rgbd_odometry_tpu/pipeline/odometry.EdgeDvoOdometry`.

Per frame the device builds the pyramid, computes the DT targets and runs
the coarse-to-fine solve (the JAX fused step); the host holds the control
flow that is data-dependent across frames: keyframe switches (every-N and
the optional quality triggers), the rollback re-solve that promotes frame
n-1, the naive ref update, the divergence guard, and GOP composition in
float64. The steady-state frame reads its results back in one device->host
copy. The warm start is the previous relative pose ("hold") or, with
`motion_model="constant_velocity"`, that pose extrapolated on the device by
the last inter-frame motion (`cv_extrapolate`). `process_pyramid` takes an
already-built pyramid, as `pipeline/feeder.FrameFeeder` delivers it. With
`RelocalizeConfig(enabled=True)` healthy keyframes feed the appearance
database of `pipeline/relocalize.py`, and a streak of lost frames triggers a
recovery query that re-anchors the trajectory (REASON_RELOCALIZED).
`process_stream` is the pipelined mode: frame n+1 is launched off frame n's
unresolved outputs, and frame n's results come back through a copy enqueued
when it was launched (`enqueue_pull`), so the host waits for frame n only.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import PipelineConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.core.pyramid import FramePyramid, build_pyramid
from rgbd_odometry_tpu_torch.device import resolve_device
from rgbd_odometry_tpu_torch.pipeline.gop import (
    REASON_FIRST_FRAME,
    REASON_LAPLACIAN_THRESH,
    REASON_LOW_VISIBILITY,
    REASON_PERIODIC,
    REASON_RELOCALIZED,
    REASON_TOO_FEW_REPROJECTIONS,
    Gop,
)
from rgbd_odometry_tpu_torch.solvers import edge_dvo


@dataclass
class FrameMetrics:
    """Per-frame observability record (the JAX `FrameMetrics`)."""

    frame_num: int
    solve_ms: float
    best_energy: float
    best_iter: int
    visible_ratio: float
    b_cap: float  # Laplacian-MLE scale of the residual histogram
    num_points: int
    keyframe_reason: int  # 0 = ordinary frame
    rolled_back: bool = False
    energy_curve: Optional[np.ndarray] = None
    diverged: bool = False
    final_epsilons: Optional[np.ndarray] = None
    final_valid: Optional[np.ndarray] = None


@dataclass
class _Finest:
    """Host copy of the finest level's diagnostics for one frame."""

    energy: np.ndarray
    best_energy: float
    best_iter: int
    visible_ratio: float
    num_points: int
    final_epsilons: np.ndarray
    final_valid: np.ndarray


def residual_b_cap(epsilons: np.ndarray, count: int) -> float:
    """Laplace-MLE scale b-hat = sum(|residual|) / count."""
    return float(np.sum(epsilons) / max(int(count), 1))


def residual_histogram(epsilons: np.ndarray, valid: np.ndarray, bins: int = 260) -> np.ndarray:
    """Normalized 260-bin histogram of the int residues of the valid points
    (the JAX `residual_histogram`)."""
    e = np.clip(epsilons[valid].astype(np.int32) + 1, 0, bins - 1)
    h = np.bincount(e, minlength=bins).astype(np.float64)
    return h / max(len(e), 1)


def cv_extrapolate(R0, t0, Rp, tp):
    """Constant-velocity warm start in the solver's pose parameterization
    p_now = R (p_ref - t): from the current relative pose T0 = (R0, t0) and
    the previous frame's Tp = (Rp, tp) (same keyframe), the last
    inter-frame motion D = T0 Tp^-1 applied once more, D T0:
    R_warm = R0 Rp^T R0, t_warm = t0 + R0^T Rp (t0 - tp). Batched (B,3,3),
    (B,3); composed on the device, no host transfer."""
    Rw = R0 @ (Rp.transpose(-1, -2) @ R0)
    tw = t0 + (R0.transpose(-1, -2) @ (Rp @ (t0 - tp)[..., None]))[..., 0]
    return Rw, tw


@dataclass
class PulledBatch:
    """Host copy of B pairs' poses and finest diagnostics (`pull_batch`)."""

    R: np.ndarray  # (B, 3, 3) float32
    t: np.ndarray  # (B, 3)
    best_energy: Optional[np.ndarray] = None  # (B,)
    best_iter: Optional[np.ndarray] = None  # (B,) int
    visible_ratio: Optional[np.ndarray] = None  # (B,)
    num_points: Optional[np.ndarray] = None  # (B,) int
    energy: Optional[np.ndarray] = None  # (B, n_iters)
    final_epsilons: Optional[np.ndarray] = None  # (B, K)
    final_valid: Optional[np.ndarray] = None  # (B, K) bool


class PendingPull(NamedTuple):
    """A device->host copy of B pairs' packed results, enqueued but not yet
    waited for (`enqueue_pull`)."""

    host: torch.Tensor  # (B, row) float32, pinned when the results are on a card
    event: Optional[torch.cuda.Event]  # recorded after the copy; None on the CPU
    n_iters: int  # 0: poses only
    k: int


def enqueue_pull(R_d: torch.Tensor, t_d: torch.Tensor,
                 finest: Optional[edge_dvo.LevelDiagnostics] = None) -> PendingPull:
    """Pack the poses of every pair, and with `finest` its diagnostics
    (scalars, energy curve, per-point residuals and visibility), into one
    row of float32 per pair, and enqueue its copy to the host: on a card a
    `non_blocking` copy into pinned memory on the current stream, then an
    event. The host waits on that event only (`finish_pull`), not on what
    is launched after it. The pinned buffer lives in the returned handle;
    dropped before its copy ends, it goes back to PyTorch's pinned-memory
    cache, which keeps it until the copy's stream has passed it."""
    f32 = torch.float32
    b = R_d.shape[0]
    parts = [R_d.reshape(b, 9), t_d.reshape(b, 3)]
    n_it = k = 0
    if finest is not None:
        n_it, k = finest.energy.shape[-1], finest.final_epsilons.shape[-1]
        parts += [
            torch.stack([finest.best_energy, finest.best_iter.to(f32), finest.visible_ratio,
                         finest.num_points.to(f32)], dim=-1),
            finest.energy, finest.final_epsilons, finest.final_valid.to(f32),
        ]
    packed = torch.cat([p.to(f32) for p in parts], dim=1)
    if packed.device.type != "cuda":
        return PendingPull(packed, None, n_it, k)
    host = torch.empty(packed.shape, dtype=f32, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return PendingPull(host, event, n_it, k)


def finish_pull(pending: PendingPull) -> PulledBatch:
    """Wait for an enqueued pull's copy and unpack it."""
    if pending.event is not None:
        pending.event.synchronize()
    host = pending.host.numpy()
    b = host.shape[0]
    out = PulledBatch(R=host[:, :9].reshape(b, 3, 3).copy(), t=host[:, 9:12].copy())
    if pending.n_iters:
        o, k = 16 + pending.n_iters, pending.k
        out.best_energy = host[:, 12].copy()
        out.best_iter = host[:, 13].astype(np.int64)
        out.visible_ratio = host[:, 14].copy()
        out.num_points = host[:, 15].astype(np.int64)
        out.energy = host[:, 16:o].copy()
        out.final_epsilons = host[:, o:o + k].copy()
        out.final_valid = host[:, o + k:o + 2 * k] > 0.5
    return out


def pull_batch(R_d: torch.Tensor, t_d: torch.Tensor,
               finest: Optional[edge_dvo.LevelDiagnostics] = None) -> PulledBatch:
    """Poses of every pair, and with `finest` its diagnostics, in ONE
    device->host copy (`enqueue_pull`, then `finish_pull`)."""
    return finish_pull(enqueue_pull(R_d, t_d, finest))


def _single(p: PulledBatch):
    """Pose and finest diagnostics of the one pair of a single-stream solve."""
    fin = _Finest(
        energy=p.energy[0],
        best_energy=float(p.best_energy[0]),
        best_iter=int(p.best_iter[0]),
        visible_ratio=float(p.visible_ratio[0]),
        num_points=int(p.num_points[0]),
        final_epsilons=p.final_epsilons[0],
        final_valid=p.final_valid[0],
    )
    return p.R[0], p.t[0], fin


class _Dispatched(NamedTuple):
    """One frame's solve as launched, before the host has read it."""

    pyr: FramePyramid
    timestamp: float
    frame_num: int
    R_d: torch.Tensor
    t_d: torch.Tensor
    targets: tuple
    pull: PendingPull
    warm: tuple  # the warm pair the solve started from
    t_start: float


class EdgeDvoOdometry:
    """Streaming odometry over a sequence of RGB-D frames on one device."""

    def __init__(self, config: PipelineConfig | None = None, device=None):
        self.cfg = config or PipelineConfig()
        edge_dvo.check_config(self.cfg.solver)
        self.device = resolve_device(device)
        self.intr = Intrinsics.from_config(self.cfg.camera)
        self.gop = Gop()
        self.metrics: "deque[FrameMetrics]" = deque(maxlen=self.cfg.metrics_max or None)
        pyr = self.cfg.pyramid
        self._max_pts = tuple(pyr.max_points[: pyr.num_levels])
        self._ref_feats = None
        self._prev_pyr: Optional[FramePyramid] = None
        self._prev_targets = None
        self._frame_num = -1
        self._last_ref_frame = -1
        self._R = np.eye(3, dtype=np.float64)
        self._t = np.zeros(3, dtype=np.float64)
        # device copy of (_R, _t) as float32 (1, 3, 3), (1, 3); None = the
        # next frame uploads the host pose once
        self._warm = None
        # constant velocity: the device copy of the previous frame's relative
        # pose (same keyframe), and the warm pair the current solve started
        # from (it becomes _prevpose once the frame resolves). None = no
        # velocity evidence yet: the warm pair stands in (JAX `_step_cv`)
        self._cv = self.cfg.motion_model == "constant_velocity"
        self._prevpose = None
        self._dispatch_warm = None
        self.keep_residuals = False
        self.discarded_dispatches = 0  # speculative solves of process_stream launched again
        # relocalization after tracking loss: `trigger_consecutive` lost
        # frames in a row query the appearance database
        self._reloc = None
        self._bad_streak = 0
        if self.cfg.relocalize.enabled:
            from rgbd_odometry_tpu_torch.pipeline.relocalize import Relocalizer

            self._reloc = Relocalizer(self.intr, self.cfg.relocalize, device=self.device)

    # ------------------------------------------------------------------
    def process_frame(
        self,
        gray0: np.ndarray,
        depth0_mm: np.ndarray,
        timestamp: float = 0.0,
        pose_prior: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Feed one frame (level-0 gray + depth in mm, numpy arrays or
        tensors as `io.stream.preprocess_vga` returns them); returns the
        current global pose (R, t). `pose_prior`, if given, is a delta (R, t)
        composed onto the warm start."""
        f32 = dict(dtype=torch.float32, device=self.device)
        pyr = build_pyramid(
            torch.as_tensor(gray0, **f32)[None],
            torch.as_tensor(depth0_mm, **f32)[None],
            self.cfg.pyramid.num_levels,
        )
        return self.process_pyramid(pyr, timestamp, pose_prior)

    def process_pyramid(
        self,
        pyr: FramePyramid,
        timestamp: float = 0.0,
        pose_prior: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Feed one already-built pyramid of batch 1 on this driver's device
        (the entry `FrameFeeder` uses, so the host build and the copy to the
        card overlap the previous frame's solve)."""
        self._frame_num += 1
        if pose_prior is not None:
            dR, dt = pose_prior
            self._t = self._t + self._R @ np.asarray(dt, np.float64)
            self._R = self._R @ np.asarray(dR, np.float64)
            self._warm = None
            self._prevpose = None  # the prior is the velocity source
        if self._frame_num == 0:
            return self._bootstrap(pyr, timestamp)
        return self._resolve(self._dispatch(pyr, timestamp, self._frame_num, self._resolved_warm(),
                                            self._prevpose))

    def process_stream(self, pyramids):
        """Pipelined streaming over (pyramid, timestamp) items, as
        `FrameFeeder` yields them; yields the global pose (R, t) per frame,
        in order. Frame n+1's solve is launched with frame n's unresolved
        device outputs as its warm start (and, for constant velocity, frame
        n's own warm pair as the previous pose) before the host reads frame
        n's results and decides its keyframe policy, so the host's dispatch
        of frame n+1 overlaps frame n's device work and readback. The
        outcome is bitwise that of the sequential loop: the speculation
        holds only while frame n's resolution keeps the chain intact (its
        solved pose becomes the next warm start). A keyframe switch, a
        rollback, a divergence or a relocalization breaks it; the
        speculative solve is then discarded (counted in
        `discarded_dispatches`) and launched again from the resolved state,
        on the same now-frame targets."""
        pend: Optional[_Dispatched] = None
        for pyr, ts in pyramids:
            self._frame_num += 1
            if self._frame_num == 0:
                yield self._bootstrap(pyr, ts)
                continue
            if pend is None:
                pend = self._dispatch(pyr, ts, self._frame_num, self._resolved_warm(),
                                      self._prevpose)
                continue
            spec = self._dispatch(pyr, ts, self._frame_num, (pend.R_d, pend.t_d), pend.warm)
            pose = self._resolve(pend)
            if self._warm is None or self._warm[0] is not pend.R_d:
                self.discarded_dispatches += 1
                spec = self._dispatch(pyr, ts, self._frame_num, self._resolved_warm(),
                                      self._prevpose, targets=spec.targets)
            pend = spec
            yield pose
        if pend is not None:
            yield self._resolve(pend)

    def _resolved_warm(self):
        """The warm start from the resolved state, uploaded once after the
        host changed it."""
        if self._warm is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            self._warm = (
                torch.as_tensor(self._R, **f32)[None],
                torch.as_tensor(self._t, **f32)[None],
            )
        return self._warm

    def _dispatch(self, pyr, timestamp, frame_num, warm, prev, targets=None) -> _Dispatched:
        """Launch one frame's targets (unless given) and solve from the warm
        pair `warm` (`prev`: the previous pose for constant velocity, None
        for none yet), and enqueue the copy of its results to the host."""
        t_start = time.perf_counter()
        R0, t0 = warm
        if self._cv:
            R0, t0 = cv_extrapolate(R0, t0, *(prev or warm))
        scfg = self.cfg.solver
        if targets is None:
            targets = edge_dvo.prepare_now_targets(pyr.gray, scfg)
        R_d, t_d, diags = edge_dvo.solve_pyramid(self._ref_feats, targets, self.intr, scfg, R0, t0)
        return _Dispatched(pyr, timestamp, frame_num, R_d, t_d, targets,
                           enqueue_pull(R_d, t_d, diags[0]), warm, t_start)

    def _bootstrap(self, pyr: FramePyramid, timestamp: float):
        """The first frame becomes the reference keyframe."""
        self._set_ref(pyr)
        self._last_ref_frame = 0
        self.gop.push_keyframe(0, REASON_FIRST_FRAME, np.eye(3), np.zeros(3), timestamp)
        count = int(self._ref_feats[0].count[0])
        self.metrics.append(FrameMetrics(0, 0.0, 0.0, -1, 1.0, 0.0, count, REASON_FIRST_FRAME))
        self._register_keyframe(pyr)
        self._prev_pyr = pyr
        return self.gop.global_pose(0)

    def _resolve(self, d: _Dispatched):
        """Host-side bookkeeping for one dispatched frame: wait for its
        results, decide keyframes, maybe rollback-resolve, log trajectory +
        metrics."""
        pyr, timestamp, frame_num, R_d, t_d, targets, t_start = (
            d.pyr, d.timestamp, d.frame_num, d.R_d, d.t_d, d.targets, d.t_start)
        self._dispatch_warm = d.warm
        R, t, finest = _single(finish_pull(d.pull))
        solve_ms = (time.perf_counter() - t_start) * 1000.0
        b_cap = residual_b_cap(finest.final_epsilons, finest.num_points)
        vis = finest.visible_ratio
        n_reproj = int(finest.final_valid.sum())

        if self._reloc is not None:
            rcfg = self.cfg.relocalize
            lost = (vis < rcfg.lost_visible_ratio or n_reproj < rcfg.lost_min_points
                    or b_cap > rcfg.lost_b_cap or not (np.isfinite(R).all() and np.isfinite(t).all()))
            self._bad_streak = self._bad_streak + 1 if lost else 0
            if self._bad_streak >= rcfg.trigger_consecutive:
                res = self._reloc.relocalize(pyr.gray[0][0])
                if res is not None:
                    return self._relocalized(pyr, targets, timestamp, frame_num, res, finest,
                                             b_cap, vis, t_start)

        kf_cfg = self.cfg.keyframe
        reason = 0
        if kf_cfg.enable_quality_triggers:
            if b_cap > kf_cfg.laplacian_b_thresh:
                reason = REASON_LAPLACIAN_THRESH
            if vis < kf_cfg.min_visible_ratio:
                reason = REASON_LOW_VISIBILITY
            if n_reproj < kf_cfg.min_reprojected_pts:
                reason = REASON_TOO_FEW_REPROJECTIONS
        if (frame_num - self._last_ref_frame) == kf_cfg.force_every:
            reason = REASON_PERIODIC

        rolled_back = False
        if (
            reason != 0
            and kf_cfg.rollback_resolve
            and self._last_ref_frame != (frame_num - 1)
            and self._prev_pyr is not None
        ):
            # rollback re-solve: promote frame n-1 to the reference keyframe,
            # reset the relative pose, re-run the full pyramid solve
            self._last_ref_frame = frame_num - 1
            self._set_ref(self._prev_pyr, targets=self._prev_targets)
            self.gop.update_most_recent_to_keyframe(reason)
            R_d, t_d, diags = edge_dvo.solve_pyramid(
                self._ref_feats, targets, self.intr, self.cfg.solver
            )
            R, t, finest = _single(pull_batch(R_d, t_d, diags[0]))
            rolled_back = True
            b_cap = residual_b_cap(finest.final_epsilons, finest.num_points)
            vis = finest.visible_ratio
            # the new ref IS frame n-1, at identity relative pose: the
            # inter-frame velocity estimate survives the rollback
            self._dispatch_warm = self._identity()
            if self._bad_streak == 0:
                self._register_keyframe(self._prev_pyr)
        elif reason != 0 and not kf_cfg.rollback_resolve:
            # naive ref update: the current frame becomes the keyframe with
            # its (possibly bad) estimate kept
            self.gop.push_keyframe(frame_num, reason, np.asarray(R), np.asarray(t), timestamp)
            self._last_ref_frame = frame_num
            self._set_ref(pyr, targets=targets)
            if self._bad_streak == 0:
                self._register_keyframe(pyr)
            self._record(frame_num, solve_ms, finest, b_cap, vis, reason, False)
            self._prev_pyr = pyr
            self._prev_targets = targets
            return self.gop.global_pose(-1)

        R_np = np.asarray(R, np.float64)
        t_np = np.asarray(t, np.float64)
        # divergence guard: a non-finite estimate never enters the trajectory
        diverged = not (np.isfinite(R_np).all() and np.isfinite(t_np).all())
        if not diverged:
            self._R = R_np
            self._t = t_np
            # the warm pair this frame started from is its predecessor's
            # resolved pose: the constant-velocity "previous pose"
            self._prevpose = self._dispatch_warm
            self._warm = (R_d, t_d)
        else:
            self._warm = None
            self._prevpose = None
        self.gop.push_ordinary(frame_num, self._R, self._t, timestamp)
        self._record(frame_num, solve_ms, finest, b_cap, vis, reason, rolled_back, diverged)
        self._prev_pyr = pyr
        self._prev_targets = targets
        return self.gop.global_pose(-1)

    def _register_keyframe(self, pyr: FramePyramid):
        """Add the keyframe just pushed to the Gop (level 0 of `pyr`, at the
        Gop's last-keyframe pose) to the relocalization database."""
        if self._reloc is not None:
            self._reloc.add_keyframe(pyr.gray[0][0], pyr.depth[0][0], self.gop.last_key_R,
                                     self.gop.last_key_t, node=self.gop.last_key_index)

    def _relocalized(self, pyr, targets, timestamp, frame_num, res, finest, b_cap, vis, t_start):
        """Re-anchor at a recovered global pose: the current frame becomes the
        reference keyframe (REASON_RELOCALIZED) at the PnP-verified pose,
        tracking resumes from identity, and the frame joins the database.
        The discarded solve's diagnostics are still recorded."""
        solve_ms = (time.perf_counter() - t_start) * 1000.0
        self._last_ref_frame = frame_num
        self._set_ref(pyr, targets=targets)
        self.gop.push_keyframe_absolute(frame_num, REASON_RELOCALIZED, res.R, res.t, timestamp)
        self._bad_streak = 0
        self._register_keyframe(pyr)
        self._record(frame_num, solve_ms, finest, b_cap, vis, REASON_RELOCALIZED, False)
        self._prev_pyr = pyr
        self._prev_targets = targets
        return self.gop.global_pose(-1)

    def _set_ref(self, pyr: FramePyramid, targets=None):
        """Make `pyr` the reference keyframe; with its now-targets at hand
        their edge maps feed extraction directly (bit-identical)."""
        edges = tuple(t.edges for t in targets) if targets is not None else None
        self._ref_feats = edge_dvo.extract_ref_features(
            pyr.gray, pyr.depth, self.intr, self.cfg.solver, self._max_pts, edges_pyr=edges
        )
        self._R = np.eye(3)
        self._t = np.zeros(3)
        self._warm = self._identity()
        # a keyframe switch re-bases the relative poses: velocity evidence
        # in the old basis is dropped (the rollback restores it at once)
        self._prevpose = None

    def _identity(self):
        """Identity pose (1, 3, 3), (1, 3) made on the device."""
        return (
            torch.eye(3, dtype=torch.float32, device=self.device)[None],
            torch.zeros((1, 3), dtype=torch.float32, device=self.device),
        )

    def _record(self, frame_num, solve_ms, finest: _Finest, b_cap, vis, reason, rolled_back,
                diverged=False):
        keep = self.keep_residuals
        self.metrics.append(
            FrameMetrics(
                frame_num=frame_num,
                solve_ms=solve_ms,
                best_energy=finest.best_energy,
                best_iter=finest.best_iter,
                visible_ratio=vis,
                b_cap=b_cap,
                num_points=finest.num_points,
                keyframe_reason=reason,
                rolled_back=rolled_back,
                energy_curve=finest.energy,
                diverged=diverged,
                final_epsilons=finest.final_epsilons if keep else None,
                final_valid=finest.final_valid if keep else None,
            )
        )

    # ------------------------------------------------------------------
    def keyframe_cloud(self):
        """(points (M,3) float64 metres in the current reference keyframe's
        camera frame, its trajectory node): the finest-level edge points the
        solver extracted, the semi-dense map primitive
        (`viz.pointcloud.compose_map`). One device->host copy per call."""
        f = self._ref_feats[0]
        pts = f.pts3d[0][f.valid[0]].cpu().numpy().astype(np.float64)
        return pts, self.gop.keyframe_indices()[-1]

    def sync_reloc_db(self) -> int:
        """Refresh the relocalization database's global poses from the
        current (refined) trajectory; the number refreshed (0 without
        relocalization)."""
        if self._reloc is None:
            return 0
        return self._reloc.update_poses(self.gop)

    def pose_information(self):
        """(info (6,6) float64, sigma2, n_eff) of the last resolved frame at
        its relative pose against the current reference keyframe, on the
        finest level over all points (`edge_dvo.pose_information`); None
        before the second frame. One extra pass, paid only when called."""
        if self._prev_targets is None:
            return None
        f32 = dict(dtype=torch.float32, device=self.device)
        info, sigma2, n_eff = edge_dvo.pose_information(
            self._ref_feats[0], self._prev_targets[0], self.intr.at_level(0), self.cfg.solver,
            torch.as_tensor(self._R, **f32)[None], torch.as_tensor(self._t, **f32)[None],
        )
        host = torch.cat([info[0].reshape(-1), sigma2, n_eff]).cpu().numpy()
        return host[:36].reshape(6, 6).astype(np.float64), float(host[36]), float(host[37])

    # ------------------------------------------------------------------
    # checkpoint hooks (utils/checkpoint.py)
    def checkpoint_state(self) -> dict:
        """The streaming state a checkpoint keeps, on the host: counters, the
        relative pose (float64), the constant-velocity previous pose (float32
        (3,3), (3,), or None), the lost-frame streak, the keyframe features
        per level (RefLevel of numpy arrays, batch axis dropped) and the
        previous frame's pyramid (per-level (H, W) gray and depth)."""
        host = lambda x: x[0].cpu().numpy()  # noqa: E731
        prev = None if self._prevpose is None else tuple(host(x) for x in self._prevpose)
        feats = None if self._ref_feats is None else tuple(
            type(f)(*(host(x) for x in f)) for f in self._ref_feats)
        pyr = None if self._prev_pyr is None else tuple(
            tuple(host(x) for x in level) for level in (self._prev_pyr.gray, self._prev_pyr.depth))
        return {"frame_num": self._frame_num, "last_ref_frame": self._last_ref_frame,
                "R": self._R, "t": self._t, "prev_pose": prev, "bad_streak": self._bad_streak,
                "ref_feats": feats, "prev_pyr": pyr}

    def restore_checkpoint_state(self, frame_num: int, last_ref_frame: int, R, t, prev_pose,
                                 bad_streak: int, ref_feats, prev_pyr) -> None:
        """Set the state `checkpoint_state` returned (numpy arrays, on this
        driver's device) and rebuild what derives from it: the previous
        frame's targets from its pyramid (the kernels are deterministic, so
        they are bitwise the ones the interrupted run held), and the warm
        start, uploaded from (R, t) on the next frame (exact: R and t are the
        float64 of the solver's float32 output)."""
        dev = lambda x: torch.from_numpy(np.array(x, order="C"))[None].to(self.device)  # noqa: E731
        self._frame_num, self._last_ref_frame = int(frame_num), int(last_ref_frame)
        self._R, self._t = np.asarray(R, np.float64), np.asarray(t, np.float64)
        self._prevpose = None if prev_pose is None else tuple(
            dev(np.asarray(x, np.float32)) for x in prev_pose)
        self._bad_streak = int(bad_streak)
        self._ref_feats = None if ref_feats is None else tuple(
            edge_dvo.RefLevel(*(dev(x) for x in f)) for f in ref_feats)
        self._warm = self._dispatch_warm = None
        self._prev_pyr = self._prev_targets = None
        if prev_pyr is not None:
            gray, depth = prev_pyr
            self._prev_pyr = FramePyramid(gray=tuple(dev(g) for g in gray),
                                          depth=tuple(dev(d) for d in depth))
            self._prev_targets = edge_dvo.prepare_now_targets(self._prev_pyr.gray,
                                                              self.cfg.solver)

    # ------------------------------------------------------------------
    def trajectory(self):
        """(T,3,3) R, (T,3) t, (T,) timestamps of the estimated global path."""
        return self.gop.poses()

    def average_solve_ms(self) -> float:
        ms = [m.solve_ms for m in self.metrics if m.frame_num > 0]
        return float(np.mean(ms)) if ms else 0.0
