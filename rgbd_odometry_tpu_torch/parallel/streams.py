"""N independent odometry streams in lockstep, over the ranks of a process
group: port of `rgbd_odometry_tpu/parallel/streams.MultiStreamOdometry`.

One camera stream per batch slot; every step advances all N streams by one
frame with batched work: the N frames staged in one pinned buffer and sent
to the card in one asynchronous copy, then one frame step
(`pipeline/step.py`, JAX's jitted `_one` / `_one_cv` under `vmap`): the
pyramid build, one `prepare_now_targets` (one `canny_pyramid` call, one
`dt_pyramid` call over every level) and one `solve_pyramid` (one `level_lm` or
`level_sg` launch, under every configuration), each at B = N, and ONE
device-to-host copy for every stream's control decisions, replayed on a
card as one CUDA graph from a ring of 2 slots. `graphs=False` takes the
uncaptured route (the same work op by op into fresh tensors, from a
pageable copy), which the tests hold the step against bit for bit.

Keyframe semantics are the single-stream odometry's naive ref update (the
reference's __OLD__REF_UPDATE): the periodic refresh and the per-stream
quality triggers (Laplacian b-hat, visibility, reprojected-point count, in
`EdgeDvoOdometry`'s predicate order) make the current frame the stream's
reference. When any stream refreshes, one `extract_pyramid` call (one
launch) re-extracts every stream from the step's own edge maps and a
masked `torch.where` swaps the new features into the flagged streams only.
The rollback re-solve and relocalization are per-stream divergent control
paths and are rejected at construction.

Warm-start poses stay on the device between steps; the host keeps each
stream's trajectory (`Gop`) in float64 and a mirror of its relative pose
for the divergence guard. Both motion models are supported: "hold" and
"constant_velocity" (extrapolation on the device by the last inter-frame
motion; a stream whose pose basis changed at a refresh, or that diverged,
drops its velocity evidence for one frame).

The JAX version shards the stream axis over a device mesh. Here a `Mesh`
(`parallel/mesh.py`) of W ranks splits the N streams into W contiguous
blocks: rank r owns streams [r N/W, (r+1) N/W) and runs the step above on
them alone, at B = N/W on its own device. Streams never exchange data, so
no collective runs inside a step; `all_gops` and `trajectories` gather the
host bookkeeping of every stream once, at the end of a run.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import PipelineConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
from rgbd_odometry_tpu_torch.parallel.mesh import Mesh, local_mesh
from rgbd_odometry_tpu_torch.pipeline.gop import (
    REASON_FIRST_FRAME,
    REASON_LAPLACIAN_THRESH,
    REASON_LOW_VISIBILITY,
    REASON_PERIODIC,
    REASON_TOO_FEW_REPROJECTIONS,
    Gop,
)
from rgbd_odometry_tpu_torch.pipeline.odometry import (
    PendingPull,
    cv_extrapolate,
    finish_pull,
    pull_batch,
    residual_b_cap,
)
from rgbd_odometry_tpu_torch.pipeline.step import FrameStep, level_shapes
from rgbd_odometry_tpu_torch.solvers import edge_dvo


def _merge(old, new, mask: torch.Tensor):
    """Per stream: `new` where `mask` (N,) is set, else `old`, for every
    tensor of two equal (named) tuples, nested, with a leading stream axis."""
    if isinstance(old, torch.Tensor):
        return torch.where(mask.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)
    merged = [_merge(a, b, mask) for a, b in zip(old, new)]
    return type(old)(*merged) if hasattr(old, "_fields") else tuple(merged)


class MultiStreamOdometry:
    """N lockstep odometry streams. Each stream is an independent camera;
    streams never exchange data. With a `mesh` of W ranks, `n_streams` must
    be a multiple of W and this rank owns streams [lo, hi) on the mesh's
    device; without one (the world-1 `local_mesh(device)`) it owns them all
    on `device`. `gops` and `diverged_frames` (frame, global stream) are
    this rank's streams'. `graphs=False` takes the uncaptured route
    (module docstring)."""

    def __init__(self, n_streams: int, config: Optional[PipelineConfig] = None, device=None,
                 mesh: Optional[Mesh] = None, graphs: bool = True):
        self.cfg = config or PipelineConfig()
        kf = self.cfg.keyframe
        if kf.rollback_resolve:
            raise ValueError(
                "MultiStreamOdometry implements the __OLD__REF_UPDATE keyframe variant "
                "(current frame becomes the reference, synchronized PERIODIC refresh + "
                "per-stream quality triggers via masked batched re-extraction). "
                "rollback_resolve (__NEW__REF_UPDATE, promote frame n-1 + re-solve) "
                "desynchronizes the lockstep; use EdgeDvoOdometry per stream when it is "
                "required."
            )
        if self.cfg.relocalize.enabled:
            raise ValueError(
                "MultiStreamOdometry does not support relocalization: a recovery re-anchor "
                "is a per-stream divergent control path (host-driven candidate verification) "
                "that breaks the one-batch step. Use EdgeDvoOdometry per stream when "
                "relocalization is required."
            )
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if mesh is None:
            mesh = local_mesh(device)
        elif device is not None:
            raise ValueError("MultiStreamOdometry: give a device or a mesh (the streams run on "
                             "its device), not both")
        if n_streams % mesh.world_size:
            raise ValueError(
                f"n_streams={n_streams} not a multiple of mesh size {mesh.world_size}")
        edge_dvo.check_config(self.cfg.solver)
        self.mesh, self.device = mesh, mesh.device
        self.n_streams = int(n_streams)
        rows = mesh.rows(self.n_streams)
        self.lo, self.hi = rows.start, rows.stop
        self.n = self.hi - self.lo  # this rank's streams
        self.intr = Intrinsics.from_config(self.cfg.camera)
        self.gops: List[Gop] = [Gop() for _ in range(self.n)]
        self.diverged_frames: List[Tuple[int, int]] = []  # (frame, stream)
        pyr = self.cfg.pyramid
        self._max_pts = tuple(pyr.max_points[: pyr.num_levels])
        self._frame_num = -1
        # per-stream last reference frame (quality triggers desynchronize it)
        self._last_ref = np.zeros(self.n, np.int64)
        self._ref_feats = None
        self._warm = None  # device (N,3,3), (N,3)
        # constant velocity: the warm pair of the previous step (N streams);
        # None = no velocity evidence yet (the warm pair stands in)
        self._cv = self.cfg.motion_model == "constant_velocity"
        self._prev = None
        # host mirror of each stream's relative pose, float64 (divergence guard)
        self._R = np.tile(np.eye(3), (self.n, 1, 1))
        self._t = np.zeros((self.n, 3))
        self._graphs = bool(graphs)
        self._steps: dict = {}  # level shapes -> FrameStep

    def _identity(self):
        """Identity poses (N,3,3), (N,3) made on the device."""
        return (torch.eye(3, dtype=torch.float32, device=self.device).repeat(self.n, 1, 1),
                torch.zeros((self.n, 3), dtype=torch.float32, device=self.device))

    def _upload(self, R: np.ndarray, t: np.ndarray):
        f32 = dict(dtype=torch.float32, device=self.device)
        return torch.as_tensor(R, **f32), torch.as_tensor(t, **f32)

    def process_batch(self, gray0_b: np.ndarray, depth0_b: np.ndarray,
                      timestamp: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        """Advance every stream by one frame: `gray0_b` (N, H, W) level-0
        gray and `depth0_b` (N, H, W) depth in mm, one frame per stream of
        all N (the same call on every rank; this rank uploads its rows).
        Returns this rank's streams' global poses (R (n,3,3), t (n,3))
        after this frame."""
        self._frame_num += 1
        scfg, kf = self.cfg.solver, self.cfg.keyframe
        if len(gray0_b) != self.n_streams or len(depth0_b) != self.n_streams:
            raise ValueError(f"process_batch: {len(gray0_b)} frames for {self.n_streams} streams")
        frame = (gray0_b[self.lo:self.hi], depth0_b[self.lo:self.hi])
        if self._graphs:
            return self._graph_batch(frame, timestamp)
        host = np.stack([np.asarray(x, np.float32) for x in frame])
        frames = torch.from_numpy(host).to(self.device)  # one host-to-device copy
        pyr = build_pyramid(frames[0], frames[1], self.cfg.pyramid.num_levels)

        if self._frame_num == 0:
            return self._bootstrap(pyr, timestamp)

        dispatch_warm = self._warm
        R0, t0 = self._warm
        if self._cv:
            R0, t0 = cv_extrapolate(R0, t0, *(self._prev if self._prev is not None else self._warm))
        targets = edge_dvo.prepare_now_targets(pyr.gray, scfg)
        R_d, t_d, diags = edge_dvo.solve_pyramid(self._ref_feats, targets, self.intr, scfg, R0, t0)
        # ONE device->host copy for every stream's control decisions
        pulled = pull_batch(R_d, t_d, diags[0] if kf.enable_quality_triggers else None)
        return self._advance(pyr, targets, R_d, t_d, pulled, dispatch_warm, timestamp)

    def _graph_batch(self, frame, timestamp: float):
        """`process_batch` through the frame step: the frames staged into
        the next slot and sent in one asynchronous copy; a solved step one
        graph replay and one wait on its event."""
        step = self._frame_step(np.shape(frame[0])[-2:])
        s = step.slot()
        if self._frame_num == 0:
            step.stage(s, frame)
            return self._bootstrap(build_pyramid(s.frame[0], s.frame[1],
                                                 self.cfg.pyramid.num_levels), timestamp)
        dispatch_warm = self._warm
        step.load(s, self._ref_feats, self._warm, self._prev, frame=frame)
        out = step.run(s)
        pulled = finish_pull(PendingPull(s.row, s.event, step.pull_iters, step.pull_points))
        return self._advance(out.pyr, out.targets, out.R, out.t, pulled, dispatch_warm, timestamp)

    def _frame_step(self, hw) -> FrameStep:
        """The frame step for frames of (H, W) `hw` (made on first use)."""
        levels = level_shapes(hw, self.cfg.pyramid.num_levels)
        if levels not in self._steps:
            self._steps[levels] = FrameStep(
                self.cfg.solver, self.intr, self.device, self.n, levels, self._max_pts, self._cv,
                self.cfg.keyframe.enable_quality_triggers, "frame", 2)
        return self._steps[levels]

    def prepare(self) -> Optional[FrameStep]:
        """Make and capture now the frame step for frames of the configured
        camera, as the first solved step would: set-up to take out of a
        timed loop, and what a caller does before a profiler starts
        recording (a capture while one records raises). Returns the step
        (None on the uncaptured route)."""
        if not self._graphs:
            return None
        step = self._frame_step((self.cfg.camera.height, self.cfg.camera.width))
        step.capture()
        return step

    def _bootstrap(self, pyr, timestamp: float):
        """Frame 0: every stream's reference features from its own frame."""
        self._ref_feats = edge_dvo.extract_ref_features(
            pyr.gray, pyr.depth, self.intr, self.cfg.solver, self._max_pts)
        self._last_ref[:] = 0
        self._warm = self._identity()
        for g in self.gops:
            g.push_keyframe(0, REASON_FIRST_FRAME, np.eye(3), np.zeros(3), timestamp)
        return self._global_poses()

    def _advance(self, pyr, targets, R_d, t_d, pulled, dispatch_warm, timestamp: float):
        """The host's part of a solved step: the divergence guard, every
        stream's keyframe decision, the masked re-extraction and the next
        warm pairs, from the step's device outputs and their pulled copy."""
        scfg, kf = self.cfg.solver, self.cfg.keyframe
        R = pulled.R.astype(np.float64)
        t = pulled.t.astype(np.float64)
        finite = np.isfinite(R).all(axis=(1, 2)) & np.isfinite(t).all(axis=1)
        for s in np.nonzero(~finite)[0]:
            # failure containment per stream: keep the previous relative pose
            R[s], t[s] = self._R[s], self._t[s]
            self.diverged_frames.append((self._frame_num, self.lo + int(s)))
        self._R, self._t = R, t

        # per-stream keyframe decision, EdgeDvoOdometry._resolve's predicate order
        reasons = np.zeros(self.n, np.int64)
        if kf.enable_quality_triggers:
            for s in range(self.n):
                if residual_b_cap(pulled.final_epsilons[s], pulled.num_points[s]) \
                        > kf.laplacian_b_thresh:
                    reasons[s] = REASON_LAPLACIAN_THRESH
                if float(pulled.visible_ratio[s]) < kf.min_visible_ratio:
                    reasons[s] = REASON_LOW_VISIBILITY
                if int(pulled.final_valid[s].sum()) < kf.min_reprojected_pts:
                    reasons[s] = REASON_TOO_FEW_REPROJECTIONS
        reasons[(self._frame_num - self._last_ref) == kf.force_every] = REASON_PERIODIC

        refresh = reasons != 0
        for s in range(self.n):
            if refresh[s]:
                # the solved pose becomes the keyframe edge; the current
                # frame becomes the stream's reference
                self.gops[s].push_keyframe(self._frame_num, int(reasons[s]), R[s], t[s], timestamp)
                self._last_ref[s] = self._frame_num
                self._R[s] = np.eye(3)
                self._t[s] = np.zeros(3)
            else:
                self.gops[s].push_ordinary(self._frame_num, R[s], t[s], timestamp)

        if refresh.any():
            # ONE re-extraction of every stream from this step's edge maps;
            # the flagged streams swap their features in, the rest keep theirs
            new_feats = edge_dvo.extract_ref_features(
                pyr.gray, pyr.depth, self.intr, scfg, self._max_pts,
                edges_pyr=tuple(tg.edges for tg in targets))
            mask = torch.from_numpy(refresh).to(self.device)
            self._ref_feats = _merge(self._ref_feats, new_feats, mask)
            if finite.all():
                self._warm = _merge((R_d, t_d), self._identity(), mask)
            else:
                self._warm = self._upload(self._R, self._t)
        elif finite.all():
            # stays on the device, no upload: the step's slot outputs, read by
            # the next step's load and (as its `_prev`) the one after, within
            # the ring of 2
            self._warm = (R_d, t_d)
        else:
            self._warm = self._upload(R, t)
        if self._cv:
            # the next step's velocity source is the warm pair this step
            # started from; refreshed or diverged streams drop it (their
            # warm pair stands in, so the extrapolation holds for one frame)
            drop = refresh | ~finite
            if drop.any():
                self._prev = _merge(dispatch_warm, self._warm,
                                    torch.from_numpy(drop).to(self.device))
            else:
                self._prev = dispatch_warm
        return self._global_poses()

    def frame_steps(self) -> tuple:
        """The frame steps made so far (for their capture times and pool
        sizes)."""
        return tuple(self._steps.values())

    def _global_poses(self) -> Tuple[np.ndarray, np.ndarray]:
        poses = [g.global_pose(-1) for g in self.gops]
        return np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses])

    def all_gops(self) -> List[Gop]:
        """Every stream's `Gop`, all N in stream order, on every rank. A
        collective with a mesh of a process group: every rank must call
        it; one `all_gather_object` of the ranks' host objects."""
        if self.mesh.group is None:
            return list(self.gops)
        import torch.distributed as dist

        parts = [None] * self.mesh.world_size
        dist.all_gather_object(parts, self.gops, group=self.mesh.group)
        return [g for part in parts for g in part]

    def trajectories(self) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per-stream (R (T,3,3), t (T,3), timestamps) absolute
        trajectories of all N streams, on every rank: a collective with a
        mesh of a process group (`all_gops`)."""
        return [g.poses() for g in self.all_gops()]
