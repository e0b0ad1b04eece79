"""The frame step as CUDA graphs: the port's counterpart of JAX's jitted
`_step` / `_step_cv` (`rgbd_odometry_tpu/pipeline/odometry.py:136-154`) and
of the lockstep driver's `_one` / `_one_cv` under `vmap`
(`rgbd_odometry_tpu/parallel/streams.py:143-170`).

JAX compiles a frame's targets and its whole pyramid solve into one
executable. A `FrameStep` does the same on a card with `torch.cuda.CUDAGraph`:
for one (solver configuration, batch B, level shapes, capacities, motion
model, pull contents, input kind) it holds a small ring of slots, and each
slot owns

* static inputs: the level-0 gray and depth, staged in pinned host memory
  and copied to the card (`source="frame"`), or the gray levels of a
  pyramid built elsewhere (`source="levels"`); the reference features (each
  level's `pts3d`, `valid`, `count` at the capacities); the warm pair, and
  for constant velocity the previous pose;
* static outputs: the pyramid it built, the targets, R, t and the finest
  level's diagnostics;
* one host row, pinned on a card, that a device-to-host copy of the
  packed results (`pack_results`) inside the graph fills;
* on a card one CUDA graph over the pyramid build, `cv_extrapolate`,
  `prepare_now_targets`, `solve_pyramid`, the pack and that copy.

A frame: `load` writes the inputs into the next slot (the staging by
`np.copyto`, the warm pair by `copy_`, the reference features only when
the caller's features are another object than the slot last took), `run`
replays the graph and records the slot's event, and the host waits on that
event alone (`odometry.finish_pull`). On the CPU the same object runs the
same functions eagerly and writes their results into the same slot
buffers in place, so that a lifetime fault shows in the CPU tests as a
wrong pose.

Where trouble is likely, and what is done about it:

1. Output lifetimes. A replay overwrites its slot's outputs, and the
   drivers keep outputs across frames (the warm pair, the constant-velocity
   previous pose, the previous frame's targets and pyramid that a rollback
   reads one frame later). A slot is handed out again only when the ring
   comes round (`slot`), so a driver sizes its ring by the frames it keeps
   alive at once: 2 for the sequential and lockstep drivers, 3 for
   `process_stream` (frame n-1 for the rollback, frame n being resolved,
   frame n+1 speculated). A discarded speculation replays its own slot
   again: the targets come out bitwise the same.
2. Capture preconditions (`capture`): every library is loaded through
   `build.load_all` first; a warm-up runs on a side stream at the exact
   shapes, so that the launchers' `cudaFuncSetAttribute` and
   `cudaOccupancyMaxActiveClusters` calls (`csrc/launch.cuh`) are made
   before the capture and not inside it; the wrappers' `torch.empty`
   outputs land in each slot's private pool; nothing in the captured region
   reads the host; a capture while a profiler records raises. A capture or
   replay error raises: nothing falls back to the uncaptured route.
3. Launch accounting. The wrappers count their Python calls; a replay makes
   none. The capture records each counter's delta (`counters`) and puts the
   counters back, and every replay adds the delta, so the counts stay per
   frame.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import SolverConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.core.pyramid import FramePyramid, build_pyramid
from rgbd_odometry_tpu_torch.kernels import build, canny, edt, level_lm, level_sg
from rgbd_odometry_tpu_torch.kernels.extract import RefLevel
from rgbd_odometry_tpu_torch.solvers import edge_dvo


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


def pack_results(R_d: torch.Tensor, t_d: torch.Tensor,
                 finest: Optional[edge_dvo.LevelDiagnostics] = None) -> torch.Tensor:
    """The poses of every pair, and with `finest` its diagnostics (scalars,
    energy curve, per-point residuals and visibility), as one row of
    float32 a pair: R 9, t 3, then best energy, best iteration, visible
    ratio, point count, the energy curve, the residuals, the visibility."""
    f32 = torch.float32
    b = R_d.shape[0]
    parts = [R_d.reshape(b, 9), t_d.reshape(b, 3)]
    if finest is not None:
        parts += [
            torch.stack([finest.best_energy, finest.best_iter.to(f32), finest.visible_ratio,
                         finest.num_points.to(f32)], dim=-1),
            finest.energy, finest.final_epsilons, finest.final_valid.to(f32),
        ]
    return torch.cat([p.to(f32) for p in parts], dim=1)


def level_shapes(hw, num_levels: int) -> tuple:
    """The (H, W) of each level of a pyramid built from an (H, W) level 0
    (`core/pyramid.build_pyramid`: every other row and column)."""
    h, w = (int(x) for x in hw)
    shapes = []
    for _ in range(num_levels):
        shapes.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return tuple(shapes)


# Launch tallies beside the kernel wrappers' own, for a check that counts
# more than launches (objects with an int attribute `launches`): a capture
# puts them back as it does the wrappers' counters, and a replay adds its
# delta to them too.
COUNTED: list = []


def counters() -> tuple:
    """The launch counters a frame step can move: the four kernel wrappers
    its graph calls, then `COUNTED`."""
    return (canny.canny_pyramid, edt.dt_pyramid, level_lm.level_lm_pyramid,
            level_sg.level_sg_pyramid, *COUNTED)


class StepOut(NamedTuple):
    """A slot's static outputs."""

    pyr: Optional[FramePyramid]  # the pyramid the step built ("frame" source), else None
    targets: tuple  # a `NowLevel` a level
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    finest: edge_dvo.LevelDiagnostics


class Slot:
    """One frame's buffers in a `FrameStep`'s ring."""

    def __init__(self):
        self.host: Optional[torch.Tensor] = None  # (2, B, H, W) staging ("frame")
        self.frame: Optional[torch.Tensor] = None  # (2, B, H, W) on the device ("frame")
        self.gray: Tuple[torch.Tensor, ...] = ()  # (B, H_l, W_l) a level ("levels")
        self.ref: Tuple[RefLevel, ...] = ()
        self.ref_src = None  # the features last copied in (held, so its identity stays)
        self.warm: Tuple[torch.Tensor, ...] = ()  # R0, t0, and Rp, tp for constant velocity
        self.row: Optional[torch.Tensor] = None  # (B, row) float32 host, pinned on a card
        self.out: Optional[StepOut] = None
        self.graph = None
        self.event: Optional[torch.cuda.Event] = None
        self.recorded = False  # the event was recorded by a replay not yet seen complete
        self.pool_bytes = 0  # device memory the capture reserved for this slot's pool


def _map(fn, tree):
    """`fn` on every tensor of nested (named) tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    items = [_map(fn, x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _copy_into(dst, src) -> None:
    """Write every tensor of `src` into the same place of `dst`, in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dst is not None:
        for a, b in zip(dst, src):
            _copy_into(a, b)


class FrameStep:
    """A frame's targets and pyramid solve over a ring of `slots` slots:
    for B images of `level_shapes` ((H, W) a level, finest first) against
    reference features of `capacities` points a level (at most a level's
    pixels, as extraction makes them), under `cfg`, with
    the warm pair extrapolated by `cv_extrapolate` when `cv`, and the
    finest level's diagnostics in the pulled row when `diagnostics`.
    `source` "frame" takes the level-0 gray and depth and builds the
    pyramid inside the step; "levels" takes the gray levels of a pyramid
    built elsewhere. On a CUDA `device` each slot replays a CUDA graph,
    captured for every slot at the first `run` (or at `capture`); on the
    CPU the step runs eagerly into the same buffers."""

    def __init__(self, cfg: SolverConfig, intr: Intrinsics, device, batch: int,
                 level_shapes, capacities, cv: bool, diagnostics: bool, source: str,
                 slots: int):
        if source not in ("frame", "levels"):
            raise ValueError(f"FrameStep: source must be 'frame' or 'levels', got {source!r}")
        if slots < 1:
            raise ValueError(f"FrameStep: a ring needs a slot, got {slots}")
        edge_dvo.check_config(cfg)
        self.cfg, self.intr = cfg, intr
        self.device = torch.device(device)
        self.batch = int(batch)
        self.level_shapes = tuple(tuple(int(x) for x in s) for s in level_shapes)
        # extraction's slots a level: min(capacity, pixels) (`extract_pyramid`)
        self.capacities = tuple(min(int(k), h * w)
                                for k, (h, w) in zip(capacities, self.level_shapes))
        self.cv, self.diagnostics, self.source = bool(cv), bool(diagnostics), source
        self.graphs = self.device.type == "cuda"
        self.capture_s = 0.0  # the warm-up and every slot's capture, host clock
        self._delta: List[int] = []
        self._next = 0
        # the pulled row: R 9, t 3, and with the diagnostics 4 scalars, the
        # energy curve and 2 values a point of the finest level solved
        self.pull_iters = self.pull_points = 0
        if self.diagnostics:
            iters = [cfg.iterations[lv] if lv < len(cfg.iterations) else cfg.iterations[-1]
                     for lv in range(len(self.capacities))]
            finest = next(lv for lv, n in enumerate(iters) if n > 0)
            self.pull_iters, self.pull_points = iters[finest], self.capacities[finest]
        self.row_width = 12 + (4 + self.pull_iters + 2 * self.pull_points
                               if self.diagnostics else 0)
        self.slots = [self._slot() for _ in range(slots)]

    def _slot(self) -> Slot:
        """A slot with its inputs set to a valid frame (zeros, the identity
        pose, no reference point), so a capture before the first load runs
        on defined data."""
        s = Slot()
        b, dev = self.batch, self.device
        zeros = dict(dtype=torch.float32, device=dev)
        if self.source == "frame":
            h, w = self.level_shapes[0]
            s.frame = torch.zeros((2, b, h, w), **zeros)
            s.host = (torch.zeros((2, b, h, w), dtype=torch.float32, pin_memory=True)
                      if self.graphs else s.frame)
        else:
            s.gray = tuple(torch.zeros((b, h, w), **zeros) for h, w in self.level_shapes)
        s.ref = tuple(RefLevel(pts3d=torch.zeros((b, k, 3), **zeros), uv=None,
                               valid=torch.zeros((b, k), dtype=torch.bool, device=dev),
                               count=torch.zeros((b,), dtype=torch.int32, device=dev))
                      for k in self.capacities)
        eye = torch.eye(3, **zeros).repeat(b, 1, 1)
        s.warm = (eye, torch.zeros((b, 3), **zeros))
        if self.cv:
            s.warm += (eye.clone(), torch.zeros((b, 3), **zeros))
        # allocated here: a capture may not allocate pinned memory
        s.row = torch.empty((b, self.row_width), dtype=torch.float32, pin_memory=self.graphs)
        if self.graphs:
            s.event = torch.cuda.Event()
        return s

    # ------------------------------------------------------------------
    def slot(self) -> Slot:
        """The next slot of the ring: the one used longest ago."""
        s = self.slots[self._next]
        self._next = (self._next + 1) % len(self.slots)
        return s

    def load(self, s: Slot, ref, warm, prev=None, frame=None, gray=None) -> None:
        """Write a frame's inputs into slot `s`: `frame` (gray, depth) of
        level 0 ((B, H, W) or (H, W) at B = 1; numpy, CPU or device tensors)
        or `gray` (the levels, device tensors); the reference features `ref`
        (a `RefLevel` a level), copied only when they are another object
        than the slot last took; the warm pair `warm` (R0, t0), and for
        constant velocity the previous pose `prev` (None: the warm pair
        stands in)."""
        if self.source == "frame":
            self.stage(s, frame)
        else:
            for dst, src in zip(s.gray, gray):
                dst.copy_(src)
        if s.ref_src is not ref:
            for dst, src in zip(s.ref, ref):
                dst.pts3d.copy_(src.pts3d)
                dst.valid.copy_(src.valid)
                dst.count.copy_(src.count)
            s.ref_src = ref
        pairs = tuple(warm) + (tuple(prev if prev is not None else warm) if self.cv else ())
        for dst, src in zip(s.warm, pairs):
            dst.copy_(src)

    def stage(self, s: Slot, frame) -> None:
        """The level-0 (gray, depth) into slot `s`: host data through the
        staging, written once the slot's last use of it is complete, then
        one copy to the card for both (and the slot's event after it);
        device tensors directly."""
        shape = s.frame.shape[1:]
        upload = []
        for i, x in enumerate(frame):
            if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                s.frame[i].copy_(x.reshape(shape))
                continue
            if s.recorded:
                if not s.event.query():
                    s.event.synchronize()
                s.recorded = False
            np.copyto(s.host[i].numpy(), np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                                                    else x).reshape(shape))
            upload.append(i)
        if not self.graphs or not upload:
            return
        if len(upload) == 2:
            s.frame.copy_(s.host, non_blocking=True)
        else:
            s.frame[upload[0]].copy_(s.host[upload[0]], non_blocking=True)
        s.event.record()
        s.recorded = True

    def _body(self, s: Slot) -> StepOut:
        """The step's work on slot `s`'s inputs: the pyramid ("frame"),
        the warm start, the targets, the solve, the pack and its copy to the
        slot's host row. What the graph holds."""
        pyr = None
        if self.source == "frame":
            pyr = build_pyramid(s.frame[0], s.frame[1], len(self.level_shapes))
            gray = pyr.gray
        else:
            gray = s.gray
        R0, t0 = s.warm[0], s.warm[1]
        if self.cv:
            R0, t0 = cv_extrapolate(R0, t0, s.warm[2], s.warm[3])
        targets = edge_dvo.prepare_now_targets(gray, self.cfg)
        R, t, diags = edge_dvo.solve_pyramid(s.ref, targets, self.intr, self.cfg, R0, t0)
        s.row.copy_(pack_results(R, t, diags[0] if self.diagnostics else None),
                    non_blocking=self.graphs)
        return StepOut(pyr, targets, R, t, diags[0])

    def run(self, s: Slot) -> StepOut:
        """Run the step on slot `s` as loaded: on a card replay its graph
        (capturing the ring first) and record its event; on the CPU run
        it eagerly into the slot's outputs. Returns the slot's outputs."""
        if not self.graphs:
            out = self._body(s)
            if s.out is None:
                s.out = _map(torch.clone, out)
            else:
                _copy_into(s.out, out)
            return s.out
        if s.graph is None:
            self.capture()
        with build.traced("frame_step"):
            s.graph.replay()
        for c, d in zip(counters(), self._delta):
            c.launches += d
        s.event.record()
        s.recorded = True
        return s.out

    def capture(self) -> None:
        """Capture every slot's graph (on a card; nothing on the CPU or once
        captured): the libraries loaded, one warm-up of the step on slot 0
        on a side stream, then each slot's capture into a pool of its own.
        The launch counters are put back to what they were, and each
        counter's delta over one capture is what a replay adds. Raises
        while a profiler records."""
        if not self.graphs or all(s.graph is not None for s in self.slots):
            return
        if torch.autograd._profiler_enabled():
            raise RuntimeError("FrameStep: a CUDA graph is not captured while a profiler "
                               "records; capture the step first (EdgeDvoOdometry.prepare)")
        t0 = time.perf_counter()
        build.load_all(("canny", "edt", "level_lm" if self.cfg.method == "gauss_newton"
                        else "level_sg"))
        tally = counters()
        before = [c.launches for c in tally]
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(self.slots[0])
        cur.wait_stream(side)
        # each slot on the side stream into a private pool; thread-local, so
        # that another thread's calls (a FrameFeeder pinning and copying the
        # next frame) are not refused while the capture is open
        for s in self.slots:
            mark = [c.launches for c in tally]
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            side.wait_stream(cur)
            with torch.cuda.device(self.device), torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self._body(s)
                finally:
                    graph.capture_end()
            cur.wait_stream(side)
            s.graph, s.out = graph, out
            s.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            self._delta = [c.launches - m for c, m in zip(tally, mark)]
        for c, n in zip(tally, before):
            c.launches = n
        self.capture_s = time.perf_counter() - t0
