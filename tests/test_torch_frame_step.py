"""The port's frame step (`pipeline/step.py`: the targets and pyramid solve
of a frame over a ring of slots, one CUDA graph replay a frame on a card)
on the CPU, where it runs the same functions eagerly and writes their
results into the slots' buffers in place.

* The step against the JAX package's `prepare_now_targets` +
  `solve_pyramid` (+ `cv_extrapolate`), the body of its jitted `_step` /
  `_step_cv`, on the same seeded inputs: the edge maps and the distance
  transform bitwise, the poses within tests/test_torch_pipeline.py's
  2e-3.
* `EdgeDvoOdometry` (`process_frame` and `process_stream`, hold and
  constant velocity, 30 frames with rollback re-solves) and
  `MultiStreamOdometry` (hold and constant velocity, a quality-trigger
  refresh) through the slot ring, bit for bit against the same drivers'
  uncaptured route (`graphs=False`): poses, keyframes and every
  `FrameMetrics` field but the host-clock `solve_ms`.
* The slot lifetime rule: a slot's outputs are rewritten only when the
  ring comes round, and `process_stream`, which keeps three frames alive,
  breaks its rollback on a ring of two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from rgbd_odometry_tpu.pipeline.odometry import cv_extrapolate as jax_cv  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.config import (  # noqa: E402
    CameraConfig,
    KeyframeConfig,
    PipelineConfig,
    PyramidConfig,
    SolverConfig,
)
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.geometry import se3_exp  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair, render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline import odometry, step  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo  # noqa: E402

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
PYR = PyramidConfig(num_levels=3, max_points=(2048, 1024, 512))
GN = SolverConfig(method="gauss_newton", iterations=(12, 6, 4))
SG = SolverConfig(method="subgradient", iterations=(20, 10, 10))
# FrameMetrics fields compared bit for bit (solve_ms is the host clock)
FIELDS = ("frame_num", "best_energy", "best_iter", "visible_ratio", "b_cap", "num_points",
          "keyframe_reason", "rolled_back", "diverged", "energy_curve", "final_epsilons",
          "final_valid")
POSE_BAR = 2e-3  # tests/test_torch_pipeline.py's bar on the port's poses against JAX's


def _psis(n, step=0.004):
    ts = np.arange(n)
    return np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
                     0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts], -1).astype(np.float32)


def _pose(rng, scale):
    """A small random pose as float32 numpy (R (3,3), t (3,))."""
    R, t = se3_exp(torch.from_numpy((rng.uniform(-1, 1, (1, 6)) * scale).astype(np.float32)))
    return R[0].numpy(), t[0].numpy()


# --------------------------------------------------------------------------
# the step against JAX's step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method, cv", [("gauss_newton", False), ("gauss_newton", True),
                                        ("subgradient", False)])
def test_step_matches_jax_step(method, cv):
    """Two pairs (B = 2) through one `FrameStep` ("frame": the pyramid is
    built inside the step) against JAX's `_step` / `_step_cv` body pair by
    pair: edges and DT bitwise at every level, the poses within 2e-3."""
    cfg = GN if method == "gauss_newton" else SG
    rng = np.random.default_rng(3)
    seqs = [render_sequence(CAM, _psis(3), seed=s)[0] for s in range(2)]
    ref_g = np.stack([sq[0][0] for sq in seqs]).astype(np.float32)
    ref_d = np.stack([sq[0][1] for sq in seqs]).astype(np.float32)
    now_g = np.stack([sq[2][0] for sq in seqs]).astype(np.float32)
    now_d = np.stack([sq[2][1] for sq in seqs]).astype(np.float32)
    warm = [_pose(rng, 0.004) for _ in range(2)]
    prev = [_pose(rng, 0.002) for _ in range(2)]
    intr = Intrinsics.from_config(CAM)
    ref_pyr = build_pyramid(torch.from_numpy(ref_g), torch.from_numpy(ref_d), PYR.num_levels)
    feats = edge_dvo.extract_ref_features(ref_pyr.gray, ref_pyr.depth, intr, cfg, PYR.max_points)
    levels = step.level_shapes((CAM.height, CAM.width), PYR.num_levels)
    fs = step.FrameStep(cfg, intr, "cpu", 2, levels, PYR.max_points, cv, True, "frame", 2)
    s = fs.slot()
    as_t = lambda xs: torch.from_numpy(np.stack(xs))  # noqa: E731
    fs.load(s, feats, (as_t([w[0] for w in warm]), as_t([w[1] for w in warm])),
            (as_t([p[0] for p in prev]), as_t([p[1] for p in prev])) if cv else None,
            frame=(now_g, now_d))
    out = fs.run(s)

    jintr = JIntrinsics.from_config(CAM)

    def jax_step(feats_j, gray_pyr, R0, t0, Rp, tp):
        if cv:
            R0, t0 = jax_cv(R0, t0, Rp, tp)
        tgts = jed.prepare_now_targets(gray_pyr, cfg)
        R, t, diags = jed.solve_pyramid(feats_j, tgts, jintr, cfg, R0, t0)
        return R, t, diags[0], tgts

    jstep = jax.jit(jax_step)
    for b in range(2):
        jref = jax_build_pyramid(jnp.asarray(ref_g[b]), jnp.asarray(ref_d[b]), PYR.num_levels)
        jfeats = jed.extract_ref_features(jref.gray, jref.depth, jintr, cfg, PYR.max_points)
        jnow = jax_build_pyramid(jnp.asarray(now_g[b]), jnp.asarray(now_d[b]), PYR.num_levels)
        R_j, t_j, _, tgts_j = jstep(jfeats, jnow.gray, jnp.asarray(warm[b][0]),
                                    jnp.asarray(warm[b][1]), jnp.asarray(prev[b][0]),
                                    jnp.asarray(prev[b][1]))
        for lv, (tp, tj) in enumerate(zip(out.targets, tgts_j)):
            assert np.array_equal(tp.edges[b].numpy(), np.asarray(tj.edges)), (b, lv)
            assert np.array_equal(tp.dt[b].numpy(), np.asarray(tj.dt)), (b, lv)
        assert np.abs(out.R[b].numpy() - np.asarray(R_j)).max() < POSE_BAR, b
        assert np.abs(out.t[b].numpy() - np.asarray(t_j)).max() < POSE_BAR, b
    # the pulled row carries the poses as solved, bit for bit
    row = s.row.numpy()
    assert np.array_equal(row[:, :9].reshape(2, 3, 3), out.R.numpy())
    assert np.array_equal(row[:, 9:12], out.t.numpy())


# --------------------------------------------------------------------------
# the drivers through the slot ring against their uncaptured route
# --------------------------------------------------------------------------


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _assert_same_runs(a, b):
    for x, y in zip(a.trajectory(), b.trajectory()):
        assert _same(x, y)
    assert [e.reason for e in a.gop.elements] == [e.reason for e in b.gop.elements]
    assert len(a.metrics) == len(b.metrics)
    for m1, m2 in zip(a.metrics, b.metrics):
        bad = [f for f in FIELDS if not _same(getattr(m1, f), getattr(m2, f))]
        assert not bad, (m1.frame_num, bad)


def _stream_config(motion_model):
    return PipelineConfig(camera=CAM, pyramid=PYR, solver=GN,
                          keyframe=KeyframeConfig(force_every=5, rollback_resolve=True),
                          motion_model=motion_model)


@pytest.fixture(scope="module")
def frames30():
    return render_sequence(CAM, _psis(30), seed=1)[0]


def _run(cfg, frames, entry, graphs):
    odo = EdgeDvoOdometry(cfg, device="cpu", graphs=graphs)
    odo.keep_residuals = True
    if entry == "process_frame":
        for i, (g, d) in enumerate(frames):
            odo.process_frame(g, d, float(i))
    else:
        source = ((g, d, float(i)) for i, (g, d) in enumerate(frames))
        for _pose_out in odo.process_stream(FrameFeeder(source, num_levels=PYR.num_levels,
                                                        device="cpu")):
            pass
    return odo


@pytest.mark.parametrize("entry", ["process_frame", "process_stream"])
@pytest.mark.parametrize("motion_model", ["hold", "constant_velocity"])
def test_odometry_slot_ring_is_bitwise_the_uncaptured_route(frames30, entry, motion_model):
    cfg = _stream_config(motion_model)
    ring = _run(cfg, frames30, entry, True)
    plain = _run(cfg, frames30, entry, False)
    _assert_same_runs(ring, plain)
    assert sum(m.rolled_back for m in ring.metrics) >= 5
    assert not plain.frame_steps()
    (fs,) = ring.frame_steps()
    assert len(fs.slots) == (3 if entry == "process_stream" else 2)
    if entry == "process_stream":
        assert ring.discarded_dispatches == plain.discarded_dispatches >= 5


def test_process_stream_on_two_slots_breaks_the_rollback(frames30, monkeypatch):
    """`process_stream` speculates frame n+1 before frame n's rollback reads
    frame n-1's targets: on a ring of two slots the speculation overwrites
    them, and the run leaves the uncaptured route's. (The test above holds
    the ring of three bitwise.)"""
    monkeypatch.setattr(odometry, "_STREAM_SLOTS", 2)
    cfg = _stream_config("hold")
    ring = _run(cfg, frames30[:12], "process_stream", True)
    plain = _run(cfg, frames30[:12], "process_stream", False)
    assert len(ring.frame_steps()[0].slots) == 2
    R1, t1, _ = ring.trajectory()
    R2, t2, _ = plain.trajectory()
    assert not (_same(R1, R2) and _same(t1, t2))


def test_a_slot_is_rewritten_only_when_the_ring_comes_round():
    """Three frames through a ring of two: frame 0's outputs (pyramid,
    targets, pose, pulled row) stay as they were while frame 1 runs in the
    other slot and are overwritten in place by frame 2."""
    frames = render_sequence(CAM, _psis(4), seed=2)[0]
    intr = Intrinsics.from_config(CAM)
    ref = build_pyramid(torch.from_numpy(frames[0][0])[None], torch.from_numpy(frames[0][1])[None],
                        PYR.num_levels)
    feats = edge_dvo.extract_ref_features(ref.gray, ref.depth, intr, GN, PYR.max_points)
    levels = step.level_shapes((CAM.height, CAM.width), PYR.num_levels)
    fs = step.FrameStep(GN, intr, "cpu", 1, levels, PYR.max_points, False, True, "frame", 2)
    warm = (torch.eye(3)[None], torch.zeros((1, 3)))

    def snapshot(out):
        return [x.clone() for x in (out.R, out.t, out.pyr.gray[0], out.targets[0].edges,
                                    out.targets[1].dt, out.finest.final_epsilons)]

    slots, outs, snaps = [], [], []
    for f in (1, 2, 3):
        s = fs.slot()
        fs.load(s, feats, warm, frame=frames[f])
        outs.append(fs.run(s))
        slots.append(s)
        snaps.append(snapshot(outs[-1]) + [s.row.clone()])
        if f == 2:
            # frame 1's slot is untouched by frame 2
            assert all(torch.equal(a, b) for a, b in zip(snapshot(outs[0]) + [slots[0].row],
                                                          snaps[0]))
    assert slots[2] is slots[0] and slots[1] is not slots[0]
    assert outs[2].R.data_ptr() == outs[0].R.data_ptr()
    assert outs[2].targets[0].edges.data_ptr() == outs[0].targets[0].edges.data_ptr()
    # frame 3 rewrote frame 1's slot in place: its buffers now hold frame 3
    assert all(torch.equal(a, b) for a, b in zip(snapshot(outs[0]) + [slots[0].row], snaps[2]))
    assert not torch.equal(snaps[0][3], snaps[2][3])  # the edge maps of frames 1 and 3 differ
    assert s.ref_src is feats


def test_features_are_copied_only_when_they_change():
    """`load` copies the reference features into a slot only when the
    caller's features are another object than the slot holds."""
    intr = Intrinsics.from_config(CAM)
    levels = step.level_shapes((CAM.height, CAM.width), PYR.num_levels)
    fs = step.FrameStep(GN, intr, "cpu", 1, levels, PYR.max_points, False, False, "frame", 1)
    frames = render_sequence(CAM, _psis(2), seed=0)[0]
    pyr = build_pyramid(torch.from_numpy(frames[0][0])[None],
                        torch.from_numpy(frames[0][1])[None], PYR.num_levels)
    feats = edge_dvo.extract_ref_features(pyr.gray, pyr.depth, intr, GN, PYR.max_points)
    warm = (torch.eye(3)[None], torch.zeros((1, 3)))
    s = fs.slot()
    fs.load(s, feats, warm, frame=frames[1])
    assert torch.equal(s.ref[0].pts3d, feats[0].pts3d) and s.ref_src is feats
    s.ref[0].pts3d.zero_()  # a stale copy stays stale while the features are the same object
    fs.load(s, feats, warm, frame=frames[1])
    assert not torch.any(s.ref[0].pts3d)
    fs.load(s, tuple(list(feats)), warm, frame=frames[1])  # equal features, another object
    assert torch.equal(s.ref[0].pts3d, feats[0].pts3d)
    assert s.row.shape == (1, 12)  # poses only without the diagnostics


def test_prepare_is_a_no_op_off_the_card():
    odo = EdgeDvoOdometry(_stream_config("hold"), device="cpu")
    for entry in ("process_frame", "process_pyramid", "process_stream"):
        fs = odo.prepare(entry)
        assert fs.graphs is False and all(s.graph is None for s in fs.slots)
    assert EdgeDvoOdometry(_stream_config("hold"), device="cpu", graphs=False).prepare() is None
    with pytest.raises(ValueError):
        odo.prepare("process_batch")
    multi = MultiStreamOdometry(2, _lockstep_config("hold"), device="cpu")
    fs = multi.prepare()
    assert fs.batch == 2 and fs.level_shapes == ((120, 160), (60, 80))
    assert multi.frame_steps() == (fs,) and all(s.graph is None for s in fs.slots)
    assert MultiStreamOdometry(2, _lockstep_config("hold"), device="cpu",
                               graphs=False).prepare() is None


# --------------------------------------------------------------------------
# the lockstep driver
# --------------------------------------------------------------------------


def _lockstep_config(motion_model):
    return PipelineConfig(
        camera=CAM,
        pyramid=PyramidConfig(num_levels=2, max_points=(768, 384)),
        solver=SolverConfig(method="gauss_newton", iterations=(8, 6)),
        keyframe=KeyframeConfig(force_every=5, enable_quality_triggers=True,
                                laplacian_b_thresh=10.0, rollback_resolve=False),
        motion_model=motion_model,
    )


@pytest.mark.parametrize("motion_model", ["hold", "constant_velocity"])
def test_lockstep_slot_ring_is_bitwise_the_uncaptured_route(motion_model):
    """Three streams, 8 frames, a scene cut in stream 1 from frame 4 (a
    quality-trigger refresh of that stream alone) and the periodic refresh
    at frame 5: the slot ring bitwise the uncaptured route."""
    n_frames, cut_stream, cut_frame = 8, 1, 4
    seqs = [list(render_sequence(CAM, _psis(n_frames, 0.003 + 0.001 * s), seed=s)[0])
            for s in range(3)]
    for f in range(cut_frame, n_frames):
        seqs[cut_stream][f] = render_pair(CAM, np.zeros(6, np.float32), seed=91 + f)[0]
    cfg = _lockstep_config(motion_model)
    runs = []
    for graphs in (True, False):
        multi = MultiStreamOdometry(3, cfg, device="cpu", graphs=graphs)
        for f in range(n_frames):
            multi.process_batch(np.stack([sq[f][0] for sq in seqs]),
                                np.stack([sq[f][1] for sq in seqs]), timestamp=f / 30.0)
        runs.append(multi)
    ring, plain = runs
    assert len(ring.frame_steps()[0].slots) == 2 and not plain.frame_steps()
    reasons = [[e.reason for e in g.elements] for g in ring.gops]
    assert reasons == [[e.reason for e in g.elements] for g in plain.gops]
    # a quality trigger (reasons 2-4) refreshed the cut stream
    assert any(r in (2, 3, 4) for r in reasons[cut_stream]), reasons
    for g1, g2 in zip(ring.gops, plain.gops):
        for x, y in zip(g1.poses(), g2.poses()):
            assert _same(x, y)
