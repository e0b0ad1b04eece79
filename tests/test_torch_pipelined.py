"""The port's pipelined streaming (`EdgeDvoOdometry.process_stream`) on the
CPU, on the sequences of tests/test_pipeline.py (hold), tests/test_motion_model.py
(constant velocity) and tests/test_relocalize.py (the blackout teleport with
relocalization): fed by a CPU `FrameFeeder`, it must equal the sequential
loop bit for bit, `process_pyramid` from a feeder and `process_frame` alike,
in every pose, keyframe and `FrameMetrics` field but the host-clock
`solve_ms`; and it must match the JAX package's `process_stream` to
tests/test_torch_pipeline.py's bars."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import (  # noqa: E402
    CameraConfig,
    KeyframeConfig,
    PipelineConfig,
    PyramidConfig,
    RelocalizeConfig,
    SolverConfig,
)
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from rgbd_odometry_tpu.pipeline.odometry import EdgeDvoOdometry as JaxOdometry  # noqa: E402
from rgbd_odometry_tpu.profiles import production_320  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.gop import REASON_RELOCALIZED  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
SOLVER = SolverConfig(method="gauss_newton", iterations=(50, 8, 5))
RELOC = RelocalizeConfig(enabled=True, trigger_consecutive=1, min_matches=20, min_inliers=12)
BLANK = (np.zeros((120, 160), np.float32), np.zeros((120, 160), np.float32))
# FrameMetrics fields compared bit for bit (solve_ms is the host clock)
FIELDS = ("frame_num", "best_energy", "best_iter", "visible_ratio", "b_cap", "num_points",
          "keyframe_reason", "rolled_back", "diverged", "energy_curve", "final_epsilons",
          "final_valid")


def _psis(n, step=0.004):
    ts = np.arange(n)
    return np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
                     0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts], -1).astype(np.float32)


def _config(motion_model="hold", reloc=None, **kw):
    cfg = PipelineConfig(
        camera=CAM,
        pyramid=PyramidConfig(num_levels=3, max_points=(2048, 1024, 512)),
        solver=SOLVER,
        keyframe=KeyframeConfig(**kw),
        motion_model=motion_model,
    )
    return cfg if reloc is None else dataclasses.replace(cfg, relocalize=reloc)


def _case(name):
    """(frames, config) of tests/test_pipeline.py::test_pipelined_stream_matches_sequential_exactly,
    tests/test_motion_model.py::test_cv_streaming_matches_sequential_exactly and
    tests/test_relocalize.py::test_reloc_streaming_matches_sequential_exactly."""
    if name == "hold":
        return render_sequence(CAM, _psis(12), seed=0)[0], _config()
    if name == "constant_velocity":
        return (render_sequence(CAM, _psis(12), seed=1)[0],
                _config("constant_velocity", force_every=5, rollback_resolve=True))
    frames_a, _ = render_sequence(CAM, _psis(6, step=0.012), seed=0)
    frames_b, _ = render_sequence(CAM, _psis(4, step=0.002), seed=0)
    return (list(frames_a) + [BLANK] * 3 + list(frames_b),
            _config(reloc=RELOC, force_every=5, enable_quality_triggers=True,
                    rollback_resolve=True))


def _source(frames):
    return ((g, d, float(i)) for i, (g, d) in enumerate(frames))


def _odometry(cfg):
    odo = EdgeDvoOdometry(cfg, device="cpu")
    odo.keep_residuals = True
    return odo


@pytest.fixture(scope="module", params=["hold", "constant_velocity", "relocalize"])
def three_ways(request):
    """The same frames through `process_frame`, `process_pyramid` from a CPU
    feeder and `process_stream` from a CPU feeder."""
    frames, cfg = _case(request.param)
    levels = cfg.pyramid.num_levels
    seq = _odometry(cfg)
    for g, d, ts in _source(frames):
        seq.process_frame(g, d, ts)
    fed = _odometry(cfg)
    for pyr, ts in FrameFeeder(_source(frames), num_levels=levels, device="cpu"):
        fed.process_pyramid(pyr, ts)
    pipe = _odometry(cfg)
    poses = list(pipe.process_stream(FrameFeeder(_source(frames), num_levels=levels,
                                                 device="cpu")))
    return request.param, frames, seq, fed, pipe, poses


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_process_stream_is_bitwise_the_sequential_loop(three_ways):
    name, frames, seq, fed, pipe, poses = three_ways
    assert len(poses) == len(frames) == len(pipe.metrics)
    R1, t1, ts1 = seq.trajectory()
    for other in (fed, pipe):
        R2, t2, ts2 = other.trajectory()
        assert _same(R1, R2) and _same(t1, t2) and _same(ts1, ts2)
        assert [e.reason for e in seq.gop.elements] == [e.reason for e in other.gop.elements]
        assert seq.gop.keyframe_indices() == other.gop.keyframe_indices()
        for m1, m2 in zip(seq.metrics, other.metrics, strict=True):
            for f in FIELDS:
                assert _same(getattr(m1, f), getattr(m2, f)), (name, m1.frame_num, f)
    # each yielded pose is the trajectory's global pose of that frame
    Rg, tg = zip(*poses)
    assert _same(np.stack(tg), t1) and _same(np.stack(Rg), R1)
    # the chain broke at every keyframe decided at a frame with a successor:
    # the speculation was discarded and launched again there
    switches = sum(m.keyframe_reason != 0 for m in list(seq.metrics)[1:-1])
    assert switches >= 1 and pipe.discarded_dispatches >= switches
    if name == "relocalize":
        assert REASON_RELOCALIZED in [e.reason for e in pipe.gop.elements]
        assert pipe._reloc.successes == seq._reloc.successes >= 1
    if name == "constant_velocity":
        assert sum(m.rolled_back for m in pipe.metrics) >= 1


def test_process_stream_matches_jax():
    """The port's `process_stream` against JAX's on the rollback sequence of
    tests/test_torch_pipeline.py (production semantics, keyframe every 5):
    the same keyframes and rollbacks, positions within 2e-3 m."""
    frames, _ = render_sequence(CAM, _psis(12), seed=1)
    cfg = dataclasses.replace(
        _config(force_every=5, rollback_resolve=True),
        solver=dataclasses.replace(production_320().solver, iterations=(18, 6, 4)))
    port = EdgeDvoOdometry(cfg, device="cpu")
    list(port.process_stream(FrameFeeder(_source(frames), num_levels=3, device="cpu")))
    jax_ = JaxOdometry(cfg)
    list(jax_.process_stream(
        (jax_build_pyramid(jnp.asarray(g), jnp.asarray(d), 3), float(i))
        for i, (g, d) in enumerate(frames)))
    assert port.gop.keyframe_indices() == jax_.gop.keyframe_indices()
    assert [m.rolled_back for m in port.metrics] == [m.rolled_back for m in jax_.metrics]
    assert [m.frame_num for m in port.metrics] == list(range(len(frames)))
    _, t_p, _ = port.trajectory()
    _, t_j, _ = jax_.trajectory()
    assert np.abs(t_p - t_j).max() < 2e-3
