"""The PyTorch port's lockstep N-stream odometry (`parallel/streams.py`) on the
CPU, at tests/test_multistream.py's size (160x120, 2 levels): against the
port's own single-stream `EdgeDvoOdometry` per stream (hold and constant
velocity), against the JAX package's `MultiStreamOdometry` on a one-device
CPU mesh, the per-stream quality trigger, the rejected policies and the
`multistream` command.

Keyframe schedules must be exact. Poses use the JAX test's bars: 5e-3 for
hold and 1e-2 for constant velocity, since on the CPU the plain versions'
batched reductions need not be bitwise across batch sizes; measured here,
lockstep and single streams agree to the last bit in both motion models
and the port stays within 6.0e-4 (hold) and 9.0e-4 (constant velocity) of
JAX's lockstep."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from rgbd_odometry_tpu.config import (  # noqa: E402
    CameraConfig,
    KeyframeConfig,
    PipelineConfig,
    PyramidConfig,
    SolverConfig,
)
from rgbd_odometry_tpu_torch.io.synthetic import render_pair, render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402

torch.set_num_threads(1)

CAM = CameraConfig(width=160, height=120, fx=176.0, fy=176.0, cx=79.5, cy=59.5)
N_STREAMS = 3
N_FRAMES = 7  # crosses the periodic refresh at frame 5


def _config(**kw):
    keyframe = dict(force_every=5, enable_quality_triggers=False, rollback_resolve=False)
    keyframe.update(kw)
    return PipelineConfig(
        camera=CAM,
        pyramid=PyramidConfig(num_levels=2, max_points=(768, 384)),
        solver=SolverConfig(method="gauss_newton", iterations=(8, 6)),
        keyframe=KeyframeConfig(**keyframe),
    )


def _twists(amp, n):
    phase = np.sin(np.pi * np.arange(n) / (n - 1))
    return np.stack([amp * phase, -0.5 * amp * phase, 0.3 * amp * phase,
                     0.2 * amp * phase, -0.15 * amp * phase, 0.1 * amp * phase],
                    -1).astype(np.float32)


def _linear(step, n):
    ts = np.arange(n)
    return np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
                     0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts], -1).astype(np.float32)


@pytest.fixture(scope="module")
def sequences():
    return [render_sequence(CAM, _twists(0.02 + 0.004 * s, N_FRAMES), seed=s)[0]
            for s in range(N_STREAMS)]


def _lockstep(multi, seqs):
    for f in range(len(seqs[0])):
        multi.process_batch(np.stack([sq[f][0] for sq in seqs]),
                             np.stack([sq[f][1] for sq in seqs]), timestamp=f / 30.0)
    return multi


def _single(cfg, frames):
    odo = EdgeDvoOdometry(cfg, device="cpu")
    for f, (g, d) in enumerate(frames):
        odo.process_frame(g, d, timestamp=f / 30.0)
    return odo


def _max_pose_diff(traj_a, traj_b) -> float:
    (Ra, ta, _), (Rb, tb, _) = traj_a, traj_b
    return float(max(np.abs(Ra - Rb).max(), np.abs(ta - tb).max()))


@pytest.fixture(scope="module")
def hold_run(sequences):
    return _lockstep(MultiStreamOdometry(N_STREAMS, _config(), device="cpu"), sequences)


def _cv_config():
    return dataclasses.replace(_config(), motion_model="constant_velocity")


@pytest.fixture(scope="module")
def cv_sequences():
    return [render_sequence(CAM, _linear(0.004 + 0.0008 * s, N_FRAMES), seed=10 + s)[0]
            for s in range(N_STREAMS)]


@pytest.fixture(scope="module")
def cv_run(cv_sequences):
    return _lockstep(MultiStreamOdometry(N_STREAMS, _cv_config(), device="cpu"), cv_sequences)


def test_lockstep_matches_single_streams_hold(hold_run, sequences):
    """Each lockstep stream against its own `EdgeDvoOdometry` run: the same
    keyframes and frame count, poses within 5e-3 (measured here: equal to
    the last bit)."""
    for s in range(N_STREAMS):
        single = _single(_config(), sequences[s])
        assert hold_run.gops[s].keyframe_indices() == single.gop.keyframe_indices() == [0, 5]
        traj = hold_run.trajectories()[s]
        assert len(traj[2]) == len(single.trajectory()[2]) == N_FRAMES
        assert _max_pose_diff(traj, single.trajectory()) <= 5e-3, s
    assert not hold_run.diverged_frames


def test_lockstep_constant_velocity_matches_single_streams(cv_run, cv_sequences):
    """Constant velocity on fast linear motion: the same keyframes, poses
    within 1e-2 of each stream's single-stream run (measured here: equal to
    the last bit); the velocity state is live after the refresh."""
    assert cv_run._prev is not None
    for s in range(N_STREAMS):
        single = _single(_cv_config(), cv_sequences[s])
        assert cv_run.gops[s].keyframe_indices() == single.gop.keyframe_indices()
        assert _max_pose_diff(cv_run.trajectories()[s], single.trajectory()) <= 1e-2, s
    assert not cv_run.diverged_frames


@pytest.mark.parametrize("motion_model, bar", [("hold", 5e-3), ("constant_velocity", 1e-2)])
def test_lockstep_matches_jax_lockstep(motion_model, bar, request):
    """The JAX `MultiStreamOdometry` on a one-device CPU mesh, the same
    frames and configuration: the same keyframe schedule per stream, poses
    within the JAX test's bar (measured here: 6.0e-4 at most in hold and
    9.0e-4 in constant velocity, the port's single-stream distance from
    JAX's). Constant velocity runs fast
    linear motion across the frame-5 refresh, so the velocity merge of the
    refreshed streams is held against JAX's."""
    from rgbd_odometry_tpu.parallel.mesh import make_mesh
    from rgbd_odometry_tpu.parallel.streams import MultiStreamOdometry as JaxMulti

    if motion_model == "hold":
        cfg, seqs, run = _config(), request.getfixturevalue("sequences"), "hold_run"
    else:
        cfg, seqs, run = _cv_config(), request.getfixturevalue("cv_sequences"), "cv_run"
    port = request.getfixturevalue(run)
    jm = _lockstep(JaxMulti(make_mesh(np.asarray(jax.devices()[:1])), N_STREAMS, cfg), seqs)
    for s in range(N_STREAMS):
        assert port.gops[s].keyframe_indices() == jm.gops[s].keyframe_indices() == [0, 5], s
        assert _max_pose_diff(port.trajectories()[s], jm.trajectories()[s]) <= bar, s
    assert port.diverged_frames == jm.diverged_frames


def test_quality_trigger_fires_on_one_stream():
    """A scene cut in one stream refreshes that stream alone, for a quality
    reason, with the keyframes its single-stream run takes; the other
    streams keep their first keyframe only."""
    n_frames, cut_stream, cut_frame = 8, 1, 4
    cfg = _config(force_every=50, enable_quality_triggers=True, laplacian_b_thresh=10.0)
    seqs = [list(render_sequence(CAM, _twists(0.006 + 0.0015 * s, n_frames), seed=s)[0])
            for s in range(N_STREAMS)]
    for f in range(cut_frame, n_frames):
        seqs[cut_stream][f] = render_pair(CAM, np.zeros(6, np.float32), seed=91 + f)[0]
    multi = _lockstep(MultiStreamOdometry(N_STREAMS, cfg, device="cpu"), seqs)
    cut = multi.gops[cut_stream]
    assert any(k >= cut_frame for k in cut.keyframe_indices()), cut.keyframe_indices()
    assert all(e.reason in (1, 2, 3, 4) for e in cut.elements if e.is_keyframe)
    for s in range(N_STREAMS):
        if s != cut_stream:
            assert multi.gops[s].keyframe_indices() == [0], s
    single = _single(cfg, seqs[cut_stream])
    assert single.gop.keyframe_indices() == cut.keyframe_indices()


def test_rejects_desynchronizing_policies():
    cfg = _config()
    rollback = dataclasses.replace(cfg, keyframe=dataclasses.replace(cfg.keyframe,
                                                                     rollback_resolve=True))
    with pytest.raises(ValueError, match="lockstep"):
        MultiStreamOdometry(2, rollback, device="cpu")
    from rgbd_odometry_tpu.config import RelocalizeConfig

    reloc = dataclasses.replace(cfg, relocalize=RelocalizeConfig(enabled=True))
    with pytest.raises(ValueError, match="relocalization"):
        MultiStreamOdometry(2, reloc, device="cpu")
    with pytest.raises(ValueError, match="n_streams"):
        MultiStreamOdometry(0, cfg, device="cpu")


def test_cli_multistream(tmp_path, capsys):
    """`multistream --device cpu` prints the JAX command's JSON keys (one
    device), tracks every stream within 2 cm and writes one TUM file a
    stream."""
    from rgbd_odometry_tpu_torch.cli import main

    od = str(tmp_path / "streams")
    summary = main(["multistream", "--device", "cpu", "--streams", "2", "--frames", "6",
                    "--cam-scale", "0.5", "--iterations", "8,5", "--out-dir", od])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == ["aggregate_frames_per_s", "ate_rmse_max", "ate_rmse_per_stream",
                           "devices", "frames", "streams"]
    assert out["streams"] == 2 and out["frames"] == 6 and out["devices"] == 1
    assert out["ate_rmse_max"] < 0.02
    assert summary["keyframes"] == [[0, 5], [0, 5]]
    files = sorted(os.listdir(od))
    assert files == ["stream00.txt", "stream01.txt"]
    assert np.loadtxt(os.path.join(od, files[1]), comments="#").shape == (6, 8)
