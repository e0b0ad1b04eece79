"""Checkpoint and resume of the port (`rgbd_odometry_tpu_torch.utils.checkpoint`,
`dvo --checkpoint` / `--resume`) on the CPU at 160x120.

Bitwise to itself: a run interrupted by a checkpoint and resumed gives the
uninterrupted run's poses, keyframes, every `FrameMetrics` field but
`solve_ms`, closures and relocalizer counters, in hold and constant-velocity
modes, with loop closure, online refinement and relocalization. Across
packages: the port resumes from a `.npz` the JAX package wrote (its next
frames within tests/test_torch_pipeline.py's bars of JAX's own resumed run),
and JAX's loaders read the port's files. The four checkpoint defects of the
JAX module: each test shows the port's difference from JAX's behaviour, and
JAX's behaviour on the same file."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgbd_odometry_tpu.config import CameraConfig as JaxCameraConfig  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JaxIntrinsics  # noqa: E402
from rgbd_odometry_tpu.pipeline.odometry import EdgeDvoOdometry as JaxOdometry  # noqa: E402
from rgbd_odometry_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from rgbd_odometry_tpu_torch.cli import main  # noqa: E402
from rgbd_odometry_tpu_torch.config import (  # noqa: E402
    CameraConfig,
    KeyframeConfig,
    PipelineConfig,
    PyramidConfig,
    RelocalizeConfig,
    SolverConfig,
)
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.loop_closure import LoopCloser, LoopClosureConfig  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

torch.set_num_threads(2)

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
BLANK = (np.zeros((120, 160), np.float32), np.zeros((120, 160), np.float32))


def _psis(n, step=0.004):
    ts = np.arange(n)
    return np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
                     0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts], -1).astype(np.float32)


def _config(motion_model="hold", reloc=None, quality=False):
    return PipelineConfig(
        camera=CAM,
        pyramid=PyramidConfig(num_levels=3, max_points=(2048, 1024, 512)),
        solver=SolverConfig(method="gauss_newton", iterations=(18, 6, 4)),
        keyframe=KeyframeConfig(force_every=4, enable_quality_triggers=quality),
        relocalize=reloc or RelocalizeConfig(enabled=True),
        motion_model=motion_model,
    )


@pytest.fixture(scope="module")
def seq():
    frames, poses = render_sequence(CAM, _psis(12), seed=1)
    return frames, poses


def _feed(odo, closer, frames, start):
    for i, (g, d) in enumerate(frames):
        odo.process_frame(g, d, timestamp=(start + i) / 30.0)
        m = odo.metrics[-1]
        if closer is not None and m.keyframe_reason:
            closer.add_keyframe(m.frame_num, g, d)


def _same_metrics(a, b):
    for x, y in zip(dataclasses.astuple(a), dataclasses.astuple(b)):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(x, y)
        else:
            assert x == y


def _assert_same_run(full, resumed, n_before):
    """Poses, keyframes, reasons and every FrameMetrics field but solve_ms
    of the frames after the checkpoint, bit for bit."""
    Ra, ta, tsa = full.trajectory()
    Rb, tb, tsb = resumed.trajectory()
    assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb) and np.array_equal(tsa, tsb)
    assert [(e.is_keyframe, e.reason) for e in full.gop.elements] == [
        (e.is_keyframe, e.reason) for e in resumed.gop.elements]
    after = [m for m in full.metrics if m.frame_num >= n_before]
    assert len(after) == len(resumed.metrics)
    for m, r in zip(after, resumed.metrics):
        _same_metrics(dataclasses.replace(m, solve_ms=0.0), dataclasses.replace(r, solve_ms=0.0))


@pytest.mark.parametrize("motion_model", ["hold", "constant_velocity"])
def test_resume_is_bitwise_the_uninterrupted_run(seq, tmp_path, motion_model):
    """12 frames with a relocalizer and a loop closer, against 6, a
    checkpoint, a restore (`load_odometry`, `load_loop_closer`) and 6 more."""
    frames, _ = seq
    cfg = _config(motion_model)
    lc_cfg = LoopClosureConfig(min_separation=2)
    full = EdgeDvoOdometry(cfg, device="cpu")
    full_lc = LoopCloser(full.intr, lc_cfg, device="cpu")
    _feed(full, full_lc, frames, 0)

    part = EdgeDvoOdometry(cfg, device="cpu")
    part.keep_residuals = full.keep_residuals
    part_lc = LoopCloser(part.intr, lc_cfg, device="cpu")
    _feed(part, part_lc, frames[:6], 0)
    path = str(tmp_path / "c.npz")
    ckpt.save_odometry(part, path, closer=part_lc)
    odo = ckpt.load_odometry(path, device="cpu")
    lc = ckpt.load_loop_closer(path, odo.intr, device="cpu")
    assert lc.cfg == lc_cfg and len(lc.keyframes) == len(part_lc.keyframes)
    _feed(odo, lc, frames[6:], 6)
    _assert_same_run(full, odo, 6)
    assert [c[:2] + (c[4],) for c in lc.closures] == [c[:2] + (c[4],) for c in full_lc.closures]
    for a, b in zip(lc.closures, full_lc.closures):
        assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    assert (odo._reloc.attempts, odo._reloc.successes, odo._reloc.nodes) == (
        full._reloc.attempts, full._reloc.successes, full._reloc.nodes)
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(odo._reloc.poses, full._reloc.poses))
    # the RANSAC generators continue where the interrupted run's stood
    for m, f in ((odo._reloc.matcher, full._reloc.matcher), (lc.matcher, full_lc.matcher)):
        assert torch.equal(m.generator_state(), f.generator_state())


_CLI = ["dvo", "--device", "cpu", "--cam-scale", "0.5", "--iterations", "10,5,3,2",
        "--keyframe-every", "3", "--loop-close", "--refine-every", "2", "--relocalize"]


@pytest.mark.parametrize("motion_model", ["hold", "constant_velocity"])
def test_cli_checkpoint_resume_writes_the_uninterrupted_trajectory(tmp_path, capsys,
                                                                   monkeypatch, motion_model):
    """`dvo --loop-close --refine-every 2 --relocalize`: 12 frames against 6
    with `--checkpoint`, then `--resume` with the same source flags. The
    trajectory files are identical, and so are the closures, the map
    backend's lines and the relocalizer's counters. The resume restores the
    odometry, the loop closer and the raw chain from one read of the file:
    every array is decompressed once."""
    argv = [*_CLI, "--motion-model", motion_model, "--frames", "12"]
    full = main([*argv, "--out", str(tmp_path / "full.txt")])
    c = str(tmp_path / "c.npz")
    main([*_CLI, "--motion-model", motion_model, "--frames", "6", "--checkpoint", c])
    capsys.readouterr()
    reads = {}
    real = np.lib.npyio.NpzFile.__getitem__

    def counting(self, key):
        reads[key] = reads.get(key, 0) + 1
        return real(self, key)

    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", counting)
    resumed = main([*argv, "--resume", c, "--out", str(tmp_path / "resumed.txt")])
    monkeypatch.undo()
    assert "lc_uv" in reads and "raw_rel_R" in reads and max(reads.values()) == 1
    err = capsys.readouterr().err
    assert "resumed at frame 5" in err and "loop closer restored: " in err
    assert (tmp_path / "full.txt").read_text() == (tmp_path / "resumed.txt").read_text()
    assert resumed["closures"] == full["closures"] and len(full["closures"]) >= 1
    assert resumed["keyframes"] == full["keyframes"]
    assert (resumed["recoveries"], resumed["ate_rmse"]) == (full["recoveries"], full["ate_rmse"])


def _jax_config(cfg):
    from rgbd_odometry_tpu.config import PipelineConfig as JaxPipelineConfig

    return JaxPipelineConfig.from_json(cfg.to_json())


def test_port_resumes_from_a_jax_checkpoint(seq, tmp_path, capsys):
    """JAX runs 6 frames and saves; the port and JAX each resume from that
    file for 6 more: the same keyframes, poses within 2e-3 (the bar of
    tests/test_torch_pipeline.py), the relocalizer's database as JAX's.
    The port says on stderr that the file is JAX's and what that means."""
    frames, _ = seq
    cfg = _config()
    jodo = JaxOdometry(_jax_config(cfg))
    for i, (g, d) in enumerate(frames[:6]):
        jodo.process_frame(g, d, timestamp=i / 30.0)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_odometry(jodo, path)
    capsys.readouterr()
    port = ckpt.load_odometry(path, device="cpu")
    err = capsys.readouterr().err
    assert "written by the JAX package" in err and "streak resumes at 0" in err
    assert err.count("\n") == 1
    assert len(port._reloc) == len(jodo._reloc) and port._reloc.nodes == jodo._reloc.nodes
    jres = jax_ckpt.load_odometry(path)
    for i, (g, d) in enumerate(frames[6:]):
        port.process_frame(g, d, timestamp=(6 + i) / 30.0)
        jres.process_frame(g, d, timestamp=(6 + i) / 30.0)
    assert port.gop.keyframe_indices() == jres.gop.keyframe_indices()
    _, t_p, _ = port.trajectory()
    _, t_j, _ = jres.trajectory()
    assert np.abs(t_p - t_j).max() < 2e-3


def test_jax_loaders_read_a_port_checkpoint(seq, tmp_path):
    """The port runs 6 frames (relocalizer, loop closer, raw chain) and
    saves; JAX's `load_odometry`, `load_loop_closer` and `load_raw_rels` read
    the file, with the port's state, and JAX's resumed run stays within
    2e-3 of the port's."""
    frames, _ = seq
    cfg = _config()
    odo = EdgeDvoOdometry(cfg, device="cpu")
    lc = LoopCloser(odo.intr, LoopClosureConfig(min_separation=2), device="cpu")
    _feed(odo, lc, frames[:6], 0)
    rels = [(np.eye(3), np.full(3, 0.001 * k)) for k in range(5)]
    path = str(tmp_path / "port.npz")
    ckpt.save_odometry(odo, path, closer=lc, raw_rels=rels, refine_state={"kf": 1, "closures": 0})
    jodo = jax_ckpt.load_odometry(path)
    assert jodo._frame_num == odo._frame_num == 5
    assert np.array_equal(jodo.trajectory()[1], odo.trajectory()[1])
    for jf, pf in zip(jodo._ref_feats, odo._ref_feats):
        assert np.array_equal(np.asarray(jf.pts3d), pf.pts3d[0].numpy())
        assert int(jf.count) == int(pf.count[0])
    assert len(jodo._reloc) == len(odo._reloc)
    jintr = JaxIntrinsics.from_config(JaxCameraConfig(**dataclasses.asdict(CAM)))
    jlc = jax_ckpt.load_loop_closer(path, jintr)
    assert [k.node for k in jlc.keyframes] == [k.node for k in lc.keyframes]
    assert all(np.array_equal(a, b) for pair in zip(jax_ckpt.load_raw_rels(path), rels)
               for a, b in zip(*pair))
    resumed = ckpt.load_odometry(path, device="cpu")
    for i, (g, d) in enumerate(frames[6:]):
        jodo.process_frame(g, d, timestamp=(6 + i) / 30.0)
        resumed.process_frame(g, d, timestamp=(6 + i) / 30.0)
    assert jodo.gop.keyframe_indices() == resumed.gop.keyframe_indices()
    assert np.abs(jodo.trajectory()[1] - resumed.trajectory()[1]).max() < 2e-3


def _strip(path, out, *meta_keys, arrays=()):
    """A copy of a port checkpoint without some of the port's keys, as the
    JAX package writes it."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files if k not in arrays}
    meta = json.loads(str(data.pop("__meta__")))
    for key in meta_keys:
        node, _, sub = key.partition(".")
        (meta[node].pop(sub) if sub else meta.pop(node))
    np.savez_compressed(out, __meta__=json.dumps(meta), **data)


def _blackout_frames():
    """6 fast tracked frames, 3 blank frames, then 6 slow frames teleported
    back near the origin (tests/test_torch_relocalize.py's run, longer)."""
    frames_a, _ = render_sequence(CAM, _psis(6, step=0.012), seed=0)
    frames_b, _ = render_sequence(CAM, _psis(6, step=0.002), seed=0)
    return list(frames_a) + [BLANK] * 3 + list(frames_b)


def test_defect_bad_streak_is_saved(tmp_path, capsys):
    """JAX `utils/checkpoint.py:98` does not save the lost-frame streak. A
    checkpoint taken two lost frames into a streak of three (the first two
    teleported frames): the port's resume queries the relocalizer on the
    frame the uninterrupted run does, bit for bit; the same file without
    `bad_streak` (what JAX writes) resumes the streak at 0 and queries
    later, so fewer times."""
    reloc = RelocalizeConfig(enabled=True, trigger_consecutive=3, min_matches=20, min_inliers=12)
    cfg = dataclasses.replace(_config(reloc=reloc), keyframe=KeyframeConfig(force_every=5))
    frames = _blackout_frames()
    full = EdgeDvoOdometry(cfg, device="cpu")
    _feed(full, None, frames, 0)
    part = EdgeDvoOdometry(cfg, device="cpu")
    _feed(part, None, frames[:12], 0)
    assert part._bad_streak == 2
    path, jax_like = str(tmp_path / "c.npz"), str(tmp_path / "jax_like.npz")
    ckpt.save_odometry(part, path)
    _strip(path, jax_like, "bad_streak")
    resumed = ckpt.load_odometry(path, device="cpu")
    assert resumed._bad_streak == 2
    _feed(resumed, None, frames[12:], 12)
    _assert_same_run(full, resumed, 12)
    assert full._reloc.attempts >= 1
    assert jax_ckpt.load_odometry(path)._bad_streak == 0  # JAX's loader drops it
    jaxish = ckpt.load_odometry(jax_like, device="cpu")
    assert jaxish._bad_streak == 0 and "streak resumes at 0" in capsys.readouterr().err
    _feed(jaxish, None, frames[12:], 12)
    # the streak restarted: fewer frames reach the database query
    assert jaxish._reloc.attempts < full._reloc.attempts


def test_defect_restore_reads_each_array_once(tmp_path, monkeypatch):
    """JAX `utils/checkpoint.py:57` indexes the `.npz` inside per-slot loops
    (each access decompresses the whole array): with 8 stored keyframes it
    reads `reloc_uv` 8 times; the port reads every array once."""
    seqf, poses = render_sequence(CAM, _psis(8), seed=0)
    odo = EdgeDvoOdometry(_config(), device="cpu")
    odo.process_frame(*seqf[0])
    for k in range(1, 8):
        odo._reloc.add_keyframe(*seqf[k], *poses[k], node=k)
    assert len(odo._reloc) == 8
    path = str(tmp_path / "c.npz")
    ckpt.save_odometry(odo, path)
    reads = {}
    real = np.lib.npyio.NpzFile.__getitem__

    def counting(self, key):
        reads[key] = reads.get(key, 0) + 1
        return real(self, key)

    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", counting)
    port = ckpt.load_odometry(path, device="cpu")
    assert max(reads.values()) == 1
    reads.clear()
    jodo = jax_ckpt.load_odometry(path)
    assert reads["reloc_uv"] == 8
    monkeypatch.undo()
    for a, b in zip(port._reloc.matcher.stored, odo._reloc.matcher.stored):
        assert torch.equal(a.pts3d, b.pts3d)
    assert torch.equal(port._reloc.matcher._slots.desc, odo._reloc.matcher._slots.desc)
    assert len(jodo._reloc) == 8


def test_defect_loop_closer_config_is_saved(seq, tmp_path):
    """JAX `utils/checkpoint.py:244` neither saves nor checks the loop
    closer's configuration: its loader gives the default gates. The port
    restores the saved one and refuses a different one."""
    frames, _ = seq
    cfg = LoopClosureConfig(max_keypoints=256, min_inliers=25, min_separation=2)
    odo = EdgeDvoOdometry(_config(), device="cpu")
    lc = LoopCloser(odo.intr, cfg, device="cpu")
    _feed(odo, lc, frames[:5], 0)
    path = str(tmp_path / "c.npz")
    ckpt.save_odometry(odo, path, closer=lc)
    got = ckpt.load_loop_closer(path, odo.intr, device="cpu")
    assert got.cfg == cfg and got.matcher.cfg.max_keypoints == 256
    with pytest.raises(ValueError, match="saved with"):
        ckpt.load_loop_closer(path, odo.intr, config=LoopClosureConfig(), device="cpu")
    jintr = JaxIntrinsics.from_config(JaxCameraConfig(**dataclasses.asdict(CAM)))
    jlc = jax_ckpt.load_loop_closer(path, jintr)
    assert jlc.cfg.min_inliers == 20 and jlc.cfg.max_keypoints == 384  # JAX's defaults
    stripped = str(tmp_path / "jax_like.npz")
    _strip(path, stripped, "closer.config")
    assert ckpt.load_loop_closer(stripped, odo.intr, device="cpu").cfg == LoopClosureConfig()


def test_defect_refine_baseline_is_saved(tmp_path):
    """JAX `cli.py:237` resumes online refinement with the closure baseline
    at the restored closure count: closures found before the checkpoint but
    not yet refined never trigger a refine. The port saves the keyframe
    counter and the baseline, so a pending closure stays pending; a file
    without them gets JAX's baseline."""
    odo = EdgeDvoOdometry(_config(), device="cpu")
    odo.process_frame(*BLANK)
    lc = LoopCloser(odo.intr, device="cpu")
    lc.closures = [(0, 9, np.eye(3), np.zeros(3), 30), (3, 12, np.eye(3), np.zeros(3), 25)]
    path = str(tmp_path / "c.npz")
    ckpt.save_odometry(odo, path, closer=lc, refine_state={"kf": 1, "closures": 1})
    state = ckpt.load_refine_state(path, len(lc.closures))
    assert state == {"kf": 1, "closures": 1}  # one closure still to refine
    stripped = str(tmp_path / "jax_like.npz")
    _strip(path, stripped, "refine_state")
    assert ckpt.load_refine_state(stripped, 2) == {"kf": 0, "closures": 2}  # JAX: none pending


def test_generator_state_is_per_device_type(seq, tmp_path, capsys):
    """A generator's state resumes on the device type that wrote it; a file
    whose state came from another device type restarts the matcher from its
    seed and says so."""
    frames, _ = seq
    odo = EdgeDvoOdometry(_config(), device="cpu")
    _feed(odo, None, frames[:2], 0)
    odo._reloc.matcher._uniforms(4, 8)  # advance the stream
    path, other = str(tmp_path / "c.npz"), str(tmp_path / "other.npz")
    ckpt.save_odometry(odo, path)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(str(data.pop("__meta__")))
    meta["reloc"]["gen_device"] = "cuda"
    np.savez_compressed(other, __meta__=json.dumps(meta), **data)
    same = ckpt.load_odometry(path, device="cpu")._reloc.matcher
    assert torch.equal(same.generator_state(), odo._reloc.matcher.generator_state())
    capsys.readouterr()
    fresh = ckpt.load_odometry(other, device="cpu")._reloc.matcher
    assert "restarts from its seed" in capsys.readouterr().err
    assert torch.equal(fresh.generator_state(), torch.Generator().manual_seed(0).get_state())
    with np.load(path) as z:
        assert np.array_equal(z["reloc_key"], np.array([0, 0], np.uint32))
