"""The PyTorch port's batched sequence alignment and batch step
(`parallel/sequence.py`, `parallel/mesh.py`) and its window helpers
(`parallel/multihost.py`) on the CPU, against the JAX package's at
tests/test_sharding.py's sizes and bars."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig, SolverConfig  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.parallel import mesh as jmesh  # noqa: E402
from rgbd_odometry_tpu.parallel import multihost as jmh  # noqa: E402
from rgbd_odometry_tpu.parallel import sequence as jseq  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from rgbd_odometry_tpu_torch.parallel import multihost as tmh  # noqa: E402
from rgbd_odometry_tpu_torch.parallel import sequence as tseq  # noqa: E402

torch.set_num_threads(1)

SEQ_CAM = CameraConfig(width=96, height=64, fx=100.0, fy=100.0, cx=47.5, cy=31.5)
SEQ_CFG = SolverConfig(method="gauss_newton", iterations=(10, 4))


@pytest.fixture(scope="module")
def sequence():
    ts = np.arange(6)
    psis = np.stack([0.004 * ts, -0.003 * ts, 0.002 * ts, 0.001 * ts, -0.001 * ts,
                     0.0005 * ts], -1).astype(np.float32)
    frames, poses = render_sequence(SEQ_CAM, psis, seed=0)
    return [f[0] for f in frames], [f[1] for f in frames], np.stack([p[1] for p in poses])


@pytest.mark.parametrize("keyframe_every", [None, 3])
def test_align_sequence_matches_jax(sequence, keyframe_every):
    """Both pairing modes: the last frame within tests/test_sharding.py's
    bar of ground truth, the same pairs as JAX, and every relative pose
    within 2e-3 of JAX's (measured here: 8.9e-4 at most)."""
    grays, depths, gt_t = sequence
    R, t, rel_R, rel_t = tseq.align_sequence(
        grays, depths, Intrinsics.from_config(SEQ_CAM), SEQ_CFG, max_points=(1024, 512),
        num_levels=2, keyframe_every=keyframe_every, device="cpu")
    assert R.shape == (6, 3, 3) and t.shape == (6, 3) and rel_R.shape == (5, 3, 3)
    assert R.dtype == np.float64 and np.isfinite(t).all()
    err = np.linalg.norm(t - gt_t, axis=-1)
    assert err[-1] < max(0.5 * np.linalg.norm(gt_t[-1]), 0.02), err
    jR, jt, jrel_R, jrel_t = jseq.align_sequence(
        grays, depths, JIntrinsics.from_config(SEQ_CAM), SEQ_CFG, max_points=(1024, 512),
        num_levels=2, keyframe_every=keyframe_every)
    np.testing.assert_allclose(rel_t, jrel_t, rtol=0, atol=2e-3)
    np.testing.assert_allclose(rel_R, jrel_R, rtol=0, atol=2e-3)
    np.testing.assert_allclose(t, jt, rtol=0, atol=2e-3)


def test_pair_indices():
    ref, now = tseq.pair_indices(8, 3)
    assert now.tolist() == [1, 2, 3, 4, 5, 6, 7]
    assert ref.tolist() == [0, 0, 0, 3, 3, 3, 6]
    ref, now = tseq.pair_indices(4)
    assert ref.tolist() == [0, 1, 2] and now.tolist() == [1, 2, 3]


def test_batch_step_stats_match_jax(sequence):
    """`build_batch_step` on the sequence's 5 consecutive pairs against the
    JAX train step on a one-device mesh: poses within 2e-3, total points
    exact, mean visible ratio within 1e-3 and mean energy within 1% (the
    bf16 samples' plateau decisions; measured here: 8.7e-4, equal, equal,
    4e-5 relative)."""
    grays, depths, _ = sequence
    max_pts = (1024, 512)
    g = torch.from_numpy(np.stack(grays))
    d = torch.from_numpy(np.stack(depths))
    ref = build_pyramid(g[:-1], d[:-1], 2)
    now = build_pyramid(g[1:], d[1:], 2)
    step = tmesh.build_batch_step(Intrinsics.from_config(SEQ_CAM), SEQ_CFG, max_pts)
    (R, t), stats = step(ref.gray, ref.depth, now.gray)
    assert set(stats) == {"mean_energy", "mean_visible_ratio", "total_points"}
    jstep = jmesh.build_sharded_train_step(jmesh.make_mesh(np.asarray(jax.devices()[:1])),
                                           JIntrinsics.from_config(SEQ_CAM), SEQ_CFG, max_pts)
    j = lambda pyr: tuple(jnp.asarray(x.numpy()) for x in pyr)  # noqa: E731
    (jR, jt), jstats = jstep(j(ref.gray), j(ref.depth), j(now.gray))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=2e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=2e-3)
    assert int(stats["total_points"]) == int(jstats["total_points"])
    assert abs(float(stats["mean_visible_ratio"]) - float(jstats["mean_visible_ratio"])) <= 1e-3
    np.testing.assert_allclose(float(stats["mean_energy"]), float(jstats["mean_energy"]),
                               rtol=1e-2)


@pytest.mark.parametrize("num_frames,window,overlap", [(20, 8, 1), (21, 5, 2), (7, 8, 1),
                                                       (9, 3, 1)])
def test_window_helpers_match_jax(num_frames, window, overlap):
    """The window split, each process's window and the stitched trajectory,
    exactly as the JAX package's."""
    wins = tmh.shard_sequence_windows(num_frames, window, overlap)
    assert wins == jmh.shard_sequence_windows(num_frames, window, overlap)
    for pid in range(5):
        assert tmh.local_window(wins, pid) == jmh.local_window(wins, pid)
    assert tmh.local_window(wins) == wins[0]
    rng = np.random.default_rng(num_frames)
    results = []
    for s, e in wins:
        q, _ = np.linalg.qr(rng.standard_normal((e - s, 3, 3)))
        results.append((q, rng.standard_normal((e - s, 3))))
    tR, tt = tmh.stitch_windows(results, overlap)
    jR, jt = jmh.stitch_windows(results, overlap)
    assert np.array_equal(tR, jR) and np.array_equal(tt, jt)
    assert len(tt) == num_frames
