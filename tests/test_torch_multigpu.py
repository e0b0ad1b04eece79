"""The port's multi-GPU path (`parallel/mesh.py`, `multihost.py`, `streams.py`
and `sequence.py` over `torch.distributed` ranks, and `multistream
--world-size`) on the CPU: ranks of a gloo process group, started once a
module with the `spawn` method (tests/torch_multigpu_worker.py), each
saving its results to an `.npz` that the tests below hold against the JAX
package on the 8-device virtual CPU mesh of tests/conftest.py and against
the port's one-process calls.

Bars: the sharded aligner within JAX's own 5e-5 (tests/test_sharding.py)
of JAX's on its test's pair, and bitwise the port's one-process
`align_pair` on 8 distinct pairs; the sharded train step's poses bitwise
`build_batch_step`'s, its stats within 1e-6 relative of them, total points
exact; against JAX's two train steps the poses and stats of
tests/test_torch_sequence.py's batch-step test (2e-3, equal points,
visible ratio 1e-3, energy 1e-2; measured here: 1.3e-3, equal, equal,
3.3e-3 relative), since the port's solve is not JAX's to 1e-6 at three
and two iterations; lockstep within tests/test_multistream.py's bars of
JAX's mesh-sharded driver (5e-3 hold, 1e-2 constant velocity; measured
here: 2.2e-3 and 7.2e-3) and of the one-process driver (measured: equal
to the last bit), the same keyframes; `align_sequence` bitwise the
one-process call and within tests/test_torch_sequence.py's 2e-3 of JAX's
(measured: 8.9e-4); the multi-host recipe within 5e-5 of JAX's same
computation in one process bitwise and within 2e-3 of JAX's (measured:
1.2e-3)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_multigpu_worker as W  # noqa: E402

from rgbd_odometry_tpu.config import (  # noqa: E402
    KeyframeConfig, PipelineConfig, PyramidConfig, SolverConfig,
)
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jbuild  # noqa: E402
from rgbd_odometry_tpu.parallel import mesh as jmesh  # noqa: E402
from rgbd_odometry_tpu.parallel import multihost as jmh  # noqa: E402
from rgbd_odometry_tpu.parallel import sequence as jseq  # noqa: E402
from rgbd_odometry_tpu.parallel.streams import MultiStreamOdometry as JaxMulti  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.parallel import launch  # noqa: E402
from rgbd_odometry_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from rgbd_odometry_tpu_torch.parallel import multihost as tmh  # noqa: E402
from rgbd_odometry_tpu_torch.parallel import sequence as tseq  # noqa: E402
from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo  # noqa: E402

torch.set_num_threads(1)

WORLD = 4
DEADLINE_S = 400


class _Joined:
    """The ranks' saved results, joined on first use (so that the test
    process builds its references while the ranks run)."""

    def __init__(self, ranks, files):
        self.ranks, self.files, self.res = ranks, files, None

    def __call__(self):
        if self.res is None:
            self.ranks.join()
            self.res = [dict(np.load(f)) for f in self.files]
        return self.res


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    data = {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        streams = {m: pool.submit(W.stream_sequences, m) for m in ("hold", "constant_velocity")}
        for key, batch, distinct in (("align_same", W.ALIGN_BATCH, False),
                                     ("align_distinct", W.ALIGN_BATCH, True),
                                     ("step", W.STEP_BATCH, False)):
            for i, x in enumerate(W.pair_batch(batch, distinct)):
                data[f"{key}_{i}"] = x
        for model, fut in streams.items():
            data[f"{model}_gray"], data[f"{model}_depth"] = fut.result()
    grays, depths = W.sequence_frames()
    data["seq_gray"], data["seq_depth"] = np.stack(grays), np.stack(depths)
    path = str(tmp_path_factory.mktemp("multigpu_inputs") / "inputs.npz")
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module")
def mesh_ranks(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks4")
    ranks = launch.Ranks(W.mesh_rank, WORLD, (f"127.0.0.1:{launch.free_port()}", str(out),
                                              inputs[0]), str(out), DEADLINE_S)
    return _Joined(ranks, [out / f"rank{r}.npz" for r in range(WORLD)])


@pytest.fixture(scope="module")
def recipe_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks2")
    ranks = launch.Ranks(W.recipe_rank, 2, (f"127.0.0.1:{launch.free_port()}",
                                            f"127.0.0.1:{launch.free_port()}", str(out)),
                         str(out), DEADLINE_S)
    return _Joined(ranks, [out / f"recipe{r}.npz" for r in range(2)])


def _jax_pyramids(frames, levels=2):
    rg, rd, ng, nd = (jnp.asarray(x) for x in frames)
    ref = jax.vmap(lambda g, d: jbuild(g, d, levels))(rg, rd)
    now = jax.vmap(lambda g, d: jbuild(g, d, levels))(ng, nd)
    return tuple(ref.gray), tuple(ref.depth), tuple(now.gray)


def _frames(data, key):
    return tuple(data[f"{key}_{i}"] for i in range(4))


def test_sharded_aligner(inputs, mesh_ranks):
    """4 ranks of B = 8: the global poses on every rank, one gather a call;
    tests/test_sharding.py's pair within 5e-5 of JAX's 8-device sharded
    aligner, 8 distinct pairs bitwise the one-process `align_pair`."""
    _, data = inputs
    cfg = SolverConfig(method="gauss_newton", iterations=W.ALIGN_ITERS)
    m = jmesh.make_mesh()
    R_j, t_j = jmesh.build_sharded_aligner(m, JIntrinsics.from_config(W.pair_camera()), cfg,
                                           W.MAX_PTS)(*jmesh.shard_batch(
                                               m, _jax_pyramids(_frames(data, "align_same"))))
    R1, t1, _ = edge_dvo.align_pair(*W.pyramids(_frames(data, "align_distinct")),
                                    Intrinsics.from_config(W.pair_camera()), cfg, W.MAX_PTS)
    for r, res in enumerate(mesh_ranks()):
        assert res["align_same_R"].shape == (W.ALIGN_BATCH, 3, 3)
        np.testing.assert_allclose(res["align_same_R"], np.asarray(R_j), rtol=0, atol=5e-5)
        np.testing.assert_allclose(res["align_same_t"], np.asarray(t_j), rtol=0, atol=5e-5)
        assert np.array_equal(res["align_distinct_R"], R1.numpy()), r
        assert np.array_equal(res["align_distinct_t"], t1.numpy()), r
        for key in ("same", "distinct"):
            assert json.loads(str(res[f"align_{key}_collectives"])) == {"all_gather": 1}


def test_sharded_train_step(inputs, mesh_ranks):
    """4 ranks of B = 16 (tests/test_sharding.py's train-step batch): one
    `all_reduce` a step; the ranks' poses bitwise `build_batch_step`'s,
    every rank's stats within 1e-6 relative of its stats, total points
    exact; against JAX's auto-sharded and `shard_map` steps (which agree
    to 1e-6) the bars of the module docstring."""
    _, data = inputs
    cfg = SolverConfig(method="gauss_newton", iterations=W.STEP_ITERS)
    intr = Intrinsics.from_config(W.pair_camera())
    (R1, t1), s1 = tmesh.build_batch_step(intr, cfg, W.MAX_PTS)(*W.pyramids(_frames(data, "step")))
    m = jmesh.make_mesh()
    args = jmesh.shard_batch(m, _jax_pyramids(_frames(data, "step")))
    jintr = JIntrinsics.from_config(W.pair_camera())
    (jR, jt), s_auto = jmesh.build_sharded_train_step(m, jintr, cfg, W.MAX_PTS)(*args)
    _, s_expl = jmesh.build_shardmap_train_step(m, jintr, cfg, W.MAX_PTS)(*args)
    for k in ("mean_energy", "mean_visible_ratio"):
        np.testing.assert_allclose(float(s_auto[k]), float(s_expl[k]), rtol=1e-6)
    res = mesh_ranks()
    R = np.concatenate([r["step_R"] for r in res])
    t = np.concatenate([r["step_t"] for r in res])
    assert np.array_equal(R, R1.numpy()) and np.array_equal(t, t1.numpy())
    np.testing.assert_allclose(R, np.asarray(jR), rtol=0, atol=2e-3)
    np.testing.assert_allclose(t, np.asarray(jt), rtol=0, atol=2e-3)
    for r in res:
        assert json.loads(str(r["step_collectives"])) == {"all_reduce": 1}
        assert r["step_mean_energy"].dtype == np.float32
        assert int(r["step_total_points"]) == int(s1["total_points"]) == int(
            s_auto["total_points"]) == int(s_expl["total_points"])
        for k in ("mean_energy", "mean_visible_ratio"):
            assert float(r[f"step_{k}"]) == float(res[0][f"step_{k}"])
            np.testing.assert_allclose(float(r[f"step_{k}"]), float(s1[k]), rtol=1e-6)
        assert abs(float(r["step_mean_visible_ratio"])
                   - float(s_auto["mean_visible_ratio"])) <= 1e-3
        np.testing.assert_allclose(float(r["step_mean_energy"]), float(s_auto["mean_energy"]),
                                   rtol=1e-2)


@pytest.mark.parametrize("motion_model, bar", [("hold", 5e-3), ("constant_velocity", 1e-2)])
def test_lockstep(inputs, mesh_ranks, motion_model, bar):
    """tests/test_multistream.py's 8 streams x 12 frames over 4 ranks: rank
    r owns streams [2r, 2r + 2) and runs no collective inside a step; every
    rank gathers all 8 trajectories; the same keyframes as JAX's
    `MultiStreamOdometry` on the 8-device mesh and as the one-process
    driver, poses within the bar of both."""
    _, data = inputs
    gray, depth = data[f"{motion_model}_gray"], data[f"{motion_model}_depth"]
    jcfg = PipelineConfig(
        camera=W.stream_camera(), pyramid=PyramidConfig(num_levels=2, max_points=(768, 384)),
        solver=SolverConfig(method="gauss_newton", iterations=(8, 6)),
        keyframe=KeyframeConfig(force_every=5, enable_quality_triggers=False,
                                rollback_resolve=False),
        motion_model=motion_model)
    jm = W.lockstep(JaxMulti(jmesh.make_mesh(), W.N_STREAMS, jcfg), gray, depth)
    one = W.lockstep(MultiStreamOdometry(W.N_STREAMS, W.stream_config(motion_model),
                                         device="cpu"), gray, depth)
    j_traj, one_traj = jm.trajectories(), one.trajectories()
    for r, res in enumerate(mesh_ranks()):
        assert json.loads(str(res[f"{motion_model}_collectives"])) == {}
        assert res[f"{motion_model}_local_streams"].tolist() == [2 * r, 2 * r + 2]
        assert int(res[f"{motion_model}_diverged"]) == 0
        for s in range(W.N_STREAMS):
            kfs = res[f"{motion_model}_keyframes"][s].tolist()
            assert kfs == jm.gops[s].keyframe_indices() == one.gops[s].keyframe_indices(), s
            for ref in (j_traj[s], one_traj[s]):
                assert np.abs(res[f"{motion_model}_R"][s] - ref[0]).max() <= bar, s
                assert np.abs(res[f"{motion_model}_t"][s] - ref[1]).max() <= bar, s


@pytest.mark.parametrize("keyframe_every", [None, 3])
def test_align_sequence(inputs, mesh_ranks, keyframe_every):
    """tests/test_sharding.py's 6 frames (5 pairs, padded to 8) over 4
    ranks: every rank composes the one-process call's result to the last
    bit; JAX's `align_sequence(mesh=make_mesh())` within 2e-3."""
    _, data = inputs
    grays, depths = list(data["seq_gray"]), list(data["seq_depth"])
    cfg = SolverConfig(method="gauss_newton", iterations=(10, 4))
    one = tseq.align_sequence(grays, depths, Intrinsics.from_config(W.seq_camera()), cfg,
                              max_points=(1024, 512), num_levels=2,
                              keyframe_every=keyframe_every, device="cpu")
    jres = jseq.align_sequence(grays, depths, JIntrinsics.from_config(W.seq_camera()), cfg,
                               max_points=(1024, 512), num_levels=2,
                               keyframe_every=keyframe_every, mesh=jmesh.make_mesh())
    for res in mesh_ranks():
        got = [res[f"seq_{keyframe_every}_{k}"] for k in ("R", "t", "rel_R", "rel_t")]
        assert got[0].shape == (W.SEQ_FRAMES, 3, 3) and got[2].shape == (W.SEQ_FRAMES - 1, 3, 3)
        for a, b, c in zip(got, one, jres):
            assert np.array_equal(a, b)
            np.testing.assert_allclose(a, np.asarray(c), rtol=0, atol=2e-3)


def test_multihost_recipe(recipe_ranks):
    """tests/multihost_worker.py's recipe on 2 gloo ranks: each aligns its
    own window of a 7-frame sequence, one statistic is `all_reduce`d (the
    same on both), and the stitched trajectory is bitwise the same
    computation in one process and within tests/test_torch_sequence.py's
    2e-3 for a composed trajectory of JAX's (measured here: 6.4e-4 in R,
    1.2e-3 in t; the port's `align_pair` is not JAX's to 5e-5 on these
    pairs at four and three iterations, tests/test_torch_solve.py holds it
    to 1e-3 a pair)."""
    res = recipe_ranks()
    assert [int(r["lo"]) for r in res] == [0, 3] and [int(r["hi"]) for r in res] == [4, 7]
    assert float(res[0]["mean_window_err"]) == float(res[1]["mean_window_err"]) < 0.05
    R_g, t_g = tmh.stitch_windows([(r["R"], r["t"]) for r in res], W.RECIPE_OVERLAP)
    assert R_g.shape == (W.RECIPE_FRAMES, 3, 3)

    from rgbd_odometry_tpu.io.synthetic import render_sequence as jrender

    windows = jmh.shard_sequence_windows(W.RECIPE_FRAMES, W.RECIPE_WINDOW, W.RECIPE_OVERLAP)
    one = [W.window_odometry(lo, hi) for lo, hi in windows]
    R1, t1 = tmh.stitch_windows([(R, t) for R, t, _ in one], W.RECIPE_OVERLAP)
    assert np.array_equal(R_g, R1) and np.array_equal(t_g, t1)
    assert float(res[0]["mean_window_err"]) == sum(e for _, _, e in one) / 2

    jcfg = SolverConfig(method="gauss_newton", iterations=(4, 3))
    jintr = JIntrinsics.from_config(W.recipe_camera())
    jalign = jax.jit(lambda rg, rd, ng: jed.align_pair(rg, rd, ng, jintr, jcfg, W.MAX_PTS)[:2])
    results, errs = [], []
    for lo, hi in windows:
        frames, poses = jrender(W.recipe_camera(), W.recipe_psis()[lo:hi], seed=0)
        Rs, ts = [np.eye(3)], [np.zeros(3)]
        for i in range(1, len(frames)):
            rp = jbuild(jnp.asarray(frames[i - 1][0]), jnp.asarray(frames[i - 1][1]), 2)
            np_ = jbuild(jnp.asarray(frames[i][0]), jnp.asarray(frames[i][1]), 2)
            R, t = jalign(rp.gray, rp.depth, np_.gray)
            R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
            ts.append(ts[-1] + Rs[-1] @ t)
            Rs.append(Rs[-1] @ R)
        results.append((np.stack(Rs), np.stack(ts)))
        gt_rel_t = poses[-1][1] - poses[0][1]
        errs.append(np.linalg.norm(ts[-1] - np.asarray(poses[0][0]).T @ gt_rel_t))
    jR, jt = jmh.stitch_windows(results, W.RECIPE_OVERLAP)
    np.testing.assert_allclose(R_g, jR, rtol=0, atol=2e-3)
    np.testing.assert_allclose(t_g, jt, rtol=0, atol=2e-3)
    np.testing.assert_allclose(float(res[0]["mean_window_err"]), np.mean(errs), rtol=0,
                               atol=2e-3)


def test_cli_multistream_two_ranks(recipe_ranks, capsys):
    """`multistream --world-size 2` over gloo: only rank 0 prints, its line
    says `"devices": 2` and its ATEs and keyframes are the one-process
    run's."""
    from rgbd_odometry_tpu_torch.cli import main

    summary = main(list(W.CLI_ARGS))
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = recipe_ranks()
    assert str(res[1]["cli_stdout"]) == ""
    line = json.loads(str(res[0]["cli_stdout"]).strip().splitlines()[-1])
    assert line["devices"] == 2 and one["devices"] == 1
    assert line["streams"] == one["streams"] == 2 and line["frames"] == one["frames"] == 6
    assert line["ate_rmse_per_stream"] == one["ate_rmse_per_stream"]
    assert line["ate_rmse_max"] < 0.02
    for r in res:
        assert json.loads(str(r["cli_summary"]))["keyframes"] == summary["keyframes"]


def test_initialize_is_a_noop_for_one_process():
    import torch.distributed as dist

    tmh.initialize()
    tmh.initialize("127.0.0.1:1", 1, 0, backend=tmh.GLOO)
    assert not dist.is_initialized()
    m = tmh.global_mesh("cpu")
    assert (m.rank, m.world_size, m.device.type, m.group) == (0, 1, "cpu", None)
    assert tmh.local_window([(0, 4), (3, 7)]) == (0, 4)
    tmh.shutdown()


def _mesh4(rank=0):
    return tmesh.Mesh(rank, WORLD, torch.device("cpu"))


def test_streams_not_a_multiple_raise():
    cfg = W.stream_config("hold")
    with pytest.raises(ValueError, match="not a multiple of mesh size 4"):
        MultiStreamOdometry(6, cfg, mesh=_mesh4())
    multi = MultiStreamOdometry(8, cfg, mesh=_mesh4(3))
    assert (multi.lo, multi.hi, multi.n) == (6, 8, 2)
    with pytest.raises(ValueError, match="not both"):
        MultiStreamOdometry(8, cfg, device="cpu", mesh=_mesh4())


def test_shard_batch_rows_and_error():
    """This rank's contiguous rows of every leaf, in one staging buffer;
    JAX's error for a batch that is not a multiple of the world size."""
    tree = {"a": (np.arange(24, dtype=np.float32).reshape(8, 3),
                  torch.arange(8, dtype=torch.int32)),
            "b": [np.ones((8, 2, 2), bool)]}
    got = tmesh.shard_batch(_mesh4(2), tree)
    assert np.array_equal(got["a"][0].numpy(), tree["a"][0][4:6])
    assert got["a"][1].tolist() == [4, 5] and got["a"][1].dtype == torch.int32
    assert got["b"][0].dtype == torch.bool and got["b"][0].shape == (2, 2, 2)
    with pytest.raises(ValueError, match=r"divisible by 4, but it is equal to 6 \(full shape"):
        tmesh.shard_batch(_mesh4(), (np.zeros((6, 3), np.float32),))


def _fake_cards(monkeypatch, cards):
    """`cards` CUDA cards, and a process group that records its arguments
    instead of opening."""
    import torch.distributed as dist

    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("card", d))
    monkeypatch.setattr(dist, "init_process_group", lambda **k: calls.setdefault("group", k))
    monkeypatch.setattr(tmh, "_LOCAL_RANK", None)
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_nccl_two_ranks_on_one_card_refused(monkeypatch):
    """NCCL refuses two ranks on one card; `initialize` says so first,
    before any process group exists: on one host, and on each host of
    two."""
    calls = _fake_cards(monkeypatch, 1)
    with pytest.raises(ValueError, match="Duplicate GPU detected"):
        tmh.initialize("127.0.0.1:1", 2, 0, backend=tmh.NCCL)
    with pytest.raises(ValueError, match="2 ranks on this host's 1 card"):
        tmh.initialize("127.0.0.1:1", 4, 3, backend=tmh.NCCL, local_rank=1, local_world_size=2)
    assert calls == {}


@pytest.mark.parametrize("from_env", [False, True])
def test_nccl_across_two_hosts(monkeypatch, from_env):
    """2 hosts x 4 cards over NCCL: global rank 5 is local rank 1 of its
    host's 4, drives card 1 there, and joins a world of 8; the local place
    comes from the arguments or from LOCAL_RANK / LOCAL_WORLD_SIZE."""
    calls = _fake_cards(monkeypatch, 4)
    if from_env:
        monkeypatch.setenv("LOCAL_RANK", "1")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
        tmh.initialize("10.0.0.1:29500", 8, 5, backend=tmh.NCCL)
    else:
        tmh.initialize("10.0.0.1:29500", 8, 5, backend=tmh.NCCL, local_rank=1,
                       local_world_size=4)
    assert calls["card"] == 1 and tmh.local_rank() == 1
    group = calls["group"]
    assert (group["world_size"], group["rank"], group["backend"]) == (8, 5, tmh.NCCL)
    assert group["init_method"] == "tcp://10.0.0.1:29500"
    with pytest.raises(ValueError, match="does not fit a world of 8"):
        tmh.local_layout(8, 5, local_rank=4, local_world_size=4)


@pytest.mark.parametrize("backend, error, match", [
    (None, ValueError, "backend must be"),
    ("nccl", ValueError, "backend must be"),
    (tmh.NCCL, RuntimeError, "NCCL needs a CUDA card"),
])
def test_initialize_refuses(monkeypatch, backend, error, match):
    """No silent choice and no fallback: the backend is named, and NCCL
    without a card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        tmh.initialize("127.0.0.1:1", 2, 0, backend=backend)


def test_cli_streams_not_a_multiple():
    from rgbd_odometry_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="multiple of the world size"):
        main(["multistream", "--device", "cpu", "--streams", "3", "--world-size", "2",
              "--dist-address", "127.0.0.1:1"])


@pytest.mark.parametrize("device, local_world, cards, backend", [
    ("cpu", 2, 0, tmh.GLOO),
    ("cuda", 2, 4, tmh.NCCL),
    ("cuda", 4, 4, tmh.NCCL),
    ("cuda", 4, 1, tmh.GLOO),
    ("cuda:0", 2, 4, tmh.GLOO),
])
def test_multistream_backend(monkeypatch, device, local_world, cards, backend):
    """`multistream` takes NCCL only where every rank of a host has a card
    of its own (a world of 8 on 2 hosts of 4 cards is a local world of 4),
    and gloo where ranks share one (or on the CPU)."""
    from rgbd_odometry_tpu_torch.cli import multistream_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multistream_backend(device, local_world) == backend
