"""The port's loop closer (`rgbd_odometry_tpu_torch.pipeline.loop_closure`)
against the JAX package's on the out-and-back sequence of
tests/test_loop_closure.py at 160x120: with the JAX matcher's random draws
replayed, the same closures (nodes and PnP inlier counts) with poses within
1e-4; with the port's own generator, every closure within 2 cm / 0.02 of
ground truth; slot growth; a JAX store loaded through `convert.load_store`;
re-anchoring equal to JAX's within 1e-12, graph refinement within 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JaxIntrinsics  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu.pipeline.gop import Gop as JaxGop  # noqa: E402
from rgbd_odometry_tpu.pipeline.loop_closure import LoopCloser as JaxLoopCloser  # noqa: E402
from rgbd_odometry_tpu.pipeline.loop_closure import LoopClosureConfig  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.ops import features as pf  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.gop import Gop  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.loop_closure import LoopCloser  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.loop_closure import (  # noqa: E402
    LoopClosureConfig as PortLoopClosureConfig,
)

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=176.0, fy=176.0, cx=79.5, cy=59.5)


def _out_and_back(n=8, amp=0.04):
    ts = np.arange(n)
    phase = np.sin(np.pi * ts / (n - 1))
    return np.stack([amp * phase, -0.5 * amp * phase, 0.3 * amp * phase,
                     0.2 * amp * phase, -0.2 * amp * phase, 0.1 * amp * phase],
                    -1).astype(np.float32)


class JaxDraws:
    """The JAX matcher's draws, in its order: per RANSAC call
    `key, ek = split(key)`, then `uniform(k_i, (K,))` for k_i in
    `split(ek, S)`. Installed as a port matcher's `_uniforms`."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, s: int, k: int) -> torch.Tensor:
        self.key, ek = jax.random.split(self.key)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(jax.random.split(ek, s))
        return torch.from_numpy(np.array(u))


@pytest.fixture(scope="module")
def seq():
    return render_sequence(CAM, _out_and_back(), seed=0)


@pytest.fixture(scope="module")
def jax_closer(seq):
    frames, _ = seq
    lc = JaxLoopCloser(JaxIntrinsics.from_config(CAM), LoopClosureConfig(min_separation=4))
    for i, (g, d) in enumerate(frames):
        lc.add_keyframe(i, g, d)
    return lc


def _port_closer(frames, replay: bool, **cfg):
    lc = LoopCloser(Intrinsics.from_config(CAM), PortLoopClosureConfig(min_separation=4, **cfg),
                    device="cpu")
    if replay:
        lc.matcher._uniforms = JaxDraws(0)
    for i, (g, d) in enumerate(frames):
        lc.add_keyframe(i, g, d)
    return lc


def _gt_rel(poses, i, j):
    (R_i, t_i), (R_j, t_j) = poses[i], poses[j]
    return R_i.T @ R_j, R_i.T @ (t_j - t_i)


def test_replayed_draws_give_the_jax_closures(seq, jax_closer):
    frames, poses = seq
    lc = _port_closer(frames, replay=True)
    assert [c[:2] + c[4:] for c in lc.closures] == [c[:2] + c[4:] for c in jax_closer.closures]
    assert len(lc.closures) > 0
    for (_, _, R, t, _), (_, _, Rj, tj, _) in zip(lc.closures, jax_closer.closures):
        np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-4)
        np.testing.assert_allclose(t, tj, rtol=0, atol=1e-4)
    assert lc.skipped_candidates == jax_closer.skipped_candidates


@pytest.fixture(scope="module")
def own_closer(seq):
    return _port_closer(seq[0], replay=False)


def test_own_generator_closures_match_ground_truth(seq, own_closer):
    frames, poses = seq
    lc = own_closer
    assert len(lc.closures) > 0
    for i, j, R_rel, t_rel, n_inl in lc.closures:
        R_gt, t_gt = _gt_rel(poses, i, j)
        assert np.linalg.norm(t_rel - t_gt) < 0.02, (i, j)
        assert np.linalg.norm(R_rel - R_gt) < 0.02, (i, j)
        assert n_inl >= 20
    again = _port_closer(frames, replay=False)
    assert [c[:2] + c[4:] for c in again.closures] == [c[:2] + c[4:] for c in lc.closures]


def test_slot_store_doubles_and_keeps_matching(seq, own_closer):
    """At slot_capacity=2 the store doubles twice (2 -> 4 -> 8); every slot,
    those stored after a doubling included, keeps its keypoints and matches
    a query as a single `match` against that keyframe does."""
    frames, poses = seq
    lc = _port_closer(frames, replay=False, slot_capacity=2)
    assert lc._num_slots() == 8 and len(lc.matcher.stored) == 8
    assert [c[:2] for c in lc.closures] == [c[:2] for c in own_closer.closures]
    q = lc.matcher.detect(frames[2][0])
    all_m, goods = lc.matcher.match_all(q)
    for k, kf in enumerate(lc.keyframes):
        stored = lc.matcher.describe(*frames[k]).kps
        assert kf.node == k and torch.equal(lc.matcher.slot_kps(k).desc, stored.desc)
        m = pf.match(stored, q)
        assert int(goods[k]) == int(m.num_good) and torch.equal(all_m.good[k], m.good)
    assert goods[5] >= 30  # frame 5 renders frame 2's pose: a slot past the first cap


def test_loaded_jax_store_matches_like_jax(seq, jax_closer):
    """`convert.load_store` carries the JAX store over: the port's batched
    match of a query against it gives the JAX per-slot good counts."""
    frames, _ = seq
    lc = LoopCloser(Intrinsics.from_config(CAM), PortLoopClosureConfig(min_separation=4),
                    device="cpu")
    convert.load_store(jax_closer, lc)
    assert lc._num_slots() == jax_closer._num_slots()
    assert [kf.node for kf in lc.keyframes] == [kf.node for kf in jax_closer.keyframes]
    assert len(lc.closures) == len(jax_closer.closures)
    q = _out_and_back(n=15)[4:5]  # a pose between the stored frames
    (g, _), = render_sequence(CAM, q, seed=0)[0]
    _, goods_j = jax_closer.matcher.match_all(jax_closer.matcher.detect(g))
    _, goods_p = lc.matcher.match_all(lc.matcher.detect(g))
    np.testing.assert_array_equal(goods_p, goods_j[: len(goods_p)])
    assert goods_p.max() >= 30


def _inject(lc, R_gt, t_gt, min_sep, seed=4):
    rng = np.random.default_rng(seed)
    for j in range(len(t_gt)):
        for i in range(j - min_sep, -1, -1):
            if np.linalg.norm(t_gt[j] - t_gt[i]) < 0.01:
                dR = R_gt[i].T @ R_gt[j]
                dt = R_gt[i].T @ (t_gt[j] - t_gt[i]) + rng.normal(0, 1e-3, 3)
                lc.closures.append((i, j, dR, dt, 30))
                break


def _drift(n=40, kind="revisit3", seed=11):
    ts = np.arange(n)
    phase = (np.sin(np.pi * ts / (n - 1)) if kind == "outback"
             else np.abs(np.sin(3 * np.pi * ts / (n - 1))))
    amp = 0.12
    psis = np.stack([amp * phase, -0.5 * amp * phase, 0.3 * amp * phase,
                     0.2 * amp * phase, -0.2 * amp * phase, 0.1 * amp * phase],
                    -1).astype(np.float32)
    R_gt, t_gt = (np.asarray(x, np.float64) for x in jgeo.se3_exp(jnp.asarray(psis)))
    rng = np.random.default_rng(seed)
    Rs, tss = [R_gt[0]], [t_gt[0]]
    for k in range(n - 1):
        dR = R_gt[k].T @ R_gt[k + 1]
        dt = 1.04 * (R_gt[k].T @ (t_gt[k + 1] - t_gt[k])) + rng.normal(0, 5e-4, 3)
        tss.append(tss[-1] + Rs[-1] @ dt)
        Rs.append(Rs[-1] @ dR)
    return R_gt, t_gt, np.stack(Rs), np.stack(tss)


@pytest.mark.parametrize("kind", ["outback", "revisit3"])
def test_reanchor_and_graph_refine_match_jax(kind):
    R_gt, t_gt, R_d, t_d = _drift(kind=kind)
    jlc = JaxLoopCloser(JaxIntrinsics.from_config(CAM))
    plc = LoopCloser(Intrinsics.from_config(CAM), device="cpu")
    _inject(jlc, R_gt, t_gt, jlc.cfg.min_loop_separation)
    plc.closures = list(jlc.closures)
    assert plc.closures
    Rj, tj, nj = jlc.refine(R_d, t_d)
    Rp, tp, np_ = plc.refine(R_d, t_d)
    np.testing.assert_allclose(Rp, Rj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_, nj, rtol=0, atol=1e-12)
    si = np.broadcast_to(np.eye(6, dtype=np.float32) * 2.0, (len(t_d) - 1, 6, 6)).copy()
    for kw in ({}, {"odo_sqrt_info": si}, {"robust": "huber"}):
        Rj, tj, nj = jlc.refine(R_d, t_d, mode="graph", iterations=4, **kw)
        Rp, tp, np_ = plc.refine(R_d, t_d, mode="graph", iterations=4, **kw)
        np.testing.assert_allclose(Rp, Rj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np_, nj, rtol=1e-4)


def test_refine_inplace_writes_back_like_jax():
    R_gt, t_gt, R_d, t_d = _drift(n=24, kind="outback")
    jlc = JaxLoopCloser(JaxIntrinsics.from_config(CAM))
    plc = LoopCloser(Intrinsics.from_config(CAM), device="cpu")
    _inject(jlc, R_gt, t_gt, jlc.cfg.min_loop_separation)
    plc.closures = list(jlc.closures)
    gops = []
    for G in (JaxGop, Gop):
        gop = G()
        gop.push_keyframe(0, 1, np.eye(3), np.zeros(3))
        for k in range(1, len(t_d)):
            push = gop.push_keyframe if k % 4 == 0 else gop.push_ordinary
            args = (k, 5) if k % 4 == 0 else (k,)
            rel_R = gop.last_key_R.T @ R_d[k]
            push(*args, rel_R, gop.last_key_R.T @ (t_d[k] - gop.last_key_t))
        gops.append(gop)
    assert jlc.refine_inplace(gops[0], edge_traj=(R_d, t_d), mode="graph") is not None
    assert plc.refine_inplace(gops[1], edge_traj=(R_d, t_d), mode="graph") is not None
    (Rj, tj, _), (Rp, tp, _) = gops[0].poses(), gops[1].poses()
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gops[1].last_key_t, gops[0].last_key_t, rtol=0, atol=1e-5)
