"""The port's sparse feature front-end (`rgbd_odometry_tpu_torch.ops.
features`) and kernel A's plain version against the JAX package on rendered
160x120 frames: Harris response within 1e-5 relative (bitwise in practice),
the same corners in the same order, descriptors and match distances bit for
bit (the bar is 1e-5), identical matches (`ref_idx`, `good`) on rendered
pairs, on a frame's exact duplicate and on a near-duplicate pair with the
relocalizer's 0.2 gate floor."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu.ops import features as jf  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import match as kmatch  # noqa: E402
from rgbd_odometry_tpu_torch.ops import features as pf  # noqa: E402

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=176.0, fy=176.0, cx=79.5, cy=59.5)


@pytest.fixture(scope="module")
def frames():
    ts = np.arange(8)
    phase = np.sin(np.pi * ts / 7)
    amp = 0.04
    psis = np.stack([amp * phase, -0.5 * amp * phase, 0.3 * amp * phase,
                     0.2 * amp * phase, -0.2 * amp * phase, 0.1 * amp * phase], -1)
    frames, _ = render_sequence(CAM, psis.astype(np.float32), seed=0)
    rng = np.random.default_rng(1)
    noisy = frames[0][0] + rng.normal(0, 2.0, frames[0][0].shape).astype(np.float32)
    return [g for g, _ in frames] + [noisy]


@pytest.mark.parametrize("idx", [0, 3, 8])
def test_harris_response_matches_jax(frames, idx):
    g = frames[idx]
    want = np.asarray(jf.harris_response(jnp.asarray(g)))
    got = pf.harris_response(torch.from_numpy(g)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("idx,k_max", [(0, 384), (2, 384), (8, 384), (5, 16)])
def test_detect_and_describe_matches_jax(frames, idx, k_max):
    g = frames[idx]
    kj = jf.detect_and_describe(jnp.asarray(g), k_max)
    kp = pf.detect_and_describe(torch.from_numpy(g), k_max)
    assert int(kp.count) == int(kj.count) > 0
    np.testing.assert_array_equal(kp.valid.numpy(), np.asarray(kj.valid))
    # every slot's uv, the tie-ordered slots past the last corner included
    np.testing.assert_array_equal(kp.uv.numpy(), np.asarray(kj.uv))
    np.testing.assert_array_equal(kp.score.numpy(), np.asarray(kj.score))
    # the mean and norm are summed in XLA's order: bitwise, inside 1e-5
    np.testing.assert_array_equal(kp.desc.numpy(), np.asarray(kj.desc))


@pytest.mark.parametrize("pair,floor", [((0, 1), 1e-3), ((2, 4), 1e-3), ((1, 6), 1e-3),
                                        ((0, 8), 0.2), ((0, 0), 0.2)])
def test_match_matches_jax(frames, pair, floor):
    a, b = (frames[i] for i in pair)
    ja, jb = (jf.detect_and_describe(jnp.asarray(g), 384) for g in (a, b))
    pa, pb = (pf.detect_and_describe(torch.from_numpy(g), 384) for g in (a, b))
    mj = jf.match(ja, jb, dist_gate_floor=floor)
    mp = pf.match(pa, pb, dist_gate_floor=floor)
    assert int(mp.num_good) == int(mj.num_good) > 0
    np.testing.assert_array_equal(mp.ref_idx.numpy(), np.asarray(mj.ref_idx))
    np.testing.assert_array_equal(mp.good.numpy(), np.asarray(mj.good))
    # the similarities are the same fused multiply-add chain as XLA's dot
    np.testing.assert_array_equal(mp.dist.numpy(), np.asarray(mj.dist))


def test_match_mutual_batches_slots_as_one_match_each(frames):
    """Kernel A's plain version over S slots (one of them empty) equals
    `match` per slot, and the JAX vmapped match over the same slots."""
    # slot 3 (frame 6) renders the query's pose: min_d is 0 and the 1e-3
    # gate decides on float32 rounding
    kps = [pf.detect_and_describe(torch.from_numpy(frames[i]), 384) for i in (0, 3, 6)]
    q = pf.detect_and_describe(torch.from_numpy(frames[1]), 384)
    desc = torch.stack([k.desc for k in kps] + [torch.zeros_like(q.desc)])
    valid = torch.stack([k.valid for k in kps] + [torch.zeros_like(q.valid)])
    ref_idx, dist, good, num_good = kmatch.match_mutual(desc, valid, q.desc, q.valid)
    assert num_good.shape == (4,) and int(num_good[3]) == 0
    for s, k in enumerate(kps):
        m = pf.match(k, q)
        assert torch.equal(ref_idx[s], m.ref_idx) and torch.equal(good[s], m.good)
        assert torch.equal(dist[s], m.dist) and int(num_good[s]) == int(m.num_good)
        mj = jf.match(jf.detect_and_describe(jnp.asarray(frames[(0, 3, 6)[s]]), 384),
                      jf.detect_and_describe(jnp.asarray(frames[1]), 384))
        np.testing.assert_array_equal(good[s].numpy(), np.asarray(mj.good))


def test_match_mutual_refuses_other_devices(frames):
    k = pf.detect_and_describe(torch.from_numpy(frames[0]), 32)
    meta = [x.to("meta") for x in (k.desc[None], k.valid[None], k.desc, k.valid)]
    with pytest.raises(ValueError, match="unsupported device"):
        kmatch.match_mutual(*meta)
