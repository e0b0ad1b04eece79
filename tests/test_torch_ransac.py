"""The port's RANSAC stages against the JAX package's with JAX's random draws
replayed: the epipolar filter (`ops/epipolar.ransac_fundamental_filter`:
identical inliers, F equal up to sign and scale within 1e-3, both
passthrough guards) and RANSAC PnP (`solvers/pnp.ransac_pnp`, kernel B's
plain version: the same best hypothesis, identical inliers, R and t within
1e-5), plus the Gauss-Newton PnP itself. The correspondences are the
matches of two rendered 160x120 frames."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JaxIntrinsics  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu.ops import epipolar as jepi  # noqa: E402
from rgbd_odometry_tpu.pipeline.kf_matcher import KeyframeMatcher  # noqa: E402
from rgbd_odometry_tpu.solvers import pnp as jpnp  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import pnp_gn  # noqa: E402
from rgbd_odometry_tpu_torch.ops import epipolar as pepi  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import pnp as ppnp  # noqa: E402

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=176.0, fy=176.0, cx=79.5, cy=59.5)
K = 384


def _draws(key, s: int, k: int) -> torch.Tensor:
    """The uniforms JAX's RANSAC draws from `key`: uniform(k_i, (k,)) for
    k_i in split(key, s)."""
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(jax.random.split(key, s))
    return torch.from_numpy(np.array(u))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=[(0, 2), (0, 5)], ids=["near", "far"])
def corr(request):
    """Matched correspondences of frames a (stored, with depth) and b
    (query): uv_b, uv_a, candidate mask, the stored 3D points and the
    query's normalized image points."""
    a, b = request.param
    ts = np.arange(6)
    amp = 0.05
    psis = np.stack([amp * ts / 5, -0.5 * amp * ts / 5, 0.3 * amp * ts / 5,
                     0.2 * amp * ts / 5, -0.2 * amp * ts / 5, 0.1 * amp * ts / 5],
                    -1).astype(np.float32)
    frames, poses = render_sequence(CAM, psis, seed=0)
    m = KeyframeMatcher(JaxIntrinsics.from_config(CAM))
    old = m.describe(*frames[a])
    q = m.detect(frames[b][0])
    m.store(old)
    all_m, _ = m.match_all(q)
    mt = jax.tree_util.tree_map(lambda x: x[0], all_m)
    uv_old = jnp.take(old.kps.uv, mt.ref_idx, axis=0)
    valid = mt.good & q.valid & jnp.take(old.kps.valid, mt.ref_idx, axis=0)
    obj = jnp.take(old.pts3d, mt.ref_idx, axis=0)
    ov = jnp.take(old.pts_valid, mt.ref_idx, axis=0)
    imn = jpnp.normalize_image_points(q.uv, m.intr)
    return dict(uv1=q.uv, uv2=uv_old, valid=valid, obj=obj, ov=ov, imn=imn,
                rel=(poses[a][0].T @ poses[b][0], poses[a][0].T @ (poses[b][1] - poses[a][1])))


def _same_up_to_sign_and_scale(Fp, Fj, tol):
    Fp, Fj = Fp / np.linalg.norm(Fp), Fj / np.linalg.norm(Fj)
    return min(np.abs(Fp - Fj).max(), np.abs(Fp + Fj).max()) < tol


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epipolar_filter_matches_jax(corr, seed):
    """Rendered matches: the scene's surfaces leave the 8-point system
    nearly degenerate (several F fit the sample), so F is compared by what
    it decides, the identical inlier set, and by its Sampson error."""
    key = jax.random.PRNGKey(seed)
    c = corr
    assert int(jnp.sum(c["valid"])) >= 20
    want = jepi.ransac_fundamental_filter(key, c["uv1"], c["uv2"], c["valid"])
    got = pepi.ransac_fundamental_filter(_draws(key, 64, K), _t(c["uv1"]), _t(c["uv2"]),
                                         _t(c["valid"]))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 0
    d = pepi.sampson_distance(got.F, _t(c["uv1"]), _t(c["uv2"]))[got.inliers]
    assert float(d.max()) < 9.0


@pytest.mark.parametrize("seed", [0, 1])
def test_epipolar_filter_general_scene_matches_jax(seed):
    """Random 3D points at spread depths seen from two poses (a well-posed F)
    with a quarter of the pairs corrupted: identical inliers, F equal up to
    sign and scale within 1e-3."""
    rng = np.random.default_rng(seed)
    n = 96
    P = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), rng.uniform(1.5, 5, n)], -1)
    R, t = (np.asarray(x, np.float64) for x in jgeo.se3_exp(
        jnp.asarray([0.12, -0.04, 0.03, 0.02, 0.05, -0.01], jnp.float32)))
    Q = (P - t) @ R  # R^T (P - t): the second camera's frame

    def proj(X):
        return np.stack([176.0 * X[:, 0] / X[:, 2] + 79.5, 176.0 * X[:, 1] / X[:, 2] + 59.5], -1)

    uv1, uv2 = proj(Q), proj(P)
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)
    bad = rng.random(n) < 0.25
    uv1[bad] += rng.uniform(-25, 25, (int(bad.sum()), 2))
    uv1, uv2 = uv1.astype(np.float32), uv2.astype(np.float32)
    valid = np.ones(n, bool)
    valid[-6:] = False
    key = jax.random.PRNGKey(seed)
    want = jepi.ransac_fundamental_filter(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                          jnp.asarray(valid))
    got = pepi.ransac_fundamental_filter(_draws(key, 64, n), torch.from_numpy(uv1),
                                         torch.from_numpy(uv2), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) >= int(0.6 * n)
    assert _same_up_to_sign_and_scale(got.F.numpy(), np.asarray(want.F), 1e-3)


def test_epipolar_filter_passthrough_guards(corr):
    c = corr
    key = jax.random.PRNGKey(3)
    # fewer than 8 match slots
    got = pepi.ransac_fundamental_filter(_draws(key, 64, 5), _t(c["uv1"][:5]), _t(c["uv2"][:5]),
                                         torch.ones(5, dtype=torch.bool))
    assert got.inliers.all() and int(got.num_inliers) == 5 and not got.F.any()
    # fewer than min_points valid candidates: every candidate passes
    few = np.zeros(K, bool)
    few[np.nonzero(np.asarray(c["valid"]))[0][:6]] = True
    want = jepi.ransac_fundamental_filter(key, c["uv1"], c["uv2"], jnp.asarray(few))
    got = pepi.ransac_fundamental_filter(_draws(key, 64, K), _t(c["uv1"]), _t(c["uv2"]),
                                         torch.from_numpy(few))
    np.testing.assert_array_equal(got.inliers.numpy(), few)
    np.testing.assert_array_equal(np.asarray(want.inliers), few)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_pnp_matches_jax(corr, seed):
    key = jax.random.PRNGKey(seed)
    c = corr
    mask = c["valid"] & c["ov"]
    want = jpnp.ransac_pnp(key, c["obj"], c["imn"], mask)
    got = ppnp.ransac_pnp(_draws(key, 64, K), _t(c["obj"]), _t(c["imn"]), _t(mask))
    assert int(got.best_hypothesis) == int(want.best_hypothesis)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) >= 12
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-5)
    R_gt, t_gt = c["rel"]
    assert np.linalg.norm(got.t.numpy() - t_gt) < 0.02
    assert np.linalg.norm(got.R.numpy() - R_gt) < 0.02


def test_gn_pnp_matches_jax(corr):
    c = corr
    mask = c["valid"] & c["ov"]
    R0, t0 = jgeo.se3_exp(jnp.asarray([0.01, -0.01, 0.005, 0.01, 0.0, -0.01], jnp.float32))
    Rj, tj, nj = jpnp.gn_pnp(c["obj"], c["imn"], mask, R0, t0, iterations=5)
    Rp, tp, np_ = ppnp.gn_pnp(_t(c["obj"]), _t(c["imn"]), _t(mask), _t(R0), _t(t0), iterations=5)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    # near convergence the norms are float32 rounding noise: 1e-4 of the first
    np.testing.assert_allclose(np_.numpy(), np.asarray(nj), rtol=1e-4, atol=1e-4 * float(nj[0]))
    r_j = jpnp.normalized_residuals(c["obj"], c["imn"], Rj, tj, mask)[0]
    r_p = ppnp.normalized_residuals(_t(c["obj"]), _t(c["imn"]), Rp, tp, _t(mask))
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=0, atol=1e-5)


def test_pnp_gn_batches_problems_independently(corr):
    """Kernel B's plain version over B problems equals each problem run
    alone, and the inlier mask agrees with the counts."""
    c = corr
    obj, imn, mask = _t(c["obj"]), _t(c["imn"]), _t(c["valid"] & c["ov"])
    rng = np.random.default_rng(0)
    masks = torch.from_numpy(rng.random((3, K)) < 0.5) & mask
    R0 = torch.eye(3).expand(3, 3, 3).contiguous()
    t0 = torch.from_numpy(rng.normal(0, 0.01, (3, 3)).astype(np.float32))
    R, t, counts, inl = pnp_gn.pnp_gn(obj, imn, masks, R0, t0, 4, 0.01, mask, write_inliers=True)
    assert torch.equal(counts, inl.sum(-1, dtype=torch.int32))
    for b in range(3):
        Rb, tb, cb, _ = pnp_gn.pnp_gn(obj, imn, masks[b : b + 1], R0[b : b + 1], t0[b : b + 1], 4,
                                      0.01, mask)
        assert torch.equal(Rb[0], R[b]) and torch.equal(tb[0], t[b]) and int(cb) == int(counts[b])
