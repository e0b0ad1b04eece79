"""The port's photometric DVO (`rgbd_odometry_tpu_torch/solvers/photometric.py`;
on CPU tensors `kernels/level_photo.level_photo` runs its plain version)
against the JAX package on the CPU, on the 160x120 camera of the JAX tests:
reference extraction, the residual, the sampler and `solve_pyramid` in JAX's
scenarios (tests/test_secondary_solvers.py) and under every option; a
level's sums in the kernel's order at every cluster size (`_block_sum`
against a model of the kernel's threads, warps and ranks) and held to JAX
there."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig as JaxCamera  # noqa: E402
from rgbd_odometry_tpu.config import PhotometricConfig as JaxPhotoConfig  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JaxIntrinsics  # noqa: E402
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jax_pyramid  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu.solvers import photometric as jphoto  # noqa: E402
from rgbd_odometry_tpu_torch.config import PhotometricConfig  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import level_photo as klp  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import photometric as pphoto  # noqa: E402

CAM = JaxCamera(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
INTR = Intrinsics(130.0, 130.0, 79.5, 59.5)
PSI = np.array([0.008, -0.005, 0.003, 0.002, -0.003, 0.002], np.float32)


def _pyrs(gray, depth):
    j = jax_pyramid(jnp.asarray(gray), jnp.asarray(depth), 4)
    p = build_pyramid(torch.from_numpy(gray)[None], torch.from_numpy(depth)[None], 4)
    return j, ([g[0] for g in p.gray], [d[0] for d in p.depth])


@pytest.fixture(scope="module")
def pair():
    (rg, rd), (ng, nd), gt = render_pair(CAM, PSI)
    return _pyrs(rg, rd), _pyrs(ng, nd), gt


def _refs(pair, **kw):
    (jref, (pg, pd)), _, _ = pair
    jc, pc = JaxPhotoConfig(**kw), PhotometricConfig(**kw)
    jr = jphoto.extract_photo_ref(jref.gray, jref.depth, JaxIntrinsics.from_config(CAM), jc,
                                  jc.max_points)
    pr = pphoto.extract_photo_ref(pg, pd, INTR, pc, pc.max_points)
    return jc, pc, jr, pr


def test_extraction_matches_jax_selection_and_order(pair):
    """Every level's reference: the selected pixels in raster order, then the
    padding in raster order (lax.top_k's order of 0/1 scores, taken by a
    stable partition), their points, intensities, validity, count and
    Jacobian bitwise JAX's; A = J^T J within 1e-6 of its largest entry
    (a sum of K products in another order)."""
    _, _, jr, pr = _refs(pair)
    for lvl, (a, b) in enumerate(zip(jr, pr)):
        for name in ("pts3d", "intensity", "J", "valid", "count"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                          err_msg=f"level {lvl} {name}")
        Aj = np.asarray(a.A)
        assert np.abs(b.A.numpy() - Aj).max() <= 1e-6 * np.abs(Aj).max()
    assert int(pr[2].count) > 50 and pr[0].pts3d.shape == (8192, 3)


@pytest.mark.parametrize("bilinear", [False, True])
def test_photometric_residual_matches_jax(pair, bilinear):
    """The residual at a moved pose on every level against JAX's jitted
    residual: bitwise, with the visibility, in floor and bilinear mode."""
    _, (jnow, (ng, _)), _ = pair
    jc, pc, jr, pr = _refs(pair, bilinear=bilinear)
    R, t = jphoto.geo.se3_exp(jnp.asarray(PSI * 0.7))
    for lvl in range(4):
        intr = JaxIntrinsics.from_config(CAM).at_level(lvl)
        # jitted, as solve_level's scan runs it (eagerly XLA fuses nothing)
        ej, vj = jax.jit(lambda r, g, R, t: jphoto.photometric_residual(r, g, intr, R, t, jc))(
            jr[lvl], jnow.gray[lvl], R, t)
        ep, vp = pphoto.photometric_residual(pr[lvl], ng[lvl], INTR.at_level(lvl),
                                             torch.from_numpy(np.asarray(R)),
                                             torch.from_numpy(np.asarray(t)), pc)
        np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(ep.numpy(), np.asarray(ej))


def test_sample_now_clamps_and_snaps_like_jax():
    """`_sample_now` at coordinates on, near and past the image edges (u = W
    reads column W - 1, as the one-hot weights clamp) and within the snap
    distance of integers: bitwise JAX's in floor mode; bilinear within one
    ulp of each sampled value (on this 20-column image XLA:CPU sums the
    one-hot column products in another order than at the solver's widths,
    where the residual test holds the sampler bitwise)."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (15, 20)).astype(np.float32)
    u = np.concatenate([[20.0, 19.0, 19.9995, 0.0, -0.4, 20.6, 3.0007, 7.5],
                        rng.uniform(-2, 22, 40)]).astype(np.float32)
    v = np.concatenate([[15.0, 14.0, 14.9993, 0.0, -0.3, 15.7, 2.9998, 7.5],
                        rng.uniform(-2, 17, 40)]).astype(np.float32)
    for bilinear in (False, True):
        want = np.asarray(jphoto._sample_now(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v),
                                             "mxu", bilinear))
        got = pphoto._sample_now(torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v),
                                 bilinear=bilinear).numpy()
        if bilinear:
            assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
        else:
            np.testing.assert_array_equal(got, want)
    assert float(pphoto._sample_now(torch.from_numpy(img), torch.tensor([20.0]),
                                    torch.tensor([3.0]))[0]) == img[3, 19]


def _early_exit(hist, exit_norm):
    below = np.nonzero(np.asarray(hist) < exit_norm)[0]
    return int(below[0]) if len(below) else -1


SCENARIOS = {
    "defaults": dict(),
    "recover_small_motion": dict(levels=(2, 1), iterations_per_level=15, eps_norm_exit=0.0,
                                 use_huber=True),
    "zero_exit": dict(levels=(3, 2), eps_norm_exit=0.0),
    "bilinear": dict(bilinear=True, iterations_per_level=6, eps_norm_exit=0.0),
    "reweighted_huber": dict(reweight_normal_matrix=True, use_huber=True, eps_norm_exit=0.0,
                             iterations_per_level=6),
    "reweighted_plain": dict(reweight_normal_matrix=True, levels=(2,), eps_norm_exit=0.0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_solve_pyramid_matches_jax(pair, name):
    """`solve_pyramid` from the identity: pose within 1e-5 of JAX's, every
    level's |eps| history within 1e-4 of its largest value, the same early
    exit iteration (|eps| < eps_norm_exit), and the history's levels in
    `cfg.levels` order."""
    _, (jnow, (ng, _)), _ = pair
    jc, pc, jr, pr = _refs(pair, **SCENARIOS[name])
    Rj, tj, hj = jphoto.solve_pyramid(jr, jnow.gray, JaxIntrinsics.from_config(CAM), jc)
    Rp, tp, hp = pphoto.solve_pyramid(pr, ng, INTR, pc)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    assert list(hp) == list(hj)
    for lvl in hj:
        e_j, e_p = np.asarray(hj[lvl]), hp[lvl].numpy()
        assert np.abs(e_p - e_j).max() <= 1e-4 * np.abs(e_j).max()
        assert _early_exit(e_p, pc.eps_norm_exit) == _early_exit(e_j, jc.eps_norm_exit)


def test_zero_and_small_motion_scenarios(pair):
    """JAX's `test_photometric_zero_motion` and
    `test_photometric_recovers_small_motion` on the port: a pair against
    itself stays at the identity (2e-3 rad, 3 mm), and the small motion's
    reprojection error at level 1 falls below 0.6 of the identity's."""
    (jref, (pg, pd)), (_, (ng, _)), (R_gt, t_gt) = pair
    cfg = PhotometricConfig(levels=(3, 2), eps_norm_exit=0.0)
    refs = pphoto.extract_photo_ref(pg, pd, INTR, cfg, cfg.max_points)
    R, t, _ = pphoto.solve_pyramid(refs, pg, INTR, cfg)
    ang = np.arccos(np.clip((np.trace(R.numpy()) - 1) / 2, -1, 1))
    assert ang < 2e-3 and np.linalg.norm(t.numpy()) < 3e-3
    cfg = PhotometricConfig(levels=(2, 1), iterations_per_level=15, eps_norm_exit=0.0,
                            use_huber=True)
    refs = pphoto.extract_photo_ref(pg, pd, INTR, cfg, cfg.max_points)
    R, t, hist = pphoto.solve_pyramid(refs, ng, INTR, cfg)
    K = INTR.at_level(1)
    pts, pv = refs[1].pts3d.numpy().astype(np.float64), refs[1].valid.numpy()

    def proj(Rm, tm):
        xp = (pts - np.asarray(tm, np.float64)) @ np.asarray(Rm, np.float64)
        z = np.where(np.abs(xp[:, 2]) < 1e-9, 1e-9, xp[:, 2])
        return np.stack([K.fx * xp[:, 0] / z + K.cx, K.fy * xp[:, 1] / z + K.cy], -1)

    d0 = np.linalg.norm(proj(np.eye(3), np.zeros(3)) - proj(R_gt, t_gt), axis=-1)[pv].mean()
    d = np.linalg.norm(proj(R.numpy(), t.numpy()) - proj(R_gt, t_gt), axis=-1)[pv].mean()
    assert d < 0.6 * d0
    assert hist[2].min() <= hist[2][0]


def test_batched_pairs_solve_independently(pair):
    """B pairs in one `level_photo` call (batched references and images)
    equal each pair solved alone, bit for bit, and `solve_level` is a
    pyramid of one level."""
    (_, (pg, pd)), (_, (ng, nd)), _ = pair
    cfg = PhotometricConfig(use_huber=True, eps_norm_exit=0.0)
    gray = [torch.stack([a, b, a]) for a, b in zip(pg, ng)]
    depth = [torch.stack([a, b, a]) for a, b in zip(pd, nd)]
    now = [torch.stack([b, a, a]) for a, b in zip(pg, ng)]
    refs = pphoto.extract_photo_ref(gray, depth, INTR, cfg, cfg.max_points)
    R, t, hist = pphoto.solve_pyramid(refs, now, INTR, cfg)
    for b in range(3):
        one = pphoto.extract_photo_ref([g[b] for g in gray], [d[b] for d in depth], INTR, cfg,
                                       cfg.max_points)
        R1, t1, h1 = pphoto.solve_pyramid(one, [g[b] for g in now], INTR, cfg)
        assert torch.equal(R[b], R1) and torch.equal(t[b], t1)
        assert all(torch.equal(hist[lvl][b], h1[lvl]) for lvl in h1)
    R2, t2, h2 = pphoto.solve_level(one[2], now[2][2], INTR.at_level(2), None, None, cfg)
    R3, t3, h3 = pphoto.solve_pyramid(one, [g[2] for g in now], INTR,
                                      PhotometricConfig(use_huber=True, eps_norm_exit=0.0,
                                                        levels=(2,)))
    assert torch.equal(R2, R3) and torch.equal(t2, t3) and torch.equal(h2, h3[2])


def test_level_photo_checks_its_device():
    """The wrapper runs the plain version only for CPU tensors; any other
    device raises before anything is built."""
    m = dict(device="meta")
    lv = klp.PhotoLevel(torch.zeros((1, 4, 3), **m), torch.zeros((1, 4), **m),
                        torch.zeros((1, 4, 6), **m), torch.zeros((1, 6, 6), **m),
                        torch.zeros((1, 4), dtype=torch.bool, **m), torch.zeros((1, 5, 6), **m),
                        1.0, 1.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        klp.level_photo(torch.zeros((1, 3, 3), **m), torch.zeros((1, 3), **m), (lv,),
                        PhotometricConfig())
    assert klp.level_photo.launches == 0


@pytest.mark.parametrize("ranks", klp.CLUSTERS)
def test_block_sum_is_the_kernels_order(ranks):
    """`_block_sum` bitwise a model of the kernel's sum on `ranks` blocks of
    256 threads: point i on rank (i // 256) % ranks, thread i % 256, each
    thread's running sum from 0 in point order, each warp's shuffle-down
    tree (lane l gets lane l + s at s = 16, ..., 1), the 8 warps' sums in
    order, the ranks' sums in order; at K = 37, 1000 and 2048, within float32
    rounding of the float64 sum."""
    rng = np.random.default_rng(ranks)
    for k in (37, 1000, 2048):
        x = rng.normal(0.0, 100.0, (2, k, 7)).astype(np.float32)
        got = klp._block_sum(torch.from_numpy(x), ranks).numpy()
        want = np.zeros((2, 7), np.float32)
        for b in range(2):
            rank_sums = []
            for q in range(ranks):
                acc = np.zeros((256, 7), np.float32)
                for i in range(k):
                    if (i // 256) % ranks == q:
                        acc[i % 256] = acc[i % 256] + x[b, i]
                warps = []
                for w in range(8):
                    lanes = acc[32 * w:32 * w + 32].copy()
                    s = 16
                    while s >= 1:
                        lanes[:s] = lanes[:s] + lanes[s:2 * s]
                        s //= 2
                    warps.append(lanes[0])
                tot = warps[0]
                for v in warps[1:]:
                    tot = tot + v
                rank_sums.append(tot)
            tot = rank_sums[0]
            for v in rank_sums[1:]:
                tot = tot + v
            want[b] = tot
        np.testing.assert_array_equal(got, want)
        exact = x.astype(np.float64).sum(1)
        assert np.abs(got - exact).max() <= 1e-5 * np.abs(x).sum(1).max()


def test_level_ranks_rule_and_forced_clusters():
    """The route rule is a function of K alone: the fewest ranks with at
    most `POINTS_A_RANK` points each, at most 8; `cluster` forces 1, 2, 4 or
    8 and nothing else."""
    p = klp.POINTS_A_RANK
    assert [klp.level_ranks(k) for k in (1, p, p + 1, 2 * p, 2 * p + 1, 4 * p + 1, 100 * p)] == [
        1, 1, 2, 2, 4, 8, 8]
    assert [klp.level_ranks(37, c) for c in klp.CLUSTERS] == list(klp.CLUSTERS)
    with pytest.raises(ValueError, match="cluster must be one of"):
        klp.level_ranks(1000, 3)


@functools.lru_cache(maxsize=None)
def _level_case(k: int, reweight: bool):
    """A level of K points and JAX's `solve_level` on it from a moved start.
    K = 1000 and 2048: the 160x120 level 0 reference (634 selected pixels,
    then raster-ordered invalid padding). K = 37: the reference of the same
    frame with depth only on a 4-pixel grid (43 selected pixels spread over
    the image; the first 37 taken). The first 37 selected pixels of the full
    frame lie on one strip of rows, where the 6x6 system is so ill-
    conditioned that the two packages' float32 sum orders alone part by
    1.6e-5 (2.6e-4 reweighted), the same on one rank as on eight."""
    (rg, rd), (ng, _), _ = render_pair(CAM, PSI)
    if k < 256:
        grid = np.zeros_like(rd, bool)
        grid[::4, ::4] = True
        rd = np.where(grid, rd, 0.0).astype(rd.dtype)
    kw = dict(use_huber=True, eps_norm_exit=0.0, iterations_per_level=5,
              reweight_normal_matrix=reweight)
    jc, pc = JaxPhotoConfig(**kw), PhotometricConfig(**kw)
    jintr = JaxIntrinsics.from_config(CAM)
    jr = jphoto.extract_photo_ref_level(jnp.asarray(rg), jnp.asarray(rd), jintr, k, jc)
    pr = pphoto.extract_photo_ref_level(torch.from_numpy(rg), torch.from_numpy(rd), INTR, k, pc)
    R0, t0 = jphoto.geo.se3_exp(jnp.asarray(PSI * 0.3))
    want = jphoto.solve_level(jr, jnp.asarray(ng), jintr, R0, t0, jc)
    return pc, pr, torch.from_numpy(ng), (np.asarray(R0), np.asarray(t0)), [np.asarray(x)
                                                                         for x in want]


@pytest.mark.parametrize("reweight", [False, True])
@pytest.mark.parametrize("k", [37, 1000, 2048])
@pytest.mark.parametrize("cluster", klp.CLUSTERS)
def test_level_photo_plain_matches_jax_at_every_cluster(cluster, k, reweight):
    """`level_photo` (plain on the CPU) on a level of K = 37, 1000 or 2048
    points (not multiples of 32 or 256) with its sums in the kernel's order
    on 1, 2, 4 and 8 ranks, cached and reweighted normal matrix: pose within
    1e-5 of JAX's `solve_level`, |eps| history within 1e-4 of its largest
    value (the bars of `test_solve_pyramid_matches_jax`)."""
    pc, pr, now, (R0, t0), (Rj, tj, hj) = _level_case(k, reweight)
    assert pr.pts3d.shape == (k, 3) and int(pr.count) >= min(k, 43)
    lv = pphoto._levels(pr, now, INTR)
    R, t, hist = klp.level_photo(torch.from_numpy(R0)[None], torch.from_numpy(t0)[None], (lv,),
                                 pc, cluster=cluster)
    np.testing.assert_allclose(R[0].numpy(), Rj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t[0].numpy(), tj, rtol=0, atol=1e-5)
    assert np.abs(hist[0, 0].numpy() - hj).max() <= 1e-4 * np.abs(hj).max()
