"""The port's pose-graph refinement (`rgbd_odometry_tpu_torch.solvers.
pose_graph`) against the JAX package's on the same graphs: dense (N = 8) and
matrix-free CG (N = 70) solves, plain, whitened, huber and geman; the
marginal covariance; the information helpers. Tolerances: poses 1e-5
absolute, residual norms 1e-4 relative, covariance 1e-3 relative (both
sides solve in float32 with different summation orders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.solvers import pose_graph as jpg  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import pose_graph as ppg  # noqa: E402

torch.set_num_threads(2)


def _graph(n: int, seed: int, closures: int, outlier: bool = False):
    """A drifted chain of n poses with `closures` loop-closure edges of the
    ground truth (plus one gross outlier when asked): (R, t, odometry
    trajectory R, t, closure list (i, j, R_rel, t_rel, w))."""
    rng = np.random.default_rng(seed)
    psis = np.cumsum(rng.normal(0, 0.03, (n, 6)), axis=0).astype(np.float32)
    psis[0] = 0.0
    R_gt, t_gt = (np.asarray(x, np.float64) for x in jgeo.se3_exp(jnp.asarray(psis)))
    noise = rng.normal(0, 0.004, (n, 6)).astype(np.float32)
    nR, nt = (np.asarray(x, np.float64) for x in jgeo.se3_exp(jnp.asarray(noise)))
    Rs, ts = [R_gt[0]], [t_gt[0]]
    for k in range(n - 1):
        dR = R_gt[k].T @ R_gt[k + 1] @ nR[k]
        dt = R_gt[k].T @ (t_gt[k + 1] - t_gt[k]) + nt[k]
        ts.append(ts[-1] + Rs[-1] @ dt)
        Rs.append(Rs[-1] @ dR)
    lc = []
    for _ in range(closures):
        i = int(rng.integers(0, n // 2))
        j = int(rng.integers(n // 2, n))
        lc.append((i, j, R_gt[i].T @ R_gt[j], R_gt[i].T @ (t_gt[j] - t_gt[i]), 3.0))
    if outlier:
        lc.append((0, n - 1, np.eye(3), np.array([0.5, -0.3, 0.2]), 3.0))
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32), lc


def _edges(R, t, lc, sqrt_info, jax_side: bool):
    m = jpg if jax_side else ppg
    arr = jnp.asarray if jax_side else torch.from_numpy
    odo = m.odometry_edges(arr(R), arr(t), sqrt_info=None if sqrt_info is None else arr(sqrt_info))
    idx = (lambda a: jnp.asarray(a, jnp.int32)) if jax_side else (lambda a: torch.tensor(a))
    closures = m.PoseGraphEdges(
        i=idx([c[0] for c in lc]), j=idx([c[1] for c in lc]),
        R_rel=arr(np.stack([c[2] for c in lc]).astype(np.float32)),
        t_rel=arr(np.stack([c[3] for c in lc]).astype(np.float32)),
        weight=arr(np.array([c[4] for c in lc], np.float32)),
    )
    return m.concat_edges(odo, closures)


def _sqrt_info(n, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(0, 1, (n - 1, 6, 6))
    info = (M @ M.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    return np.asarray(jpg.normalized_information_sqrt(jnp.asarray(info)))


@pytest.mark.parametrize("case", [
    "dense", "dense_sqrt_info", "dense_huber", "dense_geman", "cg", "cg_sqrt_info", "cg_geman",
])
def test_refine_pose_graph_matches_jax(case):
    n = 70 if case.startswith("cg") else 8
    R, t, lc = _graph(n, seed=n, closures=3 if n == 8 else 8, outlier="geman" in case)
    si = _sqrt_info(n, 1) if "sqrt_info" in case else None
    robust = "huber" if "huber" in case else "geman" if "geman" in case else None
    kw = dict(iterations=6, robust=robust, robust_delta=1.0, solver=case.split("_")[0])
    Rj, tj, nj = jpg.refine_pose_graph(jnp.asarray(R), jnp.asarray(t), _edges(R, t, lc, si, True),
                                       **kw)
    Rp, tp, np_ = ppg.refine_pose_graph(torch.from_numpy(R), torch.from_numpy(t),
                                        _edges(R, t, lc, si, False), **kw)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_.numpy(), np.asarray(nj), rtol=1e-4, atol=1e-7)
    assert float(np_[-1]) < float(np_[0])
    if robust is not None:
        wj = jpg.edge_robust_weights(Rj, tj, _edges(R, t, lc, si, True), robust, 1.0)
        wp = ppg.edge_robust_weights(Rp, tp, _edges(R, t, lc, si, False), robust, 1.0)
        np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("solver,n", [("dense", 8), ("cg", 12)])
def test_marginal_covariance_matches_jax(solver, n):
    R, t, lc = _graph(n, seed=5, closures=2)
    nodes = None if solver == "dense" else np.array([0, 3, n - 1])
    cj = np.asarray(jpg.marginal_covariance(
        jnp.asarray(R), jnp.asarray(t), _edges(R, t, lc, None, True), solver=solver,
        nodes=None if nodes is None else jnp.asarray(nodes), robust="huber"))
    cp = ppg.marginal_covariance(
        torch.from_numpy(R), torch.from_numpy(t), _edges(R, t, lc, None, False), solver=solver,
        nodes=None if nodes is None else torch.from_numpy(nodes), robust="huber").numpy()
    assert cp.shape == cj.shape == ((n if nodes is None else 3), 6, 6)
    assert np.all(cp[0] == 0.0)
    scale = np.abs(cj).max()
    np.testing.assert_allclose(cp, cj, rtol=0, atol=1e-3 * scale)


def test_information_sqrt_and_normalization_match_jax():
    rng = np.random.default_rng(2)
    M = rng.normal(0, 1, (5, 6, 6))
    info = (M @ M.transpose(0, 2, 1) * 1e4 + np.eye(6)).astype(np.float32)
    sigma2 = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    for kw in ({}, {"block_normalize": True}):
        j = np.asarray(jpg.normalized_information_sqrt(jnp.asarray(info), jnp.asarray(sigma2), **kw))
        p = ppg.normalized_information_sqrt(torch.from_numpy(info), torch.from_numpy(sigma2),
                                            **kw).numpy()
        np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ppg.information_sqrt(torch.from_numpy(info)).numpy(),
                               np.asarray(jpg.information_sqrt(jnp.asarray(info))), rtol=1e-4)


@pytest.mark.parametrize("method", ["gauss_newton", "subgradient"])
def test_pose_information_matches_jax(method):
    """`edge_dvo.pose_information` on the same extracted levels and pose as
    the JAX function: the information matrix within 1% relative (the
    tests/test_fused_iter.py bar), sigma2 and n_eff within 1e-3 relative;
    `pose_covariance` of both agrees at the same bar."""
    import jax

    from rgbd_odometry_tpu.config import CameraConfig, SolverConfig
    from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics
    from rgbd_odometry_tpu.io.synthetic import render_pair
    from rgbd_odometry_tpu.solvers import edge_dvo as jed
    from rgbd_odometry_tpu_torch import convert
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted

    cam = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    cfg = SolverConfig(method=method, iterations=(18, 6))
    (rg, rd), (ng, _), _ = render_pair(cam, np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003],
                                                     np.float32), seed=0)
    intr = JIntrinsics.from_config(cam)
    ref = jax.jit(lambda g, d: jed.extract_ref_level(g, d, intr, 2048, cfg))(
        jnp.asarray(rg), jnp.asarray(rd))
    now = jax.jit(lambda g: jed.prepare_now_level(g, cfg))(jnp.asarray(ng))
    R, t = jgeo.se3_exp(jnp.asarray([0.01, -0.007, 0.005, 0.003, -0.004, 0.002], jnp.float32))
    info_j, s2_j, n_j = (np.asarray(x, np.float64) for x in jax.jit(
        lambda r, n: jed.pose_information(r, n, intr, cfg, R, t))(ref, now))
    info_p, s2_p, n_p = ted.pose_information(convert.ref_level(ref, device="cpu"),
                                             convert.now_level(now, device="cpu"),
                                             Intrinsics.from_config(cam), cfg,
                                             *convert.pose(R, t, device="cpu"))
    info_p = info_p[0].double().numpy()
    assert np.abs(info_p - info_j).max() <= 1e-2 * np.abs(info_j).max()
    np.testing.assert_allclose(float(s2_p[0]), s2_j, rtol=1e-3)
    np.testing.assert_allclose(float(n_p[0]), n_j, rtol=1e-3)
    cov_j = jed.pose_covariance(info_j, s2_j, n_j)
    cov_p = ted.pose_covariance(info_p, float(s2_p[0]), float(n_p[0]))
    assert np.abs(cov_p - cov_j).max() <= 1e-2 * np.abs(cov_j).max()


def test_edges_carry_over_from_jax():
    """`convert.edges_from_jax` turns the JAX package's edges (whitened odometry plus
    closures) into the port's: the same tensors the port builds itself from
    the same trajectory, within float32 rounding of the relative poses."""
    from rgbd_odometry_tpu_torch import convert

    R, t, lc = _graph(10, seed=3, closures=2)
    si = _sqrt_info(10, 2)
    got = convert.edges_from_jax(_edges(R, t, lc, si, True), device="cpu")
    want = _edges(R, t, lc, si, False)
    assert got.i.dtype == want.i.dtype == torch.int64
    assert torch.equal(got.i, want.i) and torch.equal(got.j, want.j)
    for name in ("R_rel", "t_rel", "weight", "sqrt_info"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   rtol=0, atol=1e-6)
