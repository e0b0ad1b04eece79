"""The production solve of the PyTorch port against the JAX package on the
CPU: the pose primitives to 1e-6; the deferred-accept LM level solve on
identical levels carried across with `convert.py`; `align_pair` on a batch
of 4 rendered pairs, each pose within JAX's own bar against ground truth
(|t - t_gt| < 0.02, |R - R_gt| < 0.02, tests/test_gather_grad.py) and
within 1 mm / 1e-3 of the JAX pose."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jbuild  # noqa: E402
from rgbd_odometry_tpu.ops.linalg6 import chol_solve6 as jchol  # noqa: E402
from rgbd_odometry_tpu.profiles import production_320  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.core import geometry as tgeo  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.ops.linalg6 import chol_solve6  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(1)

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
CFG = dataclasses.replace(production_320().solver, iterations=(18, 6, 4))
MAX_POINTS = (2048, 1024, 512)


def _twists(n):
    base = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
    rng = np.random.default_rng(5)
    return [
        (base * (1 + 0.3 * rng.uniform(-1, 1, 6)) * (1 if i % 2 else -1)).astype(np.float32)
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def pairs():
    return [render_pair(CAM, psi, seed=i) for i, psi in enumerate(_twists(4))]


def test_pose_primitives_match_jax():
    rng = np.random.default_rng(0)
    psi = (rng.standard_normal((64, 6)) * np.array([0.1] * 3 + [0.5] * 3)).astype(np.float32)
    psi[:4, 3:] = [[0, 0, 0], [1e-5, 0, 0], [0, 2e-4, -1e-4], [3e-3, 1e-3, 0]]  # Taylor branch
    R_j, t_j = jgeo.se3_exp(jnp.asarray(psi))
    R_t, t_t = tgeo.se3_exp(torch.from_numpy(psi))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0, atol=1e-6)
    Rn = np.asarray(R_j) + 1e-3 * rng.standard_normal((64, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.rotationize_newton(torch.from_numpy(Rn)).numpy(),
        np.asarray(jgeo.rotationize_newton(jnp.asarray(Rn))), rtol=0, atol=1e-6,
    )
    Rc, tc = tgeo.compose(R_t[:32], t_t[:32], *tgeo.inverse(R_t[:32], t_t[:32]))
    np.testing.assert_allclose(Rc.numpy(), np.broadcast_to(np.eye(3), (32, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), 0.0, atol=1e-6)


def test_chol_solve6_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((32, 6, 6)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    g = rng.standard_normal((32, 6)).astype(np.float32)
    x_t = chol_solve6(torch.from_numpy(H), torch.from_numpy(g)).numpy()
    x_j = np.asarray(jchol(jnp.asarray(H), jnp.asarray(g)))
    # 1e-6 of each solution's scale (measured 8.2e-7: the two sum the
    # factor's inner products in different orders)
    scale = np.abs(x_j).max(axis=-1, keepdims=True)
    assert (np.abs(x_t - x_j) <= 1e-6 * scale).all()
    # degenerate system (no visible points): finite zero step, as in JAX
    z = chol_solve6(torch.zeros((1, 6, 6)), torch.zeros((1, 6)))
    assert torch.equal(z, torch.zeros((1, 6)))


@pytest.mark.parametrize("regime", ["production", "reject_heavy"])
def test_level_solve_on_identical_levels(pairs, regime):
    """JAX and the port solve level 0 from the same carried-across keyframe
    features and DT target. The reject-heavy regime (near-zero damping, a
    wide trust region; tests/test_gather_grad.py) forces proposals to be
    rejected and reverted."""
    cfg = CFG if regime == "production" else dataclasses.replace(
        CFG, lm_damping=1e-9, lm_trust_region=0.5
    )
    (rg, rd), (ng, nd), (R_gt, t_gt) = pairs[0]
    intr = JIntrinsics.from_config(CAM)
    ref = jax.jit(lambda g, d: jed.extract_ref_level(g, d, intr, 2048, cfg))(jnp.asarray(rg), jnp.asarray(rd))
    now = jax.jit(lambda g: jed.prepare_now_level(g, cfg))(jnp.asarray(ng))
    R0, t0 = jgeo.se3_exp(jnp.asarray(np.array([0.008, -0.004, 0.004, 0.003, -0.004, 0.002], np.float32)))
    R_j, t_j, d_j = jax.jit(lambda r, n: jed.run_level(r, n, intr, R0, t0, cfg, 18))(ref, now)
    R_p, t_p, d_p = ted.run_level(
        convert.ref_level(ref, device="cpu"), convert.now_level(now, device="cpu"),
        Intrinsics.from_config(CAM),
        *convert.pose(R0, t0, device="cpu"), cfg, 18,
    )
    R_j, t_j = np.asarray(R_j), np.asarray(t_j)
    assert np.linalg.norm(t_p[0].numpy() - t_j) < 1e-3
    assert np.abs(R_p[0].numpy() - R_j).max() < 1e-3
    bar = 0.02 if regime == "production" else 0.05
    assert np.linalg.norm(t_p[0].numpy() - t_gt) < bar
    # The two take the same accept/reject decisions (the same plateaus of
    # reverted proposals, the same best iteration: 17 in production, 3 in the
    # reject-heavy regime on this pair); each energy differs by the bf16
    # rounding of the TPU gathers, measured <= 8e-4 relative (pose: 2e-5 m).
    e_j, e_p = np.asarray(d_j.energy), d_p.energy[0].numpy()
    assert e_p.shape == e_j.shape == (18,)
    np.testing.assert_allclose(e_p, e_j, rtol=2e-3)
    assert int(d_p.best_iter[0]) == int(d_j.best_iter)
    np.testing.assert_allclose(float(d_p.visible_ratio[0]), float(d_j.visible_ratio), atol=5e-3)
    np.testing.assert_allclose(float(d_p.best_energy[0]), float(d_j.best_energy), rtol=1e-3)
    assert int(d_p.num_points[0]) == int(d_j.num_points)
    assert d_p.final_epsilons.shape == (1, 2048)


def test_align_pair_batch_matches_jax_and_ground_truth(pairs):
    st = lambda i, j: torch.from_numpy(np.stack([p[i][j] for p in pairs]))  # noqa: E731
    ref = build_pyramid(st(0, 0), st(0, 1), 3)
    now = build_pyramid(st(1, 0), st(1, 1), 3)
    R, t, diags = ted.align_pair(ref.gray, ref.depth, now.gray, Intrinsics.from_config(CAM), CFG, MAX_POINTS)
    assert R.shape == (4, 3, 3) and t.shape == (4, 3) and len(diags) == 3
    assert diags[0].final_epsilons.shape == (4, 2048) and diags[0].energy.shape == (4, 18)
    jintr = JIntrinsics.from_config(CAM)
    f = jax.jit(lambda rg, rd, ng: jed.align_pair(rg, rd, ng, jintr, CFG, MAX_POINTS)[:2])
    for i, ((rg, rd), (ng, nd), (R_gt, t_gt)) in enumerate(pairs):
        r, n = jbuild(jnp.asarray(rg), jnp.asarray(rd), 3), jbuild(jnp.asarray(ng), jnp.asarray(nd), 3)
        R_j, t_j = (np.asarray(x) for x in f(r.gray, r.depth, n.gray))
        R_p, t_p = R[i].numpy(), t[i].numpy()
        assert np.linalg.norm(t_p - t_gt) < 0.02, i
        assert np.linalg.norm(R_p - R_gt) < 0.02, i
        assert np.linalg.norm(t_p - t_j) < 1e-3, i
        assert np.abs(R_p - R_j).max() < 1e-3, i
