"""The port's reference-parity mode on the CPU against the JAX package:
every `SolverConfig` branch JAX accepts (`interpolate_dt`, `take` gathers
for Gauss-Newton, "channels" gradients, float32 channels, the swapped
Jacobians, the SVD `rotationize`, `collect_trajectory`).

* `ops/interp.gather_bilinear` / `gather_sqrt_bilinear`, the exact-EDT
  chain (`edt_l2`, `normalize_minmax`, `distance_transform_of_edges`) and
  `prepare_now_level` with float32 Gauss-Newton channels: bitwise JAX's,
  integer coordinates and both clamped borders included;
* `core/geometry.rotationize_svd`: within 1e-6 of JAX's, a reflection and
  a singular input included;
* `_jacobian_residual` in every branch: the visible count exact, J^T W J,
  J^T W eps and the energy within 1e-6 relative where every gather is
  float32, within `tests/test_fused_iter.py`'s bars (1% and 1e-3) where JAX
  rounds to bf16;
* `run_level(..., collect_trajectory=True)` against JAX's (trajectory
  1e-5, energies rtol 1e-4, the oracle tests' bars) on the kernels' plain
  twins, the general loop's deferred LM against JAX's, and the default
  sub-gradient against the float64 numpy oracle
  `tests/oracle_subgradient.py`;
* the routing rule: no configuration reaches `run_level_loop` (every one
  takes the level kernels' plain twins on the CPU), and the plain twins'
  outputs are bitwise the same with and without the trajectory output.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oracle_subgradient import run_level_oracle  # noqa: E402
from rgbd_odometry_tpu import profiles as jprofiles  # noqa: E402
from rgbd_odometry_tpu.config import CameraConfig, SolverConfig  # noqa: E402
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.ops import distance_transform as jdt  # noqa: E402
from rgbd_odometry_tpu.ops import interp as jinterp  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.core import geometry as tgeo  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import level_lm as klm  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import level_sg as klsg  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import point_sem  # noqa: E402
from rgbd_odometry_tpu_torch.ops import distance_transform as tdt  # noqa: E402
from rgbd_odometry_tpu_torch.ops import interp as tinterp  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

import test_subgradient_oracle as oracle_case  # noqa: E402

torch.set_num_threads(1)

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
BASE = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
START = np.array([0.008, -0.004, 0.004, 0.003, -0.004, 0.002], np.float32)
SG = SolverConfig()  # the reference's sub-gradient
GN = SolverConfig(method="gauss_newton")  # the dvo command's standard LM


def _branches():
    """Every distinct per-point branch of JAX `_jacobian_residual`: name ->
    (config, JAX rounds to bf16)."""
    out = {}
    for jac in ("auto", "reference"):
        for mode in ("interpolant", "channels"):
            for dtype in ("bfloat16", "float32"):
                out[f"gn_mxu_{mode}_{dtype}_{jac}"] = (dataclasses.replace(
                    GN, gn_gradient_mode=mode, gather_dtype=dtype, jacobian_mode=jac),
                    dtype == "bfloat16")
        out[f"gn_take_{jac}"] = (dataclasses.replace(GN, gather_mode="take", jacobian_mode=jac),
                                 False)
    for jac in ("auto", "true"):
        for gather in ("mxu", "take"):
            for interp in (False, True):
                out[f"sg_{gather}_{'interp' if interp else 'floor'}_{jac}"] = (
                    dataclasses.replace(SG, gather_mode=gather, interpolate_dt=interp,
                                        jacobian_mode=jac), False)
    return out


BRANCHES = _branches()


# --------------------------------------------------------------------------
# Modules 1-3: the samplers, the exact EDT chain, rotationize
# --------------------------------------------------------------------------


def _coords(rng, b, k, h, w):
    """Random (u, v) (B, K) over and past the image, integer coordinates,
    both far borders, 0 and the clamped ranges."""
    u = rng.uniform(-3, w + 3, (b, k)).astype(np.float32)
    v = rng.uniform(-3, h + 3, (b, k)).astype(np.float32)
    u[:, :200] = np.round(u[:, :200])
    v[:, 100:300] = np.round(v[:, 100:300])
    u[:, 300:304] = (0, w - 1, w - 0.5, w)
    v[:, 300:304] = (h - 1, 0, h, h - 0.5)
    return u, v


@pytest.mark.parametrize("name", ["gather_bilinear", "gather_sqrt_bilinear"])
def test_samplers_bitwise_jax(name):
    rng = np.random.default_rng(1)
    b, h, w = 3, 60, 80
    img = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    u, v = _coords(rng, b, 4000, h, w)
    want = np.asarray(jax.jit(getattr(jinterp, name))(img, u, v))
    got = getattr(tinterp, name)(*(torch.from_numpy(x) for x in (img, u, v))).numpy()
    assert np.array_equal(got, want)


def _edges(rng, b=4, h=60, w=80):
    edges = rng.uniform(size=(b, h, w)) < 0.02
    edges[1] = False  # edge-free: no zero anywhere
    edges[2] = True  # all edges: a constant 0 DT
    edges[3, :, :] = False
    edges[3, 0, 0] = edges[3, -1, -1] = True  # both corners
    return edges


def test_exact_edt_chain_bitwise_jax():
    edges = _edges(np.random.default_rng(2))
    e_t = torch.from_numpy(edges)
    assert np.array_equal(tdt.edt_l2(e_t).numpy(), np.asarray(jax.jit(jdt.edt_l2)(edges)))
    for norm in (False, True):
        want = jax.jit(lambda e: jdt.distance_transform_of_edges(e, normalize=norm))(edges)
        got = tdt.distance_transform_of_edges(e_t, normalize=norm)
        assert np.array_equal(got.numpy(), np.asarray(want)), norm
    dt = np.random.default_rng(3).uniform(0, 30, (3, 60, 80)).astype(np.float32)
    dt[1] = 7.0  # dmax == dmin
    for lo, hi in ((0.0, 255.0), (-1.0, 2.0)):
        want = jax.jit(lambda x: jdt.normalize_minmax(x, lo, hi))(dt)
        got = tdt.normalize_minmax(torch.from_numpy(dt), lo, hi)
        assert np.array_equal(got.numpy(), np.asarray(want)), (lo, hi)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prepare_now_level_channels_bitwise_jax(dtype):
    """Gauss-Newton targets with bf16 or float32 channels (the exact EDT,
    normalized), from the same edge map."""
    cfg = dataclasses.replace(GN, gather_dtype=dtype)
    (_, _), (ng, _), _ = render_pair(CAM, BASE, seed=0)
    want = jax.jit(lambda g: jed.prepare_now_level(g, cfg))(jnp.asarray(ng))
    got = ted.prepare_now_level(torch.from_numpy(np.asarray(ng))[None], cfg,
                                edges=torch.from_numpy(np.asarray(want.edges))[None])
    ref = convert.now_level(want, device="cpu")
    for field in ("dt", "dgx", "dgy", "scale", "chans"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jgeo.rotmat_from_quat(jnp.asarray(q, jnp.float32)))


def test_rotationize_svd_within_1e6_of_jax():
    """Near-rotations (the solver's case), a reflection (det -1 stays -1),
    a scaled and sheared matrix and a singular one (a zero singular value
    takes the sign -1, as in JAX)."""
    rng = np.random.default_rng(4)
    R = _rotations(rng, 16) + rng.normal(scale=1e-3, size=(16, 3, 3))
    R[1] = R[1] @ np.diag([1.0, 1.0, -1.0])  # a reflection
    R[2] = R[2] * 3.0 + 0.2 * rng.normal(size=(3, 3))
    R[3] = np.outer([1.0, 2.0, 3.0], [0.5, -1.0, 0.25]) + np.outer([0.0, 1.0, 0.0],
                                                                     [1.0, 0.0, 0.0])
    R = R.astype(np.float32)
    want = np.asarray(jax.jit(jgeo.rotationize_svd)(R))
    got = tgeo.rotationize_svd(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.linalg.det(got[1]) < 0
    np.testing.assert_array_equal(tgeo.rotationize(torch.from_numpy(R), "svd").numpy(), got)
    np.testing.assert_array_equal(tgeo.rotationize(torch.from_numpy(R), "newton").numpy(),
                                  tgeo.rotationize_newton(torch.from_numpy(R)).numpy())


# --------------------------------------------------------------------------
# Module 4: the per-point terms in every branch
# --------------------------------------------------------------------------


def _level(cfg, seeds=(0, 1), cap=1024):
    """Pairs rendered at 160x120, extracted and prepared by the JAX package
    and carried across; generic start poses (no point lands on a pixel
    boundary). Returns the JAX levels and poses per pair, the port's
    batched ones and the intrinsics of both."""
    intr = JIntrinsics.from_config(CAM)
    ext = jax.jit(lambda g, d: jed.extract_ref_level(g, d, intr, cap, cfg))
    prep = jax.jit(lambda g: jed.prepare_now_level(g, cfg))
    refs, nows, starts = [], [], []
    for i in seeds:
        (rg, rd), (ng, _), _ = render_pair(CAM, BASE * (1 + 0.2 * i), seed=i)
        refs.append(ext(jnp.asarray(rg), jnp.asarray(rd)))
        nows.append(prep(jnp.asarray(ng)))
        starts.append(jgeo.se3_exp(jnp.asarray(START * (1 - 0.3 * i))))
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: np.stack(a), *xs)  # noqa: E731
    R0 = np.stack([np.asarray(s[0]) for s in starts])
    t0 = np.stack([np.asarray(s[1]) for s in starts])
    return (refs, nows, starts, intr, convert.ref_level(stack(refs), device="cpu"),
            convert.now_level(stack(nows), device="cpu"), convert.pose(R0, t0, device="cpu"),
            Intrinsics.from_config(CAM))


def _sums(J, eps, wgt):
    """J^T W J and J^T W eps in float64 from one side's per-point values."""
    J, eps, wgt = (np.asarray(x, np.float64) for x in (J, eps, wgt))
    return (J * wgt[:, None]).T @ J, (J * (wgt * eps)[:, None]).sum(0)


def _rel(a, b) -> float:
    """The largest difference over the largest magnitude."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_jacobian_residual_every_branch_matches_jax(branch):
    cfg, bf16 = BRANCHES[branch]
    refs, nows, starts, intr, ref_t, now_t, (R0, t0), intr_t = _level(cfg)
    got = ted._jacobian_residual(R0, t0, ref_t, now_t, intr_t, cfg)
    fn = jax.jit(lambda r, n, R, t: jed._jacobian_residual(R, t, r, n, intr, cfg))
    for b, (r, n, s) in enumerate(zip(refs, nows, starts)):
        J, eps, wgt, visible, energy, vis_ratio = (np.asarray(x) for x in fn(r, n, *s))
        assert int(got[3][b].sum()) == int(visible.sum()) > 200, branch
        assert np.array_equal(got[3][b].numpy(), visible)
        H_p, g_p = _sums(got[0][b], got[1][b], got[2][b])
        H_j, g_j = _sums(J, eps, wgt)
        bar, e_bar = (1e-2, 1e-3) if bf16 else (1e-6, 1e-6)
        assert _rel(H_p, H_j) < bar and _rel(g_p, g_j) < bar, (branch, b)
        assert abs(float(got[4][b]) - float(energy)) <= e_bar * float(energy), (branch, b)
        assert float(got[5][b]) == pytest.approx(float(vis_ratio), rel=1e-6)


@pytest.mark.parametrize("method", ["gauss_newton", "subgradient"])
def test_residual_pass_agrees_with_the_point_terms(method):
    """With the kernels' production point terms (here under the SVD
    `rotationize`), `_project_and_sample` projects as they do: at one pose
    its residuals, visibility and energy are bitwise `_jacobian_residual`'s
    and `residual_pass`'s, so the standard LM's exact ties stay ties."""
    from rgbd_odometry_tpu_torch.kernels.residual import residual_pass_plain

    cfg = dataclasses.replace(GN if method == "gauss_newton" else SG, rotationize_method="svd")
    assert point_sem.point_sem(cfg) == point_sem.production(method) and ted.kernel_route(cfg)
    *_, ref_t, now_t, (R0, t0), intr_t = _level(cfg)
    _, eps, _, visible, energy, ratio = ted._jacobian_residual(R0, t0, ref_t, now_t, intr_t, cfg)
    eps2, _, visible2, energy2, ratio2 = ted._project_and_sample(R0, t0, ref_t, now_t, intr_t, cfg)
    gn = method == "gauss_newton"
    energy3 = residual_pass_plain(R0, t0, ref_t.pts3d, ref_t.valid,
                                  now_t.chans[:, 0] if gn else now_t.dt, *intr_t, gn)[0]
    assert torch.equal(eps, eps2) and torch.equal(visible, visible2)
    assert torch.equal(energy, energy2) and torch.equal(energy2, energy3)
    assert torch.equal(ratio, ratio2)


# --------------------------------------------------------------------------
# Module 5: the level loop with collect_trajectory
# --------------------------------------------------------------------------

TRAJ_ITERS = 10
# name -> (config, JAX rounds its gathers to bf16)
TRAJECTORY_CASES = {
    "sg_default": (SG, False),  # the kernels' route: level_sg's plain twin
    "sg_interp_mxu": (dataclasses.replace(SG, interpolate_dt=True), False),
    "sg_interp_take": (dataclasses.replace(SG, interpolate_dt=True, gather_mode="take"), False),
    "sg_svd": (dataclasses.replace(SG, rotationize_method="svd"), False),
    "sg_true_jacobian": (dataclasses.replace(SG, jacobian_mode="true"), False),
    "gn_take": (dataclasses.replace(GN, gather_mode="take"), False),
    "gn_take_deferred": (dataclasses.replace(GN, gather_mode="take", lm_deferred_accept=True),
                         False),
    "gn_channels_float32": (dataclasses.replace(GN, gn_gradient_mode="channels",
                                                gather_dtype="float32"), False),
    "gn_standard": (GN, True),  # the kernels' route: level_lm's plain twin
    "gn_deferred": (jprofiles.production_320().solver, True),  # runs the standard LM
    "gn_reference_jacobian": (dataclasses.replace(GN, jacobian_mode="reference"), True),
    "gn_svd": (dataclasses.replace(GN, rotationize_method="svd"), True),
}


@pytest.fixture
def bf16_like_jax(monkeypatch):
    """The port's bilinear sampler of a bf16 image rounding as JAX's one-hot
    matmuls round (`test_torch_parity_solve._sample_bf16_like_jax`, bitwise
    JAX's gathers); float32 images keep the float32 blend. Every bilinear
    point term of the port samples through `fused_iter`'s."""
    from rgbd_odometry_tpu_torch.kernels import fused_iter
    from test_torch_parity_solve import _sample_bf16_like_jax

    plain = tinterp.sample_bilinear_value_grad

    def sample(img, u, v):
        return (_sample_bf16_like_jax if img.dtype == torch.bfloat16 else plain)(img, u, v)

    monkeypatch.setattr(fused_iter, "sample_bilinear_value_grad", sample)


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_collect_trajectory_matches_jax(case, bf16_like_jax):
    """`run_level(..., collect_trajectory=True)` against JAX's, B = 2, 10
    iterations. Where every gather is float32: the trajectory within 1e-5
    and the energies within rtol 1e-4 (the oracle tests' bars; measured <=
    4.6e-7 and 8.8e-6). Where JAX rounds to bf16 (the port's sampler
    rounding as JAX's): 1e-4 and 2^-8, one bf16 step (measured <= 3.6e-5
    and 2.1e-3). Longer runs part: at 20 iterations
    the interpolated sub-gradient of pair 0 (its energy rising from 69 to
    97, an unstable descent) carries a one-ulp energy difference of the
    float32 reduction order to 5e-4 by iteration 19, and the standard LM's
    accept test flips at a 2e-8 relative plateau; both packages are right
    there, and the test holds the iterations before that."""
    cfg, bf16 = TRAJECTORY_CASES[case]
    refs, nows, starts, intr, ref_t, now_t, (R0, t0), intr_t = _level(cfg)
    R, t, diag, (Rs, ts) = ted.run_level(ref_t, now_t, intr_t, R0, t0, cfg, TRAJ_ITERS,
                                         collect_trajectory=True)
    assert Rs.shape == (2, TRAJ_ITERS, 3, 3) and ts.shape == (2, TRAJ_ITERS, 3)
    fn = jax.jit(lambda r, n, R_, t_: jed.run_level(r, n, intr, R_, t_, cfg, TRAJ_ITERS,
                                                    collect_trajectory=True))
    traj_bar, e_bar = (1e-4, 2.0 ** -8) if bf16 else (1e-5, 1e-4)
    for b, (r, n, s) in enumerate(zip(refs, nows, starts)):
        R_j, t_j, d_j, (Rs_j, ts_j) = fn(r, n, *s)
        np.testing.assert_allclose(Rs[b].numpy(), np.asarray(Rs_j), atol=traj_bar, rtol=0)
        np.testing.assert_allclose(ts[b].numpy(), np.asarray(ts_j), atol=traj_bar, rtol=0)
        np.testing.assert_allclose(diag.energy[b].numpy(), np.asarray(d_j.energy), rtol=e_bar)
        assert int(diag.best_iter[b]) == int(d_j.best_iter)
        np.testing.assert_allclose(R[b].numpy(), np.asarray(R_j), atol=traj_bar, rtol=0)
        np.testing.assert_allclose(t[b].numpy(), np.asarray(t_j), atol=traj_bar, rtol=0)
    # the trajectory's last row is the pose the level ends on; a run without
    # it returns the same solution bit for bit
    R2, t2, diag2 = ted.run_level(ref_t, now_t, intr_t, R0, t0, cfg, TRAJ_ITERS)
    if not (cfg.method == "gauss_newton" and cfg.lm_deferred_accept):
        assert torch.equal(R2, R) and torch.equal(t2, t)
        assert all(torch.equal(a, b) for a, b in zip(diag2, diag))


DEFERRED_CASES = {
    "take": dataclasses.replace(GN, gather_mode="take", lm_deferred_accept=True),
    "interpolant_float32": dataclasses.replace(jprofiles.production_320().solver,
                                               gather_dtype="float32"),
    "channels_float32_j1": dataclasses.replace(GN, gn_gradient_mode="channels",
                                               gather_dtype="float32", lm_deferred_accept=True,
                                               lm_jacobian_stride=1),
}


@pytest.mark.parametrize("case", sorted(DEFERRED_CASES))
def test_deferred_loop_matches_jax(case):
    """The general loop's deferred-accept LM (JAX `_run_level_lm_deferred`)
    against JAX's, B = 2, 10 iterations, float32 gathers: poses within
    1e-5, energies within rtol 1e-4, the same best iteration, and the
    all-point diagnostics at the returned pose (energy 1e-4, visibility
    exact). `run_level` sends these configurations to `level_lm`'s plain
    twin (tests/test_torch_parity_levels.py holds it against this loop)."""
    cfg = DEFERRED_CASES[case]
    assert ted.kernel_route(cfg)
    refs, nows, starts, intr, ref_t, now_t, (R0, t0), intr_t = _level(cfg)
    R, t, diag = ted.run_level_loop(ref_t, now_t, intr_t, R0, t0, cfg, TRAJ_ITERS)
    fn = jax.jit(lambda r, n, R_, t_: jed.run_level(r, n, intr, R_, t_, cfg, TRAJ_ITERS))
    for b, (r, n, s) in enumerate(zip(refs, nows, starts)):
        R_j, t_j, d_j = fn(r, n, *s)
        np.testing.assert_allclose(R[b].numpy(), np.asarray(R_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(t[b].numpy(), np.asarray(t_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(diag.energy[b].numpy(), np.asarray(d_j.energy), rtol=1e-4)
        assert int(diag.best_iter[b]) == int(d_j.best_iter)
        assert float(diag.best_energy[b]) == pytest.approx(float(d_j.best_energy), rel=1e-4)
        assert np.array_equal(diag.final_valid[b].numpy(), np.asarray(d_j.final_valid))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("scene", range(len(oracle_case.SCENES)))
def test_collect_trajectory_matches_numpy_oracle(scene, level):
    """tests/test_subgradient_oracle.py's 50-iteration check on the port's
    `run_level(..., collect_trajectory=True)` (the default sub-gradient,
    `level_sg`'s plain twin with its trajectory output): the trajectory
    within 1e-5 and the energies within rtol 1e-4 (atol 5e-3), the bars of
    tests/test_pipeline_oracle.py."""
    seed, psi = oracle_case.SCENES[scene]
    ref, now, intr, cfg = oracle_case._level_inputs(seed, psi, level)
    R0, t0 = oracle_case._generic_start(scene)
    best_R, best_t, diag, (Rs, ts) = ted.run_level(
        convert.ref_level(ref, device="cpu"), convert.now_level(now, device="cpu"),
        Intrinsics(*(float(x) for x in intr)), *convert.pose(R0, t0, device="cpu"), cfg,
        oracle_case.N_ITERS, collect_trajectory=True)
    oracle = run_level_oracle(
        np.asarray(now.dt, np.float64), np.asarray(now.dgx, np.float64),
        np.asarray(now.dgy, np.float64), np.asarray(ref.pts3d, np.float64),
        np.asarray(ref.valid), float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
        np.asarray(R0, np.float64), np.asarray(t0, np.float64), oracle_case.N_ITERS)
    assert oracle["energies"][0] > 0.0
    np.testing.assert_allclose(diag.energy[0].numpy().astype(np.float64), oracle["energies"],
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(Rs[0].numpy().astype(np.float64), oracle["Rs"], atol=1e-5)
    np.testing.assert_allclose(ts[0].numpy().astype(np.float64), oracle["ts"], atol=1e-5)
    assert int(diag.best_iter[0]) == oracle["best_iter"]
    np.testing.assert_allclose(best_t[0].numpy().astype(np.float64), oracle["best_t"], atol=1e-5)


# --------------------------------------------------------------------------
# Module 6: the routing rule
# --------------------------------------------------------------------------


def _dispatch_configs():
    """The production configurations and one of each reference-parity
    family of tests/test_torch_parity_drivers.py, with their iteration
    ladders cut to three levels of a 160x120 frame."""
    from rgbd_odometry_tpu_torch import profiles as tprofiles
    from rgbd_odometry_tpu_torch.config import SolverConfig as TSolverConfig

    cut = lambda s, it: dataclasses.replace(s, iterations=it)  # noqa: E731
    sg = TSolverConfig(iterations=(8, 6, 4))
    gn = TSolverConfig(method="gauss_newton", iterations=(6, 4, 3))
    return {
        **{name: c for name, (c, _) in point_sem.parity_families(sg, gn).items()},
        "production_320": cut(tprofiles.production_320().solver, (6, 4, 3)),
        "production_vga": cut(tprofiles.production_vga().solver, (4, 6, 4)),
        "dvo_defaults": TSolverConfig(method="gauss_newton", iterations=(6, 4, 3)),
        "parity_320": cut(tprofiles.parity_320().solver, (8, 6, 4)),
        "standard_lm_j1": TSolverConfig(method="gauss_newton", iterations=(6, 4, 3),
                                        lm_jacobian_stride=1, rotationize=False),
        "deferred_lm_j1": TSolverConfig(method="gauss_newton", iterations=(6, 4, 3),
                                        lm_deferred_accept=True, lm_jacobian_stride=1),
    }


@pytest.fixture
def loop_forbidden(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a configuration reached run_level_loop")

    monkeypatch.setattr(ted, "run_level_loop", refuse)


@pytest.mark.parametrize("name", sorted(_dispatch_configs()))
def test_production_configurations_never_reach_the_loop(name, loop_forbidden):
    """`align_pair`, `run_level` (with and without `collect_trajectory`),
    `pose_information` and a 3-frame `EdgeDvoOdometry` run on the CPU with
    `run_level_loop` patched to raise, for the production configurations
    and every reference-parity family: the kernels' plain twins take every
    level."""
    from rgbd_odometry_tpu_torch.config import (
        CameraConfig as TCameraConfig, KeyframeConfig, PipelineConfig, PyramidConfig,
    )
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry

    cfg = _dispatch_configs()[name]
    assert ted.kernel_route(cfg)
    cam = TCameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    frames, _ = render_sequence(cam, np.stack([BASE * 0.3 * i for i in range(3)]), seed=0)
    pyr = [build_pyramid(torch.from_numpy(g)[None], torch.from_numpy(d)[None], 3)
           for g, d in frames[:2]]
    intr = Intrinsics.from_config(cam)
    caps = (1024, 512, 256)
    R, t, diags = ted.align_pair(pyr[0].gray, pyr[0].depth, pyr[1].gray, intr, cfg, caps)
    assert torch.isfinite(R).all() and len(diags) == 3
    refs = ted.extract_ref_features(pyr[0].gray, pyr[0].depth, intr, cfg, caps)
    nows = ted.prepare_now_targets(pyr[1].gray, cfg)
    for collect in (False, True):
        out = ted.run_level(refs[1], nows[1], intr.at_level(1), R, t, cfg, 4,
                            collect_trajectory=collect)
        assert torch.isfinite(out[0]).all() and len(out) == 3 + collect
    info, sigma2, n_eff = ted.pose_information(refs[0], nows[0], intr, cfg, R, t)
    assert torch.isfinite(info).all() and float(n_eff[0]) > 0
    odo = EdgeDvoOdometry(PipelineConfig(camera=cam, solver=cfg, pyramid=PyramidConfig(
        num_levels=3, max_points=caps), keyframe=KeyframeConfig(force_every=2)), device="cpu")
    for f, (g, d) in enumerate(frames):
        odo.process_frame(g, d, timestamp=float(f))
    assert np.isfinite(odo.trajectory()[1]).all()


def test_parity_configurations_take_the_loop():
    """The inverse of the rule it once held: every configuration
    `check_config` accepts takes the level kernels (`kernel_route`), the
    reference-parity ones with their own point semantics or the SVD
    (`point_sem.parity`: every branch but the three production ones, and
    the SVD `rotationize` everywhere), and only an unknown method is
    refused."""
    for branch, (cfg, _) in BRANCHES.items():
        production = branch in ("gn_mxu_interpolant_bfloat16_auto", "sg_mxu_floor_auto",
                                "sg_take_floor_auto")
        sem = point_sem.point_sem(cfg)
        assert ted.kernel_route(cfg) and (sem == point_sem.production(cfg.method)) == production, \
            branch
        assert point_sem.parity(cfg) != production, branch
        svd = dataclasses.replace(cfg, rotationize_method="svd")
        assert ted.kernel_route(svd) and point_sem.parity(svd)
        off = dataclasses.replace(cfg, rotationize=False, rotationize_method="svd")
        assert ted.kernel_route(off) and point_sem.parity(off) != production
    # JAX's Gauss-Newton never reads interpolate_dt
    assert not point_sem.parity(dataclasses.replace(GN, interpolate_dt=True))
    ted.check_config(dataclasses.replace(SG, gather_mode="take", interpolate_dt=True))
    for fn in (ted.check_config, ted.kernel_route):
        with pytest.raises(ValueError, match="method"):
            fn(dataclasses.replace(SG, method="newton"))


# --------------------------------------------------------------------------
# Module 7: the level kernels' trajectory output (their plain twins here)
# --------------------------------------------------------------------------


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("solver", ["level_sg", "level_lm_standard", "level_lm_strided"])
def test_plain_twins_bitwise_with_and_without_the_trajectory(solver):
    """Every output of `level_sg_plain` / `level_lm_plain` (through the
    pyramid entries on CPU tensors) is the same bit for bit with and
    without the trajectory output; the trajectory's rows are the poses
    after each iteration, a done pair's frozen pose in every row after it
    (a termination norm at which the pairs finish at different
    iterations); the deferred LM refuses it."""
    cfg = SG if solver == "level_sg" else GN
    if solver == "level_lm_strided":
        cfg = dataclasses.replace(GN, lm_jacobian_stride=2, lm_proposal_stride=1)
    if solver == "level_sg":  # steps inside the trust region, shrinking
        cfg = dataclasses.replace(cfg, step_length=1e-6, psi_norm_termination=1e-3)
    else:
        cfg = dataclasses.replace(cfg, psi_norm_termination=1e-3)
    _, _, _, _, ref_t, now_t, (R0, t0), intr_t = _level(cfg)
    n = 12
    if solver == "level_sg":
        lv = klsg.SgLevel(ref_t.pts3d, ref_t.valid, ref_t.count, now_t.dt, *intr_t, n)
        run = lambda trajs: klsg.level_sg_pyramid(R0, t0, (lv,), cfg, trajs=trajs)  # noqa: E731
    else:
        js, st = ted.level_strides(cfg, ref_t.pts3d.shape[1])
        lv = klm.LmLevel(ref_t.pts3d, ref_t.valid, ref_t.count, now_t.chans[:, 0], now_t.scale,
                         *intr_t, n, js, st)
        run = lambda trajs: klm.level_lm_pyramid(R0, t0, (lv,), cfg, trajs=trajs)  # noqa: E731
    traj = torch.full((2, n, 12), float("nan"))
    with_traj, without = run((traj,))[0], run(None)[0]
    assert _same(with_traj, without)
    assert torch.isfinite(traj).all()
    energy = with_traj.energy
    done_at = [int((energy[b] != 0).sum()) for b in range(2)]
    assert min(done_at) < n and done_at[0] != done_at[1], done_at  # both regimes present
    for b in range(2):
        d = done_at[b]
        if d < n:  # the frozen pose fills the rows from the one it ended on
            assert (traj[b, d:] == traj[b, d - 1]).all()
    if solver != "level_sg":
        with pytest.raises(ValueError, match="standard LM"):
            klm.level_lm_pyramid(R0, t0, (lv,), dataclasses.replace(cfg, lm_deferred_accept=True),
                                 trajs=(traj,))


@pytest.mark.parametrize("bad", ["sg_shape", "sg_dtype", "lm_shape", "lm_deferred"])
def test_cuda_wrappers_check_the_trajectory_before_building(bad, monkeypatch):
    """On a non-CPU tensor the wrappers check the trajectory output's shape
    and dtype, and `level_lm` refuses it with the deferred accept, before
    anything is built (`build.load` is made to fail to prove it)."""
    from rgbd_odometry_tpu_torch.kernels import build

    def no_build(*_a, **_k):
        raise AssertionError("a level kernel was built before its arguments were checked")

    monkeypatch.setattr(build, "load", no_build)
    m = dict(device="meta")
    b, k, n = 2, 1024, 4
    R0, t0 = torch.empty((b, 3, 3), **m), torch.empty((b, 3), **m)
    pts, valid = torch.empty((b, k, 3), **m), torch.empty((b, k), dtype=torch.bool, **m)
    count = torch.empty((b,), dtype=torch.int32, **m)
    traj = {"sg_shape": torch.empty((b, n, 18), **m),
            "sg_dtype": torch.empty((b, n, 12), dtype=torch.float64, **m),
            "lm_shape": torch.empty((b, n + 1, 12), **m),
            "lm_deferred": torch.empty((b, n, 12), **m)}[bad]
    with pytest.raises(ValueError, match="standard LM" if bad == "lm_deferred" else "must be"):
        if bad.startswith("sg"):
            klsg.level_sg(R0, t0, pts, valid, count, torch.empty((b, 60, 80), **m),
                          65.0, 65.0, 39.5, 29.5, SG, n, traj=traj)
        else:
            cfg = dataclasses.replace(GN, lm_deferred_accept=bad == "lm_deferred")
            klm.level_lm(R0, t0, pts, valid, count,
                         torch.empty((b, 60, 80), dtype=torch.bfloat16, **m),
                         torch.empty((b,), **m), 65.0, 65.0, 39.5, 29.5, cfg, n, 1, 1, traj=traj)
