"""The reference-parity configurations on the level kernels' plain twins,
on the CPU against the JAX package and against the port's general loop
`run_level_loop` (JAX's level loops op for op, reached by no route):

* for each family of tests/test_torch_parity_drivers.py, `run_level` (with
  and without `collect_trajectory`) and `solve_pyramid` on the twins
  (`level_lm_plain` / `level_sg_plain` with the families' point semantics,
  `kernels/point_sem.py`) against JAX's `run_level` / `solve_pyramid` at
  160x120: poses within 1e-4 where every gather is float32, 2e-3 where JAX
  rounds to bf16, 5e-3 for floor lookups; energies within rtol 1e-4
  (bf16: the port's sampler rounding as JAX's, one bf16 step, 2^-8);
* the same twins against `run_level_loop` on the same inputs: bitwise,
  their per-point terms and sums being the loop's operations, but for the
  SVD families, whose twin of the device SVD and the loop's
  `torch.linalg.svd` differ in the last bit (the LM's damped steps carry
  that to ~1e-6 of pose and 8e-5 of energy in 10 iterations): there the
  bars against JAX; the deferred LM included;
* the new plain samplers (`residual.sample_value`, `fused_iter.sample_gn`,
  `sg_terms.sample_sg`) bitwise JAX's `gather_sqrt_bilinear` and
  `gather_bilinear`, integer coordinates and both clamped borders
  included;
* the SVD twin `se3_plain.rotationize_svd` within 1e-6 of JAX's
  `rotationize_svd` on near-rotations, a reflection and a singular input;
* the CUDA wrappers' checks of the planes before anything is built.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu import profiles as jprofiles  # noqa: E402
from rgbd_odometry_tpu.config import SolverConfig  # noqa: E402
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jbuild  # noqa: E402
from rgbd_odometry_tpu.ops import interp as jinterp  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import fused_iter, level_lm, level_sg, point_sem  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import residual, se3_plain, sg_terms  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

from test_torch_parity_drivers import BARS, CAM, FAMILIES  # noqa: E402
from test_torch_parity_mode import _coords, _level, _rotations, bf16_like_jax  # noqa: E402,F401

torch.set_num_threads(1)

ITERS = 10
BF16 = {name for name, (_, kind) in FAMILIES.items() if kind == "bf16"}
BASE = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
START = np.array([0.008, -0.004, 0.004, 0.003, -0.004, 0.002], np.float32)


def _bars(family):
    """(pose bar, energy rtol) of a family against JAX."""
    pose = BARS[FAMILIES[family][1]][0]
    return pose, (2.0 ** -8 if family in BF16 else 1e-4)


def _loop_bars(cfg, bars):
    """(pose, energy rtol) of the twins against `run_level_loop`: exact,
    but for the SVD's twin against `torch.linalg.svd`, where the bars
    against JAX, `bars`, hold."""
    return bars if point_sem.svd(cfg) else (0.0, 0.0)


def _close(a, b, atol, rtol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if atol == 0.0 and rtol == 0.0:
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_level_twins_match_jax_and_the_loop(family, bf16_like_jax):
    """`run_level` on the level kernels' plain twins, B = 2, 10 iterations
    from generic starts, with and without `collect_trajectory`: against
    JAX's `run_level` within the family's bars and against
    `run_level_loop` on the same inputs."""
    cfg, _ = FAMILIES[family]
    assert ted.kernel_route(cfg) and point_sem.parity(cfg)
    refs, nows, starts, intr, ref_t, now_t, (R0, t0), intr_t = _level(cfg)
    pose_bar, e_bar = _bars(family)
    loop_pose, loop_e = _loop_bars(cfg, (pose_bar, e_bar))
    for collect in (False, True):
        got = ted.run_level(ref_t, now_t, intr_t, R0, t0, cfg, ITERS, collect_trajectory=collect)
        loop = ted.run_level_loop(ref_t, now_t, intr_t, R0, t0, cfg, ITERS,
                                  collect_trajectory=collect)
        fn = jax.jit(lambda r, n, R_, t_, c=collect: jed.run_level(r, n, intr, R_, t_, cfg, ITERS,
                                                                   collect_trajectory=c))
        for b, (r, n, s) in enumerate(zip(refs, nows, starts)):
            want = fn(r, n, *s)
            _close(got[0][b], want[0], pose_bar)
            _close(got[1][b], want[1], pose_bar)
            _close(got[2].energy[b], want[2].energy, 0.0 + 1e-30, e_bar)
            if collect:
                _close(got[3][0][b], want[3][0], pose_bar)
                _close(got[3][1][b], want[3][1], pose_bar)
        _close(got[0], loop[0], loop_pose)
        _close(got[1], loop[1], loop_pose)
        _close(got[2].energy, loop[2].energy, loop_pose, loop_e)
        assert torch.equal(got[2].best_iter, loop[2].best_iter)
        if not point_sem.svd(cfg):
            assert all(torch.equal(x, y) for x, y in zip(got[2], loop[2]))
        if collect:
            _close(got[3][0], loop[3][0], loop_pose)
            _close(got[3][1], loop[3][1], loop_pose)


def _pyramids(cfg, caps=(1024, 512)):
    """Two pairs' 2-level pyramids extracted and prepared by the JAX
    package and carried across: the JAX levels per pair, the port's
    batched levels, generic start poses."""
    intr = JIntrinsics.from_config(CAM)
    jr, jn, starts = [], [], []
    for i in range(2):
        (rg, rd), (ng, nd), _ = render_pair(CAM, BASE * (1 + 0.2 * i), seed=i)
        rp, npyr = jbuild(jnp.asarray(rg), jnp.asarray(rd), 2), jbuild(jnp.asarray(ng),
                                                                      jnp.asarray(nd), 2)
        jr.append(jax.jit(lambda g, d: jed.extract_ref_features(g, d, intr, cfg, caps))(
            rp.gray, rp.depth))
        jn.append(jax.jit(lambda g: jed.prepare_now_targets(g, cfg))(npyr.gray))
        starts.append(jgeo.se3_exp(jnp.asarray(START * (1 - 0.3 * i))))
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: np.stack(a), *xs)  # noqa: E731
    refs = tuple(convert.ref_level(stack([p[lv] for p in jr]), device="cpu") for lv in range(2))
    nows = tuple(convert.now_level(stack([p[lv] for p in jn]), device="cpu") for lv in range(2))
    R0 = np.stack([np.asarray(s[0]) for s in starts])
    t0 = np.stack([np.asarray(s[1]) for s in starts])
    return intr, jr, jn, starts, refs, nows, convert.pose(R0, t0, device="cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_solve_pyramid_twins_match_jax_and_the_loop(family, bf16_like_jax):
    """`solve_pyramid` (one `level_*_pyramid` call, its plain twin here)
    over two levels of the drivers' iterations against JAX's
    `solve_pyramid` and against `run_level_loop` level by level."""
    cfg, _ = FAMILIES[family]
    intr, jr, jn, starts, refs, nows, (R0, t0) = _pyramids(cfg)
    intr_t = Intrinsics.from_config(CAM)
    R, t, diags = ted.solve_pyramid(refs, nows, intr_t, cfg, R0, t0)
    pose_bar, e_bar = _bars(family)
    fn = jax.jit(lambda r, n, R_, t_: jed.solve_pyramid(r, n, intr, cfg, R_, t_))
    for b in range(2):
        R_j, t_j, d_j = fn(jr[b], jn[b], *starts[b])
        _close(R[b], R_j, pose_bar)
        _close(t[b], t_j, pose_bar)
        for d, dj in zip(diags, d_j):
            _close(d.energy[b], dj.energy, 1e-30, e_bar)
    R_l, t_l = R0, t0
    for lv in (1, 0):
        R_l, t_l, _ = ted.run_level_loop(refs[lv], nows[lv], intr_t.at_level(lv), R_l, t_l, cfg,
                                         cfg.iterations[lv])
    loop_pose, _ = _loop_bars(cfg, (pose_bar, e_bar))
    _close(R, R_l, loop_pose)
    _close(t, t_l, loop_pose)


DEFERRED = {
    "take": dataclasses.replace(FAMILIES["gn_take"][0], lm_deferred_accept=True),
    "interpolant_float32": dataclasses.replace(jprofiles.production_320().solver,
                                               gather_dtype="float32"),
    "channels_float32_j1": dataclasses.replace(FAMILIES["gn_channels_float32"][0],
                                               lm_deferred_accept=True, lm_jacobian_stride=1),
    "svd": dataclasses.replace(jprofiles.production_320().solver, rotationize_method="svd"),
}


@pytest.mark.parametrize("case", sorted(DEFERRED))
def test_deferred_twins_match_jax_and_the_loop(case, bf16_like_jax):
    """The deferred-accept LM's twin (`level_lm_plain`, its all-point tail)
    against JAX's `_run_level_lm_deferred` (poses 1e-5 where float32, the
    bf16 bar for the production gathers; energies rtol 1e-4, the same best
    iteration, the tail's visibility exact) and against the loop's."""
    cfg = DEFERRED[case]
    assert point_sem.parity(cfg)
    refs, nows, starts, intr, ref_t, now_t, (R0, t0), intr_t = _level(cfg)
    R, t, diag = ted.run_level(ref_t, now_t, intr_t, R0, t0, cfg, ITERS)
    fn = jax.jit(lambda r, n, R_, t_: jed.run_level(r, n, intr, R_, t_, cfg, ITERS))
    bf16 = cfg.gather_dtype == "bfloat16" and cfg.gather_mode == "mxu"
    pose_bar, e_bar = (BARS["bf16"][0], 2.0 ** -8) if bf16 else (1e-5, 1e-4)
    for b, (r, n, s) in enumerate(zip(refs, nows, starts)):
        R_j, t_j, d_j = fn(r, n, *s)
        _close(R[b], R_j, pose_bar)
        _close(t[b], t_j, pose_bar)
        _close(diag.energy[b], d_j.energy, 1e-30, e_bar)
        assert int(diag.best_iter[b]) == int(d_j.best_iter)
        if not bf16:
            assert np.array_equal(diag.final_valid[b].numpy(), np.asarray(d_j.final_valid))
    R_l, t_l, d_l = ted.run_level_loop(ref_t, now_t, intr_t, R0, t0, cfg, ITERS)
    loop_pose, loop_e = _loop_bars(cfg, (pose_bar, e_bar))
    _close(R, R_l, loop_pose)
    _close(t, t_l, loop_pose)
    _close(diag.energy, d_l.energy, loop_pose, loop_e)


@pytest.mark.parametrize("sampler", ["sqrt_take", "take_planes", "sqrt_take_value"])
def test_parity_samplers_bitwise_jax(sampler):
    """The level twins' samplers at random, integer and border coordinates
    (`_coords`) against JAX's: "take" gathers of the Gauss-Newton planes
    (`fused_iter.sample_gn`, `residual.sample_value`) bitwise
    `gather_bilinear`, the interpolated DT (`sg_terms.sample_sg`,
    `residual.sample_value`) bitwise `gather_sqrt_bilinear`, the floor
    gradients beside it bitwise `gather_floor` of the central
    differences."""
    rng = np.random.default_rng(7)
    b, h, w = 3, 60, 80
    planes = [rng.uniform(0, 255, (b, h, w)).astype(np.float32) for _ in range(3)]
    u, v = _coords(rng, b, 4000, h, w)
    tp = [torch.from_numpy(p) for p in planes]
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    if sampler == "take_planes":
        got = fused_iter.sample_gn(tp, tu, tv, point_sem.GN_TAKE)
        for g, p in zip(got, planes):
            assert np.array_equal(g.numpy(), np.asarray(jax.jit(jinterp.gather_bilinear)(p, u, v)))
        val = residual.sample_value(tp[0], tu, tv, point_sem.GN_TAKE)
        assert torch.equal(val, got[0])
        return
    want = np.asarray(jax.jit(jinterp.gather_sqrt_bilinear)(planes[0], u, v))
    if sampler == "sqrt_take":
        got = residual.sample_value(tp[0], tu, tv, point_sem.SG_SQRT_TAKE)
        assert np.array_equal(got.numpy(), want)
        return
    val, gx, gy = sg_terms.sample_sg(tp[0], tu, tv, point_sem.SG_SQRT_TAKE)
    assert np.array_equal(val.numpy(), want)
    dgx = np.asarray(0.5 * (np.roll(planes[0], -1, 2) - np.roll(planes[0], 1, 2)))
    dgx[..., 0] = 0.5 * (planes[0][..., 1] - planes[0][..., 1])
    dgx[..., -1] = 0.5 * (planes[0][..., -2] - planes[0][..., -2])
    want_gx = np.asarray(jax.jit(jinterp.gather_floor)(dgx, u, v))
    assert np.array_equal(gx.numpy(), want_gx)


def test_rotationize_svd_twin_within_1e6_of_jax():
    """The device SVD's twin on tests/test_torch_parity_mode.py's cases
    (near-rotations, a reflection, a scaled and sheared matrix, a rank-2
    one) and on the zero matrix (every singular value 0: -I, as JAX's),
    within 1e-6 of JAX's `rotationize_svd`; the reflection keeps det -1."""
    rng = np.random.default_rng(4)
    R = _rotations(rng, 16) + rng.normal(scale=1e-3, size=(16, 3, 3))
    R[1] = R[1] @ np.diag([1.0, 1.0, -1.0])
    R[2] = R[2] * 3.0 + 0.2 * rng.normal(size=(3, 3))
    R[3] = np.outer([1.0, 2.0, 3.0], [0.5, -1.0, 0.25]) + np.outer([0.0, 1.0, 0.0],
                                                                     [1.0, 0.0, 0.0])
    R = np.concatenate([R, np.zeros((1, 3, 3))]).astype(np.float32)
    want = np.asarray(jax.jit(jgeo.rotationize_svd)(R))
    rows = se3_plain.to_rows(torch.from_numpy(R))
    got = se3_plain.from_rows(se3_plain.rotationize_svd(rows)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.linalg.det(got[1]) < 0
    np.testing.assert_array_equal(got[-1], -np.eye(3, dtype=np.float32))
    cfg = dataclasses.replace(SolverConfig(), rotationize_method="svd")
    np.testing.assert_array_equal(level_lm.rotationize(torch.from_numpy(R), cfg).numpy(), got)


@pytest.mark.parametrize("bad", ["no_grads", "take_bf16", "grads_stride", "grads_on_interp"])
def test_cuda_wrappers_check_the_planes_before_building(bad, monkeypatch):
    """On a non-CPU tensor `level_lm` checks the planes a configuration's
    sampler reads (two beside img for "channels" and "take", none
    otherwise; float32 for "take"; img's batch stride) before anything is
    built (`build.load` is made to fail to prove it)."""
    from rgbd_odometry_tpu_torch.kernels import build

    def no_build(*_a, **_k):
        raise AssertionError("a level kernel was built before its arguments were checked")

    monkeypatch.setattr(build, "load", no_build)
    m = dict(device="meta")
    b, k, n, h, w = 2, 1024, 4, 60, 80
    R0, t0 = torch.empty((b, 3, 3), **m), torch.empty((b, 3), **m)
    pts, valid = torch.empty((b, k, 3), **m), torch.empty((b, k), dtype=torch.bool, **m)
    count, scale = torch.empty((b,), dtype=torch.int32, **m), torch.empty((b,), **m)
    gn = SolverConfig(method="gauss_newton", iterations=(4,))
    take = dataclasses.replace(gn, gather_mode="take")
    f32 = torch.empty((b, h, w), **m)
    chans = torch.empty((b, 3, h, w), **m)
    case = {
        "no_grads": (take, f32, ()),
        "take_bf16": (take, torch.empty((b, h, w), dtype=torch.bfloat16, **m),
                      (torch.empty((b, h, w), dtype=torch.bfloat16, **m),) * 2),
        "grads_stride": (dataclasses.replace(gn, gn_gradient_mode="channels",
                                             gather_dtype="float32"), chans[:, 0], (f32, f32)),
        "grads_on_interp": (dataclasses.replace(gn, gather_dtype="float32"), f32, (f32, f32)),
    }[bad]
    cfg, img, grads = case
    with pytest.raises(ValueError, match="planes beside img|must be|batch stride"):
        level_lm.level_lm(R0, t0, pts, valid, count, img, scale, 65.0, 65.0, 39.5, 29.5, cfg, n,
                          1, 1, grads=grads)
    sg = dataclasses.replace(SolverConfig(), interpolate_dt=True)
    with pytest.raises(ValueError, match="must be"):
        level_sg.level_sg(R0, t0, pts, valid, count, torch.empty((b, h, w), dtype=torch.bfloat16,
                                                                 **m), 65.0, 65.0, 39.5, 29.5,
                          sg, n)
