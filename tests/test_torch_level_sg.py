"""The whole-level sub-gradient entry point of the port
(`kernels/level_sg.level_sg`, which runs its plain version on CPU tensors)
against the JAX package's `run_level` with `method="subgradient"` on the
CPU, B = 3 pairs on identical carried-across levels (60x80 with 256 points
and 120x160 with 1024):

* the reference's defaults (L2 pull, re-orthogonalization), where the step
  length is such that the trust region binds (asserted on iteration 0's
  step), from a near and from a far start pose;
* without the pull, without the re-orthogonalization, and with a step
  length (1e-7) at which the steps lie inside the trust region;
* a termination norm at which the pairs of one batch finish at different
  iterations;
* an edge-free target, where the gradient is zero and the step is the L2
  pull alone (and, without the pull, the pose never moves).

Bars, pair by pair: the same iteration of termination; energies within 1e-5
relative (the numpy oracle's bar in `test_torch_parity_solve.py`) plus 1e-2
absolute; the same best iteration; poses within 3e-5 (the oracle's bar);
the best iterate's per-point residuals within 1e-3 with equal visibility on
all but 0.5% of the points (a floor decision one ulp apart).

Also the plain twin of the device function `se3_log` (`kernels/se3_plain`)
bitwise against `core/geometry.se3_log` in all three branches of the log
(given correctly rounded square roots) and within `test_torch_geometry.py`'s
5e-6 of JAX's, `run_level`'s routing, the
block-size rule, and the CUDA wrapper's argument checks, which run before
anything is built. The pyramid entry (`level_sg_pyramid`): its plain
version bitwise the levels one by one, `solve_pyramid` against JAX's over a
2-level pyramid, the route rule and the wrapper's checks; a numpy model of
the warp's log (`csrc/warp.cuh` `warp_se3_log`) bitwise the twin.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig, SolverConfig  # noqa: E402
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.core import geometry as tgeo  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import build, se3_plain, sg_terms  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import level_sg as klsg  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(1)

CAMS = {
    (120, 160): CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5),
    (60, 80): CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5),
}
BASE = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
START = np.array([0.008, -0.004, 0.004, 0.003, -0.004, 0.002], np.float32)
REFERENCE = SolverConfig()  # the reference's sub-gradient: pull, re-orthogonalization
INSIDE = dataclasses.replace(REFERENCE, step_length=1e-7)  # no step reaches the trust region

# case -> (config, level shape, capacity, iterations, start pose scale)
CASES = {
    "reference_60x80": (REFERENCE, (60, 80), 256, 20, 1.0),
    "reference_120x160": (REFERENCE, (120, 160), 1024, 20, 1.0),
    "reference_far_start": (REFERENCE, (60, 80), 256, 20, -3.0),
    "no_pull": (dataclasses.replace(REFERENCE, enable_l2_regularization=False), (60, 80), 256,
                20, 1.0),
    "no_rotationize": (dataclasses.replace(REFERENCE, rotationize=False), (120, 160), 1024, 20,
                       1.0),
    "inside_trust_region": (INSIDE, (60, 80), 256, 20, 1.0),
}


def _inputs(cfg, shape, cap, start_scale=1.0, flat=()):
    """B = 3 rendered pairs at one level, extracted and prepared by the JAX
    package and carried across; pairs in `flat` get an edge-free target.
    Returns the JAX levels and start poses (per pair), the JAX intrinsics
    and the port's batched levels and start poses."""
    cam = CAMS[shape]
    intr = JIntrinsics.from_config(cam)
    ext = jax.jit(lambda g, d: jed.extract_ref_level(g, d, intr, cap, cfg))
    prep = jax.jit(lambda g: jed.prepare_now_level(g, cfg))
    refs, nows, starts = [], [], []
    for i in range(3):
        (rg, rd), (ng, _), _ = render_pair(cam, BASE * (1 + 0.2 * i), seed=i)
        if i in flat:
            ng = np.full_like(ng, 90.0)
        refs.append(ext(jnp.asarray(rg), jnp.asarray(rd)))
        nows.append(prep(jnp.asarray(ng)))
        starts.append(jgeo.se3_exp(jnp.asarray(START * start_scale * (1 - 0.3 * i))))
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: np.stack(a), *xs)  # noqa: E731
    R0 = np.stack([np.asarray(s[0]) for s in starts])
    t0 = np.stack([np.asarray(s[1]) for s in starts])
    ref_t = convert.ref_level(stack(refs), device="cpu")
    now_t = convert.now_level(stack(nows), device="cpu")
    return refs, nows, starts, intr, ref_t, now_t, convert.pose(R0, t0, device="cpu")


def _solve_both(cfg, shape, cap, n_iters, start_scale=1.0, flat=()):
    refs, nows, starts, intr, ref_t, now_t, (R0, t0) = _inputs(cfg, shape, cap, start_scale, flat)
    run = jax.jit(lambda r, n, R, t: jed.run_level(r, n, intr, R, t, cfg, n_iters))
    jax_out = [run(r, n, *s) for r, n, s in zip(refs, nows, starts)]
    args = (R0, t0, ref_t.pts3d, ref_t.valid, ref_t.count, now_t.dt,
            *Intrinsics.from_config(CAMS[shape]), cfg, n_iters)
    return jax_out, klsg.level_sg(*args), args


def _check_against_jax(jax_out, out, n_iters):
    """The bars of the module docstring, pair by pair."""
    assert out.energy.shape == (3, n_iters) and out.R.shape == (3, 3, 3)
    for b, (R_j, t_j, d_j) in enumerate(jax_out):
        e_j, e_p = np.asarray(d_j.energy), out.energy[b].numpy()
        assert np.array_equal(e_p == 0, e_j == 0), f"pair {b}: done at another iteration"
        np.testing.assert_allclose(e_p, e_j, rtol=1e-5, atol=1e-2, err_msg=f"pair {b}")
        assert int(out.best_iter[b]) == int(d_j.best_iter), f"pair {b}"
        np.testing.assert_allclose(float(out.best_energy[b]), float(d_j.best_energy), rtol=1e-5,
                                   atol=1e-2)
        np.testing.assert_allclose(out.R[b].numpy(), np.asarray(R_j), rtol=0, atol=3e-5)
        np.testing.assert_allclose(out.t[b].numpy(), np.asarray(t_j), rtol=0, atol=3e-5)
        np.testing.assert_allclose(float(out.visible_ratio[b]), float(d_j.visible_ratio),
                                   atol=5e-3)
        eps_j, vis_j = np.asarray(d_j.final_epsilons), np.asarray(d_j.final_valid)
        apart = (np.abs(out.eps[b].numpy() - eps_j) > 1e-3) | (out.visible[b].numpy() != vis_j)
        assert apart.mean() <= 5e-3, f"pair {b}: {apart.sum()} per-point values differ"
    np.testing.assert_allclose(torch.sqrt((out.eps ** 2).sum(-1)).numpy(),
                               out.best_energy.numpy(), rtol=1e-5)


def _first_step_norm(args):
    """|psi| of iteration 0's step of every pair."""
    R0, t0, pts, valid, _, dt, fx, fy, cx, cy, cfg, _ = args
    g = sg_terms.subgradient_terms_plain(R0, t0, pts, valid, dt, fx, fy, cx, cy,
                                         cfg.weight_sigma2)[0]
    precond = torch.tensor([1.0] * 3 + [cfg.precondition_rot] * 3)
    psi, _ = klsg.subgradient_step(R0, t0, g, torch.zeros_like(g), 0, cfg, precond)
    return torch.linalg.vector_norm(psi, dim=-1).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_level_sg_matches_jax(case):
    cfg, shape, cap, n_iters, start_scale = CASES[case]
    jax_out, out, args = _solve_both(cfg, shape, cap, n_iters, start_scale)
    _check_against_jax(jax_out, out, n_iters)
    assert out.eps.shape == (3, cap) and out.visible.dtype == torch.bool
    assert (out.energy != 0).all()  # the default termination norm ends no pair
    norm = _first_step_norm(args)
    if case == "inside_trust_region":
        assert (norm < 0.5 * cfg.trust_region_radius).all(), norm
    else:  # the trust region binds
        np.testing.assert_allclose(norm, cfg.trust_region_radius, rtol=1e-5)


def test_pairs_finish_at_different_iterations():
    """A step length (1e-6) and a termination norm (1e-4) at which the
    three pairs stop at different iterations, each where JAX stops it, with
    zeros in the curve after and the best iterate kept from before."""
    cfg = dataclasses.replace(REFERENCE, step_length=1e-6, psi_norm_termination=1e-4)
    jax_out, out, _ = _solve_both(cfg, (60, 80), 256, 50)
    _check_against_jax(jax_out, out, 50)
    ran = (out.energy != 0).sum(-1).tolist()
    assert len(set(ran)) > 1 and max(ran) < 50 and min(ran) > 1, ran
    for b, n in enumerate(ran):
        assert (out.energy[b, :n] != 0).all() and (out.energy[b, n:] == 0).all()
        assert int(out.best_iter[b]) < n


@pytest.mark.parametrize("pull", [True, False])
def test_edge_free_target_moves_by_the_pull_alone(pull):
    """Pair 1's target is edge-free (the normalized DT all 0): its gradient
    is zero, so its step is the L2 pull toward the unit log-pose alone, as
    in JAX; without the pull it never moves, ends at iteration 0 on a zero
    step and returns the start pose. The other pairs solve as in JAX."""
    cfg = dataclasses.replace(REFERENCE, enable_l2_regularization=pull)
    jax_out, out, args = _solve_both(cfg, (60, 80), 256, 6, flat=(1,))
    _check_against_jax(jax_out, out, 6)
    assert not out.energy[1].any()
    R0, t0 = args[0][1], args[1][1]
    if pull:
        assert int(out.best_iter[1]) == 5  # every energy ties at 0: the last wins
        assert float((out.t[1] - t0).abs().max()) > 1e-4  # the pull moved it
    else:
        assert int(out.best_iter[1]) == 0
        np.testing.assert_array_equal(out.t[1].numpy(), t0.numpy())
        np.testing.assert_allclose(out.R[1].numpy(), R0.numpy(), rtol=0, atol=1e-6)


def _log_poses(rng):
    """Poses over every branch of se3_log, by name."""
    def exp(w_scale, n=256):
        psi = (rng.standard_normal((n, 6)) * w_scale).astype(np.float32)
        return tgeo.se3_exp(torch.from_numpy(psi))

    axis = rng.standard_normal((256, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.pi - rng.uniform(0, 8e-4, 256)
    near_pi = np.concatenate([rng.standard_normal((256, 3)) * 0.3, axis * theta[:, None]], 1)
    return {
        "taylor": exp(3e-4),
        "identity": (torch.eye(3)[None].repeat(4, 1, 1), torch.zeros(4, 3)),
        "generic_vinv_taylor": exp(1e-2),
        "generic": exp(0.5),
        "near_pi": tgeo.se3_exp(torch.from_numpy(near_pi.astype(np.float32))),
    }


@pytest.mark.parametrize("regime", ["taylor", "identity", "generic_vinv_taylor", "generic",
                                    "near_pi"])
def test_se3_log_twin_is_bitwise_the_ports_and_close_to_jax(regime, monkeypatch):
    """`se3_plain.se3_log` (the element-by-element twin of the device
    function) against `core/geometry.se3_log` in the Taylor, generic and
    near-pi branches of so3_log and on both sides of V^-1's threshold: bit
    for bit once both take the same square roots (the twin's are correctly
    rounded, as the device's `__fsqrt_rn`; torch's vectorized float32 sqrt on
    the CPU is off by an ulp for some arguments, so `torch.sqrt` goes through
    float64 here), within 1e-6 as `core/geometry` stands, and within 5e-6 of
    JAX's."""
    R, t = _log_poses(np.random.default_rng(5))[regime]
    cos = (R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1.0) * 0.5
    branch = {"taylor": cos > 1.0 - 1e-6, "identity": cos > 1.0 - 1e-6,
              "near_pi": cos < -(1.0 - 5e-7)}.get(
        regime, (cos <= 1.0 - 1e-6) & (cos >= -(1.0 - 5e-7)))
    assert branch.float().mean() > 0.9, regime
    twin = se3_plain.from_rows(se3_plain.se3_log(se3_plain.to_rows(R), se3_plain.to_rows(t)))
    np.testing.assert_allclose(twin.numpy(), tgeo.se3_log(R, t).numpy(), rtol=0, atol=1e-6)
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).to(x.dtype))
    want = tgeo.se3_log(R, t)
    monkeypatch.undo()
    assert torch.equal(twin, want)
    theta2 = (twin[:, 3:] ** 2).sum(-1)
    if regime == "generic_vinv_taylor":
        assert (theta2 < 1e-3).float().mean() > 0.9
    if regime in ("generic", "near_pi"):
        assert (theta2 >= 1e-3).all()
    xi_j = np.asarray(jgeo.se3_log(jnp.asarray(R.numpy()), jnp.asarray(t.numpy())))
    np.testing.assert_allclose(twin.numpy(), xi_j, rtol=0, atol=5e-6)


def test_run_level_subgradient_is_one_level_sg_call(monkeypatch):
    """`run_level` hands a sub-gradient level to `level_sg` once and returns
    its result as the level's diagnostics, and `_subgradient_step` is still
    importable from the solver module."""
    cfg = REFERENCE
    _, _, _, _, ref_t, now_t, (R0, t0) = _inputs(cfg, (60, 80), 256)
    calls = []

    def counted(*a, **k):
        calls.append(a)
        return klsg.level_sg(*a, **k)

    monkeypatch.setattr(ted, "level_sg", counted)
    intr = Intrinsics.from_config(CAMS[(60, 80)])
    R, t, diag = ted.run_level(ref_t, now_t, intr, R0, t0, cfg, 5)
    out = klsg.level_sg(R0, t0, ref_t.pts3d, ref_t.valid, ref_t.count, now_t.dt, *intr, cfg, 5)
    assert len(calls) == 1
    assert torch.equal(R, out.R) and torch.equal(t, out.t)
    assert torch.equal(diag.energy, out.energy) and torch.equal(diag.best_iter, out.best_iter)
    assert torch.equal(diag.final_epsilons, out.eps) and torch.equal(diag.final_valid, out.visible)
    assert torch.equal(diag.visible_ratio, out.visible_ratio)
    assert torch.equal(diag.num_points, ref_t.count)
    assert ted._subgradient_step is klsg.subgradient_step


@pytest.mark.parametrize("k, threads", [(1024, 512), (2048, 512), (4096, 512), (8192, 1024)])
def test_block_size_rule(k, threads):
    assert klsg.block_threads(k) == threads and threads in klsg.THREADS


def _meta_args(b=2, k=1024, h=60, w=80):
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    return dict(R0=m(b, 3, 3), t0=m(b, 3), pts=m(b, k, 3), valid=m(b, k, dt=torch.bool),
                count=m(b, dt=torch.int32), dt=m(b, h, w))


@pytest.mark.parametrize("bad", ["pts_shape", "valid_dtype", "dt_dtype", "dt_rows", "count_dtype",
                                 "R0_shape", "trace_shape", "threads", "n_iters", "smem",
                                 "device"])
def test_cuda_wrapper_rejects_bad_arguments_before_building(bad, monkeypatch):
    """On a non-CPU tensor the wrapper checks shapes, dtypes, strides, the
    block size, the iteration count and the shared-memory need before it
    builds or launches anything (`build.load` is made to fail to prove it)."""
    def no_build(*_a, **_k):
        raise AssertionError("level_sg built a kernel before checking its arguments")

    monkeypatch.setattr(build, "load", no_build)
    a = _meta_args()
    n_iters, extra = 4, {}
    if bad == "pts_shape":
        a["pts"] = torch.empty((2, 1024, 4), device="meta")
    elif bad == "valid_dtype":
        a["valid"] = torch.empty((2, 1024), dtype=torch.uint8, device="meta")
    elif bad == "dt_dtype":
        a["dt"] = torch.empty((2, 60, 80), dtype=torch.bfloat16, device="meta")
    elif bad == "dt_rows":
        a["dt"] = torch.empty((2, 60, 160), device="meta")[:, :, ::2]
    elif bad == "count_dtype":
        a["count"] = torch.empty((2,), dtype=torch.int64, device="meta")
    elif bad == "R0_shape":
        a["R0"] = torch.empty((3, 3, 3), device="meta")
    elif bad == "trace_shape":
        extra["trace"] = torch.empty((2, 4, 12), device="meta")
    elif bad == "threads":
        extra["threads"] = 96
    elif bad == "n_iters":
        n_iters = 0
    elif bad == "smem":
        a.update(_meta_args(k=131072))
    match = {"dt_rows": "rows must be contiguous", "threads": "threads", "n_iters": "n_iters",
             "smem": "shared memory", "device": "unsupported device"}.get(bad, "must be")
    with pytest.raises(ValueError, match=match):
        klsg.level_sg(a["R0"], a["t0"], a["pts"], a["valid"], a["count"], a["dt"],
                      65.0, 65.0, 39.5, 29.5, REFERENCE, n_iters, **extra)


# ---------------------------------------------------------------------------
# the pyramid launch, the route rule and a numpy model of the warp's log
# ---------------------------------------------------------------------------


def _pyramid_inputs(cfg):
    """A 2-level pyramid of the 160x120 camera (level 1 at 60x80 with 256
    points, level 0 at 120x160 with 1024), B = 3 pairs, extracted and
    prepared by the JAX package and carried across."""
    return [_inputs(cfg, (120, 160), 1024), _inputs(cfg, (60, 80), 256)]


def test_plain_pyramid_is_the_chained_levels():
    """`level_sg_pyramid` on CPU tensors (its plain version) is `level_sg`
    level by level, each from the pose the one before returned, bitwise."""
    cfg = REFERENCE
    lv = _pyramid_inputs(cfg)
    intr = Intrinsics.from_config(CAMS[(120, 160)])
    table = [klsg.SgLevel(lv[level][4].pts3d, lv[level][4].valid, lv[level][4].count,
                          lv[level][5].dt, *intr.at_level(level), 8) for level in (1, 0)]
    R0, t0 = lv[1][6]
    pyr = klsg.level_sg_pyramid(R0, t0, table, cfg)
    R, t = R0, t0
    for lvl, got in zip(table, pyr):
        want = klsg.level_sg(R, t, *lvl[:8], cfg, lvl.n_iters)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        R, t = want.R, want.t


def test_solve_pyramid_matches_jax():
    """`solve_pyramid` of the sub-gradient (one `level_sg_pyramid` call)
    against JAX's `solve_pyramid` over the same 2-level pyramid, 10
    iterations a level, pair by pair within this file's bars: each level's
    energy curve (1e-5 relative plus 1e-2), the same iteration of
    termination and best iteration, the final pose within 3e-5."""
    cfg = dataclasses.replace(REFERENCE, iterations=(10, 10))
    lv = _pyramid_inputs(cfg)
    intr = JIntrinsics.from_config(CAMS[(120, 160)])
    solve = jax.jit(lambda r, n, R, t: jed.solve_pyramid(r, n, intr, cfg, R, t))
    R0, t0 = lv[1][6]
    R, t, diags = ted.solve_pyramid(tuple(x[4] for x in lv), tuple(x[5] for x in lv),
                                    Intrinsics.from_config(CAMS[(120, 160)]), cfg, R0, t0)
    assert len(diags) == 2
    for b in range(3):
        R_j, t_j, d_j = solve(tuple(x[0][b] for x in lv), tuple(x[1][b] for x in lv),
                              jnp.asarray(R0[b].numpy()), jnp.asarray(t0[b].numpy()))
        for d_p, dj in zip(diags, d_j):
            e_j, e_p = np.asarray(dj.energy), d_p.energy[b].numpy()
            assert np.array_equal(e_p == 0, e_j == 0), f"pair {b}: done at another iteration"
            np.testing.assert_allclose(e_p, e_j, rtol=1e-5, atol=1e-2, err_msg=f"pair {b}")
            assert int(d_p.best_iter[b]) == int(dj.best_iter), f"pair {b}"
        np.testing.assert_allclose(R[b].numpy(), np.asarray(R_j), rtol=0, atol=3e-5)
        np.testing.assert_allclose(t[b].numpy(), np.asarray(t_j), rtol=0, atol=3e-5)


@pytest.mark.parametrize("k, ranks", [(1024, 1), (2048, 1), (4096, 1), (8192, 2), (14000, 4),
                                      (131072, 8)])
def test_route_rule(k, ranks):
    """`level_ranks` reads the level's capacity alone (never the batch):
    one block up to 4096 points, then one more for every 4096, each with
    `RANK_THREADS` working threads; a forced size is taken as given,
    one the card does not have raises."""
    assert klsg.level_ranks(k) == ranks
    assert klsg.level_ranks.__code__.co_argcount == 2  # k and the forced size only
    for c in klsg.CLUSTERS:
        assert klsg.level_ranks(k, c) == c
    with pytest.raises(ValueError, match="cluster must be"):
        klsg.level_ranks(k, 16)


@pytest.mark.parametrize("bad", ["empty", "levels", "traces", "level_dtype", "cluster",
                                 "device"])
def test_pyramid_wrapper_rejects_bad_arguments_before_building(bad, monkeypatch):
    """`level_sg_pyramid` on non-CPU tensors checks every level of the
    table, its traces and the route it is forced to before it builds or
    launches anything."""
    def no_build(*_a, **_k):
        raise AssertionError("level_sg_pyramid built a kernel before checking its arguments")

    monkeypatch.setattr(build, "load", no_build)
    a = _meta_args()
    table = [klsg.SgLevel(a["pts"], a["valid"], a["count"], a["dt"], 65.0, 65.0, 39.5, 29.5, 4)
             for _ in range(2)]
    cluster, traces = None, None
    if bad == "empty":
        table = []
    elif bad == "levels":
        table = table * 5
    elif bad == "traces":
        traces = (None,)
    elif bad == "level_dtype":
        table[1] = table[1]._replace(dt=torch.empty((2, 60, 80), dtype=torch.bfloat16,
                                                    device="meta"))
    elif bad == "cluster":
        cluster = 3
    match = {"empty": "no level", "levels": "levels a launch", "traces": "levels a launch",
             "cluster": "cluster must be", "device": "unsupported device"}.get(bad, "must be")
    with pytest.raises(ValueError, match=match):
        klsg.level_sg_pyramid(a["R0"], a["t0"], table, REFERENCE, cluster, traces=traces)


# numpy model of warp.cuh's warp_se3_log: the log's scalar chain is the
# warp's, uniform on every lane; V^-1 t row i on lane i, read back by
# shuffles (here: the rows computed side by side)

F32 = np.float32


def _rounded(fn, x):
    return fn(x.astype(np.float64)).astype(F32)


def _warp_se3_log(R, t):
    """R (N, 9), t (N, 3) float32 -> psi (N, 6), in warp_se3_log's order."""
    R = [R[:, i] for i in range(9)]
    t = [t[:, i] for i in range(3)]
    trace = (R[0] + R[4]) + R[8]
    cs = np.minimum(np.maximum((trace - F32(1)) * F32(0.5), F32(-1)), F32(1))
    small = cs > F32(0.999999)
    near_pi = cs < F32(-0.9999995)
    theta = _rounded(np.arccos, np.where(small, F32(0), cs))
    # near pi: the axis from the diagonal, signs from the off-diagonals
    denom = np.maximum(F32(1) - cs, F32(1e-8))
    a2 = [np.maximum((F32(0.5) * (R[4 * i] + R[4 * i]) - cs) / denom, F32(0)) for i in range(3)]
    sgn1 = lambda x: np.where(x < 0, F32(-1), F32(1))  # noqa: E731
    s01, s02, s12 = (sgn1(F32(0.5) * (R[a] + R[b])) for a, b in ((1, 3), (2, 6), (5, 7)))
    i0 = (a2[0] >= a2[1]) & (a2[0] >= a2[2])
    i1 = ~i0 & (a2[1] >= a2[2])
    sg = [np.where(i0, F32(1), np.where(i1, s01, s02)),
          np.where(i1, F32(1), np.where(i0, s01, s12)),
          np.where(~i0 & ~i1, F32(1), np.where(i0, s02, s12))]
    w_pi = [(theta * np.sqrt(a2[i])) * sg[i] for i in range(3)]
    sn = _rounded(np.sin, theta)
    k_taylor = F32(0.5) * (F32(1) + (F32(2) * (F32(1) - cs)) / F32(6))
    with np.errstate(divide="ignore", invalid="ignore"):
        k_gen = (F32(0.5) * theta) / np.where(np.abs(sn) < F32(1e-8), F32(1), sn)
    k = np.where(small, k_taylor, k_gen)
    asym = [R[7] - R[5], R[2] - R[6], R[3] - R[1]]
    w = [np.where(near_pi, w_pi[i], k * asym[i]) for i in range(3)]
    theta2 = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2]
    th = np.sqrt(theta2 + F32(1e-16))
    sd, cd = _rounded(np.sin, th), _rounded(np.cos, th)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = sd / th
        b = (F32(1) - cd) / theta2
        coef = np.where(theta2 < F32(1e-3), F32(1.0 / 12.0) + theta2 / F32(720),
                        (F32(1) - a / (F32(2) * b)) / np.maximum(theta2, F32(1e-16)))
    zero = np.zeros_like(theta2)
    W = [[zero, -w[2], w[1]], [w[2], zero, -w[0]], [-w[1], w[0], zero]]
    v = []
    for i in range(3):  # lane i
        V = []
        for j in range(3):
            ww = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j]
            V.append((F32(1 if i == j else 0) - F32(0.5) * W[i][j]) + coef * ww)
        v.append((V[0] * t[0] + V[1] * t[1]) + V[2] * t[2])
    return np.stack(v + w, 1)


@pytest.mark.parametrize("regime", ["taylor", "identity", "generic_vinv_taylor", "generic",
                                    "near_pi"])
def test_warp_model_se3_log_is_the_twin_bitwise(regime):
    """The log on the warp (warp_se3_log: the branches decided once for the
    warp, the double arccos, the generic branch's sine, one sincos for
    V^-1, its rows one a lane) gives se3_plain.se3_log bit for bit in every
    branch of so3_log and on both sides of V^-1's threshold."""
    R, t = _log_poses(np.random.default_rng(21))[regime]
    got = _warp_se3_log(R.reshape(-1, 9).numpy(), t.numpy())
    want = se3_plain.from_rows(se3_plain.se3_log(se3_plain.to_rows(R), se3_plain.to_rows(t)))
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))
