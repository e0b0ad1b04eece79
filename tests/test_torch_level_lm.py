"""The whole-level Levenberg-Marquardt entry point of the port
(`kernels/level_lm.level_lm`, which runs its plain version on CPU tensors)
against the JAX package's `run_level` on the CPU, B = 3 pairs on identical
carried-across levels (60x80 and 120x160, 256-1024 points):

* the deferred accept at Jacobian stride 1 and 2;
* the standard LM at stride 1 (the best iterate's per-point values tracked),
  with a proposal stride of 2 (the current pose's energy on the proposal
  subset) and at Jacobian stride 2;
* termination norms at which the pairs finish at different iterations;
* an edge-free target, where every proposal ties and the pose stays;
* the level's all-point diagnostics where they are not the best iterate's
  own (deferred accept, Jacobian stride > 1): at the returned pose, JAX's
  `_project_and_sample` there (visibility and visible ratio exact, residuals
  within 2e-3, the energy within 1e-5 relative), and JAX's own diagnostics
  at JAX's pose (`test_all_point_diagnostics_match_jax`); `run_level` takes
  them from the launch and runs no residual pass.

The port's bilinear sampler rounds here as JAX's one-hot matmul gathers
round (`test_torch_parity_solve._sample_bf16_like_jax`, bitwise JAX's), so
that what differs is the level loop's own arithmetic: the order of the
sums and the 6x6 step. (`test_torch_parity_solve.py` and
`test_torch_solve.py` hold the unpatched path, through `run_level`.) Bars:
energies within 1e-3 relative for the standard LM (PERF.md) and 3e-3 for
the deferred accept, whose first proposal solves an ill-conditioned 6x6
system (measured <= 2.1e-3); poses within 1e-3; accept/reject decisions
and the best iteration equal except on plateaus below 1e-3 relative; the
same iteration of termination.

Also the plain twins of `csrc/se3.cuh` (`kernels/se3_plain.py`) against
`core/geometry`, `ops/linalg6` and JAX's `rotationize_newton`, and the CUDA
wrapper's argument checks, which run before anything is built.
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
from rgbd_odometry_tpu.profiles import production_320  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.core import geometry as tgeo  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import build, fused_iter, residual, se3_plain  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import level_lm as klm  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402
from test_torch_parity_solve import _sample_bf16_like_jax  # noqa: E402

torch.set_num_threads(1)

CAMS = {
    (120, 160): CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5),
    (60, 80): CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5),
}
BASE = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
START = np.array([0.008, -0.004, 0.004, 0.003, -0.004, 0.002], np.float32)
STANDARD = SolverConfig(method="gauss_newton")  # the dvo defaults: standard LM, normalized DT
DEFERRED = production_320().solver  # deferred accept on the pixel-unit windowed DT

# case -> (config, level shape, capacity, iterations, expected (jstride, stride))
CASES = {
    "deferred_j1": (DEFERRED, (60, 80), 256, 6, (1, 1)),
    "deferred_j2": (DEFERRED, (120, 160), 1024, 6, (2, 1)),  # production_320's level 1
    "standard_track": (STANDARD, (60, 80), 256, 18, (1, 1)),
    "standard_stride2": (dataclasses.replace(STANDARD, lm_jacobian_stride=1), (120, 160), 1024,
                         18, (1, 2)),
    "standard_j2": (STANDARD, (120, 160), 1024, 18, (2, 1)),
}


@pytest.fixture
def bf16_like_jax(monkeypatch):
    monkeypatch.setattr(fused_iter, "sample_bilinear_value_grad", _sample_bf16_like_jax)
    monkeypatch.setattr(residual, "sample_bilinear_value_grad", _sample_bf16_like_jax)


def _inputs(cfg, shape, cap, flat=()):
    """B = 3 rendered pairs at one level, extracted and prepared by the JAX
    package and carried across; pairs in `flat` get an edge-free target.
    Returns the JAX levels (per pair), the port's batched levels, the
    intrinsics and the start poses."""
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
        starts.append(jgeo.se3_exp(jnp.asarray(START * (1 - 0.3 * i))))
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: np.stack(a), *xs)  # noqa: E731
    R0 = np.stack([np.asarray(s[0]) for s in starts])
    t0 = np.stack([np.asarray(s[1]) for s in starts])
    ref_t, now_t = convert.ref_level(stack(refs)), convert.now_level(stack(nows))
    return refs, nows, starts, intr, ref_t, now_t, convert.pose(R0, t0)


def _solve_both(cfg, shape, cap, n_iters, flat=()):
    refs, nows, starts, intr, ref_t, now_t, (R0, t0) = _inputs(cfg, shape, cap, flat)
    run = jax.jit(lambda r, n, R, t: jed.run_level(r, n, intr, R, t, cfg, n_iters))
    jax_out = [run(r, n, *s) for r, n, s in zip(refs, nows, starts)]
    jstride, stride = ted.level_strides(cfg, cap)
    out = klm.level_lm(R0, t0, ref_t.pts3d, ref_t.valid, ref_t.count, now_t.chans[:, 0],
                       now_t.scale, *Intrinsics.from_config(CAMS[shape]), cfg, n_iters,
                       jstride, stride)
    return jax_out, out, (jstride, stride)


def _deferred_decisions(e):
    """(accept, relative change against the backup) of each deferred-accept
    verdict read off an energy curve: iteration i > 0 evaluates the pending
    proposal, accepted when below the energy of the last accepted pose."""
    eb, out = e[0], []
    for x in e[1:]:
        if x == 0:
            break
        out.append((x < eb, abs(x - eb) / eb))
        eb = x if x < eb else eb
    return out


def _check_against_jax(cfg, jax_out, out, n_iters, stride=1):
    """The bars of the module docstring, pair by pair."""
    assert out.energy.shape == (3, n_iters) and out.R.shape == (3, 3, 3)
    deferred = cfg.lm_deferred_accept
    for b, (R_j, t_j, d_j) in enumerate(jax_out):
        e_j, e_p = np.asarray(d_j.energy), out.energy[b].numpy()
        assert np.array_equal(e_p == 0, e_j == 0), f"pair {b}: done at another iteration"
        np.testing.assert_allclose(e_p, e_j, rtol=3e-3 if deferred else 1e-3, err_msg=f"pair {b}")
        bp, bj = int(out.best_iter[b]), int(d_j.best_iter)
        assert bp == bj or abs(e_j[bp] - e_j[bj]) <= 1e-3 * e_j[bj], f"pair {b}: best {bp} {bj}"
        assert np.linalg.norm(out.t[b].numpy() - np.asarray(t_j)) < 1e-3, f"pair {b}"
        assert np.abs(out.R[b].numpy() - np.asarray(R_j)).max() < 1e-3, f"pair {b}"
        if deferred:
            for (a_p, d_p), (a_j, d_j_) in zip(_deferred_decisions(e_p), _deferred_decisions(e_j)):
                assert a_p == a_j or (d_p < 1e-3 and d_j_ < 1e-3), f"pair {b}"
        else:
            # the standard LM moves only on an accepted step, so the energy
            # entering an iteration changes exactly when the last step was
            # accepted; with the proposals tested on all points (stride 1)
            # only on a strict decrease
            live = (e_p[1:] > 0) & (e_j[1:] > 0)
            drop_j = (e_j[:-1] - e_j[1:])[live] / e_j[:-1][live]
            drop_p = (e_p[:-1] - e_p[1:])[live] / e_p[:-1][live]
            if stride == 1:
                assert (drop_p >= 0).all() and (drop_j >= 0).all()
            differ = (drop_j != 0) != (drop_p != 0)
            assert (np.abs(drop_j[differ]) < 1e-3).all() and (np.abs(drop_p[differ]) < 1e-3).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_level_lm_matches_jax(case, bf16_like_jax):
    cfg, shape, cap, n_iters, strides = CASES[case]
    jax_out, out, got = _solve_both(cfg, shape, cap, n_iters)
    assert got == strides
    _check_against_jax(cfg, jax_out, out, n_iters, strides[1])
    track = not cfg.lm_deferred_accept and strides[0] == 1
    assert out.eps.shape == (3, cap) and out.visible.shape == (3, cap)
    assert out.final_energy.shape == (3,) and out.visible_ratio.shape == (3,)
    if track:
        # the best iterate's per-point values come from the level itself
        assert torch.equal(out.final_energy, out.best_energy)
        for b, (_, _, d_j) in enumerate(jax_out):
            np.testing.assert_allclose(float(out.best_energy[b]), float(d_j.best_energy),
                                       rtol=1e-3)
            np.testing.assert_allclose(float(out.visible_ratio[b]), float(d_j.visible_ratio),
                                       atol=5e-3)
        np.testing.assert_allclose(torch.sqrt((out.eps ** 2).sum(-1)).numpy(),
                                   out.best_energy.numpy(), rtol=1e-5)


@pytest.mark.parametrize("case", ["deferred_j1", "deferred_j2", "standard_j2"])
def test_all_point_diagnostics_match_jax(case, bf16_like_jax):
    """Where the diagnostics are not the best iterate's own, `level_lm`
    returns those of one pass over all K points at its returned pose: JAX's
    `_project_and_sample` at that pose gives the same visibility and visible
    ratio exactly, residuals within 2e-3 (a projection rounded in another
    order moves a bilinear sample of the bf16 DT) and the energy within 1e-5
    relative. Against JAX's own diagnostics, at JAX's pose (up to 5e-4
    away, within this file's pose bar, which moves a few points across the
    image edge): the visible ratio within 5e-3 and the energy within 2e-2
    for every pair, and within 1e-3 for at least two of the three."""
    cfg, shape, cap, n_iters, _ = CASES[case]
    refs, nows, starts, intr, ref_t, now_t, (R0, t0) = _inputs(cfg, shape, cap)
    run = jax.jit(lambda r, n, R, t: jed.run_level(r, n, intr, R, t, cfg, n_iters))
    jstride, stride = ted.level_strides(cfg, cap)
    out = klm.level_lm(R0, t0, ref_t.pts3d, ref_t.valid, ref_t.count, now_t.chans[:, 0],
                       now_t.scale, *Intrinsics.from_config(CAMS[shape]), cfg, n_iters,
                       jstride, stride)
    close = 0
    for b in range(3):
        eps, _, vis, energy, ratio, *_ = jed._project_and_sample(
            jnp.asarray(out.R[b].numpy()), jnp.asarray(out.t[b].numpy()), refs[b], nows[b],
            intr, cfg)
        np.testing.assert_array_equal(out.visible[b].numpy(), np.asarray(vis))
        assert float(out.visible_ratio[b]) == float(ratio)
        np.testing.assert_allclose(out.eps[b].numpy(), np.asarray(eps), rtol=0, atol=2e-3)
        np.testing.assert_allclose(float(out.final_energy[b]), float(energy), rtol=1e-5)
        assert not (out.eps[b].numpy()[~out.visible[b].numpy()]).any()
        _, _, d_j = run(refs[b], nows[b], *starts[b])
        np.testing.assert_allclose(float(out.visible_ratio[b]), float(d_j.visible_ratio),
                                   atol=5e-3)
        e_p, e_j = float(out.final_energy[b]), float(d_j.best_energy)
        np.testing.assert_allclose(e_p, e_j, rtol=2e-2)
        close += abs(e_p - e_j) <= 1e-3 * e_j
    assert close >= 2


def test_run_level_takes_the_diagnostics_from_the_launch(monkeypatch, bf16_like_jax):
    """A deferred-accept level at Jacobian stride 2: `run_level`'s
    diagnostics are `level_lm`'s all-point outputs, with no residual pass
    of its own: every residual pass on the CPU ends in `residual_pass_plain`
    (`residual_pass` dispatches there too), and `run_level` makes as many
    as one `level_lm` call alone, in a single `level_lm` call."""
    counts = {"passes": 0, "level_lm": 0}
    plain, lm = residual.residual_pass_plain, ted.level_lm

    def counted_pass(*a, **k):
        counts["passes"] += 1
        return plain(*a, **k)

    def counted_lm(*a, **k):
        counts["level_lm"] += 1
        return lm(*a, **k)

    monkeypatch.setattr(residual, "residual_pass_plain", counted_pass)
    monkeypatch.setattr(klm, "residual_pass_plain", counted_pass)
    monkeypatch.setattr(ted, "level_lm", counted_lm)
    cfg, shape, cap, n_iters, _ = CASES["deferred_j2"]
    _, _, _, _, ref_t, now_t, (R0, t0) = _inputs(cfg, shape, cap)
    li = Intrinsics.from_config(CAMS[shape])
    R, t, diag = ted.run_level(ref_t, now_t, li, R0, t0, cfg, n_iters)
    in_run_level = counts["passes"]
    out = klm.level_lm(R0, t0, ref_t.pts3d, ref_t.valid, ref_t.count, now_t.chans[:, 0],
                       now_t.scale, *li, cfg, n_iters, *ted.level_strides(cfg, cap))
    assert counts["level_lm"] == 1
    assert in_run_level == counts["passes"] - in_run_level > 0
    assert torch.equal(R, out.R) and torch.equal(t, out.t)
    for got, want in ((diag.best_energy, out.final_energy), (diag.final_epsilons, out.eps),
                      (diag.final_valid, out.visible), (diag.visible_ratio, out.visible_ratio),
                      (diag.energy, out.energy), (diag.best_iter, out.best_iter)):
        assert torch.equal(got, want)
    assert not hasattr(ted, "residual_pass")


@pytest.mark.parametrize("deferred", [False, True])
def test_pairs_finish_at_different_iterations(deferred, bf16_like_jax):
    """A termination norm (5e-3 for the standard LM, 1e-3 for the deferred
    accept) at which the three pairs stop at different iterations, each
    where JAX stops it, with zeros in the curve after."""
    cfg = dataclasses.replace(DEFERRED if deferred else STANDARD,
                              psi_norm_termination=1e-3 if deferred else 5e-3)
    jax_out, out, _ = _solve_both(cfg, (60, 80), 256, 18)
    _check_against_jax(cfg, jax_out, out, 18)
    ran = (out.energy != 0).sum(-1).tolist()
    assert len(set(ran)) > 1 and max(ran) < 18 and min(ran) > 1, ran
    for b, n in enumerate(ran):
        assert (out.energy[b, :n] != 0).all() and (out.energy[b, n:] == 0).all()


@pytest.mark.parametrize("deferred", [False, True])
def test_edge_free_target_ties_and_keeps_the_pose(deferred, bf16_like_jax):
    """Pair 1's target is edge-free (the normalized DT all 0, so every
    residual is 0): every proposal ties, the standard LM neither accepts
    nor terminates and the pose stays the start pose; the deferred accept
    never accepts a pending step. The other pairs solve as in JAX."""
    cfg = DEFERRED if deferred else STANDARD
    if deferred:
        cfg = dataclasses.replace(cfg, normalize_dt=True, edt_window=0)
    jax_out, out, _ = _solve_both(cfg, (60, 80), 256, 6, flat=(1,))
    _check_against_jax(cfg, jax_out, out, 6)
    assert not out.energy[1].any()
    R0, t0 = jgeo.se3_exp(jnp.asarray(START * 0.7))
    np.testing.assert_array_equal(out.t[1].numpy(), np.asarray(t0))
    np.testing.assert_allclose(out.R[1].numpy(), np.asarray(jax_out[1][0]), atol=1e-6)


def _rand_rot(rng, n, noise=0.0):
    psi = (rng.standard_normal((n, 6)) * 0.3).astype(np.float32)
    R, t = tgeo.se3_exp(torch.from_numpy(psi))
    return R + noise * torch.from_numpy(rng.standard_normal((n, 3, 3)).astype(np.float32)), t


def test_se3_twins_compose_and_newton_schulz():
    """compose and rotationize_newton twins against core/geometry (1e-6)
    and JAX's rotationize_newton (1e-6)."""
    rng = np.random.default_rng(0)
    R1, t1 = _rand_rot(rng, 32)
    R2, t2 = _rand_rot(rng, 32)
    Rc, tc = se3_plain.compose(se3_plain.to_rows(R1), se3_plain.to_rows(t1),
                               se3_plain.to_rows(R2), se3_plain.to_rows(t2))
    Rg, tg = tgeo.compose(R1, t1, R2, t2)
    np.testing.assert_allclose(se3_plain.from_rows(Rc).numpy(), Rg.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(se3_plain.from_rows(tc).numpy(), tg.numpy(), rtol=0, atol=1e-6)
    Rn, _ = _rand_rot(rng, 32, noise=1e-3)
    twin = se3_plain.from_rows(se3_plain.rotationize_newton(se3_plain.to_rows(Rn))).numpy()
    np.testing.assert_allclose(twin, tgeo.rotationize_newton(Rn).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(twin, np.asarray(jgeo.rotationize_newton(jnp.asarray(Rn.numpy()))),
                               rtol=0, atol=1e-6)


def test_se3_twins_damped_step_and_trust_region():
    """lm_damped is `H + lam diag(max(diag H, 1e-8))` bit for bit; lm_psi
    and trust_region agree with the torch step of `kernels/level_lm`
    (`ops/linalg6.chol_solve6`) to 1e-6 of each step's scale, on steps
    inside and outside the trust region."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((32, 6, 6)).astype(np.float32)
    H = torch.from_numpy(A @ A.transpose(0, 2, 1) + 0.1 * np.eye(6, dtype=np.float32))
    H[0] = 0.0  # no visible point: the 1e-8 floor of the damping
    g = torch.from_numpy(rng.standard_normal((32, 6)).astype(np.float32))
    g[: 16] *= 1e-4  # small steps stay inside the region
    lam = torch.from_numpy(rng.uniform(1e-8, 1.0, 32).astype(np.float32))
    damped = se3_plain.from_rows(se3_plain.lm_damped(se3_plain.to_rows(H), lam))
    want = H + lam[:, None, None] * torch.diag_embed(
        torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-8))
    assert torch.equal(damped, want)
    for radius in (0.01, 10.0):
        twin = se3_plain.from_rows(
            se3_plain.lm_psi(se3_plain.to_rows(H), se3_plain.to_rows(g), lam, radius))
        ref = klm.lm_psi(H, g, lam, radius)
        scale = ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
        assert ((twin - ref).abs() <= 1e-6 * scale).all(), radius
        psi = 0.02 * torch.from_numpy(rng.standard_normal((32, 6)).astype(np.float32))
        tr = se3_plain.from_rows(se3_plain.trust_region(se3_plain.to_rows(psi), radius))
        np.testing.assert_allclose(tr.numpy(), klm.trust_region(psi, radius).numpy(), rtol=0,
                                   atol=1e-6)
        assert (torch.linalg.vector_norm(tr, dim=-1) <= radius * (1 + 1e-6)).all()


def _meta_args(b=2, k=1024, h=60, w=80):
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    return dict(R0=m(b, 3, 3), t0=m(b, 3), pts=m(b, k, 3), valid=m(b, k, dt=torch.bool),
                count=m(b, dt=torch.int32), img=m(b, h, w, dt=torch.bfloat16), scale=m(b))


@pytest.mark.parametrize("bad", ["pts_shape", "valid_dtype", "img_dtype", "count_dtype",
                                 "R0_shape", "stride", "n_iters", "smem", "device"])
def test_cuda_wrapper_rejects_bad_arguments_before_building(bad, monkeypatch):
    """On a non-CPU tensor the wrapper checks shapes, dtypes, strides, the
    iteration count and the shared-memory need before it builds or
    launches anything (`build.load` is made to fail to prove it)."""
    def no_build(*_a, **_k):
        raise AssertionError("level_lm built a kernel before checking its arguments")

    monkeypatch.setattr(build, "load", no_build)
    a = _meta_args()
    cfg, jstride, stride, n_iters = STANDARD, 1, 1, 4
    if bad == "pts_shape":
        a["pts"] = torch.empty((2, 1024, 4), device="meta")
    elif bad == "valid_dtype":
        a["valid"] = torch.empty((2, 1024), dtype=torch.uint8, device="meta")
    elif bad == "img_dtype":
        a["img"] = torch.empty((2, 60, 80), device="meta")
    elif bad == "count_dtype":
        a["count"] = torch.empty((2,), dtype=torch.int64, device="meta")
    elif bad == "R0_shape":
        a["R0"] = torch.empty((3, 3, 3), device="meta")
    elif bad == "stride":
        jstride, stride = 2, 2
    elif bad == "n_iters":
        n_iters = 0
    elif bad == "smem":
        a.update(_meta_args(k=16384))
    match = {"stride": "strides", "n_iters": "n_iters", "smem": "shared memory",
             "device": "unsupported device"}.get(bad, "must be")
    with pytest.raises(ValueError, match=match):
        klm.level_lm(a["R0"], a["t0"], a["pts"], a["valid"], a["count"], a["img"], a["scale"],
                     65.0, 65.0, 39.5, 29.5, cfg, n_iters, jstride, stride)
