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
wrapper's argument checks, which run before anything is built. The pyramid
entry (`level_lm_pyramid`): its plain version bitwise the levels one by
one, `solve_pyramid` against JAX's over a 2-level pyramid, the route rule
(`level_ranks`) and the wrapper's checks; numpy models of the kernel's
warp step (`csrc/warp.cuh`: compose, Newton-Schulz, the exponential, the
Cholesky step, the warp sums) bitwise the twins and the shuffle-down tree.
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
    ref_t = convert.ref_level(stack(refs), device="cpu")
    now_t = convert.now_level(stack(nows), device="cpu")
    return refs, nows, starts, intr, ref_t, now_t, convert.pose(R0, t0, device="cpu")


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
        a.update(_meta_args(k=131072))
    match = {"stride": "strides", "n_iters": "n_iters", "smem": "shared memory",
             "device": "unsupported device"}.get(bad, "must be")
    with pytest.raises(ValueError, match=match):
        klm.level_lm(a["R0"], a["t0"], a["pts"], a["valid"], a["count"], a["img"], a["scale"],
                     65.0, 65.0, 39.5, 29.5, cfg, n_iters, jstride, stride)


# ---------------------------------------------------------------------------
# the pyramid launch, the route rule and numpy models of the kernel's warp
# step and sums (csrc/warp.cuh, csrc/level_lm.cu)
# ---------------------------------------------------------------------------

PYRAMID = {  # case -> config, iterations (level 0, level 1)
    "deferred": (DEFERRED, (6, 6)),
    "standard": (STANDARD, (18, 6)),
}


def _pyramid_inputs(cfg):
    """A 2-level pyramid of the 160x120 camera (level 1 at 60x80 with 256
    points, level 0 at 120x160 with 1024), B = 3 pairs, extracted and
    prepared by the JAX package and carried across."""
    lv = [_inputs(cfg, (120, 160), 1024), _inputs(cfg, (60, 80), 256)]
    intr = JIntrinsics.from_config(CAMS[(120, 160)])
    return lv, intr


@pytest.mark.parametrize("case", sorted(PYRAMID))
def test_plain_pyramid_is_the_chained_levels(case, bf16_like_jax):
    """`level_lm_pyramid` on CPU tensors (its plain version) is `level_lm`
    level by level, each from the pose the one before returned, bitwise."""
    cfg, iters = PYRAMID[case]
    lv, _ = _pyramid_inputs(cfg)
    intr = Intrinsics.from_config(CAMS[(120, 160)])
    table = []
    for level in (1, 0):
        ref_t, now_t = lv[level][4], lv[level][5]
        table.append(klm.LmLevel(ref_t.pts3d, ref_t.valid, ref_t.count, now_t.chans[:, 0],
                                 now_t.scale, *intr.at_level(level), iters[level],
                                 *ted.level_strides(cfg, ref_t.pts3d.shape[1])))
    R0, t0 = lv[1][6]
    pyr = klm.level_lm_pyramid(R0, t0, table, cfg)
    R, t = R0, t0
    for lvl, got in zip(table, pyr):
        want = klm.level_lm(R, t, *lvl[:9], cfg, *lvl[9:])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        R, t = want.R, want.t


@pytest.mark.parametrize("case", sorted(PYRAMID))
def test_solve_pyramid_matches_jax(case, bf16_like_jax):
    """`solve_pyramid` (one `level_lm_pyramid` call) against JAX's
    `solve_pyramid` over the same 2-level pyramid, pair by pair: each
    level's energy curve within this file's bars (1e-3 relative, 3e-3 for
    the deferred accept; the same iteration of termination), the final pose
    within 1e-3."""
    cfg, iters = PYRAMID[case]
    cfg = dataclasses.replace(cfg, iterations=iters)
    lv, intr = _pyramid_inputs(cfg)
    solve = jax.jit(lambda r, n, R, t: jed.solve_pyramid(r, n, intr, cfg, R, t))
    refs_t = tuple(x[4] for x in lv)
    nows_t = tuple(x[5] for x in lv)
    R0, t0 = lv[1][6]
    R, t, diags = ted.solve_pyramid(refs_t, nows_t, Intrinsics.from_config(CAMS[(120, 160)]),
                                    cfg, R0, t0)
    assert len(diags) == 2
    rtol = 3e-3 if cfg.lm_deferred_accept else 1e-3
    for b in range(3):
        R_j, t_j, d_j = solve(tuple(x[0][b] for x in lv), tuple(x[1][b] for x in lv),
                              jnp.asarray(R0[b].numpy()), jnp.asarray(t0[b].numpy()))
        for d_p, dj in zip(diags, d_j):
            e_j, e_p = np.asarray(dj.energy), d_p.energy[b].numpy()
            assert np.array_equal(e_p == 0, e_j == 0), f"pair {b}: done at another iteration"
            np.testing.assert_allclose(e_p, e_j, rtol=rtol, err_msg=f"pair {b}")
        assert np.abs(R[b].numpy() - np.asarray(R_j)).max() < 1e-3, f"pair {b}"
        assert np.linalg.norm(t[b].numpy() - np.asarray(t_j)) < 1e-3, f"pair {b}"


@pytest.mark.parametrize("k, jstride, stride, deferred, ranks", [
    (512, 1, 1, True, 1),      # production_320 levels 2-3
    (1024, 2, 1, True, 1),     # production_320 level 1
    (2048, 4, 1, True, 1),     # production_320 level 0: 512 Jacobian points
    (4096, 8, 1, True, 1),     # production_vga level 0
    (1024, 2, 1, False, 1),    # the dvo defaults' level 3
    (4096, 4, 1, False, 1),    # level 1: 1024 Jacobian points
    (8192, 4, 1, False, 1),    # level 0: 2048 Jacobian points, one block (a split loses)
    (1024, 1, 2, False, 1),    # a proposal stride keeps one block
    (16384, 1, 1, False, 2),   # 16384 tracked points: 2 blocks
    (65536, 1, 1, False, 8),   # 65536: 8 blocks' shared memory
])
def test_route_rule(k, jstride, stride, deferred, ranks):
    """`level_ranks` is a function of the level's shape and solver alone:
    no batch size enters it. Forcing a route: any of 1, 2, 4, 8 where the
    level allows it; a proposal stride > 1 only on one block; a size the
    card does not have raises."""
    assert klm.level_ranks(k, jstride, stride, deferred) == ranks
    assert "b" not in klm.level_ranks.__code__.co_varnames[:klm.level_ranks.__code__.co_argcount]
    for c in klm.CLUSTERS:
        if stride > 1 and c > 1:
            with pytest.raises(ValueError, match="one block"):
                klm.level_ranks(k, jstride, stride, deferred, c)
        elif klm._rank_smem(k, jstride, not deferred and jstride == 1, c) <= klm.SMEM_BYTES:
            assert klm.level_ranks(k, jstride, stride, deferred, c) == c
    with pytest.raises(ValueError, match="cluster must be"):
        klm.level_ranks(k, jstride, stride, deferred, 3)


def _level_table_meta(n_levels=2, b=2, k=1024, h=60, w=80):
    a = _meta_args(b, k, h, w)
    return [klm.LmLevel(a["pts"], a["valid"], a["count"], a["img"], a["scale"], 65.0, 65.0,
                        39.5, 29.5, 4, 2, 1) for _ in range(n_levels)], a


@pytest.mark.parametrize("bad", ["empty", "levels", "level_dtype", "level_batch", "cluster",
                                 "n_iters", "device"])
def test_pyramid_wrapper_rejects_bad_arguments_before_building(bad, monkeypatch):
    """`level_lm_pyramid` on non-CPU tensors checks every level of the
    table (and the route it is forced to) before it builds or launches
    anything."""
    def no_build(*_a, **_k):
        raise AssertionError("level_lm_pyramid built a kernel before checking its arguments")

    monkeypatch.setattr(build, "load", no_build)
    table, a = _level_table_meta()
    cluster = None
    if bad == "empty":
        table = []
    elif bad == "levels":
        table = table * 5
    elif bad == "level_dtype":
        table[1] = table[1]._replace(img=torch.empty((2, 60, 80), device="meta"))
    elif bad == "level_batch":
        table[1] = table[1]._replace(count=torch.empty((3,), dtype=torch.int32, device="meta"))
    elif bad == "cluster":
        cluster = 16
    elif bad == "n_iters":
        table[0] = table[0]._replace(n_iters=0)
    match = {"empty": "no level", "levels": "levels a launch", "cluster": "cluster must be",
             "n_iters": "n_iters", "device": "unsupported device"}.get(bad, "must be")
    with pytest.raises(ValueError, match=match):
        klm.level_lm_pyramid(a["R0"], a["t0"], table, STANDARD, cluster)


# -- numpy models of csrc/warp.cuh: a warp is a (32, N) float32 array, lane
# by row, N independent warps by column; every operation is one numpy
# float32 operation (rounded once), as the kernel's round-to-nearest
# intrinsics are

F32 = np.float32
LANE = np.arange(32)


def _shfl(v, src):
    """__shfl_sync: lane i reads lane src[i] (mod 32) of v."""
    return v[np.broadcast_to(np.asarray(src) % 32, (32,))]


def _lane_mat3(a, b, tn=False):
    e = np.minimum(LANE, 8)
    i, j = e // 3, e % 3
    s = [_shfl(a, 3 * k + i if tn else 3 * i + k) * _shfl(b, 3 * k + j) for k in range(3)]
    return (s[0] + s[1]) + s[2]


def _lane_compose(p, x):
    e = np.minimum(LANE, 11)
    rot = e < 9
    i, j = np.where(rot, e // 3, e - 9), np.where(rot, e % 3, 0)
    s = [_shfl(p, 3 * i + k) * _shfl(x, np.where(rot, 3 * k + j, 9 + k)) for k in range(3)]
    d = (s[0] + s[1]) + s[2]
    return np.where(rot[:, None], d, p + d)


def _lane_eye(d):
    return np.where(np.isin(LANE, (0, 4, 8))[:, None], F32(d), F32(0))


def _lane_rotationize(x):
    for _ in range(3):
        m = _lane_mat3(x, x, tn=True)
        y = _lane_eye(1.5) - F32(0.5) * m
        x = np.where((LANE < 9)[:, None], _lane_mat3(x, y), x)
    return x


def _rounded(fn, x):
    return fn(x.astype(np.float64)).astype(F32)


def _lane_se3_exp(psi):
    """psi (6, N) -> the pose layout (32, N)."""
    w0, w1, w2 = psi[3], psi[4], psi[5]
    theta2 = (w0 * w0 + w1 * w1) + w2 * w2
    theta = np.sqrt(theta2 + F32(1e-16))
    small = theta2 < F32(1e-8)
    sn, cs = _rounded(np.sin, theta), _rounded(np.cos, theta)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(small, F32(1) - theta2 / F32(6), sn / theta)
        b = np.where(small, F32(0.5) - theta2 / F32(24), (F32(1) - cs) / theta2)
        c = np.where(small, F32(1.0 / 6.0) - theta2 / F32(120), (theta - sn) / (theta2 * theta))
    e = np.minimum(LANE, 8)
    zero = np.zeros_like(w0)
    hat = np.stack([zero, -w2, w1, w2, zero, -w0, -w1, w0, zero])
    W = hat[e]
    WW = _lane_mat3(W, W)
    eye = np.where(np.isin(e, (0, 4, 8))[:, None], F32(1), F32(0))
    R = (eye + a * W) + b * WW
    V = (eye + b * W) + c * WW
    ti = np.where(LANE < 9, 0, np.minimum(LANE - 9, 2))
    t = (_shfl(V, 3 * ti) * psi[0] + _shfl(V, 3 * ti + 1) * psi[1]) + _shfl(V, 3 * ti + 2) * psi[2]
    return np.where((LANE < 9)[:, None], R, t)


def _warp_lm_psi(H, g, lam, radius):
    """H (N, 6, 6) symmetric, g (N, 6), lam (N,) -> psi (6, N): warp.cuh's
    warp_lm_psi, se3.cuh's one-thread chol_solve6 and trust region, which
    every lane of the warp runs alike."""
    A = [[H[:, r, c] for c in range(6)] for r in range(6)]
    for i in range(6):
        A[i][i] = A[i][i] + lam * np.maximum(A[i][i], F32(1e-8))
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = []
        for r in range(j, 6):
            acc = np.zeros_like(lam)
            for c in range(j):
                acc = acc + L[r][c] * L[j][c]
            s.append(A[r][j] - acc)
        d = np.sqrt(np.maximum(s[0], F32(1e-20)))
        L[j][j] = d
        inv = F32(1) / d
        for r in range(j + 1, 6):
            L[r][j] = s[r - j] * inv
    y, x = [None] * 6, [None] * 6
    for i in range(6):
        acc = np.zeros_like(lam)
        for c in range(i):
            acc = acc + L[i][c] * y[c]
        y[i] = (g[:, i] - acc) / L[i][i]
    for i in range(5, -1, -1):
        acc = np.zeros_like(lam)
        for c in range(i + 1, 6):
            acc = acc + L[c][i] * x[c]
        x[i] = (y[i] - acc) / L[i][i]
    psi = [-v for v in x]
    nrm = np.sqrt(sum((p * p for p in psi[1:]), psi[0] * psi[0]))
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(nrm > F32(radius), F32(radius) / np.maximum(nrm, F32(1e-30)), F32(1))
    return np.stack([p * scale for p in psi])


def _layout(R, t):
    """(N,3,3), (N,3) -> the pose layout (32, N)."""
    v = np.concatenate([R.reshape(-1, 9), t], 1).T.astype(F32)
    return np.concatenate([v, np.zeros((20, v.shape[1]), F32)])


def _rand_poses(rng, n, scale=0.3):
    R, t = tgeo.se3_exp(torch.from_numpy((rng.standard_normal((n, 6)) * scale).astype(F32)))
    return R.numpy(), t.numpy()


def test_warp_model_compose_and_newton_schulz_are_the_twins_bitwise():
    """compose and Newton-Schulz one 3x3 entry a lane (lane_compose,
    lane_rotationize) give se3_plain's compose and rotationize_newton bit
    for bit, on random poses and on poses 1e-3 off orthogonal."""
    rng = np.random.default_rng(11)
    R1, t1 = _rand_poses(rng, 64)
    R2, t2 = _rand_poses(rng, 64, 0.05)
    got = _lane_compose(_layout(R1, t1), _layout(R2, t2))[:12].T
    Rc, tc = se3_plain.compose(*(se3_plain.to_rows(torch.from_numpy(x)) for x in (R1, t1, R2, t2)))
    want = np.concatenate([se3_plain.from_rows(Rc).reshape(-1, 9).numpy(),
                           se3_plain.from_rows(tc).numpy()], 1)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    noisy = (R1 + 1e-3 * rng.standard_normal(R1.shape)).astype(F32)
    got = _lane_rotationize(_layout(noisy, t1))
    want = se3_plain.from_rows(se3_plain.rotationize_newton(
        se3_plain.to_rows(torch.from_numpy(noisy)))).reshape(-1, 9).numpy()
    assert np.array_equal(got[:9].T.view(np.int32), want.view(np.int32))
    assert np.array_equal(got[9:12].T, t1)  # t stays


@pytest.mark.parametrize("scale", [0.5, 1e-2, 1e-5, 0.0])
def test_warp_model_se3_exp_is_the_twin_bitwise(scale):
    """The exponential in the pose layout (one sincos, W^2 one entry a
    lane, t on lanes 9-11) gives se3_plain.se3_exp bit for bit, in the
    generic and the Taylor branch (|w|^2 below 1e-8) and at 0."""
    rng = np.random.default_rng(12)
    psi = (rng.standard_normal((128, 6)) * scale).astype(F32)
    got = _lane_se3_exp(psi.T)[:12].T
    Rw, tw = se3_plain.se3_exp(se3_plain.to_rows(torch.from_numpy(psi)))
    want = np.concatenate([se3_plain.from_rows(Rw).reshape(-1, 9).numpy(),
                           se3_plain.from_rows(tw).numpy()], 1)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("regime", ["random", "rank_deficient", "tiny", "huge_lambda"])
def test_warp_model_cholesky_step_is_the_twin_bitwise(regime):
    """The damped Cholesky, the substitutions and the trust region of the
    warp's step (warp_lm_psi: se3.cuh's one-thread factorization on every
    lane) give se3_plain's lm_psi bit for bit: random SPD systems, no
    visible point (H = 0, the 1e-8 and 1e-20 floors), tiny normal equations
    and lambda at its 1e6 cap; steps inside and outside the trust region."""
    rng = np.random.default_rng({"random": 1, "rank_deficient": 2, "tiny": 3,
                                 "huge_lambda": 4}[regime])
    A = rng.standard_normal((64, 6, 6)).astype(F32)
    H = (A @ A.transpose(0, 2, 1) + F32(0.1) * np.eye(6, dtype=F32)).astype(F32)
    g = rng.standard_normal((64, 6)).astype(F32)
    lam = rng.uniform(1e-8, 1.0, 64).astype(F32)
    if regime == "rank_deficient":
        H[:32] = 0.0
        H[32:, 5, :] = H[32:, :, 5] = 0.0
    elif regime == "tiny":
        H *= F32(1e-12)
        g *= F32(1e-9)
    elif regime == "huge_lambda":
        lam[:] = 1e6
    H = np.triu(H) + np.triu(H, 1).transpose(0, 2, 1)  # symmetric bit for bit, as the kernel's
    g[:16] *= F32(1e-4)  # small steps stay inside the region
    for radius in (0.01, 10.0):
        got = _warp_lm_psi(H, g, lam, radius)
        want = se3_plain.from_rows(se3_plain.lm_psi(
            se3_plain.to_rows(torch.from_numpy(H)), se3_plain.to_rows(torch.from_numpy(g)),
            torch.from_numpy(lam), radius)).numpy().T
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), radius


def _pair_sums(vals, ranks):
    """The kernel's fixed-order sum of one pair's per-point values over
    `ranks` blocks of 256 threads (pair_sum of warp.cuh): point i to rank
    (i / 256) % ranks and thread i % 256, each thread's points in order,
    a shuffle-down tree in each warp, the 8 warp partials in order, then
    the ranks' sums in rank order."""
    total = F32(0)
    for q in range(ranks):
        part = []
        for warp in range(8):
            lanes = np.zeros(32, F32)
            for lane in range(32):
                tid = warp * 32 + lane
                for i in range(q * 256 + tid, len(vals), 256 * ranks):
                    lanes[lane] = lanes[lane] + vals[i]
            for off in (16, 8, 4, 2, 1):
                lanes = lanes + np.concatenate([lanes[off:], np.zeros(off, F32)])
            part.append(lanes[0])
        s = part[0]
        for v in part[1:]:
            s = s + v
        total = s if q == 0 else total + s
    return total


def test_reduction_model_depends_on_the_pair_and_its_route_only():
    """The sums of one pair: the same whatever other pairs share the
    launch (each pair reduces its own points only), bitwise the one-block
    order of the kernel before the cluster split at one rank, and on 2, 4,
    8 ranks a different order of the same sum (which is why the route rule
    reads the level's shape only, never the batch)."""
    rng = np.random.default_rng(13)
    batch = (rng.standard_normal((4, 2048)) * 100).astype(F32)
    alone = [_pair_sums(batch[p], 1) for p in range(4)]
    again = [_pair_sums(np.concatenate([batch[p]]), 1) for p in range(4)]
    assert alone == again
    # one rank: thread tid sums points tid, tid + 256, ... (the parent's map)
    lanes = np.zeros(256, F32)
    for i, v in enumerate(batch[0]):
        lanes[i % 256] = lanes[i % 256] + v
    warps = []
    for w in range(8):
        x = lanes[w * 32:(w + 1) * 32].copy()
        for off in (16, 8, 4, 2, 1):
            x = x + np.concatenate([x[off:], np.zeros(off, F32)])
        warps.append(x[0])
    s = warps[0]
    for v in warps[1:]:
        s = s + v
    assert s.view(np.int32) == alone[0].view(np.int32)
    scale = float(np.abs(batch[0]).sum())
    for r in (2, 4, 8):
        assert abs(float(_pair_sums(batch[0], r)) - float(s)) <= 1e-6 * scale, r


def test_split_tail_model_is_residual_pass_bitwise():
    """The all-point tail on r ranks: each rank writes its share of the
    residuals, then the first rank sums e2 and the count from them in
    residual.cu's map (thread i % 256, points in order) and tree, which is
    the one-block tail's own order: bitwise at every r."""
    rng = np.random.default_rng(14)
    eps = (rng.standard_normal(8192) * 3).astype(F32)
    vis = rng.uniform(size=8192) < 0.7
    eps[~vis] = 0.0

    def tail(order):
        acc = np.zeros((2, 256), F32)
        for i in order:
            if vis[i]:
                # the multiply-add rounded once (eps^2 is exact in float64)
                acc[0, i % 256] = F32(np.float64(eps[i]) * np.float64(eps[i])
                                      + np.float64(acc[0, i % 256]))
                acc[1, i % 256] = acc[1, i % 256] + F32(1)
        for s in (128, 64, 32, 16, 8, 4, 2, 1):
            acc[:, :s] = acc[:, :s] + acc[:, s:2 * s]
        return acc[:, 0]

    one_block = tail(range(8192))
    for r in (2, 4, 8):
        # each rank writes its points; the sum then reads them back in the one-block order
        written = np.zeros(8192, F32)
        for q in range(r):
            for i in range(8192):
                if (i // 256) % r == q:
                    written[i] = eps[i]
        assert np.array_equal(written, eps)
        assert np.array_equal(tail(range(8192)).view(np.int32), one_block.view(np.int32))


def _shfl_down_tree(vals):
    """vals (32,) float32: the __shfl_down_sync tree at offsets 16..1, lane 0's sum."""
    x = vals.copy()
    for off in (16, 8, 4, 2, 1):
        x = x + np.concatenate([x[off:], x[32 - off:]])  # lanes past 31 read their own value
    return x[0]


def _warp_tree(acc):
    """acc (32 lanes, N values) float32 -> (32,): warp_tree of warp.cuh, lane m
    holding sum m for m < N."""
    n = acc.shape[1]
    p = 1 << (n - 1).bit_length()
    x = np.zeros((32, p), F32)
    x[:, :n] = acc
    o = 16
    while o >= p:  # the offsets from N up: every value, both lanes alike
        x = x + x[LANE ^ o]
        o >>= 1
    o = p // 2
    while o >= 1:  # below N: keep the half the lane bit names, trade the other
        hi = (LANE & o) != 0
        keep = np.where(hi[:, None], x[:, o:2 * o], x[:, :o])
        send = np.where(hi[:, None], x[:, :o], x[:, o:2 * o])
        x = keep + send[LANE ^ o]
        o >>= 1
    return x[:, 0]


@pytest.mark.parametrize("n", [29, 8, 2, 1])
def test_warp_tree_model_is_the_shuffle_down_tree_bitwise(n):
    """warp_tree (a lane keeps half of its values at each offset below N and
    trades the other half: 31 shuffles for 32 sums instead of 160) leaves in
    lane m bitwise the sum a shuffle-down tree of value m leaves in lane 0,
    for the Gauss-Newton pass's 29 sums, the sub-gradient's 8 and the
    residual pass's 2; values of mixed magnitude and sign, so that the
    association order shows."""
    rng = np.random.default_rng(15 + n)
    for _ in range(20):
        acc = (rng.standard_normal((32, n)) * 10.0 ** rng.integers(-6, 6, (32, n))).astype(F32)
        got = _warp_tree(acc)
        want = np.array([_shfl_down_tree(acc[:, m]) for m in range(n)], F32)
        assert np.array_equal(got[:n].view(np.int32), want.view(np.int32))
