"""The pieces of the `dvo` command's defaults and of the reference's
sub-gradient solver, port against the JAX package on the CPU, on keyframe
features and DT targets carried across with `convert.py`:

* the floor value + central-difference gradients, bitwise against JAX's
  `gather_floor_value_cgrads_mm` and `gather_floor`;
* the 0-255 normalized `prepare_now_level`, bitwise, including an edge-free
  and an all-edge map;
* the plain versions of kernels 2-4 against `_jacobian_residual` and
  `_project_and_sample` (bars of tests/test_fused_iter.py where JAX rounds
  its gathers to bf16; exact where both are float32 floor lookups), and
  kernel 2's per-point outputs against kernel 3's;
* `lm_psi` (`kernels/level_lm`) and `_subgradient_step` against JAX on the
  same sums.
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
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jbuild  # noqa: E402
from rgbd_odometry_tpu.ops.interp import gather_floor as jgather_floor  # noqa: E402
from rgbd_odometry_tpu.ops.matmul_gather import gather_floor_value_cgrads_mm  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import fused_iter, level_lm, residual, sg_terms  # noqa: E402
from rgbd_odometry_tpu_torch.ops.interp import gather_floor, gather_floor_value_cgrads  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(1)
HI = jax.lax.Precision.HIGHEST

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
GN = SolverConfig(method="gauss_newton")  # the dvo command's solver: normalized DT
SG = SolverConfig(method="subgradient")  # the reference's
POSES = (
    np.array([0.003, -0.002, 0.001, 0.002, 0.001, -0.002], np.float32),
    np.array([-0.006, 0.004, 0.002, -0.001, 0.003, 0.001], np.float32),
)


@pytest.fixture(scope="module")
def scene():
    psi = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
    (rg, rd), (ng, nd), _ = render_pair(CAM, psi, seed=0)
    ref = jbuild(jnp.asarray(rg), jnp.asarray(rd), 1)
    now = jbuild(jnp.asarray(ng), jnp.asarray(nd), 1)
    intr = JIntrinsics.from_config(CAM)
    out = {"intr": intr, "ng": ng}
    for name, cfg in (("gn", GN), ("sg", SG)):
        out[name] = (
            jax.jit(lambda g, d, c=cfg: jed.extract_ref_level(g, d, intr, 1024, c))(
                ref.gray[0], ref.depth[0]),
            jax.jit(lambda g, c=cfg: jed.prepare_now_level(g, c))(now.gray[0]),
        )
    return out


def _poses():
    Rs, ts = zip(*(jgeo.se3_exp(jnp.asarray(p)) for p in POSES))
    R_t = torch.from_numpy(np.stack([np.asarray(r) for r in Rs]))
    t_t = torch.from_numpy(np.stack([np.asarray(t) for t in ts]))
    return Rs, ts, R_t, t_t


def _f(intr):
    return tuple(float(x) for x in (intr.fx, intr.fy, intr.cx, intr.cy))


def _two(x):
    return x.expand(2, *x.shape[1:]).contiguous()


def test_floor_gathers_bitwise_match_jax():
    rng = np.random.default_rng(0)
    h, w = 30, 40
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    # generic points, the borders (REFLECT_101 gradients), exact integers
    # and coordinates outside the image (clamped)
    u = np.concatenate([rng.uniform(-2, w + 2, 300), [0, 0.5, w - 1, w - 0.5, w, -0.7, 7.0]])
    v = np.concatenate([rng.uniform(-2, h + 2, 300), [0, h - 1, 0.2, h - 0.5, h, 3.0, -0.1]])
    u, v = u.astype(np.float32), v.astype(np.float32)
    want = [np.asarray(x) for x in gather_floor_value_cgrads_mm(jnp.asarray(img), u, v)]
    got = gather_floor_value_cgrads(torch.from_numpy(img)[None], torch.from_numpy(u)[None],
                                    torch.from_numpy(v)[None])
    for a, b in zip(got, want):
        assert np.array_equal(a[0].numpy(), b)
    assert np.array_equal(
        gather_floor(torch.from_numpy(img)[None], torch.from_numpy(u)[None],
                     torch.from_numpy(v)[None])[0].numpy(),
        np.asarray(jgather_floor(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))),
    )


@pytest.mark.parametrize("edges", ["canny", "none", "all"])
@pytest.mark.parametrize("method", ["gauss_newton", "subgradient"])
def test_normalized_targets_bitwise_match_jax(scene, edges, method):
    cfg = GN if method == "gauss_newton" else SG
    gray = scene["ng"]
    e = None if edges == "canny" else np.full(gray.shape, edges == "all")
    jt = jed.prepare_now_level(jnp.asarray(gray), cfg, None if e is None else jnp.asarray(e))
    pt = ted.prepare_now_level(
        torch.from_numpy(gray)[None], cfg, None if e is None else torch.from_numpy(e)[None])
    want = convert.now_level(jt)
    for name in ("dt", "dgx", "dgy", "edges", "scale", "chans"):
        a, b = getattr(pt, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert pt.chans.dtype == (torch.bfloat16 if method == "gauss_newton" else torch.float32)
    if edges != "canny":  # dmax == dmin: all-zero DT at scale 255 / 1e-12
        assert not pt.dt.any() and float(pt.scale[0]) == pytest.approx(2.55e14, rel=1e-6)
    else:
        assert float(pt.dt.max()) == 255.0 and float(pt.scale[0]) > 1.0


def test_gn_terms_with_a_per_pair_scale_match_jax(scene):
    """Kernel 2 with a normalized DT: the weight takes eps / scale."""
    intr = scene["intr"]
    ref, now = scene["gn"]
    ref_t, now_t = convert.ref_level(ref), convert.now_level(now)
    Rs, ts, R_t, t_t = _poses()
    scale = _two(now_t.scale)
    H, g, e, n = fused_iter.fused_gn_terms(
        R_t, t_t, _two(ref_t.pts3d), _two(ref_t.valid), _two(now_t.chans[:, 0]), *_f(intr),
        GN.gn_weight_sigma2_px, scale,
    )
    assert float(scale[0]) > 1.0
    for b in range(2):
        J, eps, wgt, visible, energy, _ = jed._jacobian_residual(Rs[b], ts[b], ref, now, intr, GN)
        Jw = J * wgt[..., None]
        H_x = np.asarray(jnp.einsum("ni,nj->ij", Jw, J, precision=HI))
        g_x = np.asarray(jnp.einsum("nj,n->j", Jw, eps, precision=HI))
        np.testing.assert_allclose(H[b].numpy(), H_x, rtol=1e-2, atol=1e-3 * np.abs(H_x).max())
        np.testing.assert_allclose(g[b].numpy(), g_x, rtol=1e-2, atol=1e-3 * np.abs(g_x).max())
        np.testing.assert_allclose(float(e[b]), float(energy), rtol=1e-3)
        assert int(n[b]) == int(np.asarray(visible).sum())
    # scale 1 is the pixel-unit path: bitwise the call without a scale
    ones = torch.ones(2)
    args = (R_t, t_t, _two(ref_t.pts3d), _two(ref_t.valid), _two(now_t.chans[:, 0]), *_f(intr), 1.0)
    for a, b in zip(fused_iter.fused_gn_terms(*args, ones), fused_iter.fused_gn_terms(*args)):
        assert torch.equal(a, b)


def test_gn_terms_write_points_match_residual_pass(scene):
    """Kernel 2's per-point outputs (a stride-1 scan's diagnostics) are the
    bilinear residual pass's at the same pose, its energy is bitwise the
    residual pass's (an LM tie stays a tie), and writing them leaves the
    sums as they are."""
    intr = scene["intr"]
    ref, now = scene["gn"]
    ref_t, now_t = convert.ref_level(ref), convert.now_level(now)
    _, _, R_t, t_t = _poses()
    args = (R_t, t_t, _two(ref_t.pts3d), _two(ref_t.valid), _two(now_t.chans[:, 0]), *_f(intr))
    gn = (GN.gn_weight_sigma2_px, _two(now_t.scale))
    sums = fused_iter.fused_gn_terms(*args, *gn)
    out = fused_iter.fused_gn_terms(*args, *gn, write_points=True)
    energy, n, eps, vis = residual.residual_pass(*args, True, write_points=True)
    assert len(sums) == 4 and len(out) == 6
    for a, b in zip(out[:4], sums):
        assert torch.equal(a, b)
    assert torch.equal(out[4], eps) and torch.equal(out[5], vis)
    assert torch.equal(out[2], energy) and torch.equal(out[3], n)


@pytest.mark.parametrize("method", ["gauss_newton", "subgradient"])
def test_residual_pass_matches_project_and_sample(scene, method):
    """Kernel 3: bilinear on the bf16 channel or floor on the float32 DT
    (exact). JAX's bilinear `gather_channels_mm` rounds both weights to
    bf16 and its row mix and result to bf16 (up to ~4 x 2^-9 relative); the
    port blends the bf16 corners in float32: eps within 2^-6 relative."""
    intr = scene["intr"]
    cfg = GN if method == "gauss_newton" else SG
    ref, now = scene["gn" if method == "gauss_newton" else "sg"]
    ref_t, now_t = convert.ref_level(ref), convert.now_level(now)
    Rs, ts, R_t, t_t = _poses()
    bilinear = method == "gauss_newton"
    img = _two(now_t.chans[:, 0] if bilinear else now_t.dt)
    energy, n, eps, vis = residual.residual_pass(
        R_t, t_t, _two(ref_t.pts3d), _two(ref_t.valid), img, *_f(intr), bilinear,
        write_points=True,
    )
    assert residual.residual_pass(R_t, t_t, _two(ref_t.pts3d), _two(ref_t.valid), img, *_f(intr),
                                  bilinear)[2:] == (None, None)
    for b in range(2):
        eps_j, _, vis_j, e_j, *_ = jed._project_and_sample(Rs[b], ts[b], ref, now, intr, cfg)
        eps_j = np.asarray(eps_j)
        assert np.array_equal(vis[b].numpy(), np.asarray(vis_j))
        assert int(n[b]) == int(np.asarray(vis_j).sum())
        if bilinear:
            np.testing.assert_allclose(eps[b].numpy(), eps_j, rtol=2**-6, atol=0.05)
            np.testing.assert_allclose(float(energy[b]), float(e_j), rtol=1e-3)
        else:
            assert np.array_equal(eps[b].numpy(), eps_j)
            np.testing.assert_allclose(float(energy[b]), float(e_j), rtol=1e-6)


def test_subgradient_terms_match_jacobian_residual(scene):
    """Kernel 4: per-point residuals and visibility exact, J^T W eps and
    the energy to float32 summation order."""
    intr = scene["intr"]
    ref, now = scene["sg"]
    ref_t, now_t = convert.ref_level(ref), convert.now_level(now)
    Rs, ts, R_t, t_t = _poses()
    g, e, n, eps, vis = sg_terms.subgradient_terms(
        R_t, t_t, _two(ref_t.pts3d), _two(ref_t.valid), _two(now_t.dt), *_f(intr),
        SG.weight_sigma2,
    )
    for b in range(2):
        J, eps_j, wgt, vis_j, e_j, _ = jed._jacobian_residual(Rs[b], ts[b], ref, now, intr, SG)
        g_j = np.asarray(jnp.einsum("nj,n->j", J, wgt * eps_j, precision=HI))
        assert np.array_equal(eps[b].numpy(), np.asarray(eps_j))
        assert np.array_equal(vis[b].numpy(), np.asarray(vis_j))
        assert int(n[b]) == int(np.asarray(vis_j).sum())
        np.testing.assert_allclose(g[b].numpy(), g_j, rtol=1e-4, atol=1e-5 * np.abs(g_j).max())
        np.testing.assert_allclose(float(e[b]), float(e_j), rtol=1e-6)
        J_p, _, wgt_p, _ = sg_terms.reference_jacobian_terms(
            R_t[b:b + 1], t_t[b:b + 1], ref_t.pts3d, ref_t.valid, now_t.dt, *_f(intr),
            SG.weight_sigma2)
        np.testing.assert_allclose(J_p[0].numpy(), np.asarray(J), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(J)).max())
        np.testing.assert_allclose(wgt_p[0].numpy(), np.asarray(wgt), rtol=1e-6)


def test_lm_and_subgradient_steps_match_jax(scene):
    intr = scene["intr"]
    ref, now = scene["sg"]
    Rs, ts, R_t, t_t = _poses()
    J, eps, wgt, *_ = jed._jacobian_residual(Rs[0], ts[0], ref, now, intr, SG)
    Jw = J * wgt[..., None]
    H = jnp.einsum("ni,nj->ij", Jw, J, precision=HI)
    gl = jnp.einsum("nj,n->j", Jw, eps, precision=HI)
    descent = jnp.asarray(np.random.default_rng(2).standard_normal(6).astype(np.float32)) * 100
    for lam, tr in ((1e-4, 0.01), (10.0, 0.01), (1e-4, 1e6)):  # clipped, damped, free
        cfg = dataclasses.replace(GN, lm_trust_region=tr)
        state = jed._LevelState(R=Rs[0], t=ts[0], descent=descent, lm_lambda=jnp.float32(lam),
                                done=False, best_energy=0.0, best_R=0.0, best_t=0.0,
                                best_iter=0, best_vis=0.0, best_eps=0.0, best_visible=0.0)
        psi_j, _ = jed._lm_psi(state, J, eps, wgt, cfg)
        psi_t = level_lm.lm_psi(torch.from_numpy(np.asarray(H))[None],
                                torch.from_numpy(np.asarray(gl))[None], torch.tensor([lam]), tr)
        np.testing.assert_allclose(psi_t[0].numpy(), np.asarray(psi_j), rtol=1e-4,
                                   atol=1e-6 * np.abs(np.asarray(psi_j)).max())
    precond = torch.tensor([1.0, 1.0, 1.0, 0.5, 0.5, 0.5])
    g = jnp.einsum("nj,n->j", J, wgt * eps, precision=HI)
    for itr in (0, 5, 6, 17):
        for R, t in ((Rs[0], ts[0]), (jnp.eye(3), jnp.zeros(3))):  # generic, identity (log 0)
            for l2, tr in ((True, 0.003), (False, 1e9)):
                cfg = dataclasses.replace(SG, enable_l2_regularization=l2, trust_region_radius=tr,
                                          l2_lambda=100.0)
                state = jed._LevelState(R=R, t=t, descent=descent, lm_lambda=0.0, done=False,
                                        best_energy=0.0, best_R=0.0, best_t=0.0, best_iter=0,
                                        best_vis=0.0, best_eps=0.0, best_visible=0.0)
                psi_j, d_j = jed._subgradient_step(
                    state, J, eps, wgt, jnp.int32(itr), cfg=cfg,
                    precond=jnp.asarray([1, 1, 1, 0.5, 0.5, 0.5], jnp.float32))
                psi_t, d_t = ted._subgradient_step(
                    torch.from_numpy(np.asarray(R))[None], torch.from_numpy(np.asarray(t))[None],
                    torch.from_numpy(np.asarray(g))[None],
                    torch.from_numpy(np.asarray(descent))[None], itr, cfg, precond)
                np.testing.assert_allclose(d_t[0].numpy(), np.asarray(d_j), rtol=1e-5)
                np.testing.assert_allclose(psi_t[0].numpy(), np.asarray(psi_j), rtol=1e-5,
                                           atol=1e-7 * np.abs(np.asarray(psi_j)).max())
