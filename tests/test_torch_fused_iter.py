"""Kernel 2's plain PyTorch version against the JAX package on the CPU: the
Pallas `fused_gn_terms` (interpret mode) and the XLA `_jacobian_residual`
einsums, on the same keyframe features and DT target carried across with
`convert.py`.

Bar (tests/test_fused_iter.py): 1% relative on J^T W J and J^T W eps with an
atol of 1e-3 x the largest entry, 1e-3 relative on the energy, an exact
visible count. The reasons: the TPU forms round the bilinear row weights
(Pallas) or the whole row mix (XLA) to bf16 where the port blends the bf16
corners in float32, and every form sums in its own order."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig, SolverConfig  # noqa: E402
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jbuild  # noqa: E402
from rgbd_odometry_tpu.pallas.fused_iter import fused_gn_terms as pallas_gn  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch import convert  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import edt, fused_iter  # noqa: E402

torch.set_num_threads(1)

CAM = CameraConfig(width=160, height=120, fx=176.0, fy=176.0, cx=79.5, cy=59.5)
CFG = SolverConfig(method="gauss_newton", normalize_dt=False, gn_gradient_mode="interpolant")
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
    tgt = jax.jit(lambda g: jed.prepare_now_level(g, CFG))(now.gray[0])
    feats = {
        k: jax.jit(lambda g, d, k=k: jed.extract_ref_level(g, d, intr, k, CFG))(ref.gray[0], ref.depth[0])
        for k in (1024, 1000)
    }
    return intr, feats, tgt


def _assert_close(H, g, e, n, H_w, g_w, e_w, n_w):
    H_w, g_w = np.asarray(H_w), np.asarray(g_w)
    np.testing.assert_allclose(H, H_w, rtol=1e-2, atol=1e-3 * np.abs(H_w).max())
    np.testing.assert_allclose(g, g_w, rtol=1e-2, atol=1e-3 * np.abs(g_w).max())
    np.testing.assert_allclose(float(e), float(e_w), rtol=1e-3)
    assert int(n) == int(n_w)


@pytest.mark.parametrize("k", [1024, 1000])
def test_plain_fused_gn_matches_pallas_and_xla(scene, k):
    intr, feats, tgt = scene
    ref = feats[k]
    ref_t = convert.ref_level(ref)
    now_t = convert.now_level(tgt)
    Rs, ts = zip(*(jgeo.se3_exp(jnp.asarray(p)) for p in POSES))
    R_t = torch.from_numpy(np.stack([np.asarray(r) for r in Rs]))
    t_t = torch.from_numpy(np.stack([np.asarray(t) for t in ts]))
    two = lambda x: x.expand(2, *x.shape[1:]).contiguous()  # noqa: E731
    f = (float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy))
    H, g, e, n = fused_iter.fused_gn_terms(
        R_t, t_t, two(ref_t.pts3d), two(ref_t.valid), two(now_t.chans[:, 0]), *f,
        CFG.gn_weight_sigma2_px,
    )
    assert H.shape == (2, 6, 6) and n.dtype == torch.int32
    for b in range(2):
        want_p = pallas_gn(Rs[b], ts[b], ref.pts3d, ref.valid, tgt.chans[0], *f,
                           sigma2_px=CFG.gn_weight_sigma2_px, k_block=512, interpret=True)
        _assert_close(H[b].numpy(), g[b].numpy(), e[b], n[b], *want_p)
        J, eps, wgt, visible, energy, _ = jed._jacobian_residual(Rs[b], ts[b], ref, tgt, intr, CFG)
        Jw = J * wgt[..., None]
        H_x = jnp.einsum("ni,nj->ij", Jw, J, precision=jax.lax.Precision.HIGHEST)
        g_x = jnp.einsum("nj,n->j", Jw, eps, precision=jax.lax.Precision.HIGHEST)
        _assert_close(H[b].numpy(), g[b].numpy(), e[b], n[b], H_x, g_x, energy,
                      np.asarray(visible).sum())


def test_wrapper_on_cpu_is_the_plain_version(scene):
    intr, feats, tgt = scene
    ref_t, now_t = convert.ref_level(feats[1000]), convert.now_level(tgt)
    R, t = convert.pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    f = (float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy))
    args = (R, t, ref_t.pts3d, ref_t.valid, now_t.chans[:, 0], *f, 1.0)
    for a, b in zip(fused_iter.fused_gn_terms(*args), fused_iter.fused_gn_terms_plain(*args)):
        assert torch.equal(a, b)


def test_wrappers_reject_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on a CUDA device raises
    instead of silently taking another path."""
    meta = torch.empty((1, 8, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        edt.edt_squared(meta, 16)
    pts = torch.empty((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_iter.fused_gn_terms(
            torch.empty((1, 3, 3), device="meta"), torch.empty((1, 3), device="meta"), pts,
            torch.empty((1, 4), dtype=torch.bool, device="meta"),
            torch.empty((1, 8, 8), dtype=torch.bfloat16, device="meta"), 1.0, 1.0, 0.0, 0.0,
        )
