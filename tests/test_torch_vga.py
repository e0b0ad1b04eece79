"""`profiles.production_vga` on the CPU, the port against the JAX package at
the sensor's full 640x480, B = 1: 5 levels, capacities 4096/2048/1024/512/512,
LM 4/18/6/4/3, a Jacobian stride of 8 at level 0. `align_pair` under
tests/test_torch_solve.py's bars (|t - t_gt| < 0.02, |R - R_gt| < 0.02; 1 mm
and 1e-3 from JAX's pose; the finest level's energy curve within 2e-3
relative, its best energy within 1e-3, its visible ratio within 5e-3, the
same point count); the plain `canny_pyramid` over 5 levels bitwise JAX's
`canny_multi` and per-level `canny`; `prepare_now_level` at 480 rows bitwise
(edges, dt, bf16 channels); a 6-frame stream with a rollback keyframe at
frame 5, the same keyframes and rollbacks as JAX and positions within
tests/test_torch_pipeline.py's 2e-3 m (and 8 mm of ground truth). Frames are
rendered one sample a pixel, as bench.py renders VGA."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import KeyframeConfig, PipelineConfig, PyramidConfig  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jbuild  # noqa: E402
from rgbd_odometry_tpu.ops import canny as jcanny  # noqa: E402
from rgbd_odometry_tpu.pipeline.odometry import EdgeDvoOdometry as JaxOdometry  # noqa: E402
from rgbd_odometry_tpu.profiles import production_vga  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair, render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import canny as kcanny  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(2)
PROF = production_vga()
CAM, CFG, LEVELS = PROF.camera, PROF.solver, PROF.num_levels


@pytest.fixture(scope="module")
def pair():
    psi = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
    return render_pair(CAM, psi, seed=3, supersample=1)


def test_vga_profile_shapes():
    assert (CAM.height, CAM.width) == (480, 640) and LEVELS == 5
    assert PROF.max_points == (4096, 2048, 1024, 512, 512)
    assert CFG.iterations == (4, 18, 6, 4, 3)
    # level 0 stages 512 Jacobian points (every 8th); the tail runs all 4096
    assert ted.level_strides(CFG, 4096)[0] == 8


def test_vga_align_pair_matches_jax(pair):
    (rg, rd), (ng, nd), (R_gt, t_gt) = pair
    ref = build_pyramid(torch.from_numpy(rg)[None], torch.from_numpy(rd)[None], LEVELS)
    now = build_pyramid(torch.from_numpy(ng)[None], torch.from_numpy(nd)[None], LEVELS)
    assert now.gray[-1].shape == (1, 30, 40)
    R, t, diags = ted.align_pair(ref.gray, ref.depth, now.gray, Intrinsics.from_config(CAM), CFG,
                                 PROF.max_points)
    assert len(diags) == LEVELS and diags[0].final_epsilons.shape == (1, 4096)
    jintr = JIntrinsics.from_config(CAM)
    r, n = jbuild(jnp.asarray(rg), jnp.asarray(rd), LEVELS), jbuild(jnp.asarray(ng), jnp.asarray(nd),
                                                                     LEVELS)
    R_j, t_j, d_j = jax.jit(lambda a, b, c: jed.align_pair(a, b, c, jintr, CFG, PROF.max_points))(
        r.gray, r.depth, n.gray)
    R_p, t_p = R[0].numpy(), t[0].numpy()
    assert np.linalg.norm(t_p - t_gt) < 0.02 and np.linalg.norm(R_p - R_gt) < 0.02
    assert np.linalg.norm(t_p - np.asarray(t_j)) < 1e-3
    assert np.abs(R_p - np.asarray(R_j)).max() < 1e-3
    d_p, d_j = diags[0], d_j[0]
    np.testing.assert_allclose(d_p.energy[0].numpy(), np.asarray(d_j.energy), rtol=2e-3)
    np.testing.assert_allclose(float(d_p.best_energy[0]), float(d_j.best_energy), rtol=1e-3)
    np.testing.assert_allclose(float(d_p.visible_ratio[0]), float(d_j.visible_ratio), atol=5e-3)
    assert int(d_p.num_points[0]) == int(d_j.num_points)


def test_vga_canny_pyramid_bitwise_equals_jax(pair):
    _, (ng, nd), _ = pair
    pyr = build_pyramid(torch.from_numpy(ng)[None], torch.from_numpy(nd)[None], LEVELS).gray
    got = kcanny.canny_pyramid(pyr, CFG.canny_low, CFG.canny_high)
    assert len(got) == LEVELS and kcanny.canny_pyramid.launches == 0
    fused = jax.jit(functools.partial(jcanny.canny_multi, low=CFG.canny_low, high=CFG.canny_high))(
        tuple(jnp.asarray(g.numpy()) for g in pyr))
    single = jax.jit(functools.partial(jcanny.canny, low=CFG.canny_low, high=CFG.canny_high))
    for lvl, (g, e, f) in enumerate(zip(pyr, got, fused)):
        assert e.dtype == torch.bool and e.shape == g.shape
        np.testing.assert_array_equal(e.numpy(), np.asarray(f), err_msg=f"level {lvl}")
        np.testing.assert_array_equal(e.numpy(), np.asarray(single(jnp.asarray(g.numpy()))),
                                      err_msg=f"level {lvl}")
    assert got[0].any()


@pytest.mark.parametrize("window", [16, 0])
def test_vga_prepare_now_level_exact(pair, window):
    import dataclasses

    cfg = dataclasses.replace(CFG, edt_window=window)
    _, (ng, _), _ = pair
    assert ng.shape == (480, 640)
    want = jax.jit(lambda g: jed.prepare_now_level(g, cfg))(jnp.asarray(ng))
    got = ted.prepare_now_level(torch.from_numpy(ng)[None], cfg)
    np.testing.assert_array_equal(got.edges[0].numpy(), np.asarray(want.edges))
    np.testing.assert_array_equal(got.dt[0].numpy(), np.asarray(want.dt))
    assert got.chans.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.chans[0].view(torch.int16).numpy(),
                                  np.asarray(want.chans).view(np.int16))


def test_vga_stream_matches_jax():
    step = 0.002
    ts = np.arange(6)
    psis = np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
                     0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts], -1).astype(np.float32)
    frames, poses = render_sequence(CAM, psis, seed=0, supersample=1)
    cfg = PipelineConfig(camera=CAM, solver=CFG,
                         pyramid=PyramidConfig(num_levels=LEVELS, max_points=PROF.max_points),
                         keyframe=KeyframeConfig(force_every=5, rollback_resolve=True))
    port, jax_ = EdgeDvoOdometry(cfg, device="cpu"), JaxOdometry(cfg)
    for i, (g, d) in enumerate(frames):
        port.process_frame(g, d, float(i))
        jax_.process_frame(g, d, float(i))
    kf = port.gop.keyframe_indices()
    assert kf == jax_.gop.keyframe_indices() and kf == [0, 4]
    assert [m.rolled_back for m in port.metrics] == [m.rolled_back for m in jax_.metrics]
    assert port.metrics[5].rolled_back
    _, t_p, _ = port.trajectory()
    _, t_j, _ = jax_.trajectory()
    assert np.abs(t_p - t_j).max() < 2e-3
    gt_t = np.stack([p[1] for p in poses])
    assert np.sqrt(((t_p - gt_t) ** 2).sum(-1).mean()) < 0.008
