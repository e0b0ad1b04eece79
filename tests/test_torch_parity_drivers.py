"""The port's reference-parity configurations through the entry points a
user calls, on the CPU against the JAX package: `align_pair` on two
rendered pairs, `pose_information` at JAX's solved pose and a 5-frame
`EdgeDvoOdometry` run, for one configuration of each family outside the
production semantics (`point_sem.PARITY_FAMILIES`: their level solves run
the level kernels, here their plain twins); and the lockstep
driver (`parallel/streams.py`) with one of them against its single
streams.

Bars: poses within 1e-4 (metres and rotation entries) where every gather is
float32 and within the edge drivers' 2e-3 where JAX rounds to bf16; the
information matrix, sigma^2 and n_eff within 1e-5 relative (1e-2 for bf16)
at the same pose; the same keyframes; the lockstep streams at
tests/test_torch_multistream.py's bars (5e-3, hold).

`align_pair` starts from a generic pose, as tests/test_subgradient_oracle.py
does: at the identity every point lands on a pixel boundary, where a floor
decision rides on the last ulp of u, and XLA rounds u inside the jitted
pipeline otherwise than in its `_project` alone. The families whose
residuals are floor lookups (the sub-gradient with the SVD or the textbook
Jacobian) part from JAX at one floor decision all the same, as the
production sub-gradient (`level_sg`'s route) does on the same inputs:
8.1e-4 m on pair 0 of `align_pair`, 2.1e-3 m over the odometry's
sequence, whose first solve starts at the identity; the sub-gradient's
step is then its trust region's 3e-3, and their bar is 5e-3 (measured
8.1e-4 and 1.8e-3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import (  # noqa: E402
    CameraConfig,
    KeyframeConfig,
    PipelineConfig,
    PyramidConfig,
    SolverConfig,
)
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.core.pyramid import build_pyramid as jbuild  # noqa: E402
from rgbd_odometry_tpu.pipeline.odometry import EdgeDvoOdometry as JaxOdometry  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair, render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import point_sem  # noqa: E402
from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(1)

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
CAPS = (1024, 512)
SG = SolverConfig(iterations=(12, 8))
GN = SolverConfig(method="gauss_newton", iterations=(10, 6))
# family -> (config, kind of residual: "float32" gathers, "bf16" gathers, "floor" lookups)
FAMILIES = point_sem.parity_families(SG, GN)
BARS = {"float32": (1e-4, 1e-5), "bf16": (2e-3, 1e-2), "floor": (5e-3, 1e-5)}  # pose, info
START = np.array([0.003, -0.002, 0.001, 0.002, 0.001, -0.002], np.float32)
TWISTS = [np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32) * s
          for s in (1.0, -0.7)]


@pytest.fixture(scope="module")
def pairs():
    return [render_pair(CAM, tw, seed=i) for i, tw in enumerate(TWISTS)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_align_pair_and_pose_information_match_jax(family, pairs):
    """Both pairs in one batch from a generic start; the finest level's
    information at JAX's pose."""
    cfg, kind = FAMILIES[family]
    assert ted.kernel_route(cfg) and point_sem.parity(cfg)
    pose_bar, info_bar = BARS[kind]
    st = lambda i, j: torch.from_numpy(np.stack([p[i][j] for p in pairs]))  # noqa: E731
    ref, now = build_pyramid(st(0, 0), st(0, 1), 2), build_pyramid(st(1, 0), st(1, 1), 2)
    intr = Intrinsics.from_config(CAM)
    starts = [jgeo.se3_exp(jnp.asarray(START * (1 + 0.3 * i))) for i in range(2)]
    R0 = torch.from_numpy(np.stack([np.asarray(s[0]) for s in starts]))
    t0 = torch.from_numpy(np.stack([np.asarray(s[1]) for s in starts]))
    R, t, diags = ted.align_pair(ref.gray, ref.depth, now.gray, intr, cfg, CAPS, R0, t0)
    assert len(diags) == 2 and diags[0].energy.shape == (2, cfg.iterations[0])
    jintr = JIntrinsics.from_config(CAM)
    align = jax.jit(lambda rg, rd, ng, R_, t_: jed.align_pair(rg, rd, ng, jintr, cfg, CAPS,
                                                              R_, t_))
    info_fn = jax.jit(lambda rg, rd, ng, R_, t_: jed.pose_information(
        jed.extract_ref_level(rg, rd, jintr, CAPS[0], cfg), jed.prepare_now_level(ng, cfg),
        jintr, cfg, R_, t_))
    ref_feats = ted.extract_ref_features(ref.gray, ref.depth, intr, cfg, CAPS)
    now_feats = ted.prepare_now_targets(now.gray, cfg)
    for i, ((rg, rd), (ng, nd), (R_gt, t_gt)) in enumerate(pairs):
        r, n = jbuild(jnp.asarray(rg), jnp.asarray(rd), 2), jbuild(jnp.asarray(ng), jnp.asarray(nd), 2)
        R_j, t_j, d_j = align(r.gray, r.depth, n.gray, *starts[i])
        np.testing.assert_allclose(t[i].numpy(), np.asarray(t_j), atol=pose_bar, rtol=0)
        np.testing.assert_allclose(R[i].numpy(), np.asarray(R_j), atol=pose_bar, rtol=0)
        assert np.linalg.norm(t[i].numpy() - t_gt) < 0.02, i
        assert int(diags[0].num_points[i]) == int(d_j[0].num_points)
        # the information at JAX's pose, over the finest level
        info_j = [np.asarray(x, np.float64) for x in info_fn(r.gray[0], r.depth[0], n.gray[0],
                                                             R_j, t_j)]
        info_p = ted.pose_information(
            ted.RefLevel(*(x[i:i + 1] for x in ref_feats[0])),
            ted.NowLevel(*(x[i:i + 1] for x in now_feats[0])), intr, cfg,
            torch.from_numpy(np.asarray(R_j))[None], torch.from_numpy(np.asarray(t_j))[None])
        for got, want in zip(info_p, info_j):
            got = got[0].numpy().astype(np.float64)
            assert np.abs(got - want).max() <= info_bar * np.abs(want).max(), family


def _odometry_config(solver):
    return PipelineConfig(camera=CAM, solver=solver,
                          pyramid=PyramidConfig(num_levels=2, max_points=CAPS),
                          keyframe=KeyframeConfig(force_every=3))


def _run(odo, frames):
    for f, (g, d) in enumerate(frames):
        odo.process_frame(g, d, timestamp=float(f))
    return odo


@pytest.fixture(scope="module")
def sequence():
    n = 5
    tw = np.stack([np.array([0.8, -0.5, 0.3, 0.15, -0.2, 0.1], np.float32) * 0.004 * i
                   for i in range(n)])
    return render_sequence(CAM, tw, seed=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_odometry_matches_jax(family, sequence):
    """5 frames, a keyframe every 3: the same keyframes and every pose
    within the family's bar of JAX's."""
    cfg, kind = FAMILIES[family]
    frames, poses = sequence
    port = _run(EdgeDvoOdometry(_odometry_config(cfg), device="cpu"), frames)
    jax_ = _run(JaxOdometry(_odometry_config(cfg)), frames)
    assert port.gop.keyframe_indices() == jax_.gop.keyframe_indices()
    (R_p, t_p, _), (R_j, t_j, _) = port.trajectory(), jax_.trajectory()
    bar = BARS[kind][0]
    np.testing.assert_allclose(t_p, t_j, atol=bar, rtol=0)
    np.testing.assert_allclose(R_p, R_j, atol=bar, rtol=0)
    gt = np.stack([p[1] for p in poses])
    assert np.abs(t_p - gt).max() < 0.02


def test_lockstep_parity_matches_single_streams():
    """`MultiStreamOdometry` with the interpolated-DT sub-gradient (hold),
    3 streams of 5 frames, against each stream's `EdgeDvoOdometry`: the
    same keyframes, poses within 5e-3 (measured: equal to the last bit)."""
    cfg = _odometry_config(FAMILIES["sg_interpolate_dt_take"][0])
    cfg = dataclasses.replace(cfg, keyframe=KeyframeConfig(
        force_every=3, enable_quality_triggers=False, rollback_resolve=False))
    seqs = [render_sequence(CAM, np.stack([np.array([0.6, -0.4, 0.3, 0.2, -0.1, 0.1], np.float32)
                                           * (0.004 + 0.001 * s) * i for i in range(5)]),
                            seed=20 + s)[0] for s in range(3)]
    multi = MultiStreamOdometry(3, cfg, device="cpu")
    for f in range(5):
        multi.process_batch(np.stack([sq[f][0] for sq in seqs]),
                            np.stack([sq[f][1] for sq in seqs]), timestamp=f / 30.0)
    for s in range(3):
        single = _run(EdgeDvoOdometry(cfg, device="cpu"), seqs[s])
        assert multi.gops[s].keyframe_indices() == single.gop.keyframe_indices()
        (Ra, ta, _), (Rb, tb, _) = multi.trajectories()[s], single.trajectory()
        assert max(np.abs(Ra - Rb).max(), np.abs(ta - tb).max()) <= 5e-3, s
