"""The PyTorch port's streaming odometry (`EdgeDvoOdometry`) on the CPU, on the
rendered sequences of tests/test_pipeline.py under production semantics:
ATE under 8 mm, the same keyframes as the JAX package, rollback re-solves,
the naive ref update, the quality triggers and the divergence guard; the
constant-velocity motion model against JAX, the frame feeder, the JAX
package's default and parity configurations, the reference-parity mode's
configurations against JAX and the one configuration refused."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgbd_odometry_tpu import profiles  # noqa: E402
from rgbd_odometry_tpu.config import (  # noqa: E402
    CameraConfig,
    KeyframeConfig,
    PipelineConfig,
    PyramidConfig,
    SolverConfig,
)
from rgbd_odometry_tpu.eval.ate import ate_rmse  # noqa: E402
from rgbd_odometry_tpu.pipeline.odometry import EdgeDvoOdometry as JaxOdometry  # noqa: E402
from rgbd_odometry_tpu.profiles import production_320  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair, render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.gop import REASON_PERIODIC  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402

torch.set_num_threads(1)

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
SOLVER = dataclasses.replace(production_320().solver, iterations=(18, 6, 4))


def _config(**kw):
    return PipelineConfig(
        camera=CAM,
        pyramid=PyramidConfig(num_levels=3, max_points=(2048, 1024, 512)),
        solver=SOLVER,
        keyframe=KeyframeConfig(**kw),
    )


def _trajectory(n=8, step=0.004):
    ts = np.arange(n)
    return np.stack(
        [0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
         0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts],
        axis=-1,
    ).astype(np.float32)


def _run(odo, frames):
    for i, (g, d) in enumerate(frames):
        odo.process_frame(g, d, timestamp=float(i))
    return odo


@pytest.fixture(scope="module")
def tracked():
    """tests/test_pipeline.py::test_streaming_odometry_tracks_gt's sequence,
    through both packages."""
    frames, poses = render_sequence(CAM, _trajectory(n=8), seed=0)
    port = _run(EdgeDvoOdometry(_config(), device="cpu"), frames)
    jax_ = _run(JaxOdometry(_config()), frames)
    return port, jax_, np.stack([p[1] for p in poses])


@pytest.fixture(scope="module")
def rolled():
    """tests/test_pipeline.py::test_keyframe_every_n_and_rollback's sequence,
    through both packages."""
    frames, _ = render_sequence(CAM, _trajectory(n=12), seed=1)
    cfg = _config(force_every=5, rollback_resolve=True)
    return _run(EdgeDvoOdometry(cfg, device="cpu"), frames), _run(JaxOdometry(cfg), frames)


def test_streaming_odometry_tracks_gt(tracked):
    port, jax_, gt_t = tracked
    _, t_est, _ = port.trajectory()
    assert t_est.shape == gt_t.shape and np.isfinite(t_est).all()
    err = ate_rmse(t_est, gt_t, align=False)
    # the bar of tests/test_pipeline.py (8 mm); JAX measures the same order
    assert err < 0.008, f"ATE {err:.4f}"
    _, t_jax, _ = jax_.trajectory()
    assert abs(err - ate_rmse(t_jax, gt_t, align=False)) < 0.002
    assert port.gop.keyframe_indices() == jax_.gop.keyframe_indices()


def test_keyframes_and_rollback_match_jax(rolled):
    port, jax_ = rolled
    kf = port.gop.keyframe_indices()
    assert kf == jax_.gop.keyframe_indices()
    assert kf[0] == 0 and len(kf) >= 2
    assert all(port.gop.elements[i].reason == REASON_PERIODIC for i in kf[1:])
    rolled_port = [m.frame_num for m in port.metrics if m.rolled_back]
    assert len(rolled_port) >= 1
    assert rolled_port == [m.frame_num for m in jax_.metrics if m.rolled_back]
    _, t_p, _ = port.trajectory()
    _, t_j, _ = jax_.trajectory()
    assert np.abs(t_p - t_j).max() < 2e-3


def test_metrics_recorded(tracked):
    port, _, _ = tracked
    assert len(port.metrics) == 8
    m = port.metrics[2]
    assert m.solve_ms > 0 and m.num_points > 50
    assert np.isfinite(m.b_cap) and 0.0 <= m.visible_ratio <= 1.0
    assert m.energy_curve is not None and len(m.energy_curve) == SOLVER.iterations[0]
    assert port.average_solve_ms() > 0


def test_old_ref_update_variant():
    """rollback_resolve=False: the CURRENT frame becomes the keyframe."""
    frames, _ = render_sequence(CAM, _trajectory(n=8), seed=1)
    odo = _run(EdgeDvoOdometry(_config(force_every=3, rollback_resolve=False), device="cpu"), frames)
    kf = odo.gop.keyframe_indices()
    assert kf[0] == 0 and 3 in kf and 6 in kf, kf
    assert not any(m.rolled_back for m in odo.metrics)
    assert np.isfinite(odo.trajectory()[1]).all()


def test_quality_triggers_fire_on_scene_cut():
    cfg = dataclasses.replace(
        _config(), keyframe=KeyframeConfig(force_every=50, enable_quality_triggers=True)
    )
    odo = EdgeDvoOdometry(cfg, device="cpu")
    (g0, d0), (g1, d1), _ = render_pair(
        CAM, np.array([0.004, -0.002, 0.001, 0.001, -0.001, 0.0005], np.float32), seed=0
    )
    odo.process_frame(g0, d0, 0.0)
    odo.process_frame(g1, d1, 1.0)
    (g_cut, d_cut), _, _ = render_pair(CAM, np.zeros(6, np.float32), seed=9)
    odo.process_frame(g_cut, d_cut, 2.0)
    assert any(m.keyframe_reason in (2, 3, 4) for m in odo.metrics)


def test_divergence_guard_and_pose_prior():
    frames, _ = render_sequence(CAM, _trajectory(n=3), seed=0)
    odo = EdgeDvoOdometry(_config(), device="cpu")
    odo.process_frame(*frames[0], timestamp=0.0)
    odo.process_frame(*frames[1], timestamp=1.0, pose_prior=(np.eye(3), np.zeros(3)))
    # degenerate frame: constant image, zero depth -> no edges at all
    R, t = odo.process_frame(np.zeros((120, 160), np.float32), np.zeros((120, 160), np.float32), 2.0)
    assert np.isfinite(R).all() and np.isfinite(t).all()
    assert np.isfinite(odo.trajectory()[1]).all()


# the configurations the port once refused, now the reference-parity mode:
# case -> (pipeline overrides, pose bar against JAX: 1e-4 where every gather
# is float32, the edge drivers' 2e-3 where JAX rounds to bf16). The float32
# channels keep the interpolant gradients, which jump at pixel boundaries:
# the first solve starts at the identity, where every point lies on one and
# XLA's rounding of u inside the jitted pipeline picks the cell, so the two
# packages take other gradients at some points there and part by 1.8e-4 m
# by frame 3 (measured); that case's bar is 1e-3.
PARITY = {
    "gn_take": (dict(solver=dataclasses.replace(SOLVER, gather_mode="take")), 1e-4),
    "gn_channels": (dict(solver=dataclasses.replace(SOLVER, gn_gradient_mode="channels")), 2e-3),
    "gn_float32": (dict(solver=dataclasses.replace(SOLVER, gather_dtype="float32")), 1e-3),
    "interpolate_dt": (dict(solver=SolverConfig(interpolate_dt=True, iterations=(20, 12, 8))),
                       1e-4),
    "rotationize_svd": (dict(solver=dataclasses.replace(SOLVER, rotationize_method="svd")), 2e-3),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_configurations_match_jax(case):
    """What the port once refused runs: 4 frames through both packages, the
    same keyframes, every pose within the case's bar of JAX's."""
    overrides, bar = PARITY[case]
    cfg = dataclasses.replace(_config(force_every=3), **overrides)
    frames, poses = render_sequence(CAM, _trajectory(n=4), seed=0)
    port, jax_ = _run(EdgeDvoOdometry(cfg, device="cpu"), frames), _run(JaxOdometry(cfg), frames)
    assert port.gop.keyframe_indices() == jax_.gop.keyframe_indices()
    (R_p, t_p, _), (R_j, t_j, _) = port.trajectory(), jax_.trajectory()
    np.testing.assert_allclose(t_p, t_j, atol=bar, rtol=0)
    np.testing.assert_allclose(R_p, R_j, atol=bar, rtol=0)
    assert np.abs(t_p - np.stack([p[1] for p in poses])).max() < 0.02


def test_collect_trajectory_matches_jax():
    """`run_level(..., collect_trajectory=True)` of the reference's
    sub-gradient at level 1 of a rendered pair, 10 iterations from a
    generic start: the poses after each iteration within 1e-5 of JAX's."""
    import jax
    import jax.numpy as jnp

    from rgbd_odometry_tpu.core import geometry as jgeo
    from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics
    from rgbd_odometry_tpu.core.pyramid import build_pyramid as jbuild
    from rgbd_odometry_tpu.solvers import edge_dvo as jed
    from rgbd_odometry_tpu_torch import convert
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted

    cfg = SolverConfig()
    (rg, rd), (ng, nd), _ = render_pair(CAM, _trajectory(n=2)[1] * 2.0, seed=3)
    intr = JIntrinsics.from_config(CAM).at_level(1)
    r, n = jbuild(jnp.asarray(rg), jnp.asarray(rd), 2), jbuild(jnp.asarray(ng), jnp.asarray(nd), 2)
    ref = jed.extract_ref_level(r.gray[1], r.depth[1], intr, 1024, cfg)
    now = jed.prepare_now_level(n.gray[1], cfg)
    R0, t0 = jgeo.se3_exp(jnp.asarray([0.003, -0.002, 0.001, 0.002, 0.001, -0.002], jnp.float32))
    *_, (Rs_j, ts_j) = jed.run_level(ref, now, intr, R0, t0, cfg, 10, collect_trajectory=True)
    *_, (Rs, ts) = ted.run_level(convert.ref_level(ref, device="cpu"),
                                 convert.now_level(now, device="cpu"),
                                 Intrinsics.from_config(CAM).at_level(1),
                                 *convert.pose(R0, t0, device="cpu"), cfg, 10,
                                 collect_trajectory=True)
    np.testing.assert_allclose(Rs[0].numpy(), np.asarray(Rs_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(ts_j), atol=1e-5, rtol=0)


def test_unknown_method_raises():
    """The one configuration the port refuses: a method that is neither
    solver."""
    with pytest.raises(ValueError, match="method"):
        EdgeDvoOdometry(dataclasses.replace(_config(), solver=dataclasses.replace(
            SOLVER, method="levenberg")), device="cpu")


@pytest.mark.parametrize("which", ["defaults", "parity_320"])
def test_default_and_parity_configs_run(which):
    """`PipelineConfig()` (the JAX package's defaults: the sub-gradient on
    the normalized DT) and `profiles.parity_320`, two frames at 320x240."""
    if which == "defaults":
        cfg = PipelineConfig()
    else:
        prof = profiles.parity_320()
        cfg = PipelineConfig(camera=prof.camera, solver=prof.solver,
                             pyramid=PyramidConfig(max_points=prof.max_points))
    frames, poses = render_sequence(cfg.camera, _trajectory(n=2, step=0.002), seed=0,
                                    supersample=1)
    odo = _run(EdgeDvoOdometry(cfg, device="cpu"), frames)
    _, t, _ = odo.trajectory()
    assert np.isfinite(t).all() and np.linalg.norm(t[1] - poses[1][1]) < 0.01
    assert len(odo.metrics[1].energy_curve) == 50


def test_constant_velocity_matches_jax():
    """motion_model="constant_velocity": the warm start extrapolated on the
    device from the previous relative pose, as the JAX driver does."""
    cfg = dataclasses.replace(_config(force_every=5), motion_model="constant_velocity")
    frames, poses = render_sequence(CAM, _trajectory(n=9), seed=2)
    port, jax_ = _run(EdgeDvoOdometry(cfg, device="cpu"), frames), _run(JaxOdometry(cfg), frames)
    hold = _run(EdgeDvoOdometry(_config(force_every=5), device="cpu"), frames)
    assert port.gop.keyframe_indices() == jax_.gop.keyframe_indices()
    assert [m.rolled_back for m in port.metrics] == [m.rolled_back for m in jax_.metrics]
    _, t_p, _ = port.trajectory()
    _, t_j, _ = jax_.trajectory()
    assert np.abs(t_p - t_j).max() < 2e-3
    gt_t = np.stack([p[1] for p in poses])
    assert ate_rmse(t_p, gt_t, align=False) < 0.008
    # the extrapolated warm start changes the solves: not the hold path
    _, t_h, _ = hold.trajectory()
    assert not np.array_equal(t_p, t_h)


def test_feeder_matches_process_frame_and_surfaces_errors():
    from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder

    frames, _ = render_sequence(CAM, _trajectory(n=5), seed=0)
    stream = [(g, d, float(i)) for i, (g, d) in enumerate(frames)]
    direct = _run(EdgeDvoOdometry(_config(), device="cpu"), frames)
    fed = EdgeDvoOdometry(_config(), device="cpu")
    for pyr, ts in FrameFeeder(iter(stream), num_levels=3, depth=1, device="cpu"):
        fed.process_pyramid(pyr, ts)
    for a, b in zip(direct.trajectory(), fed.trajectory()):
        assert np.array_equal(a, b)

    def broken():
        yield stream[0]
        raise OSError("decode failed")

    feeder = FrameFeeder(broken(), num_levels=3, device="cpu")
    next(feeder)
    with pytest.raises(OSError, match="decode failed"):
        next(feeder)


def _default_device_calls():
    """Each of the port's `device=None` defaults, called without a device:
    the frame feeder, the undistortion grid, the VGA ingest, the streaming
    odometry and the lockstep driver."""
    from rgbd_odometry_tpu_torch import config as tcfg
    from rgbd_odometry_tpu_torch.core.camera import undistort_map
    from rgbd_odometry_tpu_torch.io.stream import preprocess_vga
    from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry
    from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder

    cam = tcfg.CameraConfig(width=64, height=48, fx=60.0, fy=60.0, cx=31.5, cy=23.5,
                      distortion=(0.1, 0.0, 0.0, 0.0, 0.0))
    rgb, depth = np.zeros((48, 64, 3), np.float32), np.ones((48, 64), np.float32)
    lockstep = tcfg.PipelineConfig(keyframe=tcfg.KeyframeConfig(rollback_resolve=False))
    return {
        "feeder": lambda device=None: FrameFeeder(iter(()), num_levels=2, device=device),
        "undistort_map": lambda device=None: undistort_map(cam, device),
        "preprocess_vga": lambda device=None: preprocess_vga(rgb, depth, cam, device),
        "odometry": lambda device=None: EdgeDvoOdometry(_config(), device=device),
        "multistream": lambda device=None: MultiStreamOdometry(2, lockstep, device=device),
    }


@pytest.mark.parametrize("what", ["feeder", "undistort_map", "preprocess_vga", "odometry",
                                  "multistream"])
def test_device_defaults_resolve_to_the_card(what, monkeypatch):
    """With no device each entry resolves the current CUDA device
    (`device.resolve_device`): without a card it raises, naming
    `device='cpu'`, and never falls back to the host; `device="cpu"` runs
    the plain path on the host."""
    call = _default_device_calls()[what]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    tensors = [x for x in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(x)]
    for x in tensors:
        assert x.device.type == "cpu"
    if what == "feeder":
        assert out._device == torch.device("cpu") and list(out) == []


def _converter_calls():
    """Each function of `convert.py` on a JAX-shaped object of numpy arrays,
    its device left to the default or given."""
    from types import SimpleNamespace as NS

    from rgbd_odometry_tpu_torch import convert

    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    ref = NS(pts3d=z(4, 3), uv=z(4, 2), valid=np.ones(4, bool), count=np.int32(4))
    now = NS(dt=z(6, 8), dgx=z(6, 8), dgy=z(6, 8), edges=np.zeros((6, 8), bool),
             scale=np.float32(1.0), chans=z(3, 6, 8))
    kps = NS(uv=z(4, 2), score=z(4), desc=z(4, 64), valid=np.ones(4, bool), count=np.int32(4))
    edges = NS(i=np.arange(2), j=np.arange(1, 3), R_rel=z(2, 3, 3), t_rel=z(2, 3),
               weight=np.ones(2, np.float32), sqrt_info=None)
    return {
        "to_tensor": lambda device=None: convert.to_tensor(z(3), device=device),
        "ref_level": lambda device=None: tuple(convert.ref_level(ref, device=device)),
        "now_level": lambda device=None: tuple(convert.now_level(now, device=device)),
        "pose": lambda device=None: convert.pose(np.eye(3), z(3), device=device),
        "keypoints_from_jax": lambda device=None: tuple(convert.keypoints_from_jax(kps, device)),
        "edges_from_jax": lambda device=None: tuple(convert.edges_from_jax(edges, device)),
    }


@pytest.mark.parametrize("what", ["to_tensor", "ref_level", "now_level", "pose",
                                  "keypoints_from_jax", "edges_from_jax"])
def test_converter_defaults_resolve_to_the_card(what, monkeypatch):
    """`convert.py` carries JAX state to the current CUDA device by default
    (`device.resolve_device`): without a card it raises, naming
    `device='cpu'`; `device="cpu"` puts every tensor on the host."""
    call = _converter_calls()[what]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    tensors = [x for x in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(x)]
    assert tensors and all(x.device.type == "cpu" for x in tensors)
