"""The port's fused pipeline (`rgbd_odometry_tpu_torch/pipeline/fused.py`: IMU
prior, edge DVO, sparse-PnP fallback) against the JAX package's
`FusedOdometry` on the CPU, in JAX's own scenarios (tests/test_pipeline.py:
`test_fused_pipeline_imu_prior_and_fallback`, `test_fused_fallback_fires`) on
the 160x120 camera of the JAX tests. JAX's RANSAC draws are replayed through
`FusedOdometry._uniforms`."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from rgbd_odometry_tpu import config as jcfg  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu.pipeline.fused import FusedConfig as JaxFusedConfig  # noqa: E402
from rgbd_odometry_tpu.pipeline.fused import FusedOdometry as JaxFused  # noqa: E402
from rgbd_odometry_tpu.pipeline.odometry import EdgeDvoOdometry as JaxEdgeDvoOdometry  # noqa: E402
from rgbd_odometry_tpu.solvers import imu as jimu  # noqa: E402
from rgbd_odometry_tpu_torch import config as pcfg  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.fused import FusedConfig, FusedOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import imu as pimu  # noqa: E402

CAMKW = dict(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)


class JaxDraws:
    """JAX's draws in its order: per RANSAC call `key, sub = split(key)`,
    then `uniform(k_i, (K,))` for k_i in `split(sub, S)`."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, s: int, k: int) -> torch.Tensor:
        self.key, sub = jax.random.split(self.key)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(jax.random.split(sub, s))
        return torch.from_numpy(np.array(u))


def _config(m, **kw):
    """tests/test_pipeline.py's `_config` in package `m`."""
    return m.PipelineConfig(
        camera=m.CameraConfig(**CAMKW),
        pyramid=m.PyramidConfig(num_levels=3, max_points=(2048, 1024, 512)),
        solver=m.SolverConfig(method="gauss_newton", iterations=(50, 8, 5)),
        keyframe=m.KeyframeConfig(**kw),
    )


def _frames(n, step=0.004):
    ts = np.arange(n)
    psis = np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts, 0.15 * step * ts,
                     -0.2 * step * ts, 0.1 * step * ts], -1).astype(np.float32)
    return render_sequence(jcfg.CameraConfig(**CAMKW), psis, seed=0)


def _window(i):
    return (np.zeros((10, 3), np.float32), np.zeros((10, 3), np.float32), 0.01)


def _run(fo, frames, imu=True):
    for i, (g, d) in enumerate(frames):
        fo.process_frame(g, d, float(i), imu_window=_window(i) if imu else None)
    return fo.trajectory()


def test_fused_imu_prior_scenario_matches_jax():
    """JAX's `test_fused_pipeline_imu_prior_and_fallback`: with a 10-sample
    IMU window a frame the final error is under JAX's 8 mm and no frame falls
    back, as in JAX. The fused layer adds nothing to the edge solve in
    either package: each one's poses are bitwise its own EdgeDvoOdometry
    given the same priors, so the whole distance between the two fused
    trajectories is the two edge pipelines' distance on this sequence
    (2.1e-4 at frame 1; tests/test_torch_pipeline.py holds them to 2e-3). Held within 3e-4 of JAX's: PERF.md section 6, the 1e-4 bar is
    not met here."""
    frames, poses = _frames(6)
    jf = JaxFused(_config(jcfg), JaxFusedConfig(min_pnp_matches=6))
    R_j, t_j, _ = _run(jf, frames)
    pf = FusedOdometry(_config(pcfg), FusedConfig(min_pnp_matches=6), device="cpu")
    pf._uniforms = JaxDraws(0)
    R_p, t_p, _ = _run(pf, frames)
    gt_t = np.stack([p[1] for p in poses])
    assert np.linalg.norm(t_p - gt_t, axis=-1)[-1] < 0.008
    assert pf.fallback_frames == jf.fallback_frames == []
    odo = EdgeDvoOdometry(_config(pcfg), device="cpu")
    jodo = JaxEdgeDvoOdometry(_config(jcfg))
    for i, (g, d) in enumerate(frames):
        prior = (np.eye(3), np.zeros(3)) if i else None
        odo.process_frame(g, d, float(i), pose_prior=prior)
        jodo.process_frame(g, d, float(i), pose_prior=prior)
    np.testing.assert_array_equal(R_p, odo.trajectory()[0])
    np.testing.assert_array_equal(t_p, odo.trajectory()[1])
    np.testing.assert_array_equal(R_j, jodo.trajectory()[0])
    np.testing.assert_array_equal(t_j, jodo.trajectory()[1])
    np.testing.assert_allclose(R_p, R_j, rtol=0, atol=3e-4)
    np.testing.assert_allclose(t_p, t_j, rtol=0, atol=3e-4)
    assert sorted(pf._imu_windows) == list(range(6))


def test_fused_fallback_fires_matches_jax():
    """JAX's `test_fused_fallback_fires` (b-hat threshold 0: every eligible
    frame takes the sparse-PnP path) with JAX's draws replayed: the same
    fallback frames as JAX, every pose within 1e-4 of JAX's, the final error
    under JAX's 0.12 m."""
    frames, poses = _frames(4)
    kw = dict(laplacian_b_thresh=0.0, min_pnp_matches=5)
    jf = JaxFused(_config(jcfg), JaxFusedConfig(**kw))
    R_j, t_j, _ = _run(jf, frames, imu=False)
    pf = FusedOdometry(_config(pcfg), FusedConfig(**kw), device="cpu")
    pf._uniforms = JaxDraws(0)
    R_p, t_p, _ = _run(pf, frames, imu=False)
    assert pf.fallback_frames == jf.fallback_frames and len(pf.fallback_frames) >= 1
    np.testing.assert_allclose(R_p, R_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_p, t_j, rtol=0, atol=1e-4)
    gt_t = np.stack([p[1] for p in poses])
    assert np.linalg.norm(t_p - gt_t, axis=-1)[-1] < 0.12


@pytest.mark.parametrize("rollback", [True, False])
def test_keyframe_anchoring_matches_jax(rollback):
    """Keyframe switches every 2 frames, with rollback (the sparse features
    anchor to frame n-1) or the naive update (to the current frame): after
    each frame the keyframe's keypoints equal JAX's, and the trajectory is
    within 2e-3 of JAX's (the bar tests/test_torch_pipeline.py holds the
    port's EdgeDvoOdometry to: its solve is the whole difference here)."""
    frames, _ = _frames(5)
    kw = dict(force_every=2, rollback_resolve=rollback)
    jf = JaxFused(_config(jcfg, **kw), JaxFusedConfig())
    pf = FusedOdometry(_config(pcfg, **kw), FusedConfig(), device="cpu")
    pf._uniforms = JaxDraws(0)
    for i, (g, d) in enumerate(frames):
        jf.process_frame(g, d, float(i))
        pf.process_frame(g, d, float(i))
        np.testing.assert_array_equal(pf._kf_kps.uv.numpy(), np.asarray(jf._kf_kps.uv))
        np.testing.assert_array_equal(pf._kf_pts_valid.numpy(), np.asarray(jf._kf_pts_valid))
        np.testing.assert_allclose(pf._kf_pts3d.numpy(), jf._kf_pts3d, rtol=0, atol=1e-7)
    assert pf.odo.gop.keyframe_indices() == jf.odo.gop.keyframe_indices()
    np.testing.assert_allclose(pf.trajectory()[1], jf.trajectory()[1], rtol=0, atol=2e-3)


def test_imu_prior_of_a_moving_window_matches_jax():
    """The prior dead-reckoned from a moving 25-sample window (gravity-free)
    within 1e-6 of JAX's, as float64 (R, t) on the host."""
    rng = np.random.default_rng(9)
    a = rng.normal(0, 1.0, (25, 3)).astype(np.float32)
    w = rng.normal(0, 0.5, (25, 3)).astype(np.float32)
    jf = JaxFused.__new__(JaxFused)
    jf._imu_intr = jimu.ImuIntrinsics.from_scalars(accel_bias=0.02)
    R_j, t_j = jf._imu_prior(a, w, 0.01)
    pf = FusedOdometry(_config(pcfg), imu_intrinsics=pimu.ImuIntrinsics.from_scalars(
        accel_bias=0.02, device="cpu"), device="cpu")
    R_p, t_p = pf._imu_prior(a, w, 0.01)
    assert R_p.dtype == np.float64 and t_p.dtype == np.float64
    np.testing.assert_allclose(R_p, R_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_p, t_j, rtol=0, atol=1e-6)
