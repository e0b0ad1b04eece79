"""The port's log maps and quaternions against the JAX package on the CPU:
so3_log / se3_log near 0, around se3_log's 1e-3 threshold on theta^2 and
near pi; quat_from_rotmat against JAX and the quaternion round trip."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu_torch.core import geometry as tgeo  # noqa: E402


def _rotations(thetas, seed):
    rng = np.random.default_rng(seed)
    axes = rng.standard_normal((len(thetas), 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    w = (axes * np.asarray(thetas)[:, None]).astype(np.float32)
    return np.array(jgeo.so3_exp(jnp.asarray(w))), w


# theta: exact 0 and the Taylor branch; both sides of se3_log's 1e-3
# threshold on theta^2 (theta ~0.0316); generic; near pi (the axis branch)
REGIMES = {
    "near_zero": [0.0, 1e-7, 3e-5, 1e-3, 1.3e-3],
    "threshold": [0.0300, 0.0315, 0.0316, 0.0317, 0.0330],
    "generic": [0.1, 0.5, 1.0, 2.0, 3.0],
    "near_pi": [np.pi - 1e-4, np.pi - 3e-4, np.pi - 5e-4, np.pi - 2e-3, np.pi],
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_so3_log_and_se3_log_match_jax(regime):
    R, _ = _rotations(REGIMES[regime], seed=len(regime))
    t = np.random.default_rng(3).uniform(-0.5, 0.5, (len(R), 3)).astype(np.float32)
    w_j = np.asarray(jgeo.so3_log(jnp.asarray(R)))
    w_t = tgeo.so3_log(torch.from_numpy(R)).numpy()
    # near pi the axis sign is taken from the off-diagonals; theta * axis
    # and -theta * axis are the same rotation there, and both packages take
    # the same branch
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=2e-6)
    xi_j = np.asarray(jgeo.se3_log(jnp.asarray(R), jnp.asarray(t)))
    xi_t = tgeo.se3_log(torch.from_numpy(R), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(xi_t, xi_j, rtol=0, atol=5e-6)
    if regime != "near_pi":
        # the exp-log round trip recovers the pose (float32: V^-1 then V
        # lose a few ulps of t)
        Rb, tb = tgeo.se3_exp(torch.from_numpy(xi_t))
        np.testing.assert_allclose(Rb.numpy(), R, atol=2e-5)
        np.testing.assert_allclose(tb.numpy(), t, atol=2e-5)


def test_quaternions_match_jax_and_round_trip():
    # every branch of quat_from_rotmat: positive trace, then each largest
    # diagonal (rotations by ~pi about x, y, z)
    R, _ = _rotations([0.0, 0.3, 1.5, 2.9, np.pi - 1e-3, np.pi], seed=7)
    flips = np.stack([np.diag(d) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    R = np.concatenate([R, flips.astype(np.float32)])
    q_j = np.asarray(jgeo.quat_from_rotmat(jnp.asarray(R)))
    q_t = tgeo.quat_from_rotmat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(q_t, axis=-1), 1.0, atol=1e-6)
    R_back = tgeo.rotmat_from_quat(torch.from_numpy(q_t)).numpy()
    np.testing.assert_allclose(R_back, R, atol=2e-6)
    np.testing.assert_allclose(
        R_back, np.asarray(jgeo.rotmat_from_quat(jnp.asarray(q_t))), rtol=0, atol=1e-6
    )


def test_camera_helpers_and_identity_pose_match_jax():
    """`backproject`, `backproject_points`, `project` and `transform_points`
    (JAX `core/camera.py:58-105`) and `identity_pose` (JAX
    `core/geometry.py:296`) on random depths, pixels, points and a pose:
    bitwise JAX's where each operation rounds once (the back-projections),
    within one float32 ulp of a 100-pixel coordinate (4e-6 px) where XLA
    contracts or sums in its own order (projection, warp)."""
    from rgbd_odometry_tpu.config import CameraConfig as JaxCamera
    from rgbd_odometry_tpu.core import camera as jcam
    from rgbd_odometry_tpu_torch.config import CameraConfig
    from rgbd_odometry_tpu_torch.core import camera as tcam

    rng = np.random.default_rng(5)
    ji = jcam.Intrinsics.from_config(JaxCamera())
    ti = tcam.Intrinsics.from_config(CameraConfig())
    depth = rng.uniform(300, 4000, (2, 12, 16)).astype(np.float32)
    np.testing.assert_array_equal(tcam.backproject(torch.from_numpy(depth), ti).numpy(),
                                  np.asarray(jcam.backproject(jnp.asarray(depth), ji)))
    uv = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tcam.backproject_points(torch.from_numpy(uv), torch.from_numpy(depth.reshape(-1)[:50]),
                                ti).numpy(),
        np.asarray(jcam.backproject_points(jnp.asarray(uv), jnp.asarray(depth.reshape(-1)[:50]),
                                           ji)))
    pts = np.stack([rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50), rng.uniform(0.5, 3, 50)],
                   -1).astype(np.float32)
    np.testing.assert_allclose(tcam.project(torch.from_numpy(pts), ti).numpy(),
                               np.asarray(jcam.project(jnp.asarray(pts), ji)), rtol=0, atol=4e-5)
    R, t = jgeo.se3_exp(jnp.asarray([0.02, -0.01, 0.03, 0.05, -0.02, 0.01], jnp.float32))
    np.testing.assert_allclose(
        tcam.transform_points(torch.from_numpy(np.asarray(R)), torch.from_numpy(np.asarray(t)),
                              torch.from_numpy(pts)).numpy(),
        np.asarray(jcam.transform_points(R, t, jnp.asarray(pts))), rtol=0, atol=1e-6)
    Rj, tj = jgeo.identity_pose(batch_shape=(3,))
    Rp, tp = tgeo.identity_pose(batch_shape=(3,), device="cpu")
    np.testing.assert_array_equal(Rp.numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
