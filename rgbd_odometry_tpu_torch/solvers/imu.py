"""IMU dead reckoning and preintegration: port of `rgbd_odometry_tpu/solvers/imu.py`.

Dead reckoning (the reference's `ImuDeadReckon`, src/ImuDeadReckon.cpp):
nominal-state propagation at a fixed rate with constant biases and the
hardcoded gravity (0, 9.7874, 0),

    p += v dt + 0.5 (R a_corr + g) dt^2,   v += (R a_corr + g) dt,
    q  = q * exp_quat((w - w_bias) dt),

and preintegration (beyond the reference): a window of samples compressed
to one gravity-free relative motion (dR, dv, dp) with the 9x9 covariance of
its error state, the form a pose-graph edge needs. The discretization is the
same, so composing a preintegrated window onto a start state reproduces the
dead reckoner.

`propagate_batch` and `preintegrate` take one window (T, 3) or a batch of B
windows (B, T, 3) (the JAX package vmaps one window); both are one launch of
`kernels/imu.imu_scan` on a CUDA tensor and its plain version on a CPU
tensor. Quaternions are (x, y, z, w).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_odometry_tpu_torch.core import geometry as geo
from rgbd_odometry_tpu_torch.device import resolve_device
from rgbd_odometry_tpu_torch.kernels import imu as _kernel

DEFAULT_GRAVITY = (0.0, 9.7874, 0.0)  # the reference's hardcoded value (:21-23)


class ImuState(NamedTuple):
    """Nominal state (nsv_p, nsv_v, nsv_q of the reference, :15-19), with
    optional leading batch dims."""

    p: torch.Tensor  # (..., 3)
    v: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4) quaternion (x, y, z, w)

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "ImuState":
        f = dict(dtype=dtype, device=resolve_device(device))
        return ImuState(p=torch.zeros(3, **f), v=torch.zeros(3, **f),
                        q=torch.tensor([0.0, 0.0, 0.0, 1.0], **f))


class ImuIntrinsics(NamedTuple):
    """Bias and noise parameters (`ImuSetIntrinsics`, :30-42). The noise
    variances are the per-sample white-noise variances driving
    `preintegrate`'s covariance propagation."""

    accel_bias: torch.Tensor  # (3,)
    gyro_bias: torch.Tensor  # (3,)
    accel_var: torch.Tensor  # ()
    gyro_var: torch.Tensor  # ()

    @staticmethod
    def from_scalars(accel_var=0.0, accel_bias=0.0, gyro_var=0.0, gyro_bias=0.0,
                     dtype=torch.float32, device=None) -> "ImuIntrinsics":
        """Scalar biases replicate to all axes as the reference does (aBias =
        a_b * Ones, :38-39)."""
        f = dict(dtype=dtype, device=resolve_device(device))
        return ImuIntrinsics(accel_bias=torch.full((3,), accel_bias, **f),
                             gyro_bias=torch.full((3,), gyro_bias, **f),
                             accel_var=torch.tensor(accel_var, **f),
                             gyro_var=torch.tensor(gyro_var, **f))


def _params(intr: ImuIntrinsics, gravity, device) -> torch.Tensor:
    """The kernel's (11,) parameter vector on `device`."""
    g = torch.as_tensor(gravity, dtype=torch.float32).to(device)
    return torch.cat([intr.accel_bias.reshape(3), intr.gyro_bias.reshape(3),
                      intr.accel_var.reshape(1), intr.gyro_var.reshape(1), g]).to(
        device=device, dtype=torch.float32).contiguous()


def _windows(accels: torch.Tensor, gyros: torch.Tensor):
    """(B, T, 3) float32 contiguous views of one or B windows, and whether a
    batch dim was given."""
    batched = accels.dim() == 3
    a = accels if batched else accels[None]
    w = gyros if batched else gyros[None]
    return a.float().contiguous(), w.float().contiguous(), batched


def _quat_from_rotvec(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4), Taylor-safe at phi -> 0
    (`makeQuaternionFromVector`, :85-95)."""
    return torch.stack(_kernel.quat_from_rotvec(list(w.unbind(-1))), -1)


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (x, y, z, w) component order."""
    return torch.stack(_kernel.quat_mul(list(a.unbind(-1)), list(b.unbind(-1))), -1)


def propagate_batch(state: ImuState, accels: torch.Tensor, gyros: torch.Tensor,
                    intr: ImuIntrinsics, dt: float = 1.0 / 100.0, gravity=DEFAULT_GRAVITY):
    """Propagate a window of samples accels, gyros (T, 3) from `state`, or B
    windows (B, T, 3) from B states (B, ...): (final state, the states after
    every sample (leading dims (T,) or (B, T)))."""
    a, w, batched = _windows(accels, gyros)
    b = a.shape[0]
    s0 = torch.cat([state.p, state.v, state.q], -1).float().reshape(-1, _kernel.STATE)
    s0 = s0.expand(b, _kernel.STATE).contiguous()
    traj = _kernel.imu_scan(_kernel.PROPAGATE, a, w, _params(intr, gravity, a.device), dt, s0)
    if not batched:
        traj = traj[0]
    out = ImuState(p=traj[..., 0:3], v=traj[..., 3:6], q=traj[..., 6:10])
    return ImuState(p=out.p[..., -1, :], v=out.v[..., -1, :], q=out.q[..., -1, :]), out


def propagate_step(state: ImuState, accel: torch.Tensor, gyro: torch.Tensor,
                   intr: ImuIntrinsics, dt: float = 1.0 / 100.0,
                   gravity=DEFAULT_GRAVITY) -> ImuState:
    """One nominal-state update (`updateNominalStateWithCurrentMeasurements`,
    :67-83): `propagate_batch` over one sample (3,) (or (B, 3))."""
    final, _ = propagate_batch(state, accel[..., None, :], gyro[..., None, :], intr, dt,
                               gravity)
    return final


def pose_of(state: ImuState):
    """(R, t) of the dead-reckoned pose, the edge-DVO solve's seed
    (BASELINE config 5)."""
    R = _kernel.rot_of_quat(list(state.q.unbind(-1)))
    return torch.stack([torch.stack(r, -1) for r in R], -2), state.p


class Preintegrated(NamedTuple):
    """A window of IMU samples compressed to one relative-motion measurement,
    in the body frame at the window start (see the JAX docstring):
    dR (..., 3, 3), dv (..., 3), dp (..., 3), dt_total (...,) and cov
    (..., 9, 9), the covariance of (dtheta, dv, dp) with dtheta a right
    perturbation of dR."""

    dR: torch.Tensor
    dv: torch.Tensor
    dp: torch.Tensor
    dt_total: torch.Tensor
    cov: torch.Tensor


def _so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3) of phi (..., 3): Exp(phi + d) ~= Exp(phi)
    Exp(Jr(phi) d), Taylor-safe at phi -> 0."""
    J = _kernel.right_jacobian(list(phi.unbind(-1)))
    return torch.stack([torch.stack(r, -1) for r in J], -2)


def preintegrate(accels: torch.Tensor, gyros: torch.Tensor, intr: ImuIntrinsics,
                 dt: float = 1.0 / 100.0) -> Preintegrated:
    """Preintegrate a window of raw samples (T, 3), or B windows (B, T, 3),
    with the constant biases of `intr`; `intr.accel_var` and
    `intr.gyro_var` drive the covariance."""
    a, w, batched = _windows(accels, gyros)
    dR, dv, dp, cov = _kernel.imu_scan(_kernel.PREINTEGRATE, a, w,
                                       _params(intr, (0.0, 0.0, 0.0), a.device), dt)
    T = torch.full((a.shape[0],), a.shape[1] * dt, dtype=torch.float32, device=a.device)
    pre = Preintegrated(dR=dR, dv=dv, dp=dp, dt_total=T, cov=cov)
    return pre if batched else Preintegrated(*(x[0] for x in pre))


def compose_preintegrated(state: ImuState, pre: Preintegrated,
                          gravity=DEFAULT_GRAVITY) -> ImuState:
    """Apply a preintegrated window to a start state: equals running
    `propagate_batch` over the window's raw samples."""
    g = torch.as_tensor(gravity, dtype=state.p.dtype).to(state.p.device)
    R0, _ = pose_of(state)
    T = pre.dt_total[..., None]
    p = state.p + state.v * T + 0.5 * g * T * T + (R0 @ pre.dp[..., None])[..., 0]
    v = state.v + g * T + (R0 @ pre.dv[..., None])[..., 0]
    q = _quat_mul(state.q, geo.quat_from_rotmat(pre.dR))
    return ImuState(p=p, v=v, q=q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))


_POSE_IDX = [6, 7, 8, 0, 1, 2]  # (dp, dtheta): the pose graph's (translation, rotation)


def preintegrated_pose_information(pre: Preintegrated, ridge: float = 1e-12) -> torch.Tensor:
    """(..., 6, 6) information of the window's relative pose in the pose
    graph's (translation, rotation) layout: the (dp, dtheta) marginal of the
    9x9 covariance, inverted with a ridge."""
    idx = torch.tensor(_POSE_IDX, device=pre.cov.device)
    P = pre.cov.index_select(-2, idx).index_select(-1, idx)
    eye = torch.eye(6, dtype=P.dtype, device=P.device)
    return torch.linalg.inv(P + ridge * eye)


def imu_relative_pose_edges(i: torch.Tensor, j: torch.Tensor, R_i: torch.Tensor,
                            v_i: torch.Tensor, pres: Preintegrated, gravity=DEFAULT_GRAVITY,
                            weight: float = 1.0):
    """Preintegrated windows (leading dim E) as `PoseGraphEdges`
    pseudo-measurements, velocity and gravity fixed at (R_i (E,3,3), v_i
    (E,3)): R_rel = dR, t_rel = R_i^T (v_i T + g T^2 / 2) + dp."""
    from rgbd_odometry_tpu_torch.solvers import pose_graph as pg

    g = torch.as_tensor(gravity, dtype=v_i.dtype).to(v_i.device)
    T = pres.dt_total
    drift = v_i * T[:, None] + 0.5 * g[None, :] * (T * T)[:, None]
    t_rel = torch.einsum("eij,ei->ej", R_i, drift) + pres.dp
    return pg.PoseGraphEdges(
        i=torch.as_tensor(i, dtype=torch.int64, device=v_i.device),
        j=torch.as_tensor(j, dtype=torch.int64, device=v_i.device), R_rel=pres.dR,
        t_rel=t_rel, weight=torch.full(tuple(i.shape), weight, dtype=v_i.dtype, device=v_i.device),
        sqrt_info=None,
    )


def velocities_from_trajectory(t: torch.Tensor, stamps: torch.Tensor) -> torch.Tensor:
    """(N, 3) world-frame velocities by central differences of positions t
    (N, 3) at `stamps` (N,) seconds, one-sided at the ends."""
    stamps = torch.as_tensor(stamps, dtype=t.dtype).to(t.device)
    dt_mid = torch.clamp((stamps[2:] - stamps[:-2])[:, None], min=1e-9)
    v_mid = (t[2:] - t[:-2]) / dt_mid
    v0 = (t[1] - t[0]) / torch.clamp(stamps[1] - stamps[0], min=1e-9)
    vn = (t[-1] - t[-2]) / torch.clamp(stamps[-1] - stamps[-2], min=1e-9)
    return torch.cat([v0[None], v_mid, vn[None]], dim=0)
