"""Kernel 11: IMU propagation and preintegration over B windows (`csrc/imu.cu`).

Replaces the two `lax.scan` loops of the JAX package's IMU solver (XLA, no
Pallas kernel): `propagate_batch` (`rgbd_odometry_tpu/solvers/imu.py:116`,
the body `propagate_step`, :94) and `preintegrate` (:194, the body
:210-245), and the `jax.vmap` over windows around them
(`rgbd_odometry_tpu/pipeline/fused.py:276`). `imu_scan` is the entry point:
CPU tensors go to the plain PyTorch version `imu_plain`, CUDA tensors to
the kernel; anything else raises. One launch runs B windows of T samples in
one of two modes:

- `propagate`: the state (p, v, q) after every sample, from a start state
  and a gravity vector (the reference's `ImuDeadReckon`);
- `preintegrate`: the window's (dR, dv, dp) and the 9x9 covariance of its
  error state, cov <- A cov A^T + B diag(Q) B^T each sample.

The kernel runs a window on a warp, its samples in chunks through shared
memory; the work of a sample that does not depend on the state (the bias
corrections, the rotation vector's quaternion, Exp and the right Jacobian)
is taken for a chunk's samples at once, one a lane, and only the carried
chain (q; dR; then p and v, dv and dp, the covariance) runs sample after
sample. The plain version is laid out the same way (the state-free half
for all samples at once, the chains in loops), which changes no value.

The nominal chain (state, dR, dv, dp) is written below as single float32
operations in a fixed order, each rounded once (sin and cos taken in
float64 and rounded once, square roots correctly rounded, divisions as
tensor over tensor), with a fused multiply-add wherever XLA:CPU contracts
a product into a sum (the dot products' chains, and a product that is the
first operand of a sum), and the kernel performs the same operations with
round-to-nearest intrinsics: the two agree to the last bit. The covariance
is `torch.matmul`'s here; the kernel forms each entry as the in-order chain
of multiply-adds that batched small products on an H100 take, so the two
agree to the last bit there and to float32 rounding where torch sums in
another order (a batch of one); no nominal value depends on it.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.kernels.se3_plain import _rounded, sqrt
from rgbd_odometry_tpu_torch.ops.project import div_scalar
from rgbd_odometry_tpu_torch.ops.project import fma_f32 as fma

PROPAGATE, PREINTEGRATE = 0, 1
STATE = 10  # p (3), v (3), q (4) a sample
PARAMS = 11  # accel bias (3), gyro bias (3), accel var, gyro var, gravity (3)
_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 5


def _sq4(q):
    """q0^2 + q1^2 + q2^2 + q3^2 as XLA:CPU reduces it, a fused
    multiply-add a term."""
    return fma(q[3], q[3], fma(q[2], q[2], fma(q[1], q[1], q[0] * q[0])))


def _sq3(w):
    return fma(w[2], w[2], fma(w[1], w[1], w[0] * w[0]))


def _mv(R, a):
    """R a (3x3 nested list, three (B,) tensors): each row a chain of fused
    multiply-adds, as XLA:CPU's dot emitter sums it."""
    return [fma(R[i][2], a[2], fma(R[i][1], a[1], R[i][0] * a[0])) for i in range(3)]


def _mm(A, B):
    """A B of 3x3 nested lists, each entry `_mv`'s chain."""
    return [[fma(A[i][2], B[2][j], fma(A[i][1], B[1][j], A[i][0] * B[0][j])) for j in range(3)]
            for i in range(3)]


def rot_of_quat(q):
    """Quaternion (x, y, z, w) (four (B,) tensors) -> R (3x3 nested list),
    normalized first (`core/geometry.rotmat_from_quat`), with the fused
    multiply-adds XLA:CPU contracts (a product and a sum become one
    where the product is the first operand)."""
    n = sqrt(_sq4(q))
    x, y, z, w = (c / n for c in q)
    return [[1.0 - 2.0 * fma(y, y, z * z), 2.0 * fma(x, y, -(w * z)), 2.0 * fma(x, z, w * y)],
            [2.0 * fma(x, y, w * z), 1.0 - 2.0 * fma(x, x, z * z), 2.0 * fma(y, z, -(w * x))],
            [2.0 * fma(x, z, -(w * y)), 2.0 * fma(y, z, w * x), 1.0 - 2.0 * fma(x, x, y * y)]]


def quat_from_rotvec(w):
    """Axis-angle (three (B,) tensors) -> quaternion (x, y, z, w), Taylor
    below phi = 1e-6 (JAX `_quat_from_rotvec`)."""
    phi2 = _sq3(w)
    phi = sqrt(phi2 + 1e-24)
    half = 0.5 * phi
    s = torch.where(phi < 1e-6, 0.5 - div_scalar(phi2, 48.0), _rounded(torch.sin, half) / phi)
    return [w[0] * s, w[1] * s, w[2] * s, _rounded(torch.cos, half)]


def quat_mul(a, b):
    """Hamilton product of two (x, y, z, w) quaternions (lists of (B,)), a
    chain of fused multiply-adds a component."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return [fma(-az, by, fma(ay, bz, fma(aw, bx, ax * bw))),
            fma(az, bx, fma(ay, bw, fma(aw, by, -(ax * bz)))),
            fma(az, bw, fma(-ay, bx, fma(aw, bz, ax * by))),
            fma(-az, bz, fma(-ay, by, fma(aw, bw, -(ax * bx))))]


def quat_normalized(q):
    n = sqrt(_sq4(q))
    return [c / n for c in q]


def so3_exp(w):
    """Rodrigues (three (B,) tensors -> 3x3 nested list), JAX
    `core/geometry.so3_exp`: I + a W + b W^2, Taylor below theta^2 = 1e-8."""
    theta2 = _sq3(w)
    theta = sqrt(theta2 + 1e-16)
    small = theta2 < 1e-8
    sin, cos = _rounded(torch.sin, theta), _rounded(torch.cos, theta)
    a = torch.where(small, 1.0 - div_scalar(theta2, 6.0), sin / theta)
    b = torch.where(small, 0.5 - div_scalar(theta2, 24.0), (1.0 - cos) / theta2)
    z = torch.zeros_like(theta2)
    W = [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]
    WW = _mm(W, W)
    return [[fma(b, WW[i][j], fma(a, W[i][j], 1.0 if i == j else 0.0)) for j in range(3)]
            for i in range(3)]


def right_jacobian(phi):
    """Right Jacobian of SO(3) (3x3 nested list), Taylor below theta =
    1e-5 (JAX `_so3_right_jacobian`); it enters only the covariance."""
    th2 = _sq3(phi)
    th = sqrt(th2 + 1e-24)
    small = th < 1e-5
    sin, cos = _rounded(torch.sin, th), _rounded(torch.cos, th)
    c1 = torch.where(small, 0.5 - div_scalar(th2, 24.0), (1.0 - cos) / torch.clamp(th2, min=1e-24))
    c2 = torch.where(small, 1.0 / 6.0 - div_scalar(th2, 120.0),
                     (th - sin) / torch.clamp(th2 * th, min=1e-24))
    z = torch.zeros_like(th2)
    K = [[z, -phi[2], phi[1]], [phi[2], z, -phi[0]], [-phi[1], phi[0], z]]
    KK = _mm(K, K)
    return [[(1.0 if i == j else 0.0) - c1 * K[i][j] + c2 * KK[i][j] for j in range(3)]
            for i in range(3)]


def propagate_plain(state0, accels, gyros, params, dt: float) -> torch.Tensor:
    """(B, T, 10) states after every sample, from state0 (B, 10) [p, v, q],
    accels, gyros (B, T, 3) and params (11,) (`PARAMS`): JAX
    `propagate_step`'s operations on every sample. As the kernel takes it,
    the state-free half (a, w dt, the rotation vector's quaternion) is taken
    for all samples at once; the loop carries q, then R(q) a + g is taken
    for all samples at once, then the loop carries p and v."""
    ab, gb, g = params[0:3], params[3:6], params[8:11]
    n = accels.shape[1]
    a = [accels[..., i] - ab[i] for i in range(3)]
    dq = quat_from_rotvec([(gyros[..., i] - gb[i]) * dt for i in range(3)])
    q = [state0[:, 6 + i] for i in range(4)]
    qs = []  # the quaternion after each sample
    for k in range(n):
        q = quat_normalized(quat_mul(q, [d[:, k] for d in dq]))
        qs.append(torch.stack(q, -1))
    q_after = torch.stack(qs, 1)  # (B, T, 4)
    q_before = torch.cat([state0[:, None, 6:10], q_after[:, :-1]], 1)
    R = rot_of_quat([q_before[..., i] for i in range(4)])
    acc = [x + g[i] for i, x in enumerate(_mv(R, a))]
    half = [0.5 * acc[i] * dt for i in range(3)]
    p, v = state0[:, 0:3], state0[:, 3:6]
    acc, half = torch.stack(acc, -1), torch.stack(half, -1)
    ps, vs = [], []
    for k in range(n):
        p = fma(half[:, k], dt, fma(v, dt, p))
        v = fma(acc[:, k], dt, v)
        ps.append(p)
        vs.append(v)
    return torch.cat([torch.stack(ps, 1), torch.stack(vs, 1), q_after], -1)


def transition(dR, a, E, Jr, dt: float):
    """The error-state transition A (..., 9, 9) and noise input B (..., 9,
    6) of preintegration samples (JAX `preintegrate`'s body), from dR before
    the sample, its Exp(phi) E and right Jacobian Jr (3x3 nested lists) and
    the bias-corrected a (three tensors), tensors of any one shape."""
    z = torch.zeros_like(a[0])
    hat_a = [[z, -a[2], a[1]], [a[2], z, -a[0]], [-a[1], a[0], z]]
    hRa = _mm(dR, hat_a)
    A = torch.zeros((*z.shape, 9, 9), dtype=z.dtype, device=z.device)
    Bn = torch.zeros((*z.shape, 9, 6), dtype=z.dtype, device=z.device)
    for i in range(3):
        A[..., 3 + i, 3 + i] = 1.0
        A[..., 6 + i, 3 + i] = dt
        A[..., 6 + i, 6 + i] = 1.0
        for j in range(3):
            A[..., i, j] = E[j][i]
            A[..., 3 + i, j] = -hRa[i][j] * dt
            A[..., 6 + i, j] = -0.5 * hRa[i][j] * dt * dt
            Bn[..., i, j] = Jr[i][j] * dt
            Bn[..., 3 + i, 3 + j] = dR[i][j] * dt
            Bn[..., 6 + i, 3 + j] = 0.5 * dR[i][j] * dt * dt
    return A, Bn


def _mm_t(A, B):
    """A B of (..., 3, 3) tensors, each entry `_mm`'s chain of fused
    multiply-adds."""
    return fma(A[..., :, 2, None], B[..., None, 2, :],
               fma(A[..., :, 1, None], B[..., None, 1, :], A[..., :, 0, None] * B[..., None, 0, :]))


def preintegrate_plain(accels, gyros, params, dt: float):
    """(dR (B,3,3), dv (B,3), dp (B,3), cov (B,9,9)) of B windows of T
    samples: JAX `preintegrate`'s body on every sample. As the kernel takes
    it, the state-free half (a, phi, Exp(phi), the right Jacobian) is taken
    for all samples at once; the loop carries dR, then everything dR gives
    (dR a, the transition) is taken for all samples at once, then the loop
    carries dv, dp and the covariance."""
    ab, gb = params[0:3], params[3:6]
    bsz, n = accels.shape[:2]
    a = [accels[..., i] - ab[i] for i in range(3)]
    phi = [(gyros[..., i] - gb[i]) * dt for i in range(3)]
    E = so3_exp(phi)
    Jr = right_jacobian(phi)
    Et = torch.stack([torch.stack(r, -1) for r in E], -2)  # (B, T, 3, 3)
    f = dict(dtype=accels.dtype, device=accels.device)
    dR = torch.eye(3, **f).expand(bsz, 3, 3)
    before = []
    for k in range(n):
        before.append(dR)
        dR = _mm_t(dR, Et[:, k])
    Rb = torch.stack(before, 1)  # dR before each sample, (B, T, 3, 3)
    Rl = [[Rb[..., i, j] for j in range(3)] for i in range(3)]
    A, Bn = transition(Rl, a, E, Jr, dt)
    Q = torch.cat([params[7].expand(3), params[6].expand(3)])
    N = (Bn * Q) @ Bn.transpose(-1, -2)
    Ra = torch.stack(_mv(Rl, a), -1)
    half = 0.5 * Ra * dt
    dv = torch.zeros((bsz, 3), **f)
    dp = torch.zeros((bsz, 3), **f)
    cov = torch.zeros((bsz, 9, 9), **f)
    for k in range(n):
        cov = A[:, k] @ cov @ A[:, k].transpose(1, 2) + N[:, k]
        dp = fma(half[:, k], dt, fma(dv, dt, dp))
        dv = fma(Ra[:, k], dt, dv)
    return dR.contiguous(), dv, dp, cov


def imu_plain(mode: int, accels, gyros, params, dt: float, state0=None):
    """The plain PyTorch version of `imu_scan`."""
    if mode == PROPAGATE:
        return propagate_plain(state0, accels, gyros, params, dt)
    return preintegrate_plain(accels, gyros, params, dt)


def imu_scan(mode: int, accels: torch.Tensor, gyros: torch.Tensor, params: torch.Tensor,
             dt: float, state0: torch.Tensor | None = None):
    """B IMU windows of T samples, accels and gyros (B, T, 3) float32, with
    params (11,) float32 = accel bias (3), gyro bias (3), accel variance,
    gyro variance, gravity (3) and the sample period dt:

    - mode `PROPAGATE`: the states (B, T, 10) [p, v, q (x, y, z, w)] after
      every sample from state0 (B, 10);
    - mode `PREINTEGRATE`: (dR (B,3,3), dv (B,3), dp (B,3), cov (B,9,9)).

    CPU tensors run `imu_plain`, CUDA tensors one launch of the kernel."""
    if accels.device.type == "cpu":
        return imu_plain(mode, accels, gyros, params, dt, state0)
    if accels.device.type != "cuda":
        raise ValueError(f"imu_scan: unsupported device {accels.device}")
    if mode not in (PROPAGATE, PREINTEGRATE):
        raise ValueError(f"imu_scan: unknown mode {mode}")
    dev = accels.device
    if accels.dim() != 3:
        raise ValueError("imu_scan: accels must be (B, T, 3)")
    b, n = accels.shape[:2]
    if b < 1 or n < 1:
        raise ValueError(f"imu_scan: {b} windows of {n} samples")
    fn = "imu_scan"
    build.check_arg(fn, "accels", accels, (b, n, 3), torch.float32, dev)
    build.check_arg(fn, "gyros", gyros, (b, n, 3), torch.float32, dev)
    build.check_arg(fn, "params", params, (PARAMS,), torch.float32, dev)
    f = dict(dtype=torch.float32, device=dev)
    if mode == PROPAGATE:
        if state0 is None:
            raise ValueError("imu_scan: propagate needs state0 (B, 10)")
        build.check_arg(fn, "state0", state0, (b, STATE), torch.float32, dev)
        traj = torch.empty((b, n, STATE), **f)
        outs = (traj, None, None, None)
    else:
        outs = (torch.empty((b, 3, 3), **f), torch.empty((b, 3), **f), torch.empty((b, 3), **f),
                torch.empty((b, 9, 9), **f))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = build.bind("imu", fn, _ARGTYPES)
    with build.traced(fn):
        code = lib.imu_scan(
            dev.index or 0, int(mode), b, n, accels.data_ptr(), gyros.data_ptr(),
            params.data_ptr(), ptr(state0), float(dt), *(ptr(o) for o in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "imu_scan launch")
    imu_scan.launches += 1
    return outs[0] if mode == PROPAGATE else outs


imu_scan.launches = 0
