"""SO(3)/SE(3) operations on float32 tensors with arbitrary leading dims.

Port of `rgbd_odometry_tpu/core/geometry.py` (the subset the edge-DVO
solvers, the trajectory files and the motion model run). Conventions are the
same: a twist ``psi`` is ``[v, omega]`` (translation first),
``se3_exp(psi) -> (R, t)`` with ``R = exp(hat(omega))`` and
``t = V(omega) v``; quaternions are (x, y, z, w).
"""

from __future__ import annotations

import torch

from rgbd_odometry_tpu_torch.device import resolve_device

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn (sin, cos, arccos) of float32 `x` taken in float64 and rounded once
    to float32: the correctly rounded values XLA computes. torch's
    vectorized float32 sin/cos are not always correctly rounded, and in
    float32 (1 - cos t)/t^2 and (t - sin t)/t^3 cancel catastrophically for
    small t, so a one-ulp difference in cos moves se3_exp's result by ~1e-7:
    enough to take another floor pixel decision somewhere along a
    sub-gradient trajectory."""
    return fn(x.to(torch.float64)).to(x.dtype)


def _sinc_coeffs(theta2: torch.Tensor, small_thresh: float = 1e-8):
    """Taylor-safe (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with
    the JAX package's 1e-8 threshold on theta^2 (see its docstring for why
    callers that divide by B need 1e-3 instead)."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < small_thresh
    sin, cos = _rounded(torch.sin, theta), _rounded(torch.cos, theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - sin) / (theta2 * theta))
    return a, b, c


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    a, b, _ = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3): (..., 3, 3) -> (..., 3), with the JAX version's
    three branches: Taylor below theta ~1.4e-3 (cos theta > 1 - 1e-6), the
    generic theta / (2 sin theta) vee(R - R^T), and near pi (cos theta <
    -(1 - 5e-7)) the axis from the diagonal of (R + R^T)/2 - cos theta I,
    signed from its off-diagonals."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_theta > 1.0 - 1e-6
    near_pi = cos_theta < -(1.0 - 5e-7)
    theta = _rounded(torch.arccos, torch.where(small, torch.zeros_like(cos_theta), cos_theta))
    sin_theta = _rounded(torch.sin, theta)
    w_asym = vee(R - R.transpose(-1, -2))
    safe_sin = torch.where(torch.abs(sin_theta) < _EPS, torch.ones_like(sin_theta), sin_theta)
    generic = 0.5 * theta[..., None] / safe_sin[..., None] * w_asym
    tt = 2.0 * (1.0 - cos_theta)  # theta^2 + O(theta^4)
    taylor = 0.5 * (1.0 + tt[..., None] / 6.0) * w_asym
    B = 0.5 * (R + R.transpose(-1, -2)) - cos_theta[..., None, None] * _eye_like(R)
    denom = torch.clamp(1.0 - cos_theta, min=_EPS)[..., None]
    axis2 = torch.clamp(torch.diagonal(B, dim1=-2, dim2=-1) / denom, min=0.0)
    axis = torch.sqrt(axis2)
    s01, s02, s12 = torch.sign(B[..., 0, 1]), torch.sign(B[..., 0, 2]), torch.sign(B[..., 1, 2])
    i_max = torch.argmax(axis2, dim=-1)
    one = torch.ones_like(s01)
    sign_for = torch.stack(
        [
            torch.where(i_max == 0, one, torch.where(i_max == 1, s01, s02)),
            torch.where(i_max == 1, one, torch.where(i_max == 0, s01, s12)),
            torch.where(i_max == 2, one, torch.where(i_max == 0, s02, s12)),
        ],
        dim=-1,
    )
    sign_for = torch.where(sign_for == 0.0, torch.ones_like(sign_for), sign_for)
    pi_branch = theta[..., None] * axis * sign_for
    out = torch.where(small[..., None], taylor, generic)
    return torch.where(near_pi[..., None], pi_branch, out)


def se3_exp(psi: torch.Tensor):
    """Twist [v, omega] (..., 6) -> (R (..., 3, 3), t (..., 3))."""
    v = psi[..., :3]
    w = psi[..., 3:]
    a, b, c = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    WW = W @ W
    eye = _eye_like(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> twist [v, omega], the inverse of `se3_exp`. V^-1 uses the
    1e-3 threshold on theta^2 (this path divides by B; see `_sinc_coeffs`)."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2, small_thresh=1e-3)
    W = hat(w)
    theta2_safe = torch.clamp(theta2, min=_EPS * _EPS)
    coef = torch.where(
        theta2 < 1e-3, 1.0 / 12.0 + theta2 / 720.0, (1.0 - a / (2.0 * b)) / theta2_safe
    )
    Vinv = _eye_like(W) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def compose(R1, t1, R2, t2):
    """(R1, t1) o (R2, t2): global = lastKey o rel."""
    return R1 @ R2, t1 + (R1 @ t2[..., None])[..., 0]


def inverse(R, t):
    """(R, t)^-1 = (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def rotationize_newton(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Newton-Schulz polar iteration X <- X (1.5 I - 0.5 X^T X), 3 steps: the
    orthonormalization the production profile applies after every update."""
    eye = _eye_like(R)
    X = R
    for _ in range(iters):
        X = X @ (1.5 * eye - 0.5 * (X.transpose(-1, -2) @ X))
    return X


def rotationize_svd(R: torch.Tensor) -> torch.Tensor:
    """The reference's exact projection onto O(3) (JAX `rotationize_svd`):
    R = U S V^T, each singular value replaced by its sign (+1 where it is
    positive, -1 where it is not), U sign(S) V^T. A reflection keeps its
    determinant of -1, as in JAX. On the card the SVD of a (..., 3, 3)
    batch is `torch.linalg.svd`, as JAX leaves it to XLA."""
    U, S, Vh = torch.linalg.svd(R)
    signs = torch.where(S > 0, 1.0, -1.0).to(R.dtype)
    return (U * signs[..., None, :]) @ Vh


def rotationize(R: torch.Tensor, method: str = "newton") -> torch.Tensor:
    """`rotationize_svd` for method "svd", else `rotationize_newton` (JAX
    `rotationize`)."""
    if method == "svd":
        return rotationize_svd(R)
    return rotationize_newton(R)


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> unit quaternion (x, y, z, w): the JAX version's four
    cases (w when the trace is positive, else the largest diagonal)."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    trace = m[0][0] + m[1][1] + m[2][2]

    def _s(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s = _s(trace + 1.0)
    qw = torch.stack([(m[2][1] - m[1][2]) / s, (m[0][2] - m[2][0]) / s,
                      (m[1][0] - m[0][1]) / s, 0.25 * s], -1)
    s = _s(1.0 + m[0][0] - m[1][1] - m[2][2])
    qx = torch.stack([0.25 * s, (m[0][1] + m[1][0]) / s, (m[0][2] + m[2][0]) / s,
                      (m[2][1] - m[1][2]) / s], -1)
    s = _s(1.0 + m[1][1] - m[0][0] - m[2][2])
    qy = torch.stack([(m[0][1] + m[1][0]) / s, 0.25 * s, (m[1][2] + m[2][1]) / s,
                      (m[0][2] - m[2][0]) / s], -1)
    s = _s(1.0 + m[2][2] - m[0][0] - m[1][1])
    qz = torch.stack([(m[0][2] + m[2][0]) / s, (m[1][2] + m[2][1]) / s, 0.25 * s,
                      (m[1][0] - m[0][1]) / s], -1)
    use_w = trace > 0.0
    use_x = (~use_w) & (m[0][0] >= m[1][1]) & (m[0][0] >= m[2][2])
    use_y = (~use_w) & (~use_x) & (m[1][1] >= m[2][2])
    out = torch.where(use_w[..., None], qw, torch.where(
        use_x[..., None], qx, torch.where(use_y[..., None], qy, qz)))
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) (..., 4) -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def identity_pose(dtype=torch.float32, batch_shape: tuple = (), device=None):
    """(R, t) = (I, 0) with leading dims `batch_shape`, on `device`
    (default: the current CUDA device, `resolve_device`)."""
    device = resolve_device(device)
    R = torch.eye(3, dtype=dtype, device=device).expand(batch_shape + (3, 3)).clone()
    return R, torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
