"""SO(3)/SE(3) operations on float32 tensors with arbitrary leading dims.

Port of `rgbd_odometry_tpu/core/geometry.py` (the subset the production
edge-DVO path runs). Conventions are the same: a twist ``psi`` is
``[v, omega]`` (translation first), ``se3_exp(psi) -> (R, t)`` with
``R = exp(hat(omega))`` and ``t = V(omega) v``.
"""

from __future__ import annotations

import torch

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


def _sinc_coeffs(theta2: torch.Tensor, small_thresh: float = 1e-8):
    """Taylor-safe (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with
    the JAX package's 1e-8 threshold on theta^2 (see its docstring for why
    callers that divide by B need 1e-3 instead)."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < small_thresh
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    return a, b, c


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    a, b, _ = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


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
