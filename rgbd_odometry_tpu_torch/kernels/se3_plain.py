"""Plain PyTorch twins of the device functions of `csrc/se3.cuh`.

Each function performs the device function's float32 operations in its
order, element by element on (B,) tensors held in nested lists (a 6x6 or
3x3 matrix is a list of rows, a vector a list), each operation rounded once:
square roots correctly rounded, sin and cos taken in float64 and rounded
once, nothing fused. The kernels that call the device functions
(`pnp_gn.cu`, `level_lm.cu`) and the plain versions that call these twins
therefore take the same steps. The math is that of `ops/linalg6.chol_solve6`
(1e-20 pivot floor), `core/geometry` (`se3_exp`, `compose`,
`rotationize_newton`) and the Levenberg-Marquardt step of the level solver
(`kernels/level_lm.lm_psi`).
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def chol_solve6(H, g):
    """Solve H x = g, H a 6x6 nested list of (B,) tensors, g a list of 6, by
    the port's `ops/linalg6.chol_solve6` factorization (1e-20 pivot floor),
    element by element in the kernel's order."""
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = []
        for r in range(j, 6):
            acc = torch.zeros_like(g[0])
            for c in range(j):
                acc = acc + L[r][c] * L[j][c]
            s.append(H[r][j] - acc)
        d = sqrt(torch.clamp(s[0], min=1e-20))
        L[j][j] = d
        inv = torch.reciprocal(d)
        for r in range(j + 1, 6):
            L[r][j] = s[r - j] * inv
    y = [None] * 6
    for i in range(6):
        acc = torch.zeros_like(g[0])
        for c in range(i):
            acc = acc + L[i][c] * y[c]
        y[i] = (g[i] - acc) / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        acc = torch.zeros_like(g[0])
        for c in range(i + 1, 6):
            acc = acc + L[c][i] * x[c]
        x[i] = (y[i] - acc) / L[i][i]
    return x


def mat3(A, B):
    """A B of two 3x3 nested lists."""
    return [[A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j] for j in range(3)]
            for i in range(3)]


def mat3_tn(A, B):
    """A^T B of two 3x3 nested lists."""
    return [[A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j] for j in range(3)]
            for i in range(3)]


def se3_exp(psi):
    """Twist [v, w] (six (B,) tensors) -> (R 3x3, t 3) nested lists, the
    port's `core/geometry.se3_exp` written element by element."""
    v, w = psi[:3], psi[3:]
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = sqrt(theta2 + 1e-16)
    small = theta2 < 1e-8
    sin = torch.sin(theta.double()).float()
    cos = torch.cos(theta.double()).float()
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - sin) / (theta2 * theta))
    z = torch.zeros_like(theta2)
    W = [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]
    WW = mat3(W, W)
    eye = [[torch.ones_like(z) if i == j else z for j in range(3)] for i in range(3)]
    R = [[eye[i][j] + a * W[i][j] + b * WW[i][j] for j in range(3)] for i in range(3)]
    V = [[eye[i][j] + b * W[i][j] + c * WW[i][j] for j in range(3)] for i in range(3)]
    t = [V[i][0] * v[0] + V[i][1] * v[1] + V[i][2] * v[2] for i in range(3)]
    return R, t


def compose(R, t, xR, xt):
    """(R xR, t + R xt): the right-multiplied update of `core/geometry.
    compose`, for 3x3 / 3 nested lists."""
    tn = [t[i] + (R[i][0] * xt[0] + R[i][1] * xt[1] + R[i][2] * xt[2]) for i in range(3)]
    return mat3(R, xR), tn


def rotationize_newton(X, iters: int = 3):
    """Newton-Schulz X <- X (1.5 I - 0.5 X^T X), `iters` steps, on a 3x3
    nested list (`core/geometry.rotationize_newton`)."""
    for _ in range(iters):
        M = mat3_tn(X, X)
        Y = [[(1.5 if i == j else 0.0) - 0.5 * M[i][j] for j in range(3)] for i in range(3)]
        X = mat3(X, Y)
    return X


def norm6(psi):
    """|psi| of six (B,) tensors: the squares summed in order, then a
    correctly rounded square root."""
    acc = psi[0] * psi[0]
    for p in psi[1:]:
        acc = acc + p * p
    return sqrt(acc)


def trust_region(psi, radius: float):
    """psi (six (B,) tensors) scaled back onto the ball |psi| <= radius."""
    n = norm6(psi)
    scale = torch.where(n > radius, radius / torch.clamp(n, min=1e-30), torch.ones_like(n))
    return [p * scale for p in psi]


def lm_damped(H, lam):
    """H + lam diag(max(diag H, 1e-8)) of a 6x6 nested list and (B,) lam."""
    return [[H[i][j] + lam * torch.clamp(H[i][j], min=1e-8) if i == j else H[i][j]
             for j in range(6)] for i in range(6)]


def lm_psi(H, g, lam, radius: float):
    """The Levenberg-Marquardt step -(H + lam diag H)^-1 g projected onto
    the trust region, on nested lists; returns six (B,) tensors."""
    return trust_region([-x for x in chol_solve6(lm_damped(H, lam), g)], radius)


def to_rows(x: torch.Tensor):
    """(B, n) or (B, n, m) tensor -> nested lists of (B,) tensors."""
    if x.dim() == 2:
        return [x[:, i] for i in range(x.shape[1])]
    return [[x[:, i, j] for j in range(x.shape[2])] for i in range(x.shape[1])]


def from_rows(rows) -> torch.Tensor:
    """Inverse of `to_rows`."""
    if torch.is_tensor(rows[0]):
        return torch.stack(rows, -1)
    return torch.stack([torch.stack(r, -1) for r in rows], -2)
