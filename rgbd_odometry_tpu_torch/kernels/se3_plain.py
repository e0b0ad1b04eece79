"""Plain PyTorch twins of the device functions of `csrc/se3.cuh` and of
the level solvers' step on a warp (`csrc/warp.cuh`).

Each function performs the device function's float32 operations in its
order, element by element on (B,) tensors held in nested lists (a 6x6 or
3x3 matrix is a list of rows, a vector a list), each operation rounded once:
square roots correctly rounded, sin, cos and arccos taken in float64 and
rounded once, nothing fused. The kernels that call the device functions
(`pnp_gn.cu`, `level_lm.cu`, `level_sg.cu`) and the plain versions that call
these twins therefore take the same steps; on a warp each lane takes the
operations of the value it owns (`tests/test_torch_level_lm.py` and
`tests/test_torch_level_sg.py` hold numpy models of the lanes bitwise
against these twins). The math is that of `ops/linalg6.chol_solve6`
(1e-20 pivot floor), `core/geometry` (`se3_exp`, `compose`,
`rotationize_newton`, `so3_log`, `se3_log`) and the Levenberg-Marquardt step
of the level solver (`kernels/level_lm.lm_psi`).
"""

from __future__ import annotations

import torch


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """fn (sqrt, sin, cos, arccos) taken in float64 and rounded once to
    float32."""
    return fn(x.double()).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return _rounded(torch.sqrt, x)


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
    sin, cos = _rounded(torch.sin, theta), _rounded(torch.cos, theta)
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


def so3_log(R):
    """3x3 nested list -> w (three (B,) tensors): the port's
    `core/geometry.so3_log` written element by element. Three branches:
    Taylor for cos theta > 1 - 1e-6, the generic theta / (2 sin theta)
    vee(R - R^T), and below -(1 - 5e-7) the axis from the diagonal of
    (R + R^T)/2 - cos theta I with the signs from its off-diagonals."""
    one = torch.ones_like(R[0][0])
    zero = torch.zeros_like(one)
    trace = R[0][0] + R[1][1] + R[2][2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos > 1.0 - 1e-6
    near_pi = cos < -(1.0 - 5e-7)
    theta = _rounded(torch.arccos, torch.where(small, zero, cos))
    sin = _rounded(torch.sin, theta)
    asym = [R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]]
    safe_sin = torch.where(torch.abs(sin) < 1e-8, one, sin)
    k_generic = 0.5 * theta / safe_sin
    k_taylor = 0.5 * (1.0 + 2.0 * (1.0 - cos) / 6.0)
    denom = torch.clamp(1.0 - cos, min=1e-8)
    axis2 = [torch.clamp((0.5 * (R[i][i] + R[i][i]) - cos) / denom, min=0.0) for i in range(3)]
    axis = [sqrt(a) for a in axis2]
    s01 = torch.sign(0.5 * (R[0][1] + R[1][0]))
    s02 = torch.sign(0.5 * (R[0][2] + R[2][0]))
    s12 = torch.sign(0.5 * (R[1][2] + R[2][1]))
    # the largest axis component carries the sign +1; the first wins a tie
    max0 = (axis2[0] >= axis2[1]) & (axis2[0] >= axis2[2])
    max1 = ~max0 & (axis2[1] >= axis2[2])
    max2 = ~max0 & ~max1
    sign_for = [
        torch.where(max0, one, torch.where(max1, s01, s02)),
        torch.where(max1, one, torch.where(max0, s01, s12)),
        torch.where(max2, one, torch.where(max0, s02, s12)),
    ]
    out = []
    for i in range(3):
        sgn = torch.where(sign_for[i] == 0.0, one, sign_for[i])
        w = torch.where(small, k_taylor * asym[i], k_generic * asym[i])
        out.append(torch.where(near_pi, theta * axis[i] * sgn, w))
    return out


def se3_log(R, t):
    """(R 3x3, t 3) nested lists -> twist [v, w] (six (B,) tensors), the
    port's `core/geometry.se3_log` written element by element: V^-1 = I -
    W/2 + coef W^2 with coef = 1/12 + theta^2/720 below theta^2 = 1e-3, else
    (1 - a / (2 b)) / theta^2."""
    w = so3_log(R)
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = sqrt(theta2 + 1e-16)
    small = theta2 < 1e-3
    sin, cos = _rounded(torch.sin, theta), _rounded(torch.cos, theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - a / (2.0 * b)) / torch.clamp(theta2, min=1e-16))
    z = torch.zeros_like(theta2)
    W = [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]
    WW = mat3(W, W)
    Vinv = [[(1.0 if i == j else 0.0) - 0.5 * W[i][j] + coef * WW[i][j] for j in range(3)]
            for i in range(3)]
    v = [Vinv[i][0] * t[0] + Vinv[i][1] * t[1] + Vinv[i][2] * t[2] for i in range(3)]
    return v + w


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
    # a tensor over a tensor: torch takes a Python scalar over a tensor as
    # the scalar times the tensor's reciprocal, rounded twice
    scale = torch.where(n > radius, torch.full_like(n, radius) / torch.clamp(n, min=1e-30),
                        torch.ones_like(n))
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
