"""Kernel D: the 8-point fundamental-matrix RANSAC in one launch
(`csrc/epipolar.cu`), and its step-by-step twin.

Replaces JAX's `ransac_fundamental_filter` (`rgbd_odometry_tpu/ops/
epipolar.py:91`; XLA, no Pallas kernel: the Hartley normalization, the
vmapped hypotheses :134 with `lax.top_k` :126, `eigh` :62 and the rank-2
`svd` :69, the Sampson scores, `argmax` and the inlier mask). Two entry
points:

- `fundamental_ransac`: CUDA tensors only (any other device raises), one
  launch of a thread-block cluster: a warp a hypothesis, the first best
  count across the cluster, the winner's inlier mask, no host sync.
- `fundamental_ransac_steps`: the twin, PyTorch on any device, which
  performs the kernel's operations in the kernel's order, so that the two
  agree to the last bit on the card (`chip_smoke.py` holds them so).

`ops/epipolar.ransac_fundamental_filter` sends CUDA tensors to the kernel;
CPU tensors keep the plain route over `torch.linalg.eigh` and `svd`.

The arithmetic both perform, every operation rounded once (sqrt and
division correctly rounded, nothing contracted into a fused multiply-add;
on the CPU the twin's square roots come from numpy, `_sqrt64`, so that the
twin gives the same bits on the CPU as on the card):

1. Hartley normalization of each point set over its valid points, in
   float32: the sums as 32 lane sums (lane l adds points l, l + 32, ... in
   order) folded by the tree `red[v] += red[v + s]`, s = 16, ..., 1; mu =
   S / n, d = sqrt(S_r / n), s = sqrt(2) / max(d, 1e-8), uvn = (uv - mu) s.
2. The sample: the 8 largest u + (valid ? 1 : -1), ties to the lower index
   (`lax.top_k`'s rule), taken in that order; its valid points count.
3. The normal matrix N = sum over the sample's valid points, in sample
   order, of a a^T in float32, a = (u2 u1, u2 v1, u2, v2 u1, v2 v1, v2, u1,
   v1, 1) of the normalized pair.
4. Its smallest eigenvector by cyclic Jacobi in float64 on N: the 36 pairs
   in 9 rounds of 4 disjoint pairs (`SCHEDULE9`), a round's rotations
   applied to the columns, then the rows, then each pair's 2x2 block set
   to (app - t apq, 0, 0, aqq + t apq); a sweep starts only while the
   largest off-diagonal |a_ij| exceeds 2^-40 times the largest |a_ii|, at
   most `SWEEPS` sweeps. The eigenvector is the column of V at the first
   smallest diagonal entry.
5. F = T2^T Fn T1 in float64, then rank 2 as F (I - v v^T), v the smallest
   eigenvector of F^T F by the same Jacobi (3 rounds of one pair), rounded
   to float32.
6. The Sampson distance of every valid pair in float32, counted below
   threshold_px^2; the first hypothesis with the largest count; its
   inliers, or every valid pair with fewer than `min_points` valid pairs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rgbd_odometry_tpu_torch.kernels import build

SAMPLE = 8
SWEEPS = 16  # the Jacobi's most sweeps; a sweep starts only while not converged
TOL = 2.0 ** -40  # converged: largest off-diagonal |a_ij| <= TOL x the largest |a_ii|
# the 9x9 Jacobi's rounds: the 36 pairs (p, q), four disjoint pairs a round
# (the circle method over 10 players, the pairs with the 10th dropped)
SCHEDULE9 = (
    ((1, 8), (2, 7), (3, 6), (4, 5)), ((0, 8), (1, 6), (2, 5), (3, 4)),
    ((0, 7), (6, 8), (1, 4), (2, 3)), ((0, 6), (5, 7), (4, 8), (1, 2)),
    ((0, 5), (4, 6), (3, 7), (2, 8)), ((0, 4), (3, 5), (2, 6), (1, 7)),
    ((0, 3), (2, 4), (1, 5), (7, 8)), ((0, 2), (1, 3), (5, 8), (6, 7)),
    ((0, 1), (3, 8), (4, 7), (5, 6)),
)
SCHEDULE3 = (((0, 1),), ((0, 2),), ((1, 2),))
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] + \
    [ctypes.c_void_p] * 5


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's order: lane l adds elements l,
    l + 32, ... one after another, then the tree red[v] += red[v + s] for s
    = 16, 8, 4, 2, 1."""
    k = x.shape[-1]
    pad = (-k) % 32
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, 32)
    acc = torch.zeros_like(xp[..., 0, :])
    for q in range(xp.shape[-2]):
        acc = acc + xp[..., q, :]
    s = 16
    while s:
        acc = acc[..., :s] + acc[..., s : 2 * s]
        s //= 2
    return acc[..., 0]


def _sqrt64(x: torch.Tensor) -> torch.Tensor:
    """float64 sqrt, correctly rounded on every device. On the CPU torch
    takes it from MKL's vector library, which is sometimes 1 ulp off (3 of
    the first 256 rotations of a rendered feature-vo filter), so the CPU's
    comes from numpy (the processor's own square root); CUDA's is exact."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded on every device."""
    return _sqrt64(x.double()).float()


def hartley(uv: torch.Tensor, valid: torch.Tensor):
    """(s, mu_u, mu_v) of step 1 as float32 scalars."""
    zero = torch.zeros_like(uv[:, 0])
    n = torch.clamp(valid.sum().to(torch.float32), min=1.0)
    mu = [_lane_sum(torch.where(valid, uv[:, c], zero)) / n for c in range(2)]
    du, dv = uv[:, 0] - mu[0], uv[:, 1] - mu[1]
    r2 = du * du + dv * dv
    d = _sqrt_f32(_lane_sum(torch.where(valid, r2, zero)) / n)
    s = torch.full_like(d, 2.0 ** 0.5) / torch.clamp(d, min=1e-8)
    return s, mu[0], mu[1]


def _rotations(app, aqq, apq):
    """(c, s, t) of the Jacobi rotation zeroing apq (float64), the identity
    where apq is 0."""
    one = torch.ones_like(apq)
    nz = apq != 0
    tau = (aqq - app) / torch.where(nz, 2.0 * apq, one)
    den = torch.abs(tau) + _sqrt64(one + tau * tau)
    t = torch.where(tau >= 0, one, -one) / den
    c = one / _sqrt64(one + t * t)
    s = t * c
    zero = torch.zeros_like(apq)
    return torch.where(nz, c, one), torch.where(nz, s, zero), torch.where(nz, t, zero)


def jacobi(A: torch.Tensor, schedule) -> torch.Tensor:
    """Cyclic Jacobi of symmetric float64 matrices A (B, n, n) as step 4
    describes; returns (the rotated A, V) with A's diagonal the eigenvalues
    and V's columns the eigenvectors."""
    b, n, _ = A.shape
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(b, n, n).clone()
    eye = torch.eye(n, dtype=torch.bool, device=A.device)
    active = torch.ones(b, dtype=torch.bool, device=A.device)
    for _ in range(SWEEPS):
        off = torch.where(eye, torch.zeros_like(A), A).abs().amax(dim=(1, 2))
        dmax = torch.diagonal(A, dim1=1, dim2=2).abs().amax(dim=1)
        active = active & ~(off <= dmax * TOL)
        if not bool(active.any()):
            break
        A0, V0 = A, V
        for pairs in schedule:
            P = [p for p, _ in pairs]
            Q = [q for _, q in pairs]
            app, aqq, apq = A[:, P, P], A[:, Q, Q], A[:, P, Q]
            c, s, t = _rotations(app, aqq, apq)
            A = A.clone()
            Ap, Aq = A[:, :, P], A[:, :, Q]
            A[:, :, P] = c[:, None, :] * Ap - s[:, None, :] * Aq
            A[:, :, Q] = s[:, None, :] * Ap + c[:, None, :] * Aq
            Ap, Aq = A[:, P, :], A[:, Q, :]
            A[:, P, :] = c[:, :, None] * Ap - s[:, :, None] * Aq
            A[:, Q, :] = s[:, :, None] * Ap + c[:, :, None] * Aq
            A[:, P, P] = app - t * apq
            A[:, Q, Q] = aqq + t * apq
            A[:, P, Q] = 0.0
            A[:, Q, P] = 0.0
            V = V.clone()
            Vp, Vq = V[:, :, P], V[:, :, Q]
            V[:, :, P] = c[:, None, :] * Vp - s[:, None, :] * Vq
            V[:, :, Q] = s[:, None, :] * Vp + c[:, None, :] * Vq
        A = torch.where(active[:, None, None], A, A0)
        V = torch.where(active[:, None, None], V, V0)
    return A, V


def _smallest(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The column of V at the first smallest diagonal entry of A: (B, n)."""
    j = torch.argmin(torch.diagonal(A, dim1=1, dim2=2), dim=1)
    return torch.gather(V, 2, j[:, None, None].expand(-1, V.shape[1], 1))[..., 0]


def _mat_t(Tb: torch.Tensor) -> list:
    """T's nine float64 entries [row][col] as (1,) tensors."""
    return [[Tb[i][j].reshape(1) for j in range(3)] for i in range(3)]


def sampson_f32(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Step 6's Sampson distance of (K,) pairs under float32 F (B, 3, 3):
    (B, K)."""
    u1, v1, u2, v2 = uv1[:, 0], uv1[:, 1], uv2[:, 0], uv2[:, 1]
    f = [[F[:, i, j, None] for j in range(3)] for i in range(3)]
    fx = [(f[i][0] * u1 + f[i][1] * v1) + f[i][2] for i in range(3)]
    ftx = [(f[0][j] * u2 + f[1][j] * v2) + f[2][j] for j in range(2)]
    e = (u2 * fx[0] + v2 * fx[1]) + fx[2]
    den = ((fx[0] * fx[0] + fx[1] * fx[1]) + ftx[0] * ftx[0]) + ftx[1] * ftx[1]
    return (e * e) / torch.clamp(den, min=1e-12)


def sample_order(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(S, 8) indices of each hypothesis's sample in the order step 2 takes
    them: the largest u + (valid ? 1 : -1) first, ties to the lower index."""
    scores = u + torch.where(valid, 1.0, -1.0).to(u.dtype)
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :SAMPLE]


def _normal(u, uv1, uv2, valid):
    """Steps 1-3: (N (S, 9, 9) float32, uv1's and uv2's (s, mu_u, mu_v))."""
    s_n, _ = u.shape
    s1, mu1u, mu1v = hartley(uv1, valid)
    s2, mu2u, mu2v = hartley(uv2, valid)
    uvn1 = torch.stack([(uv1[:, 0] - mu1u) * s1, (uv1[:, 1] - mu1v) * s1], -1)
    uvn2 = torch.stack([(uv2[:, 0] - mu2u) * s2, (uv2[:, 1] - mu2v) * s2], -1)
    sel = sample_order(u, valid)
    a1, a2, w = uvn1[sel], uvn2[sel], valid[sel]  # (S, 8, 2), (S, 8)
    u1, v1, u2, v2 = a1[..., 0], a1[..., 1], a2[..., 0], a2[..., 1]
    a = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], -1)
    N = torch.zeros((s_n, 9, 9), dtype=torch.float32, device=u.device)
    for r in range(SAMPLE):
        N = torch.where(w[:, r, None, None], N + a[:, r, :, None] * a[:, r, None, :], N)
    return N, (s1, mu1u, mu1v), (s2, mu2u, mu2v)


def normal_matrices(u, uv1, uv2, valid) -> torch.Tensor:
    """Each hypothesis's normal matrix N (S, 9, 9) float32 (step 3)."""
    return _normal(u, uv1, uv2, valid)[0]


def hypotheses(u, uv1, uv2, valid) -> torch.Tensor:
    """Steps 1-5: every hypothesis's F (S, 3, 3) float32."""
    s_n, _ = u.shape
    N, (s1, mu1u, mu1v), (s2, mu2u, mu2v) = _normal(u, uv1, uv2, valid)
    A, V = jacobi(N.double(), SCHEDULE9)
    Fn = _smallest(A, V).reshape(s_n, 3, 3)
    z = torch.zeros_like(s1)
    T1 = _mat_t(torch.stack([s1, z, -(s1 * mu1u), z, s1, -(s1 * mu1v), z, z, z + 1]).double()
                .reshape(3, 3))
    T2 = _mat_t(torch.stack([s2, z, -(s2 * mu2u), z, s2, -(s2 * mu2v), z, z, z + 1]).double()
                .reshape(3, 3))
    M = [[(Fn[:, k, 0] * T1[0][j] + Fn[:, k, 1] * T1[1][j]) + Fn[:, k, 2] * T1[2][j]
          for j in range(3)] for k in range(3)]
    F = [[(T2[0][i] * M[0][j] + T2[1][i] * M[1][j]) + T2[2][i] * M[2][j] for j in range(3)]
         for i in range(3)]
    G = torch.stack([torch.stack([(F[0][a_] * F[0][b] + F[1][a_] * F[1][b]) + F[2][a_] * F[2][b]
                                  for b in range(3)], -1) for a_ in range(3)], -2)
    A3, V3 = jacobi(G, SCHEDULE3)
    v = _smallest(A3, V3)
    v = [v[:, j] for j in range(3)]
    Fv = [(F[i][0] * v[0] + F[i][1] * v[1]) + F[i][2] * v[2] for i in range(3)]
    Fr = torch.stack([torch.stack([F[i][j] - Fv[i] * v[j] for j in range(3)], -1)
                      for i in range(3)], -2)
    return Fr.float()


def fundamental_ransac_steps(u, uv1, uv2, valid, threshold_px: float = 3.0, min_points: int = 8):
    """The kernel's twin on any device: (inliers (K,) bool, num_inliers ()
    int32, F (3, 3) float32, counts (S,) int32) for S hypotheses drawn from
    u (S, K) over pairs uv1, uv2 (K, 2) float32 with candidate mask valid
    (K,) bool; K >= 8."""
    if uv1.shape[0] < SAMPLE:
        raise ValueError(f"fundamental_ransac_steps: {uv1.shape[0]} match slots, fewer than "
                         f"the sample's {SAMPLE}")
    F = hypotheses(u, uv1, uv2, valid)
    thr2 = torch.tensor(threshold_px * threshold_px, dtype=torch.float32, device=u.device)
    hit = valid[None, :] & (sampson_f32(F, uv1, uv2) < thr2)
    counts = hit.sum(-1, dtype=torch.int32)
    best = torch.argmax(counts)
    inliers = torch.where(valid.sum() >= min_points, hit[best], valid)
    return inliers, inliers.sum(dtype=torch.int32), F[best], counts


def fundamental_ransac(u, uv1, uv2, valid, threshold_px: float = 3.0, min_points: int = 8):
    """One launch of kernel D on CUDA tensors: (inliers (K,) bool,
    num_inliers () int32, F (3, 3) float32, counts (S,) int32), bitwise
    `fundamental_ransac_steps`. u (S, K) float32 uniforms, uv1 and uv2 (K, 2)
    float32, valid (K,) bool, all contiguous; K >= 8, S >= 1."""
    if uv1.device.type != "cuda":
        raise ValueError(f"fundamental_ransac: unsupported device {uv1.device}; the kernel takes "
                         "CUDA tensors (ops/epipolar.ransac_fundamental_filter runs the plain "
                         "route on the CPU)")
    dev = uv1.device
    if u.dim() != 2:
        raise ValueError("fundamental_ransac: u must be (S, K)")
    s, k = u.shape
    if k < SAMPLE or s < 1:
        raise ValueError(f"fundamental_ransac: {s} hypotheses over {k} match slots (the kernel "
                         f"takes S >= 1 and K >= {SAMPLE})")
    fn = "fundamental_ransac"
    build.check_arg(fn, "u", u, (s, k), torch.float32, dev)
    build.check_arg(fn, "uv1", uv1, (k, 2), torch.float32, dev)
    build.check_arg(fn, "uv2", uv2, (k, 2), torch.float32, dev)
    build.check_arg(fn, "valid", valid, (k,), torch.bool, dev)
    inliers = torch.empty((k,), dtype=torch.bool, device=dev)
    num = torch.empty((), dtype=torch.int32, device=dev)
    F = torch.empty((3, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((s,), dtype=torch.int32, device=dev)
    lib = build.bind("epipolar", fn, _ARGTYPES)
    with build.traced(fn):
        code = lib.fundamental_ransac(
            dev.index or 0, u.data_ptr(), uv1.data_ptr(), uv2.data_ptr(), valid.data_ptr(), s, k,
            int(min_points), float(threshold_px * threshold_px), inliers.data_ptr(),
            num.data_ptr(), F.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "fundamental_ransac launch")
    fundamental_ransac.launches += 1
    return inliers, num, F, counts


fundamental_ransac.launches = 0
