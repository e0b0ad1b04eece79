"""Epipolar match filtering, 8-point fundamental-matrix RANSAC: port of
`rgbd_odometry_tpu/ops/epipolar.py` (the counterpart of the reference's
`PnPOdometry::ransacTest`, src/PnPOdometry.cpp:500-535).

`ransac_fundamental_filter` sends CUDA tensors to kernel D
(`kernels/epipolar.fundamental_ransac`: the whole filter in one launch,
Jacobi eigensolvers in float64) and CPU tensors to the plain version
`ransac_fundamental_filter_plain`: all hypotheses at once, each drawing 8
valid correspondences, the Hartley-normalized 8-point system solved as the
smallest eigenvector of the 9x9 normal matrix (batched `torch.linalg.eigh`),
rank 2 by a batched 3x3 SVD, the Sampson scores; the best hypothesis's
inliers are the filter's output. Both take each sample by `lax.top_k`'s
rule, ties to the lower index (`kernels/pnp_gn.select_sample`; `torch.topk`
does not keep it). The random draws come in as an (S, K) tensor of
uniforms in [0, 1), so that a caller (or a test replaying another
generator) decides them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rgbd_odometry_tpu_torch.kernels.epipolar import fundamental_ransac
from rgbd_odometry_tpu_torch.kernels.pnp_gn import select_sample


class EpipolarFilterResult(NamedTuple):
    inliers: torch.Tensor  # (K,) bool
    num_inliers: torch.Tensor  # () int32
    F: torch.Tensor  # (3, 3) best fundamental matrix (pixel coords)


def _hartley_normalize(uv: torch.Tensor, valid: torch.Tensor):
    """Similarity T giving the valid points zero centroid and RMS radius
    sqrt(2): (uv normalized (K,2), T (3,3))."""
    w = valid.to(uv.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mu = (uv * w[:, None]).sum(0) / n
    d = torch.sqrt((((uv - mu) ** 2).sum(-1) * w).sum() / n)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-8)
    uvn = (uv - mu) * s
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mu[0]]),
        torch.stack([zero, s, -s * mu[1]]),
        torch.stack([zero, zero, one]),
    ])
    return uvn, T


def _eight_point(uv1n: torch.Tensor, uv2n: torch.Tensor, weights: torch.Tensor):
    """Weighted 8-point solves, (S, K) weights -> (S, 3, 3): f = the
    eigenvector of the smallest eigenvalue of A^T W A, rows of A encoding
    x2^T F x1 = 0."""
    u1, v1 = uv1n[:, 0], uv1n[:, 1]
    u2, v2 = uv2n[:, 0], uv2n[:, 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)],
                    dim=-1)  # (K, 9)
    N = torch.einsum("ski,kj->sij", weights[..., None] * A, A)
    _, evecs = torch.linalg.eigh(N)
    return evecs[..., :, 0].reshape(-1, 3, 3)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    """Project F (..., 3, 3) to rank 2 (zero the smallest singular value)."""
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vh


def sampson_distance(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """First-order geometric epipolar error of (K, 2) pairs under F (..., 3,
    3) -> (..., K)."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=-1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], dim=-1)
    Fx1 = x1 @ F.transpose(-1, -2)  # F x1
    Ftx2 = x2 @ F  # F^T x2
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _pass_through(uv1: torch.Tensor, valid: torch.Tensor) -> EpipolarFilterResult:
    """Fewer than 8 match slots: every candidate passes (JAX's static guard)."""
    return EpipolarFilterResult(
        inliers=valid, num_inliers=valid.sum(dtype=torch.int32),
        F=torch.zeros((3, 3), dtype=uv1.dtype, device=uv1.device),
    )


def hypotheses_plain(u, uv1, uv2, valid, threshold_px: float = 3.0):
    """The plain version's hypotheses: (F (S, 3, 3), inlier counts (S,)
    int32), K >= 8."""
    uv1n, T1 = _hartley_normalize(uv1, valid)
    uv2n, T2 = _hartley_normalize(uv2, valid)
    thr2 = threshold_px * threshold_px
    w = select_sample(u, valid, 8)
    Fn = _eight_point(uv1n, uv2n, w.to(uv1.dtype))
    Fs = _rank2(T2.T @ Fn @ T1)  # back to pixel coordinates
    counts = (valid & (sampson_distance(Fs, uv1, uv2) < thr2)).sum(-1, dtype=torch.int32)
    return Fs, counts


def ransac_fundamental_filter_plain(u, uv1, uv2, valid, threshold_px: float = 3.0,
                                    min_points: int = 8) -> EpipolarFilterResult:
    """The plain version of `ransac_fundamental_filter` (any device)."""
    if uv1.shape[0] < 8:
        return _pass_through(uv1, valid)
    Fs, counts = hypotheses_plain(u, uv1, uv2, valid, threshold_px)
    F_b = Fs[torch.argmax(counts)]
    inliers = valid & (sampson_distance(F_b, uv1, uv2) < threshold_px * threshold_px)
    enough = valid.sum() >= min_points
    inliers = torch.where(enough, inliers, valid)
    return EpipolarFilterResult(inliers=inliers, num_inliers=inliers.sum(dtype=torch.int32),
                                F=F_b)


def ransac_fundamental_filter(
    u: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    threshold_px: float = 3.0,
    min_points: int = 8,
) -> EpipolarFilterResult:
    """RANSAC F-matrix inlier filter over matched pairs uv1 (K,2) (now) and
    uv2 (K,2) (ref) with candidate mask valid (K,). `u` (S, K) holds the
    uniforms of the S hypotheses' draws. `threshold_px` is the reference's
    distance=3 (src/PnPOdometry.cpp:463). With fewer than 8 match slots, or
    fewer than `min_points` valid matches, every candidate passes. CPU
    tensors run the plain version, CUDA tensors kernel D (one launch, no
    host sync); any other device raises."""
    if uv1.device.type == "cpu":
        return ransac_fundamental_filter_plain(u, uv1, uv2, valid, threshold_px, min_points)
    if uv1.device.type != "cuda":
        raise ValueError(f"ransac_fundamental_filter: unsupported device {uv1.device}")
    if uv1.shape[0] < 8:
        return _pass_through(uv1, valid)
    inliers, num, F, _ = fundamental_ransac(u.contiguous(), uv1.contiguous(), uv2.contiguous(),
                                            valid.contiguous(), threshold_px, min_points)
    return EpipolarFilterResult(inliers=inliers, num_inliers=num, F=F)
