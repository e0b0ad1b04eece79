"""Sparse PnP pose estimation: port of `rgbd_odometry_tpu/solvers/pnp.py`.

The reference's Gauss-Newton PnP on normalized-plane residuals
(`SolvePnP::PnP`, src/SolvePnP.cpp:148-203: 5 fixed iterations,
right-multiplied exponential update) and the `cv::solvePnPRansac` stage of
`PnPOdometry::pnpEstimation` (src/PnPOdometry.cpp:537-592) with every
hypothesis solved at once. On CUDA tensors both RANSAC phases (the
hypotheses and the winner's refine) are one launch each of the hand-written
kernel in `kernels/pnp_gn.py`. The random subsets come from an (S, K)
tensor of uniforms in [0, 1) given by the caller.

Not ported yet: the chessboard front-end (ROADMAP.md Queue 1, items 8/9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_odometry_tpu_torch.kernels import pnp_gn as _kernel
from rgbd_odometry_tpu_torch.kernels.pnp_gn import point_terms


class RansacResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (K,) bool
    num_inliers: torch.Tensor  # () int32
    best_hypothesis: torch.Tensor  # () int64


def normalized_residuals(obj_pts, im_pts_norm, R, t, valid):
    """r_i = u_norm_i - dehom(R^T (P_i - t)) (K, 2), zeroed where not valid
    (`computeResidue`, SolvePnP.cpp:298-323), for one pose R (3,3), t (3,)."""
    r0, r1, _, _ = point_terms(obj_pts, im_pts_norm, R[None], t[None])
    r = torch.stack([r0[0], r1[0]], dim=-1)
    return torch.where(valid[:, None], r, torch.zeros_like(r))


def gn_pnp_step(obj_pts, im_pts_norm, R, t, valid):
    """One Gauss-Newton iteration of `SolvePnP::PnP` (:156-194) for one pose:
    (R, t) updated, and the pre-update residual norm."""
    rn = torch.linalg.vector_norm(normalized_residuals(obj_pts, im_pts_norm, R, t, valid))
    R2, t2 = _kernel.gn_step_plain(obj_pts, im_pts_norm, R[None], t[None], valid[None])
    return R2[0], t2[0], rn


def gn_pnp(obj_pts, im_pts_norm, valid, R0=None, t0=None, iterations: int = 5):
    """Fixed-iteration GN PnP (5 iterations as the reference, :156): (R, t,
    residual norm before each iteration (iterations,))."""
    dev = obj_pts.device
    R = torch.eye(3, dtype=torch.float32, device=dev) if R0 is None else R0
    t = torch.zeros(3, dtype=torch.float32, device=dev) if t0 is None else t0
    norms = []
    for _ in range(iterations):
        R, t, rn = gn_pnp_step(obj_pts, im_pts_norm, R, t, valid)
        norms.append(rn)
    return R, t, torch.stack(norms)


def normalize_image_points(im_pts: torch.Tensor, intr) -> torch.Tensor:
    """K^-1 applied to pixel points (SolvePnP.cpp:311-313)."""
    return torch.stack([(im_pts[..., 0] - intr.cx) / intr.fx,
                        (im_pts[..., 1] - intr.cy) / intr.fy], dim=-1)


def ransac_pnp(
    u: torch.Tensor,
    obj_pts: torch.Tensor,
    im_pts_norm: torch.Tensor,
    valid: torch.Tensor,
    sample_size: int = 4,
    inlier_thresh: float = 0.01,
    hypothesis_iters: int = 4,
    refine_iters: int = 5,
    R0=None,
    t0=None,
) -> RansacResult:
    """RANSAC PnP: hypothesis s solves GN from the `sample_size` valid points
    with the largest u[s] (u (S, K) uniforms; S hypotheses), every hypothesis
    is scored by its inliers (error < inlier_thresh on the normalized plane,
    ~5 px at fx = 500), and the first best is refined on its inliers
    (cv::solvePnPRansac with an initial guess, PnPOdometry.cpp:571)."""
    s, _ = u.shape
    dev = obj_pts.device
    R0 = torch.eye(3, dtype=torch.float32, device=dev) if R0 is None else R0
    t0 = torch.zeros(3, dtype=torch.float32, device=dev) if t0 is None else t0
    scores = u + torch.where(valid, 1.0, -1.0).to(u.dtype)
    sel = torch.topk(scores, sample_size, dim=-1).indices
    sub = torch.zeros_like(u, dtype=torch.bool).scatter_(1, sel, True) & valid
    obj, imn = obj_pts.contiguous(), im_pts_norm.contiguous()
    Rs, ts, counts, inl = _kernel.pnp_gn(
        obj, imn, sub, R0.expand(s, 3, 3).contiguous(), t0.expand(s, 3).contiguous(),
        hypothesis_iters, inlier_thresh, valid, write_inliers=True,
    )
    best = torch.argmax(counts)
    inliers = inl[best]
    R_f, t_f, _, _ = _kernel.pnp_gn(
        obj, imn, inliers[None].contiguous(), Rs[best][None].contiguous(),
        ts[best][None].contiguous(), refine_iters, inlier_thresh, valid,
    )
    return RansacResult(R=R_f[0], t=t_f[0], inliers=inliers, num_inliers=counts[best],
                        best_hypothesis=best)
