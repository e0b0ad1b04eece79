"""Sparse PnP pose estimation: port of `rgbd_odometry_tpu/solvers/pnp.py`.

The reference's Gauss-Newton PnP on normalized-plane residuals
(`SolvePnP::PnP`, src/SolvePnP.cpp:148-203: 5 fixed iterations,
right-multiplied exponential update) and the `cv::solvePnPRansac` stage of
`PnPOdometry::pnpEstimation` (src/PnPOdometry.cpp:537-592) with every
hypothesis solved at once. On CUDA tensors the whole RANSAC (the
hypotheses and the winner's refine) is one launch of the hand-written
kernel in `kernels/pnp_gn.py`, and `gn_pnp` is one launch of its batched
Gauss-Newton kernel. The random subsets come from an (S, K) tensor of
uniforms in [0, 1) given by the caller. The chessboard front end
(`chessboard_object_points`, `find_chessboard`) is the reference's input
path (src/SolvePnP.cpp:97-140).
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_odometry_tpu_torch.kernels import pnp_gn as _kernel
from rgbd_odometry_tpu_torch.kernels.pnp_gn import RansacResult, point_terms


def normalized_residuals(obj_pts, im_pts_norm, R, t, valid):
    """r_i = u_norm_i - dehom(R^T (P_i - t)) (K, 2), zeroed where not valid
    (`computeResidue`, SolvePnP.cpp:298-323), for one pose R (3,3), t (3,)."""
    r0, r1, _, _ = point_terms(obj_pts, im_pts_norm, R[None], t[None])
    r = torch.stack([r0[0], r1[0]], dim=-1)
    return torch.where(valid[:, None], r, torch.zeros_like(r))


def gn_pnp_step(obj_pts, im_pts_norm, R, t, valid):
    """One Gauss-Newton iteration of `SolvePnP::PnP` (:156-194) for one pose:
    (R, t) updated, and the pre-update residual norm (`gn_pnp` of one
    iteration)."""
    R2, t2, rn = gn_pnp(obj_pts, im_pts_norm, valid, R, t, iterations=1)
    return R2, t2, rn[0]


def gn_pnp(obj_pts, im_pts_norm, valid, R0=None, t0=None, iterations: int = 5):
    """Fixed-iteration GN PnP (5 iterations as the reference, :156) on the
    points of valid (K,) bool from (R0, t0) (None: the identity): (R, t,
    residual norm before each iteration (iterations,)). On CUDA tensors one
    launch of the `pnp_gn` kernel (B = 1) and no other device work, its
    plain version on CPU tensors."""
    dev = obj_pts.device
    f32 = dict(dtype=torch.float32, device=dev)
    R0 = None if R0 is None else R0.to(**f32)[None].contiguous()
    t0 = None if t0 is None else t0.to(**f32)[None].contiguous()
    rn = torch.empty((1, iterations), **f32)
    mask = valid.to(device=dev, dtype=torch.bool).contiguous()
    R, t, _, _ = _kernel.pnp_gn(obj_pts.contiguous(), im_pts_norm.contiguous(), mask[None],
                                R0, t0, iterations, 0.0, mask, rnorm_out=rn)
    return R[0], t[0], rn[0]


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
    with the largest u[s] (u (S, K) uniforms; S hypotheses; ties to the lower
    index), every hypothesis is scored by its inliers (error < inlier_thresh
    on the normalized plane, ~5 px at fx = 500), and the first best is
    refined on its inliers (cv::solvePnPRansac with an initial guess,
    PnPOdometry.cpp:571)."""
    return _kernel.ransac_pnp(u, obj_pts, im_pts_norm, valid, sample_size, inlier_thresh,
                              hypothesis_iters, refine_iters, R0, t0)


# ----------------------------------------------------------------------
# Chessboard front end (SolvePnP's input path)
# ----------------------------------------------------------------------


def chessboard_object_points(rows: int = 6, cols: int = 9, square: float = 1.0) -> np.ndarray:
    """The planar chessboard model of the reference's 9x6 board
    (`getChessBoardPts`, SolvePnP.cpp:97-140): (rows cols, 3) float32 corners
    on the z = 0 plane, row-major."""
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    return np.stack([xs.reshape(-1) * square, ys.reshape(-1) * square, np.zeros(rows * cols)],
                    -1).astype(np.float32)


def find_chessboard(gray_u8, rows: int = 6, cols: int = 9):
    """Chessboard corners of an 8-bit image by OpenCV's
    `findChessboardCorners` (the reference's detector, SolvePnP.cpp:108):
    (rows cols, 2) float pixel corners, or None when the board is not
    found. OpenCV is imported here, at the call: without it this raises
    ImportError; nothing else of the port needs it."""
    import cv2

    found, corners = cv2.findChessboardCorners(np.asarray(gray_u8).astype("uint8"), (cols, rows))
    if not found:
        return None
    return np.asarray(corners).reshape(-1, 2)
