"""The legacy dense photometric DVO: port of `rgbd_odometry_tpu/solvers/photometric.py`.

The reference's second odometry path (`RGBDOdometry` + `EPoseEstimator` +
`PyramidalStorage`, src/RGBDOdometry.cpp) as the JAX package rebuilt it:
gradient-selected reference points (|gx| >= 5 with valid depth,
RGBDOdometry.cpp:466), the photometric Jacobian and A = J^T J precomputed
once per reference keyframe (`computeJacobianAllLevels`, :363-398),
Gauss-Newton on that fixed A with warp-and-difference residuals
eps = I_ref - I_now(pi(T^-1 X)) (`computeEpsilon`, :602-700) and the update
T <- T exp(psi)^-1 (:566-579), 3 iterations a level on levels 3 then 2,
early exit at |eps| < 200, and the JAX package's options (Huber weights,
reweighting, bilinear sampling, the step clamp, best-iterate tracking).

Extraction (`extract_photo_ref`) runs once a keyframe in plain PyTorch.
`solve_pyramid` on CUDA tensors is one launch of `kernels/level_photo.py`
for the whole pyramid; `photometric_residual` is that kernel's per-point
function in PyTorch. The functions take one frame ((K, ...) references,
(H, W) images) as JAX's do, or B frames ((B, K, ...), (B, H, W)).
`warp_image` renders a frame under a pose for `viz.live`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rgbd_odometry_tpu_torch.core.camera import Intrinsics, backproject_points
from rgbd_odometry_tpu_torch.kernels import level_photo as _kernel
from rgbd_odometry_tpu_torch.kernels.level_photo import PhotoLevel
from rgbd_odometry_tpu_torch.ops.project import fma_f32 as fma


class PhotoRefLevel(NamedTuple):
    """Per-level reference cache: the `PyramidalStorage` equivalent."""

    pts3d: torch.Tensor  # ([B,] K, 3) metres
    intensity: torch.Tensor  # ([B,] K) I_ref at the selected pixels
    J: torch.Tensor  # ([B,] K, 6) photometric Jacobian at the reference pose
    A: torch.Tensor  # ([B,] 6, 6) J^T J plus a tiny damping
    valid: torch.Tensor  # ([B,] K) bool
    count: torch.Tensor  # ([B,]) int32 selected pixels


def extract_photo_ref_level(gray: torch.Tensor, depth_mm: torch.Tensor, intr: Intrinsics,
                            k_max: int, cfg) -> PhotoRefLevel:
    """Select gradient-rich pixels of gray (H, W) or (B, H, W), back-project
    them at depth_mm, precompute J and A. Selection: the forward x-gradient
    >= `cfg.gradient_threshold` (the reference tests the raw x-gradient only,
    :466) and depth > `cfg.min_depth_mm`; the first min(k_max, H W) slots
    hold the selected pixels in raster order, then the rest in raster order
    as invalid padding (the order `lax.top_k` gives 0/1 scores)."""
    single = gray.dim() == 2
    if single:
        gray, depth_mm = gray[None], depth_mm[None]
    b, h, w = gray.shape
    gx = torch.nn.functional.pad(gray[:, :, 1:] - gray[:, :, :-1], (0, 1))
    gy = torch.nn.functional.pad(gray[:, 1:, :] - gray[:, :-1, :], (0, 0, 0, 1))
    sel = ((gx >= cfg.gradient_threshold) & (depth_mm > cfg.min_depth_mm)).reshape(b, -1)
    count = sel.sum(-1, dtype=torch.int32)
    k = min(k_max, h * w)
    # a stable partition: selected first, each part in raster order
    idx = torch.sort(sel.to(torch.uint8), dim=-1, descending=True, stable=True).indices[:, :k]
    valid = torch.gather(sel, 1, idx)
    take = lambda img: torch.gather(img.reshape(b, -1), 1, idx)  # noqa: E731
    ys = (idx // w).to(gray.dtype)
    xs = (idx % w).to(gray.dtype)
    zero = torch.zeros_like(ys)
    pts3d = backproject_points(torch.stack([xs, ys], -1),
                               torch.where(valid, take(depth_mm), torch.full_like(ys, 1000.0)),
                               intr)
    x3, y3, z = pts3d.unbind(-1)
    inten = torch.where(valid, take(gray), zero)
    gxs = torch.where(valid, take(gx), zero)
    gys = torch.where(valid, take(gy), zero)
    # dr/dpsi at the reference pose for T <- T exp(psi)^-1 (see the JAX
    # docstring): dr/dv = -(grad I A1), dr/dw = cross(grad I A1, X')
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    gfx, gfy = gxs * intr.fx, gys * intr.fy
    ga = [gfx / zs, gfy / zs, -(gfx * x3 / zs + gfy * y3 / zs) / zs]
    # cross(ga, X') with the fused multiply-add XLA:CPU contracts
    j_rot = [fma(ga[1], z, -(ga[2] * y3)), fma(ga[2], x3, -(ga[0] * z)),
             fma(ga[0], y3, -(ga[1] * x3))]
    J = torch.stack([-ga[0], -ga[1], -ga[2]] + j_rot, dim=-1)
    J = torch.where(valid[..., None], J, torch.zeros_like(J))
    A = torch.einsum("bni,bnj->bij", J, J)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    A = A + (1e-6 * tr / 6.0)[:, None, None] * torch.eye(6, dtype=A.dtype, device=A.device)
    ref = PhotoRefLevel(pts3d=pts3d, intensity=inten, J=J, A=A, valid=valid, count=count)
    return PhotoRefLevel(*(x[0] for x in ref)) if single else ref


def _snap(c: torch.Tensor, eps: float = 2e-3) -> torch.Tensor:
    """Snap coordinates within eps of an integer onto it before flooring:
    the float32 back-project/reproject round trip moves an integer pixel
    coordinate by ~1e-4, and a raw floor would fall one pixel short for half
    the points (see the JAX docstring)."""
    return _kernel.snap(c, eps)


def _sample_now(gray: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                bilinear: bool = False) -> torch.Tensor:
    """gray (H, W) or (B, H, W) at the snapped (u, v) ((K,) or (B, K)): a floor
    lookup, or bilinear (rows blended first), coordinates clamped to the
    image. Both of JAX's gather modes ("mxu", "take") sample the same
    values; the port has one."""
    single = gray.dim() == 2
    if single:
        gray, u, v = gray[None], u[None], v[None]
    out = _kernel.sample(gray, _snap(u), _snap(v), bilinear)
    return out[0] if single else out


def _levels(ref: PhotoRefLevel, now_gray: torch.Tensor, intr: Intrinsics) -> PhotoLevel:
    """The kernel's batched level of a reference and a now image."""
    if now_gray.dim() == 2:
        ref = PhotoRefLevel(*(x[None] for x in ref))
        now_gray = now_gray[None]
    return PhotoLevel(ref.pts3d.contiguous(), ref.intensity.contiguous(), ref.J.contiguous(),
                      ref.A.contiguous(), ref.valid.contiguous(), now_gray, intr.fx, intr.fy,
                      intr.cx, intr.cy)


def _pose_in(R, t, single: bool, like: torch.Tensor, b: int):
    f = dict(dtype=torch.float32, device=like.device)
    R = torch.eye(3, **f) if R is None else R.to(**f)
    t = torch.zeros(3, **f) if t is None else t.to(**f)
    if single or R.dim() == 2:
        R, t = R.expand(b, 3, 3), t.expand(b, 3)
    return R.contiguous(), t.contiguous()


def photometric_residual(ref: PhotoRefLevel, now_gray: torch.Tensor, intr: Intrinsics, R, t,
                         cfg):
    """(eps, visible): eps_i = I_ref(p_i) - I_now(pi(R^T (X_i - t))), zero
    where the point leaves the frame or is padding (`computeEpsilon`,
    RGBDOdometry.cpp:602-700)."""
    single = now_gray.dim() == 2
    lv = _levels(ref, now_gray, intr)
    R, t = _pose_in(R, t, single, now_gray, lv.pts.shape[0])
    eps, visible = _kernel.point_residuals(R, t, lv, cfg.bilinear)
    return (eps[0], visible[0]) if single else (eps, visible)


def solve_level(ref: PhotoRefLevel, now_gray: torch.Tensor, intr: Intrinsics, R0, t0, cfg):
    """`cfg.iterations_per_level` Gauss-Newton iterations at one level
    (`gaussNewtonIterations`, RGBDOdometry.cpp:514-597): (best R, best t,
    |eps| before each iteration); a pyramid of one level."""
    single = now_gray.dim() == 2
    lv = _levels(ref, now_gray, intr)
    R0, t0 = _pose_in(R0, t0, single, now_gray, lv.pts.shape[0])
    R, t, hist = _kernel.level_photo(R0, t0, (lv,), cfg)
    return (R[0], t[0], hist[0, 0]) if single else (R, t, hist[:, 0])


def solve_pyramid(ref_levels: Tuple[PhotoRefLevel, ...], now_gray_pyr, intr: Intrinsics, cfg,
                  R0=None, t0=None):
    """Coarse to fine over `cfg.levels` (the reference's 3 then 2; levels
    past the pyramid are skipped): (R, t, {level: |eps| history}). On CUDA
    tensors the whole pyramid is one `level_photo` launch."""
    single = now_gray_pyr[0].dim() == 2
    solved = [lvl for lvl in cfg.levels if lvl < len(now_gray_pyr)]
    levels = [_levels(ref_levels[lvl], now_gray_pyr[lvl], intr.at_level(lvl)) for lvl in solved]
    R0, t0 = _pose_in(R0, t0, single, now_gray_pyr[0], levels[0].pts.shape[0] if levels else 1)
    R, t, hist = _kernel.level_photo(R0, t0, levels, cfg)
    history = {lvl: (hist[0, i] if single else hist[:, i]) for i, lvl in enumerate(solved)}
    return (R[0], t[0], history) if single else (R, t, history)


def extract_photo_ref(gray_pyr, depth_pyr, intr: Intrinsics, cfg,
                      max_points: Tuple[int, ...]) -> Tuple[PhotoRefLevel, ...]:
    """`computeJacobianAllLevels` (RGBDOdometry.cpp:363-398) over all levels."""
    return tuple(
        extract_photo_ref_level(g, d, intr.at_level(lvl), max_points[lvl], cfg)
        for lvl, (g, d) in enumerate(zip(gray_pyr, depth_pyr))
    )


def warp_image(gray: torch.Tensor, depth_mm: torch.Tensor, intr: Intrinsics, R: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Dense warp render of a frame (H, W) float32 under the pose (R (3, 3),
    t (3,)) in the solver's convention p' = R^T (p - t): each pixel is
    back-projected at its depth, moved, projected, and the frame is sampled
    there bilinearly (coordinates clamped to the image, the rows mixed first
    as in the JAX package's separable gather); 0 where the point leaves the
    image or falls behind the camera. A plain bilinear gather replaces the
    JAX package's one-hot matmul."""
    h, w = gray.shape
    f32 = dict(dtype=gray.dtype, device=gray.device)
    gy, gx = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32), indexing="ij")
    z = depth_mm / 1000.0
    X = torch.stack([z * (gx - intr.cx) / intr.fx, z * (gy - intr.cy) / intr.fy, z],
                    dim=-1).reshape(-1, 3)
    xp = (X - t.to(gray.dtype)) @ R.to(gray.dtype)
    zp = xp[:, 2]
    zinv = 1.0 / torch.where(zp.abs() < 1e-12, torch.full_like(zp, 1e-12), zp)
    u = intr.fx * xp[:, 0] * zinv + intr.cx
    v = intr.fy * xp[:, 1] * zinv + intr.cy
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (zp > 0)

    def corners(c, n):
        c = torch.clamp(c, 0.0, n - 1.0)
        i0 = torch.floor(c)
        i0i = i0.long()
        return i0i, torch.clamp(i0i + 1, max=n - 1), c - i0

    r0, r1, fv = corners(v, h)
    c0, c1, fu = corners(u, w)
    row0 = (1.0 - fv) * gray[r0, c0] + fv * gray[r1, c0]
    row1 = (1.0 - fv) * gray[r0, c1] + fv * gray[r1, c1]
    vals = row0 * (1.0 - fu) + row1 * fu
    return torch.where(inside, vals, torch.zeros_like(vals)).reshape(h, w)
