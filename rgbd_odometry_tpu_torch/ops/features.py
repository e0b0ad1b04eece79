"""Sparse feature front-end: port of `rgbd_odometry_tpu/ops/features.py`.

Harris corners, 8x8 mean/std-normalized patch descriptors and mutual-nearest
matching with the reference's distance gate (src/PnPOdometry.cpp:472-492),
on one frame (H, W). The descriptors index the patch around each corner
directly (the JAX package gathers from a stack of shifted images with one-hot
MXU matmuls, a TPU mechanism the port does not carry); the rows and columns
wrap around the image as `jnp.roll` does, which only matters for slots that
hold no corner and are zeroed anyway. `detect_and_describe` and
`detect_describe_backproject` on CUDA tensors run kernel C
(`kernels/features.py`: Harris, peaks, top-K, descriptors and the
back-projection in one launch), on CPU tensors the plain version
`detect_and_describe_plain`; `match` on CUDA tensors runs the hand-written
kernel of `kernels/match.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_odometry_tpu_torch.core.camera import Intrinsics, backproject_points
from rgbd_odometry_tpu_torch.kernels.features import detect_describe
from rgbd_odometry_tpu_torch.kernels.match import match_mutual
from rgbd_odometry_tpu_torch.ops.gradient import _pad1, sobel3


class Keypoints(NamedTuple):
    uv: torch.Tensor  # (K, 2) float32 pixel coords [x, y]
    score: torch.Tensor  # (K,) Harris response (-inf where no corner)
    desc: torch.Tensor  # (K, D) unit-norm descriptors (0 where invalid)
    valid: torch.Tensor  # (K,) bool
    count: torch.Tensor  # () int32


class Matches(NamedTuple):
    ref_idx: torch.Tensor  # (K,) int64 index into the ref keypoints, per now keypoint
    dist: torch.Tensor  # (K,) float32 match distance
    good: torch.Tensor  # (K,) bool: mutual, ratio and distance gates passed
    num_good: torch.Tensor  # () int32


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum under edge padding, in the JAX version's term order."""
    p = _pad1(x, "replicate")
    return (
        p[..., :-2, :-2] + p[..., :-2, 1:-1] + p[..., :-2, 2:]
        + p[..., 1:-1, :-2] + p[..., 1:-1, 1:-1] + p[..., 1:-1, 2:]
        + p[..., 2:, :-2] + p[..., 2:, 1:-1] + p[..., 2:, 2:]
    )


def harris_response(gray: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris corner response R = det(M) - k tr(M)^2 with 3x3 aggregation."""
    gx, gy = sobel3(gray)
    sxx = _box3(gx * gx)
    syy = _box3(gy * gy)
    sxy = _box3(gx * gy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (keepdim) in XLA:CPU's order: a row longer
    than 32 is summed as windows of 32, each in order, then the window sums
    in order. The descriptors' mean and norm then round as the JAX
    package's do, so that the near-zero distances of a frame matched with
    its own duplicate, which decide the distance gate, agree bit for bit."""
    n = x.shape[-1]
    win = x.reshape(*x.shape[:-1], n // 32, 32) if n > 32 and n % 32 == 0 else x[..., None, :]
    acc = win[..., 0]
    for i in range(1, win.shape[-1]):
        acc = acc + win[..., i]
    s = acc[..., :1]
    for i in range(1, acc.shape[-1]):
        s = s + acc[..., i : i + 1]
    return s


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """resp >= the max of its 3x3 neighbourhood (-inf outside the image)."""
    h, w = resp.shape[-2:]
    p = torch.nn.functional.pad(resp[None], (1, 1, 1, 1), value=float("-inf"))[0]
    m = resp
    for dy in range(3):
        for dx in range(3):
            m = torch.maximum(m, p[..., dy : dy + h, dx : dx + w])
    return resp >= m


def detect_and_describe_plain(
    gray: torch.Tensor,
    k_max: int = 512,
    patch: int = 8,
    min_response_frac: float = 1e-4,
    border: int = 8,
) -> Keypoints:
    """The plain version of `detect_and_describe` (any device)."""
    h, w = gray.shape
    resp = harris_response(gray)
    ys = torch.arange(h, device=gray.device)[:, None]
    xs = torch.arange(w, device=gray.device)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    peak = _nms3(resp) & inside & (resp > min_response_frac * resp.amax())
    score_map = torch.where(peak, resp, torch.full_like(resp, float("-inf")))
    scores, idx = torch.sort(score_map.reshape(-1), descending=True, stable=True)
    scores, idx = scores[:k_max], idx[:k_max]
    valid = torch.isfinite(scores)
    uy = idx // w
    ux = idx % w
    uv = torch.stack([ux, uy], dim=-1).to(gray.dtype)
    count = valid.sum(dtype=torch.int32)

    half = patch // 2
    off = torch.arange(-half, half, device=gray.device)
    rows = (uy[:, None] + off[None, :]) % h  # (K, patch)
    cols = (ux[:, None] + off[None, :]) % w
    desc = gray[rows[:, :, None], cols[:, None, :]].reshape(-1, patch * patch)
    desc = desc - _row_sum(desc) / (patch * patch)
    norm = torch.sqrt(_row_sum(desc * desc).double()).float()  # correctly rounded
    desc = desc / torch.clamp(norm, min=1e-6)
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))
    return Keypoints(uv=uv, score=scores, desc=desc, valid=valid, count=count)


def backproject_keypoints_plain(kps: Keypoints, depth_mm: torch.Tensor, intr: Intrinsics,
                                min_depth_mm: float = 100.0):
    """Each keypoint at its depth (mm) through `core.camera.backproject_points`
    (every division rounded once): (pts3d (K, 3) metres, pts_valid (K,) bool,
    the valid keypoints deeper than `min_depth_mm`)."""
    h, w = depth_mm.shape
    ui = torch.clamp(kps.uv[:, 0].long(), 0, w - 1)
    vi = torch.clamp(kps.uv[:, 1].long(), 0, h - 1)
    z_mm = depth_mm.reshape(-1)[vi * w + ui]
    return backproject_points(kps.uv, z_mm, intr), kps.valid & (z_mm > min_depth_mm)


def _device_of(fn: str, gray: torch.Tensor) -> str:
    if gray.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {gray.device}")
    return gray.device.type


def detect_and_describe(
    gray: torch.Tensor,
    k_max: int = 512,
    patch: int = 8,
    min_response_frac: float = 1e-4,
    border: int = 8,
) -> Keypoints:
    """Top-`k_max` Harris corners of gray (H, W) float32, with normalized
    patch descriptors. Corners are ordered by response, the lower pixel
    index first among equal responses (as `jax.lax.top_k`); slots past the
    last corner score -inf and keep the order of their pixel index. CPU
    tensors run the plain version, CUDA tensors kernel C (one launch, no
    host sync); any other device raises."""
    if _device_of("detect_and_describe", gray) == "cpu":
        return detect_and_describe_plain(gray, k_max, patch, min_response_frac, border)
    return Keypoints(*detect_describe(gray.contiguous(), k_max, patch, min_response_frac, border))


def detect_describe_backproject(gray: torch.Tensor, depth_mm: torch.Tensor, intr: Intrinsics,
                                k_max: int = 512, min_depth_mm: float = 100.0):
    """`detect_and_describe` at its defaults and each keypoint back-projected
    at its depth: (Keypoints, pts3d (K, 3), pts_valid (K,)), the JAX
    matcher's fused `_detect_backproject`. On CUDA tensors one launch of
    kernel C."""
    if _device_of("detect_describe_backproject", gray) == "cpu":
        kps = detect_and_describe_plain(gray, k_max)
        return (kps, *backproject_keypoints_plain(kps, depth_mm, intr, min_depth_mm))
    *kps, pts3d, pts_valid = detect_describe(gray.contiguous(), k_max, depth=depth_mm.contiguous(),
                                             intr=intr, min_depth_mm=min_depth_mm)
    return Keypoints(*kps), pts3d, pts_valid


def match(
    ref: Keypoints,
    now: Keypoints,
    dist_gate_factor: float = 3.0,
    ratio: float = 0.9,
    dist_gate_floor: float = 1e-3,
) -> Matches:
    """Mutual-nearest matching with the reference's distance gate (see the
    JAX docstring): `good` requires (a) mutual nearest neighbours, (b) the
    Lowe ratio against the second neighbour, (c) d <= max(3 min_d, floor).
    One slot of `kernels.match.match_mutual`."""
    ref_idx, dist, good, num_good = match_mutual(
        ref.desc[None].contiguous(), ref.valid[None].contiguous(), now.desc.contiguous(),
        now.valid.contiguous(), dist_gate_factor, ratio, dist_gate_floor,
    )
    return Matches(ref_idx=ref_idx[0], dist=dist[0], good=good[0], num_good=num_good[0])
