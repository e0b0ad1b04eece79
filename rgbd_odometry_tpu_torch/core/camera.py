"""Pinhole intrinsics as plain Python floats, and the ingest's undistortion.

Port of `rgbd_odometry_tpu/core/camera.Intrinsics`: the JAX version carries
the four scalars as a pytree of arrays for `jit`; here they are floats that
enter the tensor math as scalar operands (float32 on float32 tensors) and the
CUDA kernel as `float` arguments. `backproject`, `backproject_points`,
`project` and `transform_points` are the JAX module's pinhole helpers;
`undistort_map` and `remap_bilinear` are the plumb-bob undistortion of the
VGA ingest (`io/stream.preprocess_vga`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rgbd_odometry_tpu_torch.config import CameraConfig
from rgbd_odometry_tpu_torch.device import resolve_device
from rgbd_odometry_tpu_torch.ops.project import div_scalar


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_config(cfg: CameraConfig) -> "Intrinsics":
        return Intrinsics(float(cfg.fx), float(cfg.fy), float(cfg.cx), float(cfg.cy))

    def at_level(self, level: int) -> "Intrinsics":
        """Every entry scaled by 2^-level (exact: a power of two)."""
        s = 2.0 ** (-level)
        return Intrinsics(self.fx * s, self.fy * s, self.cx * s, self.cy * s)


def backproject(depth_mm: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Dense back-projection of a (..., H, W) depth map (millimetres) to
    (..., H, W, 3) camera-frame points in metres: X = Z (x - cx) / fx,
    Y = Z (y - cy) / fy at pixel (x = col, y = row)."""
    h, w = depth_mm.shape[-2:]
    f = dict(dtype=depth_mm.dtype, device=depth_mm.device)
    gy, gx = torch.meshgrid(torch.arange(h, **f), torch.arange(w, **f), indexing="ij")
    return backproject_points(torch.stack([gx, gy], -1).expand(depth_mm.shape + (2,)),
                              depth_mm, intr)


def backproject_points(uv: torch.Tensor, depth_mm: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Back-project sparse pixels: uv (..., 2) [x, y] and depth (...,) in mm
    -> (..., 3) metres, each division rounded once on every device
    (`ops/project.div_scalar`)."""
    z = div_scalar(depth_mm, 1000.0)
    return torch.stack([div_scalar(z * (uv[..., 0] - intr.cx), intr.fx),
                        div_scalar(z * (uv[..., 1] - intr.cy), intr.fy), z], dim=-1)


def project(points: torch.Tensor, intr: Intrinsics, eps: float = 1e-12) -> torch.Tensor:
    """Project (..., 3) camera-frame points (m) to (..., 2) pixels [u, v]:
    dehomogenize (|z| < eps taken as eps), then apply K."""
    z = points[..., 2]
    z_inv = 1.0 / torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    return torch.stack([intr.fx * points[..., 0] * z_inv + intr.cx,
                        intr.fy * points[..., 1] * z_inv + intr.cy], dim=-1)


def transform_points(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The reference's warp X' = R^T (X - t) of points (..., N, 3) by the
    pose of now in ref (R (..., 3, 3), t (..., 3))."""
    return (pts - t[..., None, :]) @ R


def undistort_map(cfg: CameraConfig, device=None) -> torch.Tensor:
    """The plumb-bob undistortion sampling grid (H, W, 2) float32 [x, y]:
    for each output pixel the distorted source location to sample
    (bilinear); the identity grid without distortion. Computed on the CPU,
    where a float32 division by a Python scalar is a true division as in
    XLA (on a CUDA device torch takes the product with its reciprocal), then
    moved to `device` (default: the current CUDA device, `resolve_device`;
    `device="cpu"` keeps it on the host)."""
    k1, k2, p1, p2, k3 = cfg.distortion
    f32 = torch.float32
    gy, gx = torch.meshgrid(torch.arange(cfg.height, dtype=f32),
                            torch.arange(cfg.width, dtype=f32), indexing="ij")
    xn = (gx - cfg.cx) / cfg.fx
    yn = (gy - cfg.cy) / cfg.fy
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    x_d = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    y_d = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    grid = torch.stack([x_d * cfg.fx + cfg.cx, y_d * cfg.fy + cfg.cy], dim=-1)
    return grid.to(resolve_device(device))


def remap_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of a (..., H, W) image at the sampling grid (H, W, 2)
    [x, y], the coordinates clamped to the image."""
    h, w = img.shape[-2:]
    x = torch.clamp(grid[..., 0], 0.0, w - 1.0)
    y = torch.clamp(grid[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = x - x0.to(img.dtype)
    wy = y - y0.to(img.dtype)
    flat = img.reshape(img.shape[:-2] + (h * w,))

    def gat(yy, xx):
        return flat[..., yy * w + xx]

    top = gat(y0, x0) * (1 - wx) + gat(y0, x1) * wx
    bot = gat(y1, x0) * (1 - wx) + gat(y1, x1) * wx
    return top * (1 - wy) + bot * wy
