"""Image pyramid construction: port of `rgbd_odometry_tpu/core/pyramid.py`.

Nearest-neighbour downsampling by two composes exactly, so levels 1.. are
built from level 0 as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class FramePyramid(NamedTuple):
    """Per-level (gray, depth) tensors, fine (level 0) -> coarse, each
    (B, H, W) float32: gray in 0..255, depth in millimetres (0 -> 1)."""

    gray: Tuple[torch.Tensor, ...]
    depth: Tuple[torch.Tensor, ...]


def sanitize_depth(depth_mm: torch.Tensor) -> torch.Tensor:
    """Replace exact-zero (invalid) depth with 1 mm."""
    return torch.where(depth_mm == 0, torch.ones_like(depth_mm), depth_mm)


def downsample_nearest(img: torch.Tensor, factor: int) -> torch.Tensor:
    """out[i, j] = in[factor*i, factor*j] (cv::resize INTER_NEAREST)."""
    return img[..., ::factor, ::factor].contiguous()


def build_pyramid(
    gray0: torch.Tensor, depth0_mm: torch.Tensor, num_levels: int = 4
) -> FramePyramid:
    """`num_levels` pyramid from level-0 gray (0..255) and depth (mm)."""
    depth0_mm = sanitize_depth(depth0_mm)
    grays = [gray0]
    depths = [depth0_mm]
    for _ in range(1, num_levels):
        grays.append(downsample_nearest(grays[-1], 2))
        depths.append(downsample_nearest(depths[-1], 2))
    return FramePyramid(gray=tuple(grays), depth=tuple(depths))


_LUMA = (0.299, 0.587, 0.114)  # ITU-R BT.601, as cv::cvtColor RGB2GRAY


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of (..., H, W, 3) RGB in 0..255 -> (..., H, W), rounded
    half to even to integral values like the 8-bit reference. The sum is
    the chain XLA:CPU evaluates, r*wr, then g*wg and b*wb each added with
    one rounding (a fused multiply-add): taken in float64, where a product
    of two float32 values is exact, and rounded to float32 after each add
    (exact for 8-bit inputs; the dtype of `rgb` is kept)."""
    w = [torch.tensor(c, dtype=rgb.dtype).item() for c in _LUMA]  # the weights rounded once
    x = rgb.to(torch.float64)
    s = (x[..., 0] * w[0]).to(rgb.dtype)
    for c in (1, 2):
        s = (x[..., c] * w[c] + s.to(torch.float64)).to(rgb.dtype)
    return torch.round(s)


def pyramid_from_vga(
    rgb_vga: torch.Tensor, depth_vga_mm: torch.Tensor, num_levels: int = 4
) -> FramePyramid:
    """The ingest path from a VGA RGB-D frame: gray conversion (when the
    last axis holds 3 channels), the half-resolution base level, the
    nearest pyramid and the depth sanitize."""
    gray_vga = (rgb_to_gray(rgb_vga) if rgb_vga.dim() >= 3 and rgb_vga.shape[-1] == 3
                else rgb_vga)
    return build_pyramid(
        downsample_nearest(gray_vga, 2), downsample_nearest(depth_vga_mm, 2), num_levels
    )
