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
