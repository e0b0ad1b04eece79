"""Pinhole intrinsics as plain Python floats.

Port of `rgbd_odometry_tpu/core/camera.Intrinsics`: the JAX version carries
the four scalars as a pytree of arrays for `jit`; here they are floats that
enter the tensor math as scalar operands (float32 on float32 tensors) and the
CUDA kernel as `float` arguments.
"""

from __future__ import annotations

from typing import NamedTuple

from rgbd_odometry_tpu_torch.config import CameraConfig


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
