"""Kernel 1: the squared-L2 EDT of an edge mask (`csrc/edt.cu`).

Replaces `rgbd_odometry_tpu/pallas/edt.py` (`edt_minplus_pallas`, reached
through `edt_l2_squared_pallas`) and takes in the column phase and the
production +-R window. `edt_squared` is the entry point: a CPU tensor goes
to the plain PyTorch version, a CUDA tensor to the kernel; anything else
raises.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.ops.distance_transform import (
    edt_l2_squared,
    edt_l2_squared_windowed,
)

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def edt_squared_plain(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """The plain PyTorch version: full row phase when radius == 0."""
    if radius > 0:
        return edt_l2_squared_windowed(mask, radius)
    return edt_l2_squared(mask)


def edt_squared(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Squared distance to the nearest True of `mask` (B, H, W) bool or
    uint8 -> (B, H, W) float32. radius 0 = exact over the whole row, radius
    R > 0 = the row phase restricted to |x - i| <= R."""
    if mask.device.type == "cpu":
        return edt_squared_plain(mask.bool(), radius)
    if mask.device.type != "cuda":
        raise ValueError(f"edt_squared: unsupported device {mask.device}")
    if mask.dim() != 3:
        raise ValueError(f"edt_squared: mask must be (B, H, W), got {tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"edt_squared: mask must be bool or uint8, got {mask.dtype}")
    if not mask.is_contiguous():
        raise ValueError("edt_squared: mask must be contiguous")
    if radius < 0:
        raise ValueError(f"edt_squared: radius must be >= 0, got {radius}")
    b, h, w = mask.shape
    g2 = torch.empty((b, h, w), dtype=torch.float32, device=mask.device)
    d2 = torch.empty_like(g2)
    lib = build.bind("edt", "edt_squared", _ARGTYPES)
    code = lib.edt_squared(
        mask.device.index or 0, mask.data_ptr(), g2.data_ptr(), d2.data_ptr(),
        b, h, w, int(radius), torch.cuda.current_stream(mask.device).cuda_stream,
    )
    build.check(lib, code, "edt_squared launch")
    edt_squared.launches += 1
    return d2


edt_squared.launches = 0
