"""Kernel 6: Canny edge maps with the hysteresis fixpoint on the device
(`csrc/canny.cu`).

Replaces the XLA ops of `rgbd_odometry_tpu/ops/canny.py` (`_grad_mag`,
`_nms`, `hysteresis`'s `lax.while_loop`, reached through `canny`). `canny`
is the entry point: a CPU tensor goes to the plain PyTorch version
(`ops/canny.py`), a CUDA tensor to the kernel (two launches from one C
call, no host read); anything else raises. The edge map is bitwise equal
either way.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.ops import canny as _plain

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_MAX_SMEM = 227 * 1024  # the packed weak and edge planes of one image must fit


def canny_plain(img: torch.Tensor, low: float = 100.0, high: float = 150.0) -> torch.Tensor:
    """The plain PyTorch version (a host read every few hysteresis passes)."""
    return _plain.canny(img, low, high)


def _check(img: torch.Tensor) -> None:
    """Raise ValueError unless `img` is what the kernel takes."""
    if img.dim() != 3:
        raise ValueError(f"canny: img must be (B, H, W), got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise ValueError(f"canny: img must be float32, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("canny: img must be contiguous")
    b, h, w = img.shape
    if min(b, h, w) < 1 or b > 65535:
        raise ValueError(f"canny: unsupported shape {tuple(img.shape)}")
    if 8 * (h + 2) * ((w + 31) // 32 + 2) > _MAX_SMEM:
        raise ValueError(f"canny: a {h}x{w} image does not fit the hysteresis kernel's "
                         f"shared memory")


def canny(img: torch.Tensor, low: float = 100.0, high: float = 150.0) -> torch.Tensor:
    """Canny edge map (bool, same shape as `img`) with cv::Canny(img, edges,
    high, low, 3, L2gradient=true) semantics; `img` (B, H, W) float32 is
    8-bit-valued."""
    if img.device.type == "cpu":
        return canny_plain(img, low, high)
    _check(img)
    if img.device.type != "cuda":
        raise ValueError(f"canny: unsupported device {img.device}")
    if low > high:
        low, high = high, low
    b, h, w = img.shape
    words = torch.empty((2, b, h, (w + 31) // 32), dtype=torch.int32, device=img.device)
    edges = torch.empty((b, h, w), dtype=torch.bool, device=img.device)
    lib = build.bind("canny", "canny", _ARGTYPES)
    code = lib.canny(
        img.device.index or 0, img.data_ptr(), words[0].data_ptr(), words[1].data_ptr(),
        edges.data_ptr(), b, h, w, float(low) * float(low), float(high) * float(high),
        torch.cuda.current_stream(img.device).cuda_stream,
    )
    build.check(lib, code, "canny launch")
    canny.launches += 1
    return edges


canny.launches = 0
