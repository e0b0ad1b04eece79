"""Kernel 6: Canny edge maps with the hysteresis fixpoint on the device
(`csrc/canny.cu`).

Replaces the XLA ops of `rgbd_odometry_tpu/ops/canny.py` (`_grad_mag`,
`_nms`, `hysteresis`'s `lax.while_loop`, reached through `canny` and, for a
pyramid, `canny_multi`). `canny_pyramid` takes every level of a pyramid at
once, two launches from one C call with no host read, the hysteresis
fixpoints of all levels and images side by side; `canny` is a pyramid of
one level.

A CPU tensor goes to the plain PyTorch version (`ops/canny.py`), a CUDA
tensor to the kernel; anything else raises. The edge maps are bitwise equal
either way.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.ops import canny as _plain

_LL, _INT = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
_ARGTYPES = ([ctypes.c_int] * 3 + [_LL, _INT, _LL, _LL, ctypes.c_longlong]
             + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_MAX_SMEM = 227 * 1024  # the packed weak and edge planes of one image must fit
MAX_LEVELS = 8


def canny_plain(img: torch.Tensor, low: float = 100.0, high: float = 150.0) -> torch.Tensor:
    """The plain PyTorch version (a host read every few hysteresis passes)."""
    return _plain.canny(img, low, high)


def canny(img: torch.Tensor, low: float = 100.0, high: float = 150.0) -> torch.Tensor:
    """Canny edge map (bool, same shape as `img`) with cv::Canny(img, edges,
    high, low, 3, L2gradient=true) semantics; `img` (B, H, W) float32 is
    8-bit-valued. On a CUDA device: `canny_pyramid` of a one-level pyramid."""
    if img.device.type == "cpu":
        return canny_plain(img, low, high)
    return canny_pyramid((img,), low, high)[0]


def canny_pyramid_plain(imgs, low: float = 100.0, high: float = 150.0):
    """The plain PyTorch version of `canny_pyramid`: `ops/canny.canny` on
    each level."""
    return tuple(_plain.canny(g, low, high) for g in imgs)


def _check_pyramid(imgs, passes) -> None:
    """Raise ValueError unless `imgs` is a pyramid the kernel takes."""
    if not isinstance(imgs, (tuple, list)) or not 1 <= len(imgs) <= MAX_LEVELS:
        raise ValueError(f"canny_pyramid: imgs must be a tuple of 1 to {MAX_LEVELS} levels")
    first = imgs[0]
    for lvl, g in enumerate(imgs):
        what = f"canny_pyramid: level {lvl}"
        if g.dim() != 3:
            raise ValueError(f"{what} must be (B, H, W), got {tuple(g.shape)}")
        if g.dtype != torch.float32:
            raise ValueError(f"{what} must be float32, got {g.dtype}")
        if g.device != first.device:
            raise ValueError(f"{what} is on {g.device}, level 0 on {first.device}")
        if not g.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        b, h, w = g.shape
        if b != first.shape[0]:
            raise ValueError(f"{what} has {b} images, level 0 has {first.shape[0]}")
        if min(b, h, w) < 1 or b > 65535:
            raise ValueError(f"{what}: unsupported shape {tuple(g.shape)}")
        if 8 * (h + 2) * ((w + 31) // 32 + 2) > _MAX_SMEM:
            raise ValueError(f"{what}: a {h}x{w} image does not fit the hysteresis kernel's "
                             f"shared memory")
    if passes is not None:
        build.check_arg("canny_pyramid", "passes", passes, (len(imgs), first.shape[0]),
                        torch.int32, first.device)


def canny_pyramid(imgs, low: float = 100.0, high: float = 150.0, passes=None):
    """Canny edge maps of every level of a pyramid, `canny` semantics:
    `imgs` is a tuple of L <= 8 levels, each (B, H_l, W_l) float32
    8-bit-valued, contiguous, on one device. Returns a tuple of L bool (B,
    H_l, W_l) edge maps, contiguous views of one allocation. On a CUDA
    device: one C call, two launches (all levels' tiles in one grid, a block
    per (level, image) fixpoint in another); `passes`, an int32 (L, B)
    tensor, receives each fixpoint's pass count.
    Arguments are checked before anything is built or launched."""
    if len(imgs) and imgs[0].device.type == "cpu":
        return canny_pyramid_plain(imgs, low, high)
    _check_pyramid(imgs, passes)
    dev = imgs[0].device
    if dev.type != "cuda":
        raise ValueError(f"canny_pyramid: unsupported device {dev}")
    if low > high:
        low, high = high, low
    b = imgs[0].shape[0]
    shapes = [tuple(g.shape[1:]) for g in imgs]
    word_off, edge_off, nw, ne = [], [], 0, 0
    for h, w in shapes:
        word_off.append(nw)
        edge_off.append(ne)
        nw += b * h * ((w + 31) // 32)
        ne += -(-b * h * w // 16) * 16  # each level's map starts 16-byte aligned
    planes = torch.empty((2 * nw,), dtype=torch.int32, device=dev)
    edges = torch.empty((ne,), dtype=torch.bool, device=dev)
    n = len(imgs)
    lib = build.bind("canny", "canny_pyramid", _ARGTYPES)
    code = lib.canny_pyramid(
        dev.index or 0, n, b, (ctypes.c_longlong * n)(*(g.data_ptr() for g in imgs)),
        (ctypes.c_int * (2 * n))(*(x for s in shapes for x in s)),
        (ctypes.c_longlong * n)(*word_off), (ctypes.c_longlong * n)(*edge_off), nw,
        planes.data_ptr(), edges.data_ptr(), None if passes is None else passes.data_ptr(),
        float(low) * float(low), float(high) * float(high),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, code, "canny_pyramid launch")
    canny_pyramid.launches += 1
    return tuple(edges[o:o + b * h * w].view(b, h, w) for o, (h, w) in zip(edge_off, shapes))


canny_pyramid.launches = 0
