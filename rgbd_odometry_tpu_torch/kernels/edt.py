"""Kernel 1: the squared-L2 EDT of an edge mask, and kernel 7, the
now-frame targets built from it (`csrc/edt.cu`).

Replaces `rgbd_odometry_tpu/pallas/edt.py` (`edt_minplus_pallas`, reached
through `edt_l2_squared_pallas`) and takes in the column phase and the
production +-R window; `dt_channels` also takes in what
`rgbd_odometry_tpu/solvers/edge_dvo.prepare_now_level` does behind the EDT
(sqrt, the 0-255 min-max normalization, `central_gradient`, the channel
stack). `edt_squared` and `dt_channels` are the entry points: a CPU tensor
goes to the plain PyTorch version, a CUDA tensor to the kernel; anything
else raises. The card takes levels of fewer than 2^22 pixels, at most 2560
a side (`build.check_level_size`).
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.ops.distance_transform import (
    edt_l2_squared,
    edt_l2_squared_windowed,
)
from rgbd_odometry_tpu_torch.ops.gradient import central_gradient

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DT_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def edt_squared_plain(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """The plain PyTorch version: full row phase when radius == 0."""
    if radius > 0:
        return edt_l2_squared_windowed(mask, radius)
    return edt_l2_squared(mask)


def _check(fn: str, mask: torch.Tensor, radius: int, min_side: int) -> None:
    """Raise ValueError unless `mask` and `radius` are what the kernel takes."""
    if mask.dim() != 3:
        raise ValueError(f"{fn}: mask must be (B, H, W), got {tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"{fn}: mask must be bool or uint8, got {mask.dtype}")
    if not mask.is_contiguous():
        raise ValueError(f"{fn}: mask must be contiguous")
    if radius < 0:
        raise ValueError(f"{fn}: radius must be >= 0, got {radius}")
    b, h, w = mask.shape
    if not (1 <= b <= 65535 and min_side <= h and min_side <= w):
        raise ValueError(f"{fn}: unsupported shape {tuple(mask.shape)}")
    build.check_level_size(fn, h, w)


def edt_squared(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Squared distance to the nearest True of `mask` (B, H, W) bool or
    uint8 -> (B, H, W) float32. radius 0 = exact over the whole row, radius
    R > 0 = the row phase restricted to |x - i| <= R."""
    if mask.device.type == "cpu":
        return edt_squared_plain(mask.bool(), radius)
    _check("edt_squared", mask, radius, 1)
    if mask.device.type != "cuda":
        raise ValueError(f"edt_squared: unsupported device {mask.device}")
    b, h, w = mask.shape
    g = torch.empty((b, h, w), dtype=torch.int16, device=mask.device)
    d2 = torch.empty((b, h, w), dtype=torch.float32, device=mask.device)
    lib = build.bind("edt", "edt_squared", _ARGTYPES)
    code = lib.edt_squared(
        mask.device.index or 0, mask.data_ptr(), g.data_ptr(), d2.data_ptr(),
        b, h, w, int(radius), torch.cuda.current_stream(mask.device).cuda_stream,
    )
    build.check(lib, code, "edt_squared launch")
    edt_squared.launches += 1
    return d2


edt_squared.launches = 0


def dt_channels_plain(edges: torch.Tensor, radius: int, normalize: bool, bf16: bool):
    """The plain PyTorch version of `dt_channels`."""
    # sqrt in float64, rounded once to float32: the correctly rounded
    # float32 sqrt that XLA computes (torch's vectorized CPU float32 sqrt is
    # not always correctly rounded, which would break exactness with JAX)
    d2 = edt_squared_plain(edges.bool(), int(radius))
    dt = torch.sqrt(d2.to(torch.float64)).to(torch.float32)
    if normalize:
        dmin = torch.amin(dt, dim=(-2, -1))
        span = torch.clamp(torch.amax(dt, dim=(-2, -1)) - dmin, min=1e-12)
        # a true division, as XLA's 255 / x (torch's `255.0 / span` would
        # be reciprocal(span) * 255)
        scale = torch.full_like(span, 255.0) / span
        dt = (dt - dmin[:, None, None]) * scale[:, None, None]
    else:
        scale = torch.ones(dt.shape[0], dtype=dt.dtype, device=dt.device)
    dgx, dgy = central_gradient(dt)
    chans = torch.stack([dt, dgx, dgy], dim=1).to(torch.bfloat16 if bf16 else torch.float32)
    return dt, dgx, dgy, scale, chans


def dt_channels(edges: torch.Tensor, radius: int, normalize: bool, bf16: bool):
    """Edge map (B, H, W) bool or uint8 -> the distance-transform target:
    dt = sqrt of the squared EDT (row phase over +-radius, or the whole row
    when 0), per image min-max normalized to 0-255 when `normalize`; its
    central gradients dgx, dgy under REFLECT_101; scale (B,), DT units per
    pixel (1 when not normalized); chans (B, 3, H, W) = [dt, dgx, dgy] in
    bf16 when `bf16`, else float32. Returns (dt, dgx, dgy, scale, chans)."""
    if edges.device.type == "cpu":
        return dt_channels_plain(edges, radius, normalize, bf16)
    _check("dt_channels", edges, radius, 2)
    if edges.device.type != "cuda":
        raise ValueError(f"dt_channels: unsupported device {edges.device}")
    b, h, w = edges.shape
    dev = edges.device
    g = torch.empty((b, h, w), dtype=torch.int16, device=dev)
    dt, dgx, dgy = (torch.empty((b, h, w), dtype=torch.float32, device=dev) for _ in range(3))
    scale = torch.empty((b,), dtype=torch.float32, device=dev)
    chans = torch.empty((b, 3, h, w), dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
    raw = torch.empty((b, h, w), dtype=torch.float32, device=dev) if normalize else None
    minmax = torch.empty((b, 2), dtype=torch.int32, device=dev) if normalize else None
    lib = build.bind("edt", "dt_channels", _DT_ARGTYPES)
    with build.traced("dt_channels"):
        code = lib.dt_channels(
            dev.index or 0, edges.data_ptr(), g.data_ptr(),
            raw.data_ptr() if normalize else None, minmax.data_ptr() if normalize else None,
            dt.data_ptr(), dgx.data_ptr(), dgy.data_ptr(), scale.data_ptr(), chans.data_ptr(),
            b, h, w, int(radius), int(bool(normalize)), int(bool(bf16)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "dt_channels launch")
    dt_channels.launches += 1
    return dt, dgx, dgy, scale, chans


dt_channels.launches = 0
