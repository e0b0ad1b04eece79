"""Kernel C: Harris detection with patch descriptors in one launch
(`csrc/features.cu`), and with a depth map the keypoints' back-projection
in the same launch.

Replaces JAX's `detect_and_describe` (`rgbd_odometry_tpu/ops/features.py:69`;
XLA, no Pallas kernel: the Harris response, the 3x3 non-maximum test,
`lax.top_k` :91, the one-hot MXU gather of the descriptors :106) and the
matcher's fused `_detect_backproject` (`rgbd_odometry_tpu/pipeline/
kf_matcher.py:123-133`). `detect_describe` takes CUDA tensors only (any
other device raises): `ops/features.detect_and_describe` and
`detect_describe_backproject` send CPU tensors to the plain version
(`detect_and_describe_plain`, `backproject_keypoints_plain`), which the
kernel matches bit for bit on the card. The launch is a memset of a 16-byte
header and one kernel: the tiles' responses and candidate peaks, then the
last block to finish selects the top `k_max` and writes every slot; no host
synchronization. No cap on the peak count; `k_max` up to `MAX_K` (the sort's
keys in shared memory) and the image's pixel count.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build

PATCH = 8  # the kernel's descriptors: 8x8 patches, 64 values
MAX_K = 16384  # keypoints a frame: the bitonic sort's keys in shared memory
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] * 6
             + [ctypes.c_void_p] * 9)


def detect_describe(gray, k_max: int, patch: int = PATCH, min_response_frac: float = 1e-4,
                    border: int = 8, depth=None, intr=None, min_depth_mm: float = 100.0):
    """One launch of kernel C on a CUDA gray image (H, W) float32: (uv (K, 2),
    score (K,), desc (K, 64), valid (K,) bool, count () int32) and, given
    depth (H, W) float32 in mm and intrinsics `intr` (fx, fy, cx, cy), also
    (pts3d (K, 3), pts_valid (K,) bool): bitwise `ops/features.
    detect_and_describe_plain` and `backproject_keypoints_plain`."""
    if gray.device.type != "cuda":
        raise ValueError(f"detect_describe: unsupported device {gray.device}; the kernel takes "
                         "CUDA tensors (ops/features.detect_and_describe runs the plain version "
                         "on the CPU)")
    dev = gray.device
    fn = "detect_describe"
    if gray.dim() != 2:
        raise ValueError(f"{fn}: gray must be (H, W), got {tuple(gray.shape)}")
    h, w = gray.shape
    if patch != PATCH:
        raise ValueError(f"{fn}: the kernel takes {PATCH}x{PATCH} patches, got {patch}")
    if not 1 <= k_max <= min(MAX_K, h * w):
        raise ValueError(f"{fn}: the kernel takes 1 to MAX_K = {MAX_K} keypoints and at most the "
                         f"image's {h * w} pixels, got k_max = {k_max}")
    build.check_arg(fn, "gray", gray, (h, w), torch.float32, dev)
    if (depth is None) != (intr is None):
        raise ValueError(f"{fn}: depth and intr go together")
    if depth is not None:
        build.check_arg(fn, "depth", depth, (h, w), torch.float32, dev)
    scratch = torch.empty((16 + 8 * h * w,), dtype=torch.uint8, device=dev)
    uv = torch.empty((k_max, 2), dtype=torch.float32, device=dev)
    score = torch.empty((k_max,), dtype=torch.float32, device=dev)
    desc = torch.empty((k_max, PATCH * PATCH), dtype=torch.float32, device=dev)
    valid = torch.empty((k_max,), dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    pts = pts_valid = None
    if depth is not None:
        pts = torch.empty((k_max, 3), dtype=torch.float32, device=dev)
        pts_valid = torch.empty((k_max,), dtype=torch.bool, device=dev)
    fx, fy, cx, cy = (0.0,) * 4 if intr is None else (intr.fx, intr.fy, intr.cx, intr.cy)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = build.bind("features", fn, _ARGTYPES)
    with build.traced(fn):
        code = lib.detect_describe(
            dev.index or 0, gray.data_ptr(), ptr(depth), h, w, int(k_max), int(border),
            float(min_response_frac), float(fx), float(fy), float(cx), float(cy),
            float(min_depth_mm), scratch.data_ptr(), uv.data_ptr(), score.data_ptr(),
            desc.data_ptr(), valid.data_ptr(), count.data_ptr(), ptr(pts), ptr(pts_valid),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "detect_describe launch")
    detect_describe.launches += 1
    out = (uv, score, desc, valid, count)
    return out if depth is None else out + (pts, pts_valid)


detect_describe.launches = 0
