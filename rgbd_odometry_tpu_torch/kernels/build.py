"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into `build/rgbd_odometry_tpu_torch/<name>-<hash>.so` beside the
package (the hash covers the source, every shared `csrc/*.cuh` header and
the flags, so an edited source or header is rebuilt and a stale library is
never loaded). No PyTorch headers are involved, which keeps nvcc fast.
`load_all` starts one nvcc per source at once. A missing `nvcc` or a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "rgbd_odometry_tpu_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> (ctypes.CDLL, build record); filled on first load in this process
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc was not found on PATH or at /usr/local/cuda/bin/nvcc; the "
            "CUDA kernels of rgbd_odometry_tpu_torch cannot be built"
        )
    return found


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built if needed)."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = _CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    key = hashlib.sha256(text + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"{name}-{key}.so"
    record = {"name": name, "source": str(src), "library": str(so), "built": False,
              "seconds": 0.0, "ptxas": ""}
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        record.update(built=True, seconds=time.perf_counter() - t0,
                      ptxas=(proc.stdout + proc.stderr).strip())
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = (lib, record)
    return lib


def load_all(names) -> None:
    """Build (if needed) and load every named source, one nvcc process per
    source, all started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(load, names))


def build_record(name: str) -> dict:
    """What `load(name)` did in this process: whether it compiled, how long
    nvcc took, and the ptxas resource report."""
    load(name)
    return dict(_LOADED[name][1])


def bind(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """`load(name)` with the C entry point `fn` (returning a cudaError_t)
    and `cuda_error_string` given their ctypes signatures."""
    lib = load(name)
    entry = getattr(lib, fn)
    if entry.argtypes is None:
        entry.argtypes = list(argtypes)
        entry.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


# `traced` opens its ranges only while this is set; `profile_paths` clears
# it, so that its windows time the path without the ranges' host cost
ranges = True


def traced(name: str):
    """A `torch.profiler.record_function` range named `name` around a
    launch while a profiler records (so a trace names the kernel's call on
    the host too) and `ranges` is set; otherwise nothing, at the cost of two
    flag reads."""
    if ranges and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index` (read once per device)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_arg(fn: str, name: str, x, shape, dtype, device, contiguous: bool = True) -> None:
    """Raise ValueError unless tensor `x` (argument `name` of wrapper `fn`)
    has this device, dtype and shape (and is contiguous, when asked)."""
    if x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


# What every kernel on the `dvo` path takes on the card: a level of fewer
# than 2^22 pixels (below it extraction's priorities (perm + 0.5) / n are
# distinct in float32) with both sides at most 2560.
MAX_PIXELS = 1 << 22
MAX_SIDE = 2560


def check_level_size(what: str, h: int, w: int) -> None:
    """Raise ValueError, naming the limit, if an (h, w) level is past what
    the card's kernels take (`MAX_PIXELS`, `MAX_SIDE`)."""
    if h * w >= MAX_PIXELS or h > MAX_SIDE or w > MAX_SIDE:
        raise ValueError(
            f"{what}: a {h}x{w} level is too large for the card's kernels, which take levels "
            f"of fewer than 2^22 pixels (extraction's priorities are distinct below it) and at "
            f"most {MAX_SIDE} a side (ROADMAP.md Queue 3)")


def check_rows(fn: str, name: str, img) -> None:
    """Raise ValueError unless the rows of `img` (B, H, W) are contiguous
    (the batch stride may be larger, e.g. one channel of (B, C, H, W))."""
    if img.stride(2) != 1 or img.stride(1) != img.shape[2]:
        raise ValueError(f"{fn}: {name} rows must be contiguous")
