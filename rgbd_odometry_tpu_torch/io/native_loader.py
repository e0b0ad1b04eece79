"""ctypes bindings for the native C++ frame loader (native/frame_loader.cpp):
the port's own copy of `rgbd_odometry_tpu/io/native_loader.py`. It builds
the library from the repository's `native/` directory, which belongs to
neither package.

The native runtime piece of the ingest path: a worker pool decodes TUM PNG
pairs off the GIL and hands frames through a bounded in-order ring buffer —
the role the reference's camera-driver thread + publisher processes played
(reference src/PrimeSenseCam.cpp, publisherPyD.cpp). Builds on first
use with the repo's native/Makefile (g++ + zlib, both baked into the image);
`available()` gates callers so pure-Python fallbacks keep working.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libframe_loader.so")
_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"], check=True, capture_output=True, timeout=120
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fl_count.restype = ctypes.c_int
    lib.fl_count.argtypes = [ctypes.c_void_p]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.fl_close.argtypes = [ctypes.c_void_p]
    lib.fl_decode_png_gray.restype = ctypes.c_int
    lib.fl_decode_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.fl_decode_png_depth16.restype = ctypes.c_int
    lib.fl_decode_png_depth16.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_png_gray(png_bytes: bytes, width: int, height: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = np.empty((height, width), np.float32)
    rc = lib.fl_decode_png_gray(
        png_bytes, len(png_bytes), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), width, height
    )
    if rc != 0:
        raise ValueError("native PNG gray decode failed")
    return out


def decode_png_depth16(png_bytes: bytes, width: int, height: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = np.empty((height, width), np.float32)
    rc = lib.fl_decode_png_depth16(
        png_bytes, len(png_bytes), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), width, height
    )
    if rc != 0:
        raise ValueError("native PNG depth decode failed")
    return out


class NativeTumLoader:
    """Iterate (gray_f32, depth_mm_f32, timestamp) frames decoded natively.

    `entries` is a list of (timestamp, gray_png_path, depth_png_path) at full
    resolution `width` x `height`; frames come back in order.
    """

    def __init__(self, entries, width: int, height: int, queue_depth: int = 4, workers: int = 3):
        lib = _load()
        if lib is None:
            raise RuntimeError("native frame loader unavailable (build failed)")
        self._lib = lib
        self._w, self._h = width, height
        manifest = "\n".join(f"{ts:.6f} {g} {d}" for ts, g, d in entries)
        self._h_ptr = lib.fl_open(manifest.encode(), width, height, queue_depth, workers)
        self._count = lib.fl_count(self._h_ptr)
        self._closed = False

    def __len__(self):
        return self._count

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        gray = np.empty((self._h, self._w), np.float32)
        depth = np.empty((self._h, self._w), np.float32)
        ts = ctypes.c_double(0.0)
        while True:
            rc = self._lib.fl_next(
                self._h_ptr,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(ts),
            )
            if rc == -1:
                break
            if rc == -2:
                raise ValueError("native decode failed mid-stream")
            yield gray.copy(), depth.copy(), float(ts.value)

    def close(self):
        if not self._closed:
            self._lib.fl_close(self._h_ptr)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
