"""Kernel 6: Canny edge maps with the hysteresis fixpoint on the device
(`csrc/canny.cu`).

Replaces the XLA ops of `rgbd_odometry_tpu/ops/canny.py` (`_grad_mag`,
`_nms`, `hysteresis`'s `lax.while_loop`, reached through `canny` and, for a
pyramid, `canny_multi`). `canny_pyramid` takes every level of a pyramid at
once, two launches from one C call with no host read, the hysteresis
fixpoints of all levels and images side by side, each on one block or on a
thread-block cluster of 2, 4 or 8 blocks as `hysteresis_route` decides
(`cluster=` forces one); `canny` is a pyramid of one level. The card takes
levels of fewer than 2^22 pixels, at most 2560 a side
(`build.check_level_size`).

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
_ARGTYPES = ([ctypes.c_int] * 3 + [_LL, _INT, _INT, ctypes.c_int, _LL, _LL, ctypes.c_longlong]
             + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_MAX_SMEM = 227 * 1024  # the packed weak and edge planes of one band must fit a block
MAX_LEVELS = 8
CLUSTERS = (1, 2, 4, 8)  # hysteresis blocks a (level, image): csrc/canny.cu's bands
_CHUNK = 8  # rows of a hysteresis unit: a band is a multiple of it


# the route rule: a level whose units (8 rows of a 32-column word) outnumber
# a block's 1024 threads is worth a cluster, where the card holds every
# block of the launch at once (132 SMs, two 1024-thread blocks each)
_THREADS, _RESIDENT_BLOCKS = 1024, 264


def _band(h: int, c: int) -> int:
    """Rows of each of c blocks' bands (a multiple of 8; h for one block)."""
    return h if c == 1 else -(-(-(-h // c)) // _CHUNK) * _CHUNK


def hysteresis_smem(h: int, w: int, c: int) -> int:
    """Shared memory of a (level, image) fixpoint over c blocks (bytes a
    block): the packed weak and edge planes of one band of rows (a multiple
    of 8, with the zero guard ring), and the cluster's flags."""
    return 8 * (_band(h, c) + 2) * ((w + 31) // 32 + 2) + (0 if c == 1 else 64)


def hysteresis_route(shapes, b: int, cluster=None):
    """The route rule of the hysteresis: per level of `shapes` ((H, W)
    pairs) over B images its blocks an image, 1 or the launch's cluster c,
    and c. With `cluster` None: a level one block cannot hold, or whose
    units outnumber a block's threads, goes to the largest c whose blocks
    the card holds at once (every other level on one block); where none
    does, only the levels one block cannot hold go to the smallest c that
    holds them. A number forces every level onto that many blocks (for
    checks and profiles)."""
    if cluster is not None:
        if cluster not in CLUSTERS:
            raise ValueError(f"canny_pyramid: cluster must be one of {CLUSTERS}, got {cluster}")
        for h, w in shapes:
            if hysteresis_smem(h, w, cluster) > _MAX_SMEM:
                raise ValueError(f"canny_pyramid: a {h}x{w} level does not fit the shared "
                                 f"memory of {cluster} hysteresis block(s)")
        return (cluster,) * len(shapes), cluster
    big = [hysteresis_smem(h, w, 1) > _MAX_SMEM for h, w in shapes]
    wants = [g or (w + 31) // 32 * -(-h // _CHUNK) > _THREADS
             for g, (h, w) in zip(big, shapes)]
    for c in (8, 4, 2):
        if any(wants) and b * sum(c if x else 1 for x in wants) <= _RESIDENT_BLOCKS and all(
                hysteresis_smem(h, w, c) <= _MAX_SMEM for x, (h, w) in zip(wants, shapes) if x):
            return tuple(c if x else 1 for x in wants), c
    c = next((c for c in CLUSTERS if all(hysteresis_smem(h, w, c) <= _MAX_SMEM
                                         for g, (h, w) in zip(big, shapes) if g)), 0)
    return tuple(c if g else 1 for g in big), c


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
        build.check_level_size(what, h, w)
    if passes is not None:
        build.check_arg("canny_pyramid", "passes", passes, (len(imgs), first.shape[0]),
                        torch.int32, first.device)


def canny_pyramid(imgs, low: float = 100.0, high: float = 150.0, passes=None,
                  cluster: int | None = None):
    """Canny edge maps of every level of a pyramid, `canny` semantics:
    `imgs` is a tuple of L <= 8 levels, each (B, H_l, W_l) float32
    8-bit-valued, contiguous, on one device. Returns a tuple of L bool (B,
    H_l, W_l) edge maps, contiguous views of one allocation. On a CUDA
    device: one C call, two launches (all levels' tiles in one grid, a block
    or a cluster of blocks per (level, image) fixpoint in another, as
    `hysteresis_route` decides: `cluster` None takes its rule, a number
    forces that many blocks on every level); `passes`, an int32 (L, B)
    tensor, receives each fixpoint's pass count.
    Arguments are checked before anything is built or launched."""
    if len(imgs) and imgs[0].device.type == "cpu":
        return canny_pyramid_plain(imgs, low, high)
    _check_pyramid(imgs, passes)
    ranks, c = hysteresis_route([tuple(g.shape[1:]) for g in imgs], imgs[0].shape[0], cluster)
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
    with build.traced("canny_pyramid"):
        code = lib.canny_pyramid(
            dev.index or 0, n, b, (ctypes.c_longlong * n)(*(g.data_ptr() for g in imgs)),
            (ctypes.c_int * (2 * n))(*(x for s in shapes for x in s)), (ctypes.c_int * n)(*ranks),
            c, (ctypes.c_longlong * n)(*word_off), (ctypes.c_longlong * n)(*edge_off), nw,
            planes.data_ptr(), edges.data_ptr(), None if passes is None else passes.data_ptr(),
            float(low) * float(low), float(high) * float(high),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "canny_pyramid launch")
    canny_pyramid.launches += 1
    return tuple(edges[o:o + b * h * w].view(b, h, w) for o, (h, w) in zip(edge_off, shapes))


canny_pyramid.launches = 0
