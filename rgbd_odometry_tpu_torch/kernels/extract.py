"""Kernel 11: keyframe edge-point extraction over a whole pyramid
(`csrc/extract.cu`).

Replaces the XLA ops of `rgbd_odometry_tpu/solvers/edge_dvo.py`
`extract_ref_level` (:100-185) over every level, as `extract_ref_features`
(:910) runs them: the selection predicate, the exact or segmented top-k by a
fixed pseudo-random priority, and the back-projection. `extract_pyramid`
is the entry point: CPU tensors go to the plain PyTorch version
(`extract_ref_level` on each level), CUDA tensors to the kernel, one launch
for every level of B images; anything else raises. Every output is bitwise
the plain version's.

The priority of an n-pixel level is fixed, so the host computes two tables
per level once and uploads them once (cached per (n, device), like
`_priority`): `order`, the pixel indices by descending priority, and for
the segmented branch each 256-pixel segment's offsets by descending
priority. The kernel then selects with prefix sums instead of a sort
(`csrc/extract.cu`'s header gives the argument).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rgbd_odometry_tpu_torch.config import SolverConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.kernels.canny import canny

MAX_LEVELS = 8
SEGMENT = 256
_MAX_SMEM = 227 * 1024  # a level's bitmaps and one staged chunk must fit one block
_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_void_p])
# csrc/extract.cu: the staged slots of one chunk (kThreads * kItems), halved
# where the largest level's bitmaps leave too little room for the full one
_CHUNKS = (1024 * 16, 1024 * 8)


def _smem(n: int, chunk: int) -> int:
    """Shared memory of a launch whose largest level has n pixels: two
    bitmaps of 8 words a 256-pixel segment, the staged chunk, the scans."""
    return 64 * (-(-n // SEGMENT)) + 4 * chunk + 384


def chunk_size(n: int) -> int:
    """The chunk of `order` the kernel streams when its largest level has n
    pixels (0 if even the smaller one does not fit)."""
    return next((c for c in _CHUNKS if _smem(n, c) <= _MAX_SMEM), 0)


class RefLevel(NamedTuple):
    """Fixed-capacity edge-point set of the reference keyframe at one level."""

    pts3d: torch.Tensor  # (B, K, 3) metres, camera frame
    uv: torch.Tensor  # (B, K, 2) pixel coords at this level
    valid: torch.Tensor  # (B, K) bool
    count: torch.Tensor  # (B,) int32 number of tracked points


def _permutation(n: int) -> np.ndarray:
    """The JAX package's fixed priority permutation of an n-pixel level."""
    return np.random.default_rng(n).permutation(n)


@functools.lru_cache(maxsize=16)
def _priority(n: int, device: str) -> torch.Tensor:
    """The fixed pseudo-random extraction priority of an n-pixel level:
    the JAX package's `np.random.default_rng(n)` permutation, computed once
    per (shape, device) on the host and uploaded once."""
    pri = (_permutation(n).astype(np.float32) + 0.5) / n
    return torch.from_numpy(pri.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=16)
def _order_table(n: int, device: str) -> torch.Tensor:
    """int32 (n rounded up to 4,): the pixel indices of an n-pixel level by
    descending priority, then -1s."""
    inv = np.empty(n, np.int64)
    inv[_permutation(n)] = np.arange(n)
    order = np.full(-(-n // 4) * 4, -1, np.int32)
    order[:n] = inv[::-1]
    return torch.from_numpy(order).to(device)


@functools.lru_cache(maxsize=16)
def _segment_table(n: int, device: str) -> torch.Tensor:
    """uint8 (S * 256,): for each of the S = ceil(n / 256) segments, the
    offsets of its pixels by descending priority; a last partial segment's
    pads (offsets past n) come last."""
    s = -(-n // SEGMENT)
    perm = np.full(s * SEGMENT, -1, np.int64)
    perm[:n] = _permutation(n)
    offs = np.argsort(-perm.reshape(s, SEGMENT), axis=1, kind="stable")
    return torch.from_numpy(offs.astype(np.uint8).reshape(-1)).to(device)


def is_segmented(cfg: SolverConfig, n: int, k: int) -> bool:
    """Whether a level of n pixels and capacity k takes the segmented
    branch (the JAX package's rule)."""
    return cfg.extract_selection == "segmented" and n >= 8 * k


def extract_ref_level(
    gray: torch.Tensor | None,
    depth_mm: torch.Tensor,
    intr_level: Intrinsics,
    k_max: int,
    cfg: SolverConfig,
    edges: torch.Tensor | None = None,
) -> RefLevel:
    """Edge-point selection + back-projection at one level, (B, H, W) in:
    the plain PyTorch version of one level of `extract_pyramid`.

    Top-k of (edge & depth > min) + priority: the exact branch is one top-k
    over all pixels; the segmented branch (production) takes the top 32 of
    every 256-pixel segment, then the top k of the candidates, and is used
    only when H*W >= 8k. `count` follows the JAX semantics of each branch.
    """
    if edges is None:
        edges = canny(gray, cfg.canny_low, cfg.canny_high)
    mask = edges & (depth_mm > cfg.min_depth_mm)
    b, h, w = mask.shape
    n = h * w
    flat = mask.reshape(b, n)
    k = min(k_max, n)
    flat_score = flat.to(torch.float32) + _priority(n, str(mask.device))
    if is_segmented(cfg, n, k):
        seg_len = SEGMENT
        s = -(-n // seg_len)
        sc = F.pad(flat_score, (0, s * seg_len - n))
        v, i = torch.topk(sc.reshape(b, s, seg_len), 32, dim=-1)
        base = torch.arange(s, device=mask.device)[:, None] * seg_len
        gi = (base + i).reshape(b, -1)
        score, sel = torch.topk(v.reshape(b, -1), k, dim=-1)
        idx = torch.clamp(torch.gather(gi, 1, sel), max=n - 1)
        valid = score > 1.0
        count = valid.sum(-1, dtype=torch.int32)
    else:
        score, idx = torch.topk(flat_score, k, dim=-1)
        valid = score > 1.0
        count = torch.clamp(flat.sum(-1, dtype=torch.int32), max=k)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    z_raw = torch.gather(depth_mm.reshape(b, n), 1, idx)
    z = torch.where(valid, z_raw, torch.zeros_like(z_raw)) / 1000.0
    x3 = z * (xs - intr_level.cx) / intr_level.fx
    y3 = z * (ys - intr_level.cy) / intr_level.fy
    pts3d = torch.stack([x3, y3, z], dim=-1)
    uv = torch.stack([xs, ys], dim=-1)
    return RefLevel(pts3d=pts3d, uv=uv, valid=valid, count=count)


def extract_pyramid_plain(edges_pyr, depth_pyr, intr: Intrinsics, cfg: SolverConfig,
                          max_points) -> Tuple[RefLevel, ...]:
    """The plain PyTorch version: `extract_ref_level` on each level's edge
    map."""
    return tuple(
        extract_ref_level(None, d, intr.at_level(lvl), max_points[lvl], cfg, edges=e)
        for lvl, (e, d) in enumerate(zip(edges_pyr, depth_pyr))
    )


def _check(edges_pyr, depth_pyr, max_points) -> None:
    """Raise ValueError unless the pyramid is one the kernel takes."""
    if not isinstance(edges_pyr, (tuple, list)) or not 1 <= len(edges_pyr) <= MAX_LEVELS:
        raise ValueError(f"extract_pyramid: edges_pyr must be a tuple of 1 to {MAX_LEVELS} levels")
    if len(depth_pyr) != len(edges_pyr) or len(max_points) < len(edges_pyr):
        raise ValueError("extract_pyramid: depth_pyr and max_points must cover every level")
    first = edges_pyr[0]
    b, dev = first.shape[0] if first.dim() else 0, first.device
    for lvl, (e, d) in enumerate(zip(edges_pyr, depth_pyr)):
        what = f"extract_pyramid: level {lvl}"
        if e.dim() != 3 or e.dtype != torch.bool:
            raise ValueError(f"{what}: edges must be (B, H, W) bool, got {tuple(e.shape)} "
                             f"{e.dtype}")
        if e.shape[0] != b or min(e.shape) < 1 or b > 65535:
            raise ValueError(f"{what}: edges {tuple(e.shape)}, level 0 {tuple(first.shape)}")
        if e.device != dev or not e.is_contiguous():
            raise ValueError(f"{what}: edges must be contiguous on {dev}")
        if d.dtype != torch.float32 or d.shape != e.shape or d.device != dev \
                or not d.is_contiguous():
            raise ValueError(f"{what}: depth must be contiguous float32 {tuple(e.shape)} on {dev}, "
                             f"got {d.dtype} {tuple(d.shape)} on {d.device}")
        n = e.shape[1] * e.shape[2]
        if n >= 1 << 22 or not chunk_size(n):
            raise ValueError(f"{what}: a {e.shape[1]}x{e.shape[2]} level is too large for one "
                             "block's shared memory; splitting a level over blocks is "
                             "ROADMAP.md Queue 2 item 7")
        if int(max_points[lvl]) < 1:
            raise ValueError(f"{what}: capacity {max_points[lvl]} < 1")


def _aligned_offsets(sizes, itemsize: int):
    """Byte offsets of consecutive blocks of `sizes` items of `itemsize`
    bytes, each starting 16-byte aligned, and the total in items."""
    offs, total, step = [], 0, max(1, 16 // itemsize)
    for s in sizes:
        offs.append(total * itemsize)
        total += -(-s // step) * step
    return offs, total


class _Plan(NamedTuple):
    """What a call at one set of shapes needs beyond its tensors (cached)."""

    shapes: tuple  # per output: its per-level (shape, stride) pairs
    offsets: tuple  # per output (pts3d, uv, valid, count): per-level byte offsets
    totals: tuple  # per output: items in its one allocation
    tables: tuple  # per level: (order, segment table or None), kept alive here
    dims: object  # ctypes int array: H, W, K, n4 per level
    intr: object  # ctypes float array: fx, fy, cx, cy per level


@functools.lru_cache(maxsize=32)
def _plan(hw: tuple, b: int, ks: tuple, segmented: tuple, intr: Intrinsics, device: str) -> _Plan:
    p_off, p_tot = _aligned_offsets([b * k * 3 for k in ks], 4)
    u_off, u_tot = _aligned_offsets([b * k * 2 for k in ks], 4)
    v_off, v_tot = _aligned_offsets([b * k for k in ks], 1)
    c_off, c_tot = _aligned_offsets([b] * len(ks), 4)
    shapes = (
        tuple(((b, k, 3), (3 * k, 3, 1)) for k in ks),
        tuple(((b, k, 2), (2 * k, 2, 1)) for k in ks),
        tuple(((b, k), (k, 1)) for k in ks),
        tuple(((b,), (1,)) for _ in ks),
    )
    tables = tuple((_order_table(h * w, device), _segment_table(h * w, device) if seg else None)
                   for (h, w), seg in zip(hw, segmented))
    dims = [x for (h, w), k, (order, _) in zip(hw, ks, tables) for x in (h, w, k, order.numel())]
    fl = [x for lvl in range(len(ks)) for x in intr.at_level(lvl)]
    return _Plan(shapes, (tuple(p_off), tuple(u_off), tuple(v_off), tuple(c_off)),
                 (p_tot, u_tot, v_tot, c_tot), tables, (ctypes.c_int * len(dims))(*dims),
                 (ctypes.c_float * len(fl))(*fl))


_OUT_DTYPES = (torch.float32, torch.float32, torch.bool, torch.int32)


def extract_pyramid(edges_pyr, depth_pyr, intr: Intrinsics, cfg: SolverConfig,
                    max_points) -> Tuple[RefLevel, ...]:
    """Reference-keyframe edge points of every level: `edges_pyr` and
    `depth_pyr` are tuples of L <= 8 levels, (B, H_l, W_l) bool edge maps
    and float32 depths in mm, contiguous, on one device; level l keeps K_l
    = min(max_points[l], H_l W_l) slots. Returns one `RefLevel` a level,
    `extract_ref_level` semantics; each output is one allocation with a
    contiguous, 16-byte-aligned view per level. On a CUDA device: one C
    call, one launch. Arguments are checked before anything is built or
    launched."""
    if len(edges_pyr) and edges_pyr[0].device.type == "cpu":
        return extract_pyramid_plain(edges_pyr, depth_pyr, intr, cfg, max_points)
    _check(edges_pyr, depth_pyr, max_points)
    dev = edges_pyr[0].device
    if dev.type != "cuda":
        raise ValueError(f"extract_pyramid: unsupported device {dev}")
    b = edges_pyr[0].shape[0]
    hw = tuple((e.shape[1], e.shape[2]) for e in edges_pyr)
    ks = tuple(min(int(max_points[lvl]), h * w) for lvl, (h, w) in enumerate(hw))
    plan = _plan(hw, b, ks, tuple(is_segmented(cfg, h * w, k) for (h, w), k in zip(hw, ks)),
                 Intrinsics(*map(float, intr)), str(dev))
    outs = [torch.empty((n,), dtype=t, device=dev) for n, t in zip(plan.totals, _OUT_DTYPES)]
    bases = [o.data_ptr() for o in outs]
    ptrs = []
    for lvl, (e, d) in enumerate(zip(edges_pyr, depth_pyr)):
        order, seg = plan.tables[lvl]
        ptrs += [e.data_ptr(), d.data_ptr(), order.data_ptr(), 0 if seg is None else seg.data_ptr()]
        ptrs += [base + offs[lvl] for base, offs in zip(bases, plan.offsets)]
    lib = build.bind("extract", "extract_pyramid", _ARGTYPES)
    with build.traced("extract_pyramid"):
        code = lib.extract_pyramid(
            dev.index or 0, len(hw), b, (ctypes.c_longlong * len(ptrs))(*ptrs), plan.dims,
            plan.intr, float(np.float32(cfg.min_depth_mm)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "extract_pyramid launch")
    extract_pyramid.launches += 1
    return tuple(
        RefLevel(*(o.as_strided(shape, stride, offs[lvl] // o.element_size())
                   for o, offs, (shape, stride) in zip(outs, plan.offsets,
                                                       (sh[lvl] for sh in plan.shapes))))
        for lvl in range(len(hw))
    )


extract_pyramid.launches = 0
