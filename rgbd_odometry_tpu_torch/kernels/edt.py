"""Kernel 1: the squared-L2 EDT of an edge mask, and kernel 7, the
now-frame targets built from it (`csrc/edt.cu`).

Replaces `rgbd_odometry_tpu/pallas/edt.py` (`edt_minplus_pallas`, reached
through `edt_l2_squared_pallas`) and takes in the column phase and the
production +-R window; `dt_pyramid` also takes in what
`rgbd_odometry_tpu/solvers/edge_dvo.prepare_now_level` does behind the EDT
(sqrt, the 0-255 min-max normalization, `central_gradient`, the channel
stack) over every level of `prepare_now_targets`, in one launch on the
card, each (level, image) on a block or a thread-block cluster
(`dt_route`; a level of 2^20 pixels or more on per-level kernels of its
own); `dt_channels` is a pyramid of one level. `edt_squared`,
`dt_pyramid` and `dt_channels` are the entry points: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the kernel; anything else
raises. The card takes levels of fewer than 2^22 pixels, at most 2560 a
side (`build.check_level_size`).
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
_LL, _INT = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
_PYR_ARGTYPES = ([ctypes.c_int] * 3 + [_LL, _INT, _INT, ctypes.c_int, ctypes.c_int, _LL]
                 + [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


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
    _check_levels("edt_squared", (mask,), radius, 1)
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
    bf16 when `bf16`, else float32. Returns (dt, dgx, dgy, scale, chans).
    On a CUDA device: `dt_pyramid` of a one-level pyramid."""
    if edges.device.type == "cpu":
        return dt_channels_plain(edges, radius, normalize, bf16)
    return dt_pyramid((edges,), radius, normalize, bf16)[0]


def dt_pyramid_plain(edges_pyr, radius: int, normalize: bool, bf16: bool):
    """The plain PyTorch version of `dt_pyramid`: `dt_channels_plain` on
    each level."""
    return tuple(dt_channels_plain(e, radius, normalize, bf16) for e in edges_pyr)


MAX_LEVELS = 8
CLUSTERS = (1, 2, 4, 8)  # blocks a (level, image): csrc/edt.cu's bands of rows
H100_SMS = 132
# the route rule: a level is split until a block's pixels are no more than
# the launch's fair share over two blocks per SM of the card, and no further
# than 2048 pixels a block (4 a thread of the 512); a level of 2^20 pixels
# or more goes to the per-level kernels
_MIN_RANK_PIXELS, _LEVEL_ROUTE_PIXELS = 2048, 1 << 20


def dt_route(shapes, b: int, cluster=None, sms: int = H100_SMS):
    """The route rule of `dt_pyramid`: per level of `shapes` ((H, W) pairs)
    over B images its blocks an image in the pyramid kernel's one launch
    (1, 2, 4 or 8, a band of rows each), or 0 for the per-level route, and
    the launch's cluster size c (the largest count; 1: no cluster), on a
    card of `sms` SMs (the H100's 132 by default; `dt_pyramid` passes the
    device's). With `cluster` None: a level of 2^20 pixels or more (1280x960
    and up) takes the per-level kernels (columns, rows and tail, and the
    normalization: two or three launches spread over the whole card), which
    beat 8 blocks an image there at B = 1 and 8 (PERF.md); every other level
    is halved until a block's pixels are no more than the launch's share,
    max(2048, B * every level's pixels / (2 sms)), at most 8 ways: at B = 1
    the large levels spread over the card; at B = 64 only a level that would
    hold the launch back is split. Slow where it stays in the pyramid
    kernel: a level just under 2^20 pixels at a small B runs on 8 SMs.
    `dvo --cam-scale 3`'s 720x960 pyramid at B = 1 is slower there than the
    parent's one `dt_channels` call a level and than this module's own
    per-level route, which beats the rule at B = 8 as well (PERF.md section
    6); only 1280x960 and up take that route. A number forces every level
    onto that many blocks, 0 onto the per-level route (for checks and
    profiles)."""
    _check_cluster(cluster)
    if cluster is not None:
        return (cluster,) * len(shapes), max(cluster, 1)
    share = max(_MIN_RANK_PIXELS, b * sum(h * w for h, w in shapes) / (2 * sms))
    ranks = []
    for h, w in shapes:
        r = 1
        while r < CLUSTERS[-1] and h * w / r > share:
            r *= 2
        ranks.append(0 if h * w >= _LEVEL_ROUTE_PIXELS else r)
    return tuple(ranks), max(max(ranks), 1)


def _check_cluster(cluster) -> None:
    if cluster is not None and cluster not in (0,) + CLUSTERS:
        raise ValueError(f"dt_pyramid: cluster must be 0 or one of {CLUSTERS}, got {cluster}")


def _check_levels(fn: str, levels, radius: int, min_side: int) -> None:
    """Raise ValueError unless `levels` (a tuple of 1 to 8 (B, H, W) masks,
    H and W at least `min_side`) and `radius` are what the kernels take."""
    if not isinstance(levels, (tuple, list)) or not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{fn}: edges_pyr must be a tuple of 1 to {MAX_LEVELS} levels")
    if radius < 0:
        raise ValueError(f"{fn}: radius must be >= 0, got {radius}")
    first = levels[0]
    for lvl, e in enumerate(levels):
        what = f"{fn}: level {lvl}"
        if e.dim() != 3:
            raise ValueError(f"{what} must be (B, H, W), got {tuple(e.shape)}")
        if e.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"{what} must be bool or uint8, got {e.dtype}")
        if e.device != first.device:
            raise ValueError(f"{what} is on {e.device}, level 0 on {first.device}")
        if not e.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        b, h, w = e.shape
        if b != first.shape[0]:
            raise ValueError(f"{what} has {b} images, level 0 has {first.shape[0]}")
        if not (1 <= b <= 65535 and min_side <= h and min_side <= w):
            raise ValueError(f"{what}: unsupported shape {tuple(e.shape)}")
        build.check_level_size(what, h, w)


def dt_pyramid(edges_pyr, radius: int, normalize: bool, bf16: bool, cluster: int | None = None):
    """`dt_channels` of every level of a pyramid: `edges_pyr` is a tuple of
    L <= 8 levels, each (B, H_l, W_l) bool or uint8, contiguous, on one
    device (`canny_pyramid`'s edge maps). Returns a tuple, per level, of
    (dt, dgx, dgy, scale, chans) with `dt_channels`' shapes, dtypes and
    meaning; each kind is one allocation, the levels contiguous views of it.
    On a CUDA device: one launch for every level of B images, each (level,
    image) on one block or a cluster of 2, 4 or 8 as `dt_route` decides,
    but for a level of 2^20 pixels or more, which takes two or three
    launches of its own (`cluster` None takes the rule, a number
    forces that many blocks on every level, 0 the per-level route).
    Arguments are checked before anything is built or launched."""
    if len(edges_pyr) and edges_pyr[0].device.type == "cpu":
        return dt_pyramid_plain(edges_pyr, radius, normalize, bf16)
    _check_levels("dt_pyramid", edges_pyr, radius, 2)
    _check_cluster(cluster)
    dev = edges_pyr[0].device
    if dev.type != "cuda":
        raise ValueError(f"dt_pyramid: unsupported device {dev}")
    b = edges_pyr[0].shape[0]
    shapes = [tuple(e.shape[1:]) for e in edges_pyr]
    sms = build.sm_count(dev.index or 0)
    ranks, c = dt_route(shapes, b, cluster, sms)
    offs, total = [], 0
    for h, w in shapes:
        offs.append(total)
        total += -(-b * h * w // 8) * 8  # each level's planes start 16-byte aligned
    f32 = torch.float32
    g = torch.empty((total,), dtype=torch.int16, device=dev)
    raw = torch.empty((total,), dtype=f32, device=dev) if normalize else None
    per_level = normalize and 0 in ranks
    minmax = torch.empty((len(shapes), b, 2), dtype=torch.int32, device=dev) if per_level else None
    dt, dgx, dgy = (torch.empty((total,), dtype=f32, device=dev) for _ in range(3))
    scale = torch.empty((len(shapes), b), dtype=f32, device=dev)
    chans = torch.empty((3 * total,), dtype=torch.bfloat16 if bf16 else f32, device=dev)
    n = len(shapes)
    lib = build.bind("edt", "dt_pyramid", _PYR_ARGTYPES)
    with build.traced("dt_pyramid"):
        code = lib.dt_pyramid(
            dev.index or 0, n, b, (ctypes.c_longlong * n)(*(e.data_ptr() for e in edges_pyr)),
            (ctypes.c_int * (2 * n))(*(x for s in shapes for x in s)), (ctypes.c_int * n)(*ranks),
            c, sms, (ctypes.c_longlong * n)(*offs), g.data_ptr(),
            raw.data_ptr() if normalize else None, minmax.data_ptr() if per_level else None,
            dt.data_ptr(), dgx.data_ptr(), dgy.data_ptr(),
            scale.data_ptr(), chans.data_ptr(), int(radius), int(bool(normalize)),
            int(bool(bf16)), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "dt_pyramid launch")
    dt_pyramid.launches += 1
    scales = scale.unbind(0)
    return tuple(
        tuple(x.as_strided((b, h, w), (h * w, w, 1), o) for x in (dt, dgx, dgy))
        + (scales[lvl], chans.as_strided((b, 3, h, w), (3 * h * w, h * w, w, 1), 3 * o))
        for lvl, (o, (h, w)) in enumerate(zip(offs, shapes)))


dt_pyramid.launches = 0
