"""State carried across from the JAX package.

This system has no learned weights; the state that moves between the two
packages is the solver's per-level data, the map backend's keyframe store
and its pose-graph edges. These functions turn the JAX package's
`RefLevel` / `NowLevel`, `Keypoints` and `PoseGraphEdges` tuples (any
objects with those fields, holding numpy arrays or anything `np.asarray`
accepts, batched or not) and a `LoopCloser`'s or `Relocalizer`'s store into
the port's tensors, so that both packages can be fed the very same keyframe
features, DT targets and databases. Nothing here imports JAX. Like every
entry point of the port, each function puts its tensors on the current CUDA
device unless given `device` (`device.resolve_device`: without a card it
raises, naming `device="cpu"`).
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_odometry_tpu_torch.device import resolve_device
from rgbd_odometry_tpu_torch.solvers.edge_dvo import NowLevel, RefLevel


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16 arrays) -> torch tensor, bitwise."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _batched(x: torch.Tensor, unbatched_ndim: int) -> torch.Tensor:
    return x[None] if x.dim() == unbatched_ndim else x


def ref_level(level, device=None) -> RefLevel:
    """A JAX `RefLevel` ((K,3) pts or (B,K,3)) -> the port's batched one."""
    device = resolve_device(device)
    return RefLevel(
        pts3d=_batched(to_tensor(level.pts3d, device), 2).contiguous(),
        uv=_batched(to_tensor(level.uv, device), 2),
        valid=_batched(to_tensor(level.valid, device), 1).contiguous(),
        count=_batched(to_tensor(level.count, device), 0).to(torch.int32),
    )


def now_level(level, device=None) -> NowLevel:
    """A JAX `NowLevel` ((H,W) maps or (B,H,W)) -> the port's batched one."""
    device = resolve_device(device)
    return NowLevel(
        dt=_batched(to_tensor(level.dt, device), 2),
        dgx=_batched(to_tensor(level.dgx, device), 2),
        dgy=_batched(to_tensor(level.dgy, device), 2),
        edges=_batched(to_tensor(level.edges, device), 2),
        scale=_batched(to_tensor(level.scale, device), 0),
        chans=_batched(to_tensor(level.chans, device), 3),
    )


def pose(R, t, device=None):
    """A JAX pose (R (3,3) or (B,3,3), t) -> batched float32 tensors."""
    device = resolve_device(device)
    R = _batched(to_tensor(R, device).to(torch.float32), 2).contiguous()
    t = _batched(to_tensor(t, device).to(torch.float32), 1).contiguous()
    return R, t


def keypoints_from_jax(kps, device=None):
    """A JAX `features.Keypoints` (one frame, or with a leading slot axis)
    -> the port's, bitwise."""
    device = resolve_device(device)
    from rgbd_odometry_tpu_torch.ops.features import Keypoints

    return Keypoints(
        uv=to_tensor(kps.uv, device), score=to_tensor(kps.score, device),
        desc=to_tensor(kps.desc, device), valid=to_tensor(kps.valid, device),
        count=to_tensor(kps.count, device).to(torch.int32),
    )


def edges_from_jax(e, device=None):
    """A JAX `pose_graph.PoseGraphEdges` -> the port's (int64 node indices)."""
    device = resolve_device(device)
    from rgbd_odometry_tpu_torch.solvers.pose_graph import PoseGraphEdges

    f32 = lambda a: to_tensor(a, device).to(torch.float32)  # noqa: E731
    return PoseGraphEdges(
        i=to_tensor(e.i, device).long(), j=to_tensor(e.j, device).long(), R_rel=f32(e.R_rel),
        t_rel=f32(e.t_rel), weight=f32(e.weight),
        sqrt_info=None if e.sqrt_info is None else f32(e.sqrt_info),
    )


def load_store(src, dst) -> None:
    """Load the keyframe store of a JAX `LoopCloser` or `Relocalizer` (`src`)
    into the port's counterpart (`dst`, on its own device): the slot buffer
    at its capacity, every stored keyframe's 3D points, and the consumer's
    bookkeeping (keyframe nodes and closures; or global poses, nodes and
    counters). Both then match queries against the same database."""
    from rgbd_odometry_tpu_torch.pipeline.kf_matcher import StoredPoints

    dev = dst.matcher.device
    slots = src.matcher._slots
    dst.matcher._slots = None if slots is None else keypoints_from_jax(slots, dev)
    dst.matcher.stored = [
        StoredPoints(pts3d=to_tensor(p.pts3d, dev), pts_valid=to_tensor(p.pts_valid, dev))
        for p in src.matcher.stored
    ]
    if hasattr(src, "closures"):
        from rgbd_odometry_tpu_torch.pipeline.loop_closure import KeyframeRecord

        dst.keyframes = [KeyframeRecord(node=kf.node, pts3d=p.pts3d, pts_valid=p.pts_valid)
                         for kf, p in zip(src.keyframes, dst.matcher.stored)]
        dst.closures = [(i, j, np.asarray(R, np.float64), np.asarray(t, np.float64), int(n))
                        for i, j, R, t, n in src.closures]
        dst.skipped_candidates = src.skipped_candidates
    else:
        dst.poses = [(np.array(R, np.float64), np.array(t, np.float64)) for R, t in src.poses]
        dst.nodes = list(src.nodes)
        dst.attempts, dst.successes = src.attempts, src.successes
