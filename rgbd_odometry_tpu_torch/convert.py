"""State carried across from the JAX package.

This system has no learned weights; the state that moves between the two
packages is the solver's per-level data. These functions turn the JAX
package's `RefLevel` / `NowLevel` tuples (any objects with those fields,
holding numpy arrays or anything `np.asarray` accepts, batched or not) into
the port's tensors, so that both solvers can be fed the very same keyframe
features and DT targets. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_odometry_tpu_torch.solvers.edge_dvo import NowLevel, RefLevel


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16 arrays) -> torch tensor, bitwise."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _batched(x: torch.Tensor, unbatched_ndim: int) -> torch.Tensor:
    return x[None] if x.dim() == unbatched_ndim else x


def ref_level(level, device="cpu") -> RefLevel:
    """A JAX `RefLevel` ((K,3) pts or (B,K,3)) -> the port's batched one."""
    return RefLevel(
        pts3d=_batched(to_tensor(level.pts3d, device), 2).contiguous(),
        uv=_batched(to_tensor(level.uv, device), 2),
        valid=_batched(to_tensor(level.valid, device), 1).contiguous(),
        count=_batched(to_tensor(level.count, device), 0).to(torch.int32),
    )


def now_level(level, device="cpu") -> NowLevel:
    """A JAX `NowLevel` ((H,W) maps or (B,H,W)) -> the port's batched one."""
    return NowLevel(
        dt=_batched(to_tensor(level.dt, device), 2),
        dgx=_batched(to_tensor(level.dgx, device), 2),
        dgy=_batched(to_tensor(level.dgy, device), 2),
        edges=_batched(to_tensor(level.edges, device), 2),
        scale=_batched(to_tensor(level.scale, device), 0),
        chans=_batched(to_tensor(level.chans, device), 3),
    )


def pose(R, t, device="cpu"):
    """A JAX pose (R (3,3) or (B,3,3), t) -> batched float32 tensors."""
    R = _batched(to_tensor(R, device).to(torch.float32), 2).contiguous()
    t = _batched(to_tensor(t, device).to(torch.float32), 1).contiguous()
    return R, t
