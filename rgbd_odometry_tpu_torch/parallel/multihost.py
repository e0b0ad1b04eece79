"""Multi-process set-up and long-sequence windows: port of
`rgbd_odometry_tpu/parallel/multihost.py`.

JAX brings its processes up with `jax.distributed` and spans one global
mesh over every chip. The port's processes are the ranks of a
`torch.distributed` process group, one rank a process and one device a
rank, on one host or several; `initialize` opens the group from an
explicit address, world size, rank and backend, places the process on its
host's cards by its local rank, and `global_mesh` is the mesh over every
rank. A long
sequence is split into windows that share `overlap` frames; each rank
aligns its own window (`local_window`), the ranks reduce their statistics,
and the window trajectories are stitched by composing at the shared frames.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np

# each rank's device tensors through NCCL, host objects through gloo
NCCL = "cuda:nccl,cpu:gloo"
GLOO = "gloo"


# this process's rank on its host: set by `initialize`, cleared by `shutdown`,
# so that it lives exactly as long as the process group it places the rank in
_LOCAL_RANK: Optional[int] = None


def local_layout(num_processes: int, process_id: int, local_rank: Optional[int] = None,
                 local_world_size: Optional[int] = None) -> Tuple[int, int]:
    """(local rank, local world size): this process's place among the ranks
    of its own host. Each is the argument if given, else `LOCAL_RANK` /
    `LOCAL_WORLD_SIZE` from the environment (as torchrun sets them), else
    the global rank / world size (every rank on one host)."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if not 0 <= local_rank < local_world_size <= num_processes:
        raise ValueError(f"local rank {local_rank} of {local_world_size} ranks on this host "
                         f"does not fit a world of {num_processes}")
    return local_rank, local_world_size


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: int = 300,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
):
    """Open the `torch.distributed` process group of `num_processes` ranks,
    this process being rank `process_id`, through the TCP rendezvous at
    `coordinator_address` ("host:port", served by rank 0). A no-op for one
    process, as in JAX, so the same entry point runs alone.

    The caller names the backend: `NCCL` ("cuda:nccl,cpu:gloo") where each
    rank has a card of its host to itself (the rank of local rank l drives
    card l), `GLOO` ("gloo") on the CPU and where ranks share a card. The
    ranks may span hosts: `local_rank` and `local_world_size` place this
    process among its own host's ranks (`local_layout`). NCCL refuses two
    ranks on one card, so more local ranks than the host's cards raise
    here, before NCCL does. Nothing falls back: a backend that does not
    come up raises. `timeout_s` bounds the rendezvous and every
    collective."""
    global _LOCAL_RANK
    if num_processes is None or num_processes <= 1:
        return
    import torch
    import torch.distributed as dist

    if backend not in (NCCL, GLOO):
        raise ValueError(f"initialize: backend must be {NCCL!r} (a card a rank) or {GLOO!r} "
                         f"(the CPU, or ranks sharing a card), got {backend!r}")
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize: the coordinator address and the process id are required "
                         "for more than one process")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"initialize: process_id {process_id} outside [0, {num_processes})")
    local_rank, local_world = local_layout(num_processes, process_id, local_rank,
                                           local_world_size)
    if backend == NCCL:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError("initialize: NCCL needs a CUDA card and none is available")
        if local_world > cards:
            raise ValueError(
                f"initialize: NCCL with {local_world} ranks on this host's {cards} card(s) "
                f"would put two ranks on one card, which NCCL refuses (\"Duplicate GPU "
                f"detected\"); run at most one rank a card, or ranks that share a card over "
                f"{GLOO!r}")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _LOCAL_RANK = local_rank


def local_rank() -> int:
    """This process's rank on its host: what `initialize` placed it at,
    else `LOCAL_RANK`, else its global rank (0 without a process group)."""
    if _LOCAL_RANK is not None:
        return _LOCAL_RANK
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank))


def shutdown():
    """Close this process's process group, if one is open."""
    global _LOCAL_RANK
    import torch.distributed as dist

    _LOCAL_RANK = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(device=None):
    """The mesh over every rank of the process group (the world-1 mesh
    without one); see `mesh.make_mesh`."""
    from rgbd_odometry_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device)


def shard_sequence_windows(num_frames: int, window: int,
                           overlap: int = 1) -> Sequence[Tuple[int, int]]:
    """Split a sequence into [start, end) windows of `window` frames that
    share `overlap` frames with the next, so that window-local trajectories
    can be stitched at the shared frames."""
    step = window - overlap
    starts = list(range(0, max(num_frames - overlap, 1), step))
    return [(s, min(s + window, num_frames)) for s in starts]


def local_window(windows, process_id: Optional[int] = None):
    """The window process `process_id` loads (default: this process's rank
    in `torch.distributed`, 0 without a process group)."""
    if process_id is None:
        import torch.distributed as dist

        process_id = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return windows[process_id % len(windows)]


def stitch_windows(results: Sequence[Tuple[np.ndarray, np.ndarray]], overlap: int = 1):
    """Compose per-window trajectories (R_w (T,3,3), t_w (T,3)), each
    relative to its own first frame, into one trajectory by anchoring each
    window at the previous window's last (shared) frame."""
    R_all = [results[0][0]]
    t_all = [results[0][1]]
    for R_w, t_w in results[1:]:
        R_anchor = R_all[-1][-1]
        t_anchor = t_all[-1][-1]
        R_g = np.einsum("ij,tjk->tik", R_anchor, R_w[overlap:])
        t_g = t_anchor + np.einsum("ij,tj->ti", R_anchor, t_w[overlap:])
        R_all.append(R_g)
        t_all.append(t_g)
    return np.concatenate(R_all), np.concatenate(t_all)
