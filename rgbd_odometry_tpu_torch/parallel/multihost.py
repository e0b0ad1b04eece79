"""Long-sequence window helpers: the host-side part of
`rgbd_odometry_tpu/parallel/multihost.py`, as the port's own copies.

A long sequence is split into windows that share `overlap` frames; each
process aligns its own window (`local_window`), and the window trajectories
are stitched by composing at the shared frames. The JAX module's
multi-process set-up (`initialize`, `global_mesh`) is ROADMAP.md's
multi-GPU item; `local_window` reads the process index from
`torch.distributed` when a process group is up.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


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
