"""Batched sequence alignment: port of `rgbd_odometry_tpu/parallel/sequence.py`.

Given a sequence of T frames, align all consecutive (or keyframe-anchored)
pairs as one batch, then compose the relative poses into a trajectory on
the host in float64:

  * consecutive: pair (i, i+1);
  * keyframe-anchored: pair (keyframe(i), i), frame i against the last
    keyframe strictly before it, chaining through keyframes as the GOP does.

The frames go to the device in one host-to-device copy; the pyramids are
built once for the whole sequence and the relative poses come back in one
device-to-host copy. With a `Mesh` of W ranks (`parallel/mesh.py`) the
pairs are padded to a multiple of W, each rank uploads the frames of its
own contiguous block of pairs and aligns them, the relative poses are
gathered once, and every rank composes the same trajectory.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import SolverConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
from rgbd_odometry_tpu_torch.parallel.mesh import Mesh, _aligner, build_sharded_aligner, local_mesh


def build_pair_aligner(intr: Intrinsics, cfg: SolverConfig, max_points: Tuple[int, ...],
                       mesh: Optional[Mesh] = None):
    """A batched pair aligner: (ref gray pyramid, ref depth pyramid, now
    gray pyramid), each a tuple of (B, H_l, W_l) levels, -> (R (B,3,3),
    t (B,3)) on the host: the sharded aligner (`mesh.build_sharded_aligner`:
    this rank's rows in, every rank's poses out), of one process without
    `mesh`."""
    if mesh is None:
        return _aligner(None, intr, cfg, max_points)
    return build_sharded_aligner(mesh, intr, cfg, max_points)


def pair_indices(t_frames: int, keyframe_every: Optional[int] = None):
    """(ref_idx, now_idx) of the T - 1 pairs: consecutive, or each frame i
    against the last keyframe strictly before it (keyframes every
    `keyframe_every` frames from frame 0)."""
    now_idx = np.arange(1, t_frames)
    if keyframe_every is None:
        return now_idx - 1, now_idx
    return ((now_idx - 1) // keyframe_every) * keyframe_every, now_idx


def align_sequence(
    grays: Sequence[np.ndarray],
    depths: Sequence[np.ndarray],
    intr: Intrinsics,
    cfg: SolverConfig,
    max_points: Tuple[int, ...] = (4096, 2048, 1024, 512),
    num_levels: int = 4,
    keyframe_every: Optional[int] = None,
    device=None,
    mesh: Optional[Mesh] = None,
):
    """Align a whole frame sequence in one batched call. Returns (R_global
    (T,3,3), t_global (T,3), rel_R (T-1,3,3), rel_t (T-1,3)), float64.

    keyframe_every=None pairs consecutive frames; otherwise frames pair
    against their group keyframe (the reference's keyframe cadence is 5)
    and the relative poses chain through the keyframes. With `mesh`, every
    rank makes the same call and gets the same result (module docstring);
    without one, the world-1 `local_mesh(device)`."""
    t_frames = len(grays)
    if t_frames < 2 or len(depths) != t_frames:
        raise ValueError(f"align_sequence: needs >= 2 frames with depths, got {t_frames}")
    if mesh is None:
        mesh = local_mesh(device)
    elif device is not None:
        raise ValueError("align_sequence: give a device or a mesh (the pairs run on its "
                         "device), not both")
    ref_idx, now_idx = pair_indices(t_frames, keyframe_every)
    n_pairs = len(now_idx)
    # pad the pairs to a multiple of the world size: the padding repeats the last pair
    pad = (-n_pairs) % mesh.world_size
    rows = mesh.rows(n_pairs + pad)
    ref_loc = np.concatenate([ref_idx, np.repeat(ref_idx[-1], pad)])[rows]
    now_loc = np.concatenate([now_idx, np.repeat(now_idx[-1], pad)])[rows]
    # the frames these pairs use, in one host-to-device copy
    used, pos = np.unique(np.concatenate([ref_loc, now_loc]), return_inverse=True)
    host = np.stack([np.stack([np.asarray(grays[i], np.float32) for i in used]),
                     np.stack([np.asarray(depths[i], np.float32) for i in used])])
    frames = torch.from_numpy(host).to(mesh.device)
    pyr = build_pyramid(frames[0], frames[1], num_levels)
    ref = torch.from_numpy(pos[:len(ref_loc)]).to(mesh.device)
    now = torch.from_numpy(pos[len(ref_loc):]).to(mesh.device)
    aligner = build_sharded_aligner(mesh, intr, cfg, tuple(max_points[:num_levels]))
    R_h, t_h = aligner(tuple(g[ref] for g in pyr.gray), tuple(d[ref] for d in pyr.depth),
                       tuple(g[now] for g in pyr.gray))
    rel = torch.cat([R_h.reshape(-1, 9), t_h], dim=1).numpy().astype(np.float64)[:n_pairs]
    rel_R, rel_t = rel[:, :9].reshape(-1, 3, 3), rel[:, 9:]

    # host-side composition (float64, like the GOP)
    R_out = np.zeros((t_frames, 3, 3))
    t_out = np.zeros((t_frames, 3))
    R_out[0] = np.eye(3)
    for i in range(1, t_frames):
        anchor = ref_idx[i - 1]
        R_out[i] = R_out[anchor] @ rel_R[i - 1]
        t_out[i] = t_out[anchor] + R_out[anchor] @ rel_t[i - 1]
    return R_out, t_out, rel_R, rel_t
