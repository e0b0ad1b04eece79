"""Batched sequence alignment: port of `rgbd_odometry_tpu/parallel/sequence.py`.

Given a sequence of T frames, align all consecutive (or keyframe-anchored)
pairs as one batch, then compose the relative poses into a trajectory on
the host in float64:

  * consecutive: pair (i, i+1);
  * keyframe-anchored: pair (keyframe(i), i), frame i against the last
    keyframe strictly before it, chaining through keyframes as the GOP does.

The frames go to the device in one host-to-device copy; the pyramids are
built once for the whole sequence and the relative poses come back in one
device-to-host copy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import SolverConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
from rgbd_odometry_tpu_torch.device import resolve_device
from rgbd_odometry_tpu_torch.solvers import edge_dvo


def build_pair_aligner(intr: Intrinsics, cfg: SolverConfig, max_points: Tuple[int, ...]):
    """A batched pair aligner: (ref gray pyramid, ref depth pyramid, now
    gray pyramid), each a tuple of (B, H_l, W_l) levels, -> (R (B,3,3),
    t (B,3)), one `align_pair` call."""
    edge_dvo.check_config(cfg)

    def aligner(ref_gray_pyr, ref_depth_pyr, now_gray_pyr):
        R, t, _ = edge_dvo.align_pair(ref_gray_pyr, ref_depth_pyr, now_gray_pyr, intr, cfg,
                                      max_points)
        return R, t

    return aligner


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
):
    """Align a whole frame sequence in one batched call. Returns (R_global
    (T,3,3), t_global (T,3), rel_R (T-1,3,3), rel_t (T-1,3)), float64.

    keyframe_every=None pairs consecutive frames; otherwise frames pair
    against their group keyframe (the reference's keyframe cadence is 5)
    and the relative poses chain through the keyframes."""
    t_frames = len(grays)
    if t_frames < 2 or len(depths) != t_frames:
        raise ValueError(f"align_sequence: needs >= 2 frames with depths, got {t_frames}")
    device = resolve_device(device)
    host = np.stack([np.stack([np.asarray(g, np.float32) for g in grays]),
                     np.stack([np.asarray(d, np.float32) for d in depths])])
    frames = torch.from_numpy(host).to(device)  # one host-to-device copy
    pyr = build_pyramid(frames[0], frames[1], num_levels)
    ref_idx, now_idx = pair_indices(t_frames, keyframe_every)
    ref = torch.from_numpy(ref_idx).to(device)
    now = torch.from_numpy(now_idx).to(device)
    aligner = build_pair_aligner(intr, cfg, tuple(max_points[:num_levels]))
    R_d, t_d = aligner(tuple(g[ref] for g in pyr.gray), tuple(d[ref] for d in pyr.depth),
                       tuple(g[now] for g in pyr.gray))
    rel = torch.cat([R_d.reshape(-1, 9), t_d], dim=1).cpu().numpy().astype(np.float64)
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
