"""Kernel A: batched mutual-nearest descriptor matching (`csrc/match.cu`).

Replaces `jax.vmap(features.match)` over the keyframe slot store
(`rgbd_odometry_tpu/pipeline/kf_matcher.py:103-108`,
`rgbd_odometry_tpu/ops/features.py:146-170`; XLA, no Pallas kernel): one
query frame's descriptors against every stored slot at once.
`match_mutual` is the entry point: CPU tensors go to the plain PyTorch
version `match_mutual_plain`, CUDA tensors to the kernel; anything else
raises. The kernel computes each valid pair's similarity once, in tiles
spread over a thread-block cluster a slot (`cluster_size`, a function of S
and the card's SM count alone), and merges the rows and columns as
lexicographic minima on (d2, index), so its bits do not depend on the
tiling or the cluster size.

Both versions form each similarity as the same chain of float32 fused
multiply-adds over the descriptor, d ascending, which is also the order in
which XLA:CPU's dot sums it: kernel, plain version and the JAX package
agree bit for bit, so that a frame matched with its own duplicate (every
true distance within a few ulps of 0, where the distance gate decides on
rounding) passes the same matches in all three.
"""

from __future__ import annotations

import ctypes

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.ops.project import fma_f32

_BIG = 1e9
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
    + [ctypes.c_int] + [ctypes.c_void_p] * 5
)
MAX_K = 1024  # the kernel's keypoints a frame: its compaction and shared-memory layout
CLUSTERS = (1, 2, 4, 8)


def cluster_size(slots: int, sms: int) -> int:
    """Blocks a slot: the largest of 1, 2, 4, 8 with slots x blocks <= the
    card's `sms` (one block an SM)."""
    return max([c for c in CLUSTERS if slots * c <= sms] or [1])


def pair_d2(slot_desc: torch.Tensor, slot_valid: torch.Tensor, q_desc: torch.Tensor,
            q_valid: torch.Tensor) -> torch.Tensor:
    """(S, Kq, Kr) squared descriptor distances max(2 - 2 sim, 0), 1e9 for a
    pair with an invalid side; sim is a chain of fused multiply-adds over
    the descriptor in order."""
    sim = torch.zeros((slot_desc.shape[0], q_desc.shape[0], slot_desc.shape[1]),
                      dtype=torch.float32, device=q_desc.device)
    for d in range(q_desc.shape[1]):
        sim = fma_f32(q_desc[None, :, d, None], slot_desc[:, None, :, d], sim)
    d2 = torch.clamp(2.0 - 2.0 * sim, min=0.0)
    pair = q_valid[None, :, None] & slot_valid[:, None, :]
    return torch.where(pair, d2, torch.full_like(d2, _BIG))


def match_mutual_plain(slot_desc, slot_valid, q_desc, q_valid, dist_gate_factor=3.0,
                       ratio=0.9, dist_gate_floor=1e-3):
    """The plain PyTorch version: (ref_idx (S,K) int64, dist (S,K) float32,
    good (S,K) bool, num_good (S,) int32)."""
    d2 = pair_d2(slot_desc, slot_valid, q_desc, q_valid)
    s, kq, _ = d2.shape
    best_d, best_ref = torch.min(d2, dim=2)  # first index among equals
    rows = torch.arange(kq, device=d2.device)
    d2_wo = d2.clone()
    d2_wo[torch.arange(s, device=d2.device)[:, None], rows[None, :], best_ref] = _BIG
    second_d = d2_wo.amin(dim=2)
    best_now_for_ref = torch.argmin(d2, dim=1)  # (S, Kr)
    mutual = torch.gather(best_now_for_ref, 1, best_ref) == rows[None, :]
    # correctly rounded float32 sqrt (the kernel's sqrtf)
    dist = torch.sqrt(best_d.double()).float()
    inf = torch.full_like(dist, float("inf"))
    min_d = torch.where(q_valid[None, :], dist, inf).amin(dim=1, keepdim=True)
    gate = dist <= torch.clamp(dist_gate_factor * min_d, min=dist_gate_floor)
    ratio_ok = best_d <= (ratio * ratio) * second_d
    good = q_valid[None, :] & mutual & gate & ratio_ok & (best_d < _BIG * 0.5)
    return best_ref, dist, good, good.sum(dim=1, dtype=torch.int32)


def match_mutual(slot_desc, slot_valid, q_desc, q_valid, dist_gate_factor=3.0, ratio=0.9,
                 dist_gate_floor=1e-3, cluster=None):
    """Match the query keypoints (q_desc (K,D) float32, q_valid (K,) bool)
    against S stored slots (slot_desc (S,K,D), slot_valid (S,K)) as the JAX
    `features.match` does per slot: for each query keypoint its nearest
    slot keypoint `ref_idx` (S,K) int64, the distance `dist` (S,K), whether
    the match is `good` (mutual nearest, ratio test, distance gate, both
    sides valid) and the per-slot count `num_good` (S,) int32. `cluster`
    forces the blocks a slot on the card (default `cluster_size`)."""
    if q_desc.device.type == "cpu":
        return match_mutual_plain(slot_desc, slot_valid, q_desc, q_valid, dist_gate_factor,
                                  ratio, dist_gate_floor)
    if q_desc.device.type != "cuda":
        raise ValueError(f"match_mutual: unsupported device {q_desc.device}")
    dev = q_desc.device
    if slot_desc.dim() != 3 or q_desc.dim() != 2:
        raise ValueError("match_mutual: slot_desc must be (S, K, D) and q_desc (K, D)")
    s, k, d = slot_desc.shape
    if d != 64:
        raise ValueError(f"match_mutual: the kernel takes 64-wide descriptors, got {d}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"match_mutual: the kernel takes 1 to {MAX_K} keypoints a frame, got {k}")
    ranks = cluster_size(s, build.sm_count(dev.index or 0)) if cluster is None else cluster
    if ranks not in CLUSTERS:
        raise ValueError(f"match_mutual: cluster must be one of {CLUSTERS}, got {cluster}")
    fn = "match_mutual"
    build.check_arg(fn, "slot_desc", slot_desc, (s, k, d), torch.float32, dev)
    build.check_arg(fn, "slot_valid", slot_valid, (s, k), torch.bool, dev)
    build.check_arg(fn, "q_desc", q_desc, (k, d), torch.float32, dev)
    build.check_arg(fn, "q_valid", q_valid, (k,), torch.bool, dev)
    if slot_desc.data_ptr() % 16 or q_desc.data_ptr() % 16:
        raise ValueError("match_mutual: the descriptors must be 16-byte aligned")
    ref_idx = torch.empty((s, k), dtype=torch.int64, device=dev)
    dist = torch.empty((s, k), dtype=torch.float32, device=dev)
    good = torch.empty((s, k), dtype=torch.bool, device=dev)
    num_good = torch.empty((s,), dtype=torch.int32, device=dev)
    lib = build.bind("match", fn, _ARGTYPES)
    with build.traced("match_mutual"):
        code = lib.match_mutual(
            dev.index or 0, slot_desc.data_ptr(), slot_valid.data_ptr(), q_desc.data_ptr(),
            q_valid.data_ptr(), s, k, d, float(dist_gate_factor), float(ratio * ratio),
            float(dist_gate_floor), ranks, ref_idx.data_ptr(), dist.data_ptr(), good.data_ptr(),
            num_good.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "match_mutual launch")
    match_mutual.launches += 1
    return ref_idx, dist, good, num_good


match_mutual.launches = 0
