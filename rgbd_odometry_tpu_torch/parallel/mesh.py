"""Batched frame-pair alignment with batch statistics: what
`rgbd_odometry_tpu/parallel/mesh.py` computes, on one device.

The JAX module shards the pair batch over a device mesh and reduces the
trajectory statistics across it (`build_sharded_train_step`,
`build_shardmap_train_step`). On one card the batch is one `align_pair`
call and the statistics are plain reductions over it. The mesh itself
(`make_mesh`, `shard_batch`, the sharded aligners) is ROADMAP.md's
multi-GPU item.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgbd_odometry_tpu_torch.config import SolverConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.solvers import edge_dvo


def build_batch_step(intr: Intrinsics, cfg: SolverConfig, max_points: Tuple[int, ...]):
    """The batched alignment step: (ref gray pyramid, ref depth pyramid, now
    gray pyramid) of B pairs -> ((R (B,3,3), t (B,3)), stats), the stats
    over the finest level as 0-dim tensors on the device: `mean_energy` (of
    the all-point energy at the returned pose), `mean_visible_ratio` and
    `total_points`."""
    edge_dvo.check_config(cfg)

    def step(ref_gray_pyr, ref_depth_pyr, now_gray_pyr):
        R, t, diags = edge_dvo.align_pair(ref_gray_pyr, ref_depth_pyr, now_gray_pyr, intr, cfg,
                                          max_points)
        finest = diags[0]
        stats = {
            "mean_energy": torch.mean(finest.best_energy),
            "mean_visible_ratio": torch.mean(finest.visible_ratio),
            "total_points": torch.sum(finest.num_points),
        }
        return (R, t), stats

    return step
