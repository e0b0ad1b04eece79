"""Batched frame-pair alignment over the ranks of a process group: port of
`rgbd_odometry_tpu/parallel/mesh.py`.

JAX shards the pair batch over a device mesh and reduces the trajectory
statistics across it, by the `psum` XLA inserts (`build_sharded_train_step`)
or by explicit ones (`build_shardmap_train_step`). The port's counterpart
of a mesh axis is a `torch.distributed` process group, one process and one
device a rank: `Mesh` records this rank's place in it, `shard_batch` puts
this rank's contiguous rows of a batch on its device, and the sharded
aligner and train step run `align_pair` over those rows. Pairs never
exchange data, so what crosses ranks is the poses the host wants (one
gather a call) and the batch statistics (one `all_reduce` a step). Without
a process group `make_mesh` gives the world-1 mesh, on which the same code
runs no collective. JAX's sharding specs (`batch_spec`, `replicated`) have
no counterpart: a rank's rows are its shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import SolverConfig
from rgbd_odometry_tpu_torch.core.camera import Intrinsics
from rgbd_odometry_tpu_torch.device import resolve_device
from rgbd_odometry_tpu_torch.solvers import edge_dvo


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place among the ranks: its rank, their number, the
    device it drives and the process group (None: no process group, world
    1, no collective)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[object] = None

    def rows(self, n: int, shape=None) -> slice:
        """This rank's contiguous rows of a leading axis of `n`; raises
        JAX's error when `n` is not a multiple of the world size."""
        if n % self.world_size:
            raise ValueError(
                f"the mesh of {self.world_size} ranks implies that the global size of "
                f"dimension 0 should be divisible by {self.world_size}, but it is equal to {n}"
                + (f" (full shape: {tuple(shape)})" if shape is not None else ""))
        b = n // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)


def local_mesh(device=None) -> Mesh:
    """The world-1 mesh on `device` (default: the current card), whatever
    process group is open: one process's own work, with no collective.
    What the parallel entry points run on when they are given no mesh."""
    return Mesh(0, 1, resolve_device(device))


def make_mesh(device=None) -> Mesh:
    """The mesh over every rank of the open process group, or the world-1
    mesh (`local_mesh`) without one. The device is `device` if given, else
    the card `local rank % torch.cuda.device_count()` of this host (ranks
    beyond the cards share them); without a card the caller must ask for
    the CPU."""
    import torch.distributed as dist

    from rgbd_odometry_tpu_torch.parallel import multihost

    if not (dist.is_available() and dist.is_initialized()):
        return local_mesh(device)
    if device is None and torch.cuda.is_available():
        device = f"cuda:{multihost.local_rank() % torch.cuda.device_count()}"
    return Mesh(dist.get_rank(), dist.get_world_size(), resolve_device(device), dist.group.WORLD)


def _flatten(tree, leaves: list):
    """The tree's structure, its array leaves appended to `leaves` in order
    (tuples, lists, named tuples and dicts are nodes)."""
    if isinstance(tree, dict):
        return dict, [(k, _flatten(v, leaves)) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return type(tree), [_flatten(v, leaves) for v in tree]
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, children = spec
    if kind is dict:
        return {k: _unflatten(c, leaves) for k, c in children}
    items = [_unflatten(c, leaves) for c in children]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def shard_batch(mesh: Mesh, pytree):
    """This rank's rows of every array in `pytree` (numpy arrays or host
    tensors, each with the batch as its leading axis) on `mesh.device`, in
    one host-to-device copy: the rows are packed into one staging buffer,
    copied once and viewed back. Raises (JAX's error) when a batch is not a
    multiple of the world size."""
    leaves: list = []
    spec = _flatten(pytree, leaves)
    rows = [torch.as_tensor(x[mesh.rows(x.shape[0], x.shape)]).contiguous() for x in leaves]
    # 16-byte aligned byte offsets, so that every piece views back as its dtype
    sizes = [x.numel() * x.element_size() for x in rows]
    offsets = np.concatenate([[0], np.cumsum([-(-n // 16) * 16 for n in sizes])]).tolist()
    buf = torch.empty(offsets[-1], dtype=torch.uint8)
    for x, off, n in zip(rows, offsets, sizes):
        buf[off:off + n] = x.reshape(-1).view(torch.uint8)
    dev = buf.to(mesh.device)
    return _unflatten(spec, iter(dev[off:off + n].view(x.dtype).reshape(x.shape)
                                 for x, off, n in zip(rows, offsets, sizes)))


def _all_gather_rows(group, local: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `local` (equal shapes), in rank order, on the
    host: one copy to the host and, with a process group, one `all_gather`
    of host tensors (gloo takes those under either backend)."""
    host = local.cpu()
    if group is None:
        return host
    import torch.distributed as dist

    parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts)


def _aligner(group, intr: Intrinsics, cfg: SolverConfig, max_points: Tuple[int, ...]):
    edge_dvo.check_config(cfg)

    def aligner(ref_gray_pyr, ref_depth_pyr, now_gray_pyr):
        R, t, _ = edge_dvo.align_pair(ref_gray_pyr, ref_depth_pyr, now_gray_pyr, intr, cfg,
                                      max_points)
        poses = _all_gather_rows(group, torch.cat([R.reshape(-1, 9), t], dim=1))
        return poses[:, :9].reshape(-1, 3, 3), poses[:, 9:]

    return aligner


def build_sharded_aligner(mesh: Mesh, intr: Intrinsics, cfg: SolverConfig,
                          max_points: Tuple[int, ...]):
    """The sharded batched aligner: (ref gray pyramid, ref depth pyramid,
    now gray pyramid), this rank's rows of each level (as `shard_batch`
    gives them), -> the global (R (B,3,3), t (B,3)) on the host of every
    rank. One `align_pair` over the local rows, so the kernels run at
    B / W, and one gather of the poses (none at world 1)."""
    return _aligner(mesh.group, intr, cfg, max_points)


def _train_step(group, intr: Intrinsics, cfg: SolverConfig, max_points: Tuple[int, ...]):
    edge_dvo.check_config(cfg)

    def step(ref_gray_pyr, ref_depth_pyr, now_gray_pyr):
        R, t, diags = edge_dvo.align_pair(ref_gray_pyr, ref_depth_pyr, now_gray_pyr, intr, cfg,
                                          max_points)
        finest = diags[0]
        f64 = torch.float64
        sums = torch.stack([finest.best_energy.to(f64).sum(), finest.visible_ratio.to(f64).sum(),
                            finest.num_points.to(f64).sum(),
                            torch.tensor(float(R.shape[0]), dtype=f64, device=R.device)])
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        stats = {
            "mean_energy": (sums[0] / sums[3]).to(finest.best_energy.dtype),
            "mean_visible_ratio": (sums[1] / sums[3]).to(finest.visible_ratio.dtype),
            "total_points": sums[2].to(torch.int64),
        }
        return (R, t), stats

    return step


def build_batch_step(intr: Intrinsics, cfg: SolverConfig, max_points: Tuple[int, ...]):
    """The batched alignment step of one process: (ref gray pyramid, ref
    depth pyramid, now gray pyramid) of B pairs -> ((R (B,3,3), t (B,3)),
    stats), the stats over the finest level as 0-dim tensors on the device:
    `mean_energy` (of the all-point energy at the returned pose),
    `mean_visible_ratio` and `total_points`. The world-1 case of
    `build_sharded_train_step`: the same sums, and no collective."""
    return _train_step(None, intr, cfg, max_points)


def build_sharded_train_step(mesh: Mesh, intr: Intrinsics, cfg: SolverConfig,
                             max_points: Tuple[int, ...]):
    """The sharded train step, JAX's `build_sharded_train_step` and
    `build_shardmap_train_step` (which compute the same thing): this
    rank's rows aligned, then ONE `all_reduce(SUM)` of [sum of the finest
    level's best energy, sum of its visible ratio, its point count, the
    pair count] (float64, on the device) across the ranks, the means taken
    from the reduced sums as `shard_map`'s explicit `psum`s take them.
    Returns ((R, t) of this rank's rows, on the device; the global stats,
    0-dim tensors on the device of every rank: `mean_energy`,
    `mean_visible_ratio` (float32) and `total_points` (int64))."""
    return _train_step(mesh.group, intr, cfg, max_points)
