"""The ranks of tests/test_torch_multigpu.py: processes of a gloo process
group on the CPU, each running the port's multi-GPU path on its share and
saving what it computed to an `.npz` for the test process to assert on.

Imports no JAX: the JAX references are built in the test process. The
ranks are started with the `spawn` method (`parallel/launch.Ranks`), and
every rank is joined with a deadline, so that a rank that fails or hangs
fails the test instead of stalling the suite.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np

# tests/test_sharding.py's pair: 64x48, two levels
PAIR_W, PAIR_H = 64, 48
PAIR_PSI = np.array([0.008, -0.006, 0.004, 0.003, -0.004, 0.002], np.float32)
MAX_PTS = (512, 256)
ALIGN_ITERS, STEP_ITERS = (4, 3), (3, 2)
ALIGN_BATCH, STEP_BATCH = 8, 16
# tests/test_multistream.py's streams: 160x120, two levels, 8 streams of 12 frames
N_STREAMS, N_FRAMES = 8, 12
# tests/test_sharding.py's sequence: 96x64, 6 frames
SEQ_FRAMES = 6
# tests/multihost_worker.py's recipe: windows of a 7-frame sequence
RECIPE_FRAMES, RECIPE_WINDOW, RECIPE_OVERLAP = 7, 4, 1
# the multistream command over 2 ranks
CLI_ARGS = ["multistream", "--device", "cpu", "--streams", "2", "--frames", "6", "--cam-scale",
            "0.5", "--iterations", "8,5"]
def pair_camera():
    from rgbd_odometry_tpu_torch.config import CameraConfig

    w, h = PAIR_W, PAIR_H
    return CameraConfig(width=w, height=h, fx=1.1 * w, fy=1.1 * w, cx=(w - 1) / 2.0,
                        cy=(h - 1) / 2.0)


def stream_camera():
    from rgbd_odometry_tpu_torch.config import CameraConfig

    return CameraConfig(width=160, height=120, fx=176.0, fy=176.0, cx=79.5, cy=59.5)


def seq_camera():
    from rgbd_odometry_tpu_torch.config import CameraConfig

    return CameraConfig(width=96, height=64, fx=100.0, fy=100.0, cx=47.5, cy=31.5)


def recipe_camera():
    from rgbd_odometry_tpu_torch.config import CameraConfig

    return CameraConfig(width=64, height=48, fx=70.0, fy=70.0, cx=31.5, cy=23.5)


def pair_batch(batch: int, distinct: bool):
    """Host arrays (ref gray, ref depth, now gray, now depth) of `batch`
    pairs at tests/test_sharding.py's size: its one pair repeated, or pair
    k with its twist scaled by 1 + k/4 and seed k (pair 0 is its pair)."""
    from rgbd_odometry_tpu_torch.io.synthetic import render_pair

    rs = [render_pair(pair_camera(), PAIR_PSI * (1 + 0.25 * k) if distinct else PAIR_PSI,
                      seed=k if distinct else 0) for k in range(batch)]
    return tuple(np.stack([r[i][j] for r in rs]) for i in (0, 1) for j in (0, 1))


def pyramids(frames, levels: int = 2):
    """(ref gray pyramid, ref depth pyramid, now gray pyramid) of host
    pair arrays, as host tensors."""
    import torch

    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid

    rg, rd, ng, nd = (torch.from_numpy(x) for x in frames)
    ref, now = build_pyramid(rg, rd, levels), build_pyramid(ng, nd, levels)
    return tuple(ref.gray), tuple(ref.depth), tuple(now.gray)


def _twists(amp, n):
    phase = np.sin(np.pi * np.arange(n) / (n - 1))
    return np.stack([amp * phase, -0.5 * amp * phase, 0.3 * amp * phase, 0.2 * amp * phase,
                     -0.15 * amp * phase, 0.1 * amp * phase], -1).astype(np.float32)


def _linear(step, n):
    ts = np.arange(n)
    return np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts, 0.15 * step * ts,
                     -0.2 * step * ts, 0.1 * step * ts], -1).astype(np.float32)


def stream_sequences(motion_model: str):
    """tests/test_multistream.py's frames: (N, F, H, W) gray and depth."""
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    seqs = [render_sequence(stream_camera(), _twists(0.02 + 0.004 * s, N_FRAMES), seed=s)[0]
            if motion_model == "hold" else
            render_sequence(stream_camera(), _linear(0.004 + 0.0008 * s, N_FRAMES),
                            seed=10 + s)[0]
            for s in range(N_STREAMS)]
    return (np.stack([[f[0] for f in sq] for sq in seqs]),
            np.stack([[f[1] for f in sq] for sq in seqs]))


def stream_config(motion_model: str):
    from rgbd_odometry_tpu_torch.config import (
        KeyframeConfig, PipelineConfig, PyramidConfig, SolverConfig,
    )

    return PipelineConfig(
        camera=stream_camera(), pyramid=PyramidConfig(num_levels=2, max_points=(768, 384)),
        solver=SolverConfig(method="gauss_newton", iterations=(8, 6)),
        keyframe=KeyframeConfig(force_every=5, enable_quality_triggers=False,
                                rollback_resolve=False),
        motion_model=motion_model)


def sequence_frames():
    """tests/test_sharding.py's sequence: grays, depths."""
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    ts = np.arange(SEQ_FRAMES)
    psis = np.stack([0.004 * ts, -0.003 * ts, 0.002 * ts, 0.001 * ts, -0.001 * ts,
                     0.0005 * ts], -1).astype(np.float32)
    frames, _ = render_sequence(seq_camera(), psis, seed=0)
    return [f[0] for f in frames], [f[1] for f in frames]


def recipe_psis():
    ts = np.arange(RECIPE_FRAMES)
    return np.stack([0.004 * ts, -0.002 * ts, 0.001 * ts, 0.001 * ts, -0.001 * ts,
                     0.0005 * ts], -1).astype(np.float32)


def lockstep(multi, gray, depth):
    for f in range(gray.shape[1]):
        multi.process_batch(gray[:, f], depth[:, f], timestamp=f / 30.0)
    return multi


def mesh_rank(rank: int, world: int, address: str, out_dir: str, inputs: str):
    """One of the 4 ranks: the sharded aligner, the sharded train step,
    lockstep in both motion models and `align_sequence` in both pairing
    modes, each with the collectives it called."""
    import torch

    torch.set_num_threads(1)
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.config import SolverConfig
    from rgbd_odometry_tpu_torch.parallel import launch
    from rgbd_odometry_tpu_torch.parallel import mesh as pmesh
    from rgbd_odometry_tpu_torch.parallel import multihost
    from rgbd_odometry_tpu_torch.parallel.sequence import align_sequence
    from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry

    multihost.initialize(address, world, rank, backend=multihost.GLOO, timeout_s=240)
    mesh = multihost.global_mesh("cpu")
    data = np.load(inputs)
    out = {}
    intr = Intrinsics.from_config(pair_camera())
    for key in ("same", "distinct"):
        aligner = pmesh.build_sharded_aligner(
            mesh, intr, SolverConfig(method="gauss_newton", iterations=ALIGN_ITERS), MAX_PTS)
        counts: dict = {}
        with launch.counted_collectives(counts):
            R, t = aligner(*pmesh.shard_batch(mesh, pyramids(
                tuple(data[f"align_{key}_{i}"] for i in range(4)))))
        out[f"align_{key}_R"], out[f"align_{key}_t"] = R.numpy(), t.numpy()
        out[f"align_{key}_collectives"] = json.dumps(counts)

    step = pmesh.build_sharded_train_step(
        mesh, intr, SolverConfig(method="gauss_newton", iterations=STEP_ITERS), MAX_PTS)
    counts = {}
    with launch.counted_collectives(counts):
        (R, t), stats = step(*pmesh.shard_batch(mesh, pyramids(
            tuple(data[f"step_{i}"] for i in range(4)))))
    out["step_R"], out["step_t"] = R.numpy(), t.numpy()
    for k, v in stats.items():
        out[f"step_{k}"] = v.numpy()
    out["step_collectives"] = json.dumps(counts)

    for model in ("hold", "constant_velocity"):
        multi = MultiStreamOdometry(N_STREAMS, stream_config(model), mesh=mesh)
        counts = {}
        with launch.counted_collectives(counts):
            lockstep(multi, data[f"{model}_gray"], data[f"{model}_depth"])
        out[f"{model}_collectives"] = json.dumps(counts)
        out[f"{model}_local_streams"] = np.array([multi.lo, multi.hi])
        gops = multi.all_gops()
        out[f"{model}_R"] = np.stack([g.poses()[0] for g in gops])
        out[f"{model}_t"] = np.stack([g.poses()[1] for g in gops])
        out[f"{model}_keyframes"] = np.array([g.keyframe_indices() for g in gops])
        out[f"{model}_diverged"] = len(multi.diverged_frames)

    grays = [data["seq_gray"][i] for i in range(SEQ_FRAMES)]
    depths = [data["seq_depth"][i] for i in range(SEQ_FRAMES)]
    for kf in (None, 3):
        R, t, rel_R, rel_t = align_sequence(
            grays, depths, Intrinsics.from_config(seq_camera()),
            SolverConfig(method="gauss_newton", iterations=(10, 4)), max_points=(1024, 512),
            num_levels=2, keyframe_every=kf, mesh=mesh)
        out[f"seq_{kf}_R"], out[f"seq_{kf}_t"] = R, t
        out[f"seq_{kf}_rel_R"], out[f"seq_{kf}_rel_t"] = rel_R, rel_t
    multihost.shutdown()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def window_odometry(lo: int, hi: int):
    """tests/multihost_worker.py's window-local odometry with the port:
    the window's consecutive pairs aligned one by one and composed in
    float64 from its first frame. Returns (R (T,3,3), t (T,3), the last
    frame's distance to ground truth)."""
    import torch

    from rgbd_odometry_tpu_torch.config import SolverConfig
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    frames, poses = render_sequence(recipe_camera(), recipe_psis()[lo:hi], seed=0)
    intr = Intrinsics.from_config(recipe_camera())
    cfg = SolverConfig(method="gauss_newton", iterations=(4, 3))
    Rs, ts = [np.eye(3)], [np.zeros(3)]
    for i in range(1, len(frames)):
        rp = build_pyramid(*(torch.from_numpy(x)[None] for x in frames[i - 1]), 2)
        np_ = build_pyramid(*(torch.from_numpy(x)[None] for x in frames[i]), 2)
        R, t, _ = edge_dvo.align_pair(rp.gray, rp.depth, np_.gray, intr, cfg, MAX_PTS)
        R, t = R[0].numpy().astype(np.float64), t[0].numpy().astype(np.float64)
        ts.append(ts[-1] + Rs[-1] @ t)
        Rs.append(Rs[-1] @ R)
    gt_rel_t = poses[-1][1] - poses[0][1]
    err = np.linalg.norm(ts[-1] - np.asarray(poses[0][0]).T @ gt_rel_t)
    return np.stack(Rs), np.stack(ts), err


def recipe_rank(rank: int, world: int, address: str, cli_address: str, out_dir: str):
    """One of the 2 ranks: tests/multihost_worker.py's recipe (its own
    window of a 7-frame sequence aligned pair by pair, one statistic
    reduced across the ranks), then `multistream --world-size 2`."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from rgbd_odometry_tpu_torch import cli
    from rgbd_odometry_tpu_torch.parallel import multihost as mh

    mh.initialize(address, world, rank, backend=mh.GLOO, timeout_s=240)
    windows = mh.shard_sequence_windows(RECIPE_FRAMES, RECIPE_WINDOW, RECIPE_OVERLAP)
    lo, hi = mh.local_window(windows)
    R, t, err = window_odometry(lo, hi)
    total = torch.tensor([err], dtype=torch.float64)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)  # the one statistic across the ranks
    mean_err = float(total[0]) / world
    mh.shutdown()

    argv = CLI_ARGS + ["--world-size", str(world), "--rank", str(rank), "--dist-address",
                       cli_address]
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        summary = cli.main(argv)
    np.savez(os.path.join(out_dir, f"recipe{rank}.npz"), R=R, t=t, mean_window_err=mean_err,
             lo=lo, hi=hi, cli_stdout=stdout.getvalue(), cli_summary=json.dumps(summary))
