"""Profile the port's per-frame paths on one GPU with `torch.profiler`.

    python -m rgbd_odometry_tpu_torch.profile_paths [--frames 30] [--warmup 10]
    python -m rgbd_odometry_tpu_torch.profile_paths --paths cli_subgradient \
        --frames 10 --warmup 4

Copied into an older checkout of the package and run there, it profiles
that checkout (it uses only names the package has always exported).

Paths, each over rendered 320x240 frames through `EdgeDvoOdometry.
process_frame`, keyframe every 5:

  cli_default  the `dvo` command's defaults (standard LM on the normalized
               full DT, 18/6/4/3 iterations, capacities 8192/4096/2048/1024);
  stream       `profiles.production_320` with rollback re-solves (the
               stream phase of chip_smoke.py);
  cli_subgradient  `dvo --method subgradient --iterations 50,50,50,50`, the
               reference's solver (not in the default: run it in a process
               of its own, with fewer frames for a checkout older than the
               whole-level kernel, whose frame is ~46000 launches).

`--paths multistream` (not in the default; it renders 16 streams on the
host first, ~1 minute) profiles the `multistream` command's lockstep loop
(`parallel/streams.MultiStreamOdometry` at the command's defaults with
`--quality-triggers`) at N = 16 and N = 64 streams (the 16 rendered
streams tiled four times), `--frames` steps of which the first `--warmup`
run unprofiled, as for the per-frame paths: per step the wall time,
`cudaLaunchKernel` calls (and per stream-frame), kernel device time and the
device's busy share, the aggregate frames/s.

`--paths targets` (not in the default; run it alone, since after the
per-frame paths' profiles in the same process the profiler was seen to drop
kernel records, which this mode reports as an error) profiles the now-frame
target kernels, 20 calls each at 240x320 for B = 64 and B = 1 on rendered
frames: per call, the device time and the launches of every CUDA kernel
behind `canny_pyramid` (the 4-level pyramid), `canny` (a pyramid of one
level: level 0, and the four levels one call each), `dt_channels` (+-16
window in pixels, and the whole row normalized) and `edt_squared`.

The first `--warmup` frames run unprofiled; the rest run once unprofiled
(host clock, ending in a synchronise: ms/frame, and the mean
`FrameMetrics.solve_ms`, the CLI's `avg solve`) and once under the profiler
from a fresh odometry at the same frame: `cudaLaunchKernel` calls per frame,
the kernels' summed device time per frame, the device's busy share (the
union of the kernel intervals over the profiled wall time, which the
profiler itself lengthens) and the top kernels by device time. Prints the
card's name and power limit first, one JSON line per path last. Needs a
CUDA device (exits 2 without one).
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np


def _trajectory(n: int, step: float = 0.002):
    ts = np.arange(n)
    return np.stack(
        [0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
         0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts],
        axis=-1,
    ).astype(np.float32)


def _configs():
    # the package's top-level names only, which older checkouts export too
    from rgbd_odometry_tpu_torch import (
        CameraConfig, KeyframeConfig, PipelineConfig, PyramidConfig, SolverConfig, profiles,
    )

    prof = profiles.production_320()
    return {
        "cli_default": PipelineConfig(
            camera=CameraConfig(),
            solver=SolverConfig(method="gauss_newton", iterations=(18, 6, 4, 3)),
            keyframe=KeyframeConfig(force_every=5),
        ),
        "cli_subgradient": PipelineConfig(
            camera=CameraConfig(),
            solver=SolverConfig(method="subgradient", iterations=(50, 50, 50, 50)),
            keyframe=KeyframeConfig(force_every=5),
        ),
        "stream": PipelineConfig(
            camera=prof.camera,
            pyramid=PyramidConfig(num_levels=prof.num_levels, max_points=prof.max_points),
            solver=prof.solver,
            keyframe=KeyframeConfig(force_every=5, rollback_resolve=True),
        ),
    }


def _busy_us(kernels) -> float:
    """Length of the union of the kernels' device intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -float("inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_path(name, cfg, frames, warmup: int, device) -> dict:
    import torch

    from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry

    def fresh():
        odo = EdgeDvoOdometry(cfg, device=device)
        for i, (g, d) in enumerate(frames[:warmup]):
            odo.process_frame(g, d, timestamp=float(i))
        torch.cuda.synchronize()
        return odo

    window = list(enumerate(frames))[warmup:]
    odo = fresh()
    t0 = time.perf_counter()
    for i, (g, d) in window:
        odo.process_frame(g, d, timestamp=float(i))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0 / len(window)
    solve_ms = float(np.mean([m.solve_ms for m in list(odo.metrics)[-len(window):]]))

    odo = fresh()

    def run():
        for i, (g, d) in window:
            odo.process_frame(g, d, timestamp=float(i))

    prof = _profile_window(run, len(window))
    out = {
        "path": name, "frames": len(window), "ms_per_frame": ms, "avg_solve_ms": solve_ms,
        "launches_per_frame": prof["launches"], "syncs_per_frame": prof["syncs"],
        "kernels_per_frame": prof["kernels"], "kernel_ms_per_frame": prof["kernel_ms"],
        "busy_share": prof["busy_share"], "profiled_ms_per_frame": prof["profiled_ms"],
        "top_kernels_ms_per_frame": prof["top_kernels_ms"],
    }
    out["package"] = sys.modules["rgbd_odometry_tpu_torch"].__file__
    print(json.dumps(out), flush=True)
    return out


def _profile_window(run, steps: int) -> dict:
    """`run()` under the profiler: per step the `cudaLaunchKernel` calls,
    host syncs, kernels and their device time, the busy share and the top
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avg = prof.key_averages()
    launches = sum(e.count for e in avg
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    syncs = sum(e.count for e in avg
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaEventSynchronize"))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "launches": launches / steps, "syncs": syncs / steps, "kernels": len(kernels) / steps,
        "kernel_ms": sum(by_name.values()) / steps / 1000.0,
        "busy_share": _busy_us(kernels) / wall_us, "profiled_ms": wall_us / steps / 1000.0,
        "top_kernels_ms": [(k[:60], v / steps / 1000.0) for k, v in top],
    }


def profile_multistream(device, frames: int, warmup: int, streams=(16, 64)) -> list:
    """The `multistream` command's lockstep loop at each stream count: host
    clock per step over the steps after `warmup`, then the same steps under
    the profiler from a fresh `MultiStreamOdometry`."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig
    from rgbd_odometry_tpu_torch.cli import multistream_config, render_streams
    from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry

    cfg = multistream_config(CameraConfig(), quality_triggers=True)
    t0 = time.perf_counter()
    seqs, _ = render_streams(cfg.camera, 16, frames)
    render_s = time.perf_counter() - t0
    outs = []
    for n in streams:
        batches = [(np.stack([seqs[s % 16][f][0] for s in range(n)]),
                    np.stack([seqs[s % 16][f][1] for s in range(n)])) for f in range(frames)]

        def fresh():
            ms = MultiStreamOdometry(n, cfg, device=device)
            for f in range(warmup):
                ms.process_batch(*batches[f], timestamp=f / 30.0)
            torch.cuda.synchronize()
            return ms

        def window(ms):
            for f in range(warmup, frames):
                ms.process_batch(*batches[f], timestamp=f / 30.0)

        steps = frames - warmup
        ms = fresh()
        t0 = time.perf_counter()
        window(ms)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1000.0 / steps
        refreshes = sum(sum(1 for k in g.keyframe_indices() if k >= warmup) for g in ms.gops)
        ms = fresh()
        prof = _profile_window(lambda: window(ms), steps)
        out = {
            "path": "multistream", "streams": n, "steps": steps, "ms_per_step": ms_step,
            "aggregate_frames_per_s": n * 1000.0 / ms_step,
            "stream_refreshes_per_step": refreshes / steps,
            "launches_per_step": prof["launches"], "launches_per_stream_frame":
            prof["launches"] / n, "syncs_per_step": prof["syncs"],
            "kernels_per_step": prof["kernels"], "kernel_ms_per_step": prof["kernel_ms"],
            "busy_share": prof["busy_share"], "profiled_ms_per_step": prof["profiled_ms"],
            "top_kernels_ms_per_step": prof["top_kernels_ms"], "render_s": render_s,
        }
        print(json.dumps(out), flush=True)
        outs.append(out)
    return outs


def _extract_cases(pyr, edges_pyr) -> dict:
    """`extract_pyramid` on the rendered pyramid at production_320's and the
    `dvo` defaults' capacities, as functions of the batch size (an empty
    dict where the package has no such kernel)."""
    try:
        from rgbd_odometry_tpu_torch.kernels.extract import extract_pyramid
    except ImportError:
        return {}
    from rgbd_odometry_tpu_torch import SolverConfig, profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics

    p320 = profiles.production_320()
    intr = Intrinsics.from_config(p320.camera)

    def case(cfg, caps):
        def run(b):
            return extract_pyramid(tuple(e[:b].contiguous() for e in edges_pyr),
                                   tuple(d[:b].contiguous() for d in pyr.depth), intr, cfg, caps)
        return run

    return {"extract_pyramid production_320": case(p320.solver, p320.max_points),
            "extract_pyramid dvo defaults": case(SolverConfig(), (8192, 4096, 2048, 1024))}


def profile_targets(device, batch: int = 64, reps: int = 20) -> dict:
    """Per call of each target entry point, [device time (us), launches] of
    each CUDA kernel behind it, at 240x320 on `batch` rendered frames and on
    one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbd_odometry_tpu_torch import CameraConfig
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.kernels import canny, edt

    frames, _ = render_sequence(CameraConfig(), _trajectory(batch), seed=0)
    gray = torch.from_numpy(np.stack([g for g, _ in frames])).to(device)
    depth = torch.from_numpy(np.stack([d for _, d in frames])).to(device)
    full = build_pyramid(gray, depth, 4)
    pyr = full.gray
    edges = canny.canny(gray)
    edges_pyr = canny.canny_pyramid(pyr)
    extract = _extract_cases(full, edges_pyr)
    out = {"path": "targets", "batch": batch, "reps": reps}
    for b in (batch, 1):
        g, e = gray[:b].contiguous(), edges[:b].contiguous()
        levels = tuple(x[:b].contiguous() for x in pyr)
        cases = {
            "canny_pyramid": lambda: canny.canny_pyramid(levels),
            "canny": lambda: canny.canny(g),
            "canny 4 levels": lambda: [canny.canny(x) for x in levels],
            "dt_channels R=16 pixels bf16": lambda: edt.dt_channels(e, 16, False, True),
            "dt_channels R=0 normalized bf16": lambda: edt.dt_channels(e, 0, True, True),
            "edt_squared R=16": lambda: edt.edt_squared(e, 16),
            **{name: functools.partial(fn, b) for name, fn in extract.items()},
        }
        for name, fn in cases.items():
            fn()
            torch.cuda.synchronize()
            # the profiler was seen to drop all kernel records of one window
            # after many windows in one process: such a window is profiled again
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                kernels = [ev for ev in prof.key_averages()
                           if ev.device_time_total > 0 and ev.count >= reps]
                if kernels:
                    break
                print(f"profile_targets: no kernel record for {name} B={b}; again",
                      file=sys.stderr, flush=True)
            else:
                raise RuntimeError(f"profile_targets: no kernel record for {name} B={b}")
            out[f"{name} B={b}"] = {
                re.search(r"(\w+(?:<[^>]*>)?)\(", ev.key).group(1):
                [ev.device_time_total / reps, ev.count / reps] for ev in kernels}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--paths", default="cli_default,stream")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device is available", file=sys.stderr)
        return 2
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    device = resolve_device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    configs = _configs()
    for name in args.paths.split(","):
        if name == "targets":
            profile_targets(device)
            continue
        if name == "multistream":
            profile_multistream(device, args.frames, args.warmup)
            continue
        cfg = configs[name]
        frames, _ = render_sequence(cfg.camera, _trajectory(args.frames), seed=0)
        profile_path(name, cfg, frames, args.warmup, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
