"""Profile the port's per-frame paths on one GPU with `torch.profiler`.

    python -m rgbd_odometry_tpu_torch.profile_paths [--frames 30] [--warmup 10]
    python -m rgbd_odometry_tpu_torch.profile_paths --paths cli_subgradient \
        --frames 10 --warmup 4
    python -m rgbd_odometry_tpu_torch.profile_paths --paths stream_vga,pipelined

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
               whole-level kernel, whose frame is ~46000 launches);
  stream_vga   `profiles.production_vga` (5 levels from 640x480, capacities
               4096/2048/1024/512/512, LM 4/18/6/4/3) with rollback re-solves
               over the same trajectory rendered at 640x480 (one sample a
               pixel; not in the default).

`--paths pipelined` (not in the default) runs the stream path's frames
through `EdgeDvoOdometry.process_stream` (frame n+1 launched off frame n's
unresolved outputs) and through the sequential `process_pyramid`, each fed
by a `FrameFeeder` and from pyramids built on the card beforehand, after the
same `--warmup` frames: ms/frame twice (A B C D D C B A), then per frame the
same profiled numbers as the per-frame paths, and the speculative solves
`process_stream` discarded.

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
behind `canny_pyramid` (the 4-level pyramid; production_vga's 5 levels on
the frames doubled to 640x480; 4 levels on the frames quadrupled to
1280x960), `canny` (a pyramid of one level: level 0, and the four levels
one call each), `dt_channels` (+-16 window in pixels, and the whole row
normalized), `edt_squared` and `extract_pyramid` (production_320's and the
`dvo` defaults' capacities, production_vga's on the 640x480 pyramid and the
`dvo` defaults' on the 1280x960 one); `canny_pyramid` and `extract_pyramid`
on the route their rule takes and forced to each cluster size (1, 2, 4, 8
blocks a (level, image)). A case that raises for its shape or route in the
checkout profiled is reported "not supported".

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
import inspect
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
        **{name: PipelineConfig(
            camera=p.camera,
            pyramid=PyramidConfig(num_levels=p.num_levels, max_points=p.max_points),
            solver=p.solver,
            keyframe=KeyframeConfig(force_every=5, rollback_resolve=True),
        ) for name, p in (("stream", prof), ("stream_vga", profiles.production_vga()))},
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


def profile_pipelined(cfg, frames, warmup: int, device) -> list:
    """`process_stream` and the sequential `process_pyramid` over the frames
    after `warmup` (run first through `process_frame`), each fed two ways:
    by a `FrameFeeder` (the `dvo` command's way) and from pyramids built on
    the card beforehand (pipelining alone). Host clock per frame twice, in
    the order A B C D D C B A, then once under the profiler each."""
    import torch

    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder
    from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry

    window = [(g, d, float(i)) for i, (g, d) in enumerate(frames)][warmup:]
    f32 = dict(dtype=torch.float32, device=device)
    prebuilt = [(build_pyramid(torch.as_tensor(g, **f32)[None], torch.as_tensor(d, **f32)[None],
                               cfg.pyramid.num_levels), ts) for g, d, ts in window]

    def fresh():
        odo = EdgeDvoOdometry(cfg, device=device)
        for i, (g, d) in enumerate(frames[:warmup]):
            odo.process_frame(g, d, timestamp=float(i))
        torch.cuda.synchronize()
        return odo

    def run(odo, mode, source):
        items = (FrameFeeder(iter(window), num_levels=cfg.pyramid.num_levels, device=device)
                 if source == "feeder" else iter(prebuilt))
        if mode == "process_stream":
            for _pose in odo.process_stream(items):
                pass
        else:
            for pyr, ts in items:
                odo.process_pyramid(pyr, ts)

    cases = [(m, s) for s in ("feeder", "prebuilt") for m in ("process_stream", "process_pyramid")]
    ms, discarded = {c: [] for c in cases}, {}
    for case in cases + cases[::-1]:
        odo = fresh()
        t0 = time.perf_counter()
        run(odo, *case)
        torch.cuda.synchronize()
        ms[case].append((time.perf_counter() - t0) * 1000.0 / len(window))
        discarded[case] = odo.discarded_dispatches
    outs = []
    for case in cases:
        odo = fresh()
        prof = _profile_window(lambda: run(odo, *case), len(window))
        out = {
            "path": "pipelined", "mode": case[0], "source": case[1], "frames": len(window),
            "ms_per_frame": ms[case], "discarded_dispatches": discarded[case],
            "launches_per_frame": prof["launches"], "syncs_per_frame": prof["syncs"],
            "kernels_per_frame": prof["kernels"], "kernel_ms_per_frame": prof["kernel_ms"],
            "busy_share": prof["busy_share"], "profiled_ms_per_frame": prof["profiled_ms"],
            "top_kernels_ms_per_frame": prof["top_kernels_ms"],
        }
        print(json.dumps(out), flush=True)
        outs.append(out)
    return outs


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


def _forced(fn) -> tuple:
    """The cluster sizes a target entry point can be forced to (none in a
    checkout whose kernel has no `cluster` keyword)."""
    return (1, 2, 4, 8) if "cluster" in inspect.signature(fn).parameters else ()


def _pyramids(device, gray, depth) -> dict:
    """The rendered 320x240 frames as the 4-level pyramid, doubled to
    640x480 as production_vga's 5-level one and quadrupled to 1280x960 as
    `dvo --cam-scale 4`'s 4-level one (nearest), each with its Canny edges
    at the `dvo` defaults (the parent of a kernel that cannot take a level
    gets none: None)."""
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import canny

    up = lambda x, f: x.repeat_interleave(f, 1).repeat_interleave(f, 2)  # noqa: E731
    out = {}
    for name, f, levels in (("320x240", 1, 4), ("vga", 2, 5), ("1280x960", 4, 4)):
        pyr = build_pyramid(up(gray, f), up(depth, f), levels)
        try:
            edges = canny.canny_pyramid(pyr.gray)
        except ValueError:  # an older checkout's cap
            edges = None
        out[name] = (pyr, edges)
    return out


def _extract_cases(pyramids) -> dict:
    """`extract_pyramid` on the rendered pyramids at production_320's and
    the `dvo` defaults' capacities (320x240), production_vga's (640x480)
    and the `dvo` defaults' (1280x960), on the rule's route and on each
    forced cluster size the kernel takes, as functions of the batch size
    (an empty dict where the package has no such kernel)."""
    try:
        from rgbd_odometry_tpu_torch.kernels.extract import extract_pyramid
    except ImportError:
        return {}
    from rgbd_odometry_tpu_torch import SolverConfig, profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics

    p320, vga = profiles.production_320(), profiles.production_vga()
    dvo_caps = (8192, 4096, 2048, 1024)

    def case(name, cam, cfg, caps, **kw):
        full, edges = pyramids[name]
        intr = Intrinsics.from_config(cam)

        def run(b):
            return extract_pyramid(tuple(e[:b].contiguous() for e in edges),
                                   tuple(d[:b].contiguous() for d in full.depth), intr, cfg, caps,
                                   **kw)
        return run if edges is not None else None

    out = {}
    for label, name, cam, cfg, caps in (
            ("production_320", "320x240", p320.camera, p320.solver, p320.max_points),
            ("dvo defaults", "320x240", p320.camera, SolverConfig(), dvo_caps),
            ("production_vga", "vga", vga.camera, vga.solver, vga.max_points),
            ("1280x960", "1280x960", p320.camera.scaled(4), SolverConfig(), dvo_caps)):
        out[f"extract_pyramid {label}"] = case(name, cam, cfg, caps)
        for c in _forced(extract_pyramid):
            out[f"extract_pyramid {label} c={c}"] = case(name, cam, cfg, caps, cluster=c)
    return out


def _canny_cases(pyramids) -> dict:
    """`canny_pyramid` on the 320x240, 640x480 and 1280x960 pyramids, on
    the rule's route and on each forced cluster size, as functions of the
    batch size (None where the checkout cannot take the pyramid)."""
    from rgbd_odometry_tpu_torch.kernels import canny

    def case(pyr, **kw):
        def run(b):
            return canny.canny_pyramid(tuple(g[:b].contiguous() for g in pyr.gray), **kw)
        return run

    out = {}
    for name, (pyr, edges) in pyramids.items():
        label = "" if name == "320x240" else f" {name}"
        out[f"canny_pyramid{label}"] = case(pyr) if edges is not None else None
        for c in _forced(canny.canny_pyramid) if edges is not None else ():
            out[f"canny_pyramid{label} c={c}"] = case(pyr, cluster=c)
    return out


def profile_targets(device, batch: int = 64, reps: int = 20) -> dict:
    """Per call of each target entry point, [device time (us), launches] of
    each CUDA kernel behind it, at 240x320 on `batch` rendered frames and on
    one; `canny_pyramid` and `extract_pyramid` also at 640x480 and 1280x960
    (the frames upsampled) and on each cluster size the kernel can be
    forced to ("not supported": that route or shape raises in this
    checkout)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbd_odometry_tpu_torch import CameraConfig
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.kernels import canny, edt

    frames, _ = render_sequence(CameraConfig(), _trajectory(batch), seed=0)
    gray = torch.from_numpy(np.stack([g for g, _ in frames])).to(device)
    depth = torch.from_numpy(np.stack([d for _, d in frames])).to(device)
    pyramids = _pyramids(device, gray, depth)
    pyr = pyramids["320x240"][0].gray
    edges = canny.canny(gray)
    out = {"path": "targets", "batch": batch, "reps": reps}
    for b in (batch, 1):
        g, e = gray[:b].contiguous(), edges[:b].contiguous()
        levels = tuple(x[:b].contiguous() for x in pyr)
        cases = {
            **{name: fn and functools.partial(fn, b)
               for name, fn in _canny_cases(pyramids).items()},
            "canny": lambda: canny.canny(g),
            "canny 4 levels": lambda: [canny.canny(x) for x in levels],
            "dt_channels R=16 pixels bf16": lambda: edt.dt_channels(e, 16, False, True),
            "dt_channels R=0 normalized bf16": lambda: edt.dt_channels(e, 0, True, True),
            "edt_squared R=16": lambda: edt.edt_squared(e, 16),
            **{name: fn and functools.partial(fn, b)
               for name, fn in _extract_cases(pyramids).items()},
        }
        for name, fn in cases.items():
            try:
                if fn is None:
                    raise ValueError("the shape")
                fn()
            except ValueError as exc:  # a route or shape this checkout does not take
                out[f"{name} B={b}"] = f"not supported: {exc}"
                continue
            torch.cuda.synchronize()
            # the profiler was seen to drop all kernel records of one window
            # after many windows in one process: such a window is profiled again
            for _ in range(6):
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
    from rgbd_odometry_tpu_torch.kernels import build

    # the kernel wrappers' `record_function` ranges (`build.traced`) off:
    # the windows time the path as it runs unprofiled (an older checkout
    # has no ranges and ignores the flag)
    build.ranges = False
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
        cfg = configs["stream" if name == "pipelined" else name]
        # VGA one sample a pixel: three take ~3 s a frame on the host
        frames, _ = render_sequence(cfg.camera, _trajectory(args.frames), seed=0,
                                    supersample=1 if name == "stream_vga" else 3)
        if name == "pipelined":
            profile_pipelined(cfg, frames, args.warmup, device)
            continue
        profile_path(name, cfg, frames, args.warmup, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
