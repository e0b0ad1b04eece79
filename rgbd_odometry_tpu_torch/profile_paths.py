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
               pixel; not in the default);
  parity_stream  `profiles.parity_320` with `interpolate_dt` and the SVD
               `rotationize`, rollback re-solves (chip_smoke.py's
               parity_stream; not in the default).

A solved frame of a checkout that has the frame step (`pipeline/step.py`)
is one CUDA graph replay; the warm-up frames capture it, and the step's
capture time and pool bytes a slot are reported with the path.

`--paths levels` (not in the default) calls `level_lm` / `level_sg` once a
level at every level of production_320, production_vga, the `dvo`
defaults and cli_subgradient, B = 1 and 64: device us, launches and a
digest of every output (parent against change: the same bits), and where
the checkout has it, the same call with the trajectory output; then each
reference-parity family (`profile_parity`) as one `solve_pyramid` call at
the `dvo` defaults' capacities, B = 1 and 64: device us, launches, host ms
and a digest (an older checkout solves them on `run_level_loop`), and the
level-0 step's cycles where the checkout's kernels take them.

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
normalized), the targets' distance transforms of every level (`dt_pyramid`
in one call, on its rule's route and forced to each cluster size, against
one `dt_channels` call a level, as the parent ran them: production_320's
and the `dvo` defaults' flags on the 4 levels, production_vga's on its 5,
the `dvo` defaults' on the 1280x960 pyramid and, at B = 8 and 1, on
`dvo --cam-scale 3`'s own 960x720 renders), `edt_squared` and
`extract_pyramid` (production_320's and the
`dvo` defaults' capacities, production_vga's on the 640x480 pyramid and the
`dvo` defaults' on the 1280x960 one); `canny_pyramid` and `extract_pyramid`
on the route their rule takes and forced to each cluster size (1, 2, 4, 8
blocks a (level, image)). A case that raises for its shape or route in the
checkout profiled is reported "not supported".

`--paths solve` (not in the default; run it alone) profiles the level
solvers: device us per `level_lm` and `level_sg` launch at every level
shape of production_320, production_vga, the `dvo` defaults and
cli_subgradient, B = 1, 8 and 64 rendered pairs: at the level's
iterations (with a digest of the outputs' bits, to compare checkouts),
at 1, 2, 4, 8 and 18 (the slope is the per-iteration cost), with half
the points (the pass's share), on every cluster size the checkout's
kernels can be forced to, and the whole pyramid in one launch where the
checkout has that entry (`level_lm_pyramid`, `level_sg_pyramid`), with
the median cycles of an iteration's phases (pass, sum, step, barrier)
from the kernels' clock stamps where the checkout has them.

`--paths map` (not in the default; run it alone) profiles the map
backend's two kernels and a keyframe's split: device us per
`match_mutual` launch at S = 64 and 512 slots of K = 384 keypoints, at the
rendered frames' validity (chip_smoke.py's store: ~80 valid keypoints a
frame; S = 512 is it eight times) and at full validity (random unit
descriptors, every keypoint valid); device us and kernel launches (device
copies apart) of one `solvers/pnp.ransac_pnp` call on chip_smoke.py's PnP
problem; one `LoopCloser.add_keyframe` over chip_smoke.py's 12-frame
out-and-back path, its host clock split (each part synchronised) between
`detect_and_describe`, `match_all`, `ransac_fundamental_filter` and
`ransac_pnp` with the calls of each (the keyframe's detection with its
back-projection, `detect_describe_backproject`, counted under
`detect_and_describe`), and its `cudaLaunchKernel` calls; device us,
kernels, copies and host syncs of one `detect_and_describe` call (320x240,
K = 384) and one `ransac_fundamental_filter` call (S = 64, K = 384, the
frame's matches with frame 2's); the `feature-vo` command's frame (its
30 frames, host ms a frame over frames 10-29, then launches, syncs, kernels
and device ms a frame under the profiler); a digest of every output (both
gate floors, every `RansacResult` field, the front end's two calls, the
closures), so that an A/B call shows the bits equal.

`--paths secondary` (not in the default; run it alone) profiles the
secondary solvers' kernels at the shapes their commands give them: device
us and launches per call of `imu_scan` (dead reckoning B = 1 over T = 400
samples, the `imu` command; B = 1, T = 1, `fused`'s prior a frame;
preintegration of B = 29 one-sample windows, `fused --imu-refine`, and B
= 64, T = 10), of `level_photo` (levels 3 and 2, 3 iterations each, the
`photometric` command's configuration, on a rendered pair at 640x480,
320x240 and 1280x960, B = 1, and at 640x480, B = 64: the `solve_pyramid`
call, the kernel alone on the rule's route and on every forced cluster
size, pair 0's phase cycles from its clock stamps), of `gn_pnp` (the
`pnp` command: 54 chessboard points, 5 iterations, one `pnp_gn` launch),
`pnp_gn` at the step-by-step RANSAC route's two shapes (B = 64 hypotheses
of 4 points of K = 384, 4 iterations; B = 1 over the best one's inliers, 5
iterations) with problem 0's phase cycles, and
`ransac_pnp` at K = 384 and 2048 (the PnP calls also timed by CUDA events
behind a sleep kernel), with a digest of each output; and a photometric
frame at 640x480 as the command runs it, device us, kernels and copies:
the keyframe (pyramid and `extract_photo_ref`) and an ordinary frame
(pyramid, solve, the pose's copy to the host). Copied into an older
checkout, it measures what that
checkout's wrapper takes.

The first `--warmup` frames run unprofiled; the rest run once unprofiled
(host clock, ending in a synchronise: ms/frame, and the mean
`FrameMetrics.solve_ms`, the CLI's `avg solve`) and once under the profiler
from a fresh odometry at the same frame: launches per frame (kernel
launches, `cudaGraphLaunch` calls and `cudaMemcpyAsync` copies, each also
on its own), host syncs per frame, the kernels' summed device time per
frame, the device's busy share (the union of the kernel and copy
intervals over the profiled wall time, which the profiler itself
lengthens) and the top kernels by device time. Prints the
card's name and power limit first, one JSON line per path last. Needs a
CUDA device (exits 2 without one).
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
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
        ) for name, p in (("stream", prof), ("stream_vga", profiles.production_vga()),
                          ("parity_stream", _parity(profiles.parity_320())))},
    }


def _parity(p):
    """parity_320 with chip_smoke.py's parity_stream switches."""
    import dataclasses

    return p._replace(solver=dataclasses.replace(p.solver, interpolate_dt=True,
                                                 rotationize_method="svd"))


def _steps(odo) -> dict:
    """The capture time and pool bytes a slot of a driver's frame steps
    (a checkout without them: none)."""
    steps = getattr(odo, "frame_steps", lambda: ())()
    return {"capture_ms": [st.capture_s * 1000.0 for st in steps],
            "pool_bytes_a_slot": [[sl.pool_bytes for sl in st.slots] for st in steps]}


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
        "kernel_launches_per_frame": prof["kernel_launches"],
        "graph_launches_per_frame": prof["graph_launches"], "copies_per_frame": prof["copies"],
        **_steps(odo),
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
        # the frame steps of the two entry points captured before the clock
        # and the profiler start (a checkout without them: nothing)
        for entry in ("process_stream", "process_pyramid"):
            getattr(odo, "prepare", lambda entry: None)(entry)
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
            "kernel_launches_per_frame": prof["kernel_launches"],
            "graph_launches_per_frame": prof["graph_launches"], "copies_per_frame": prof["copies"],
            "kernels_per_frame": prof["kernels"], "kernel_ms_per_frame": prof["kernel_ms"],
            "busy_share": prof["busy_share"], "profiled_ms_per_frame": prof["profiled_ms"],
            "top_kernels_ms_per_frame": prof["top_kernels_ms"],
        }
        print(json.dumps(out), flush=True)
        outs.append(out)
    return outs


def _profile_window(run, steps: int) -> dict:
    """`run()` under the profiler: per step the launches (kernel launches,
    graph launches and `cudaMemcpyAsync` copies, and each alone), host
    syncs, kernels and their device time, the busy share and the top
    kernels (copies among them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avg = prof.key_averages()
    kernel_launches = sum(e.count for e in avg if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
    graph_launches = sum(e.count for e in avg if e.key == "cudaGraphLaunch")
    copies = sum(e.count for e in avg if e.key == "cudaMemcpyAsync")
    syncs = sum(e.count for e in avg
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaEventSynchronize"))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "launches": (kernel_launches + graph_launches + copies) / steps,
        "kernel_launches": kernel_launches / steps, "graph_launches": graph_launches / steps,
        "copies": copies / steps, "syncs": syncs / steps, "kernels": len(kernels) / steps,
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
            "kernel_launches_per_step": prof["kernel_launches"],
            "graph_launches_per_step": prof["graph_launches"], "copies_per_step": prof["copies"],
            **_steps(ms),
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


_DT_CASES = (("production_320", "320x240", (16, False, True)),
             ("dvo defaults", "320x240", (0, True, True)),
             ("production_vga", "vga", (16, False, True)),
             ("dvo defaults 1280x960", "1280x960", (0, True, True)))


def _dt_cases(pyramids, which=_DT_CASES) -> dict:
    """The targets' distance transforms of the rendered pyramids' edge maps
    under production_320's and production_vga's flags (+-16, pixels, bf16)
    and the `dvo` defaults' (the whole row, normalized, bf16; also at
    1280x960, `dvo --cam-scale 4`), or the (label, pyramid, flags) of
    `which`, as functions of the batch size: one `dt_channels` call a
    level, and one `dt_pyramid` call on the rule's route and forced to each
    cluster size (absent in a checkout without `dt_pyramid`; None where the
    checkout cannot take the pyramid)."""
    from rgbd_odometry_tpu_torch.kernels import edt

    pyramid = getattr(edt, "dt_pyramid", None)

    def cut(edges, b):
        return tuple(e[:b].contiguous() for e in edges)

    out = {}
    for label, name, flags in which:
        edges = pyramids[name][1]
        ok = edges is not None
        out[f"dt_channels a level, {label}"] = ok and (
            lambda b, e=edges, f=flags: [edt.dt_channels(x, *f) for x in cut(e, b)])
        if pyramid is None:
            continue
        out[f"dt_pyramid {label}"] = ok and (
            lambda b, e=edges, f=flags: pyramid(cut(e, b), *f))
        for c in (0,) + _forced(pyramid):  # 0: every level on the per-level route
            out[f"dt_pyramid {label} c={c}"] = ok and (
                lambda b, e=edges, f=flags, c=c: pyramid(cut(e, b), *f, cluster=c))
    return {k: v or None for k, v in out.items()}


def _kernel_us(fn, what: str, reps: int) -> dict:
    """Per call of `fn`, [device time (us), launches] of each CUDA kernel it
    runs, from `reps` calls under the profiler (a window the profiler
    dropped is profiled again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # the profiler was seen to drop all kernel records of one window after
    # many windows in one process: such a window is profiled again
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_time_total > 0 and ev.count >= reps]
        if kernels:
            return {re.search(r"(\w+(?:<[^>]*>)?)\(", ev.key).group(1):
                    [ev.device_time_total / reps, ev.count / reps] for ev in kernels}
        print(f"profile_targets: no kernel record for {what}; again", file=sys.stderr, flush=True)
    raise RuntimeError(f"profile_targets: no kernel record for {what}")


def _profile_cases(out: dict, cases: dict, b: int, reps: int) -> None:
    """`_kernel_us` of every case (a function of nothing, or None where the
    checkout cannot take it) into out["<name> B=<b>"]; a case that raises
    ValueError is "not supported" there."""
    for name, fn in cases.items():
        try:
            if fn is None:
                raise ValueError("the shape")
            fn()
        except ValueError as exc:  # a route or shape this checkout does not take
            out[f"{name} B={b}"] = f"not supported: {exc}"
            continue
        out[f"{name} B={b}"] = _kernel_us(fn, f"{name} B={b}", reps)


def _cam_scale_3_edges(device, frames: int = 8) -> dict:
    """`dvo --cam-scale 3`'s 4-level pyramid of `frames` rendered 960x720
    frames (one sample a pixel: the edge density of a real frame at that
    size, not an upsampled one) with its Canny edges at the `dvo` defaults,
    in `_pyramids`' form."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.kernels import canny

    rendered, _ = render_sequence(CameraConfig().scaled(3), _trajectory(frames), seed=0,
                                  supersample=1)
    gray = torch.from_numpy(np.stack([g for g, _ in rendered])).to(device)
    depth = torch.from_numpy(np.stack([d for _, d in rendered])).to(device)
    pyr = build_pyramid(gray, depth, 4)
    return {"960x720": (pyr, canny.canny_pyramid(pyr.gray))}


def profile_targets(device, batch: int = 64, reps: int = 20) -> dict:
    """Per call of each target entry point, [device time (us), launches] of
    each CUDA kernel behind it, at 240x320 on `batch` rendered frames and on
    one; `canny_pyramid`, the distance transforms (`_dt_cases`) and
    `extract_pyramid` also at 640x480 and 1280x960 (the frames upsampled)
    and on each cluster size the kernel can be forced to ("not supported":
    that route or shape raises in this checkout); the distance transforms
    of `dvo --cam-scale 3` (the `dvo` defaults on its own 960x720 renders)
    at B = 8 and 1."""
    import torch

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
        _profile_cases(out, {
            **{name: fn and functools.partial(fn, b)
               for name, fn in _canny_cases(pyramids).items()},
            "canny": lambda: canny.canny(g),
            "canny 4 levels": lambda: [canny.canny(x) for x in levels],
            "dt_channels R=16 pixels bf16": lambda: edt.dt_channels(e, 16, False, True),
            "dt_channels R=0 normalized bf16": lambda: edt.dt_channels(e, 0, True, True),
            **{name: fn and functools.partial(fn, b) for name, fn in _dt_cases(pyramids).items()},
            "edt_squared R=16": lambda: edt.edt_squared(e, 16),
            **{name: fn and functools.partial(fn, b)
               for name, fn in _extract_cases(pyramids).items()},
        }, b, reps)
    cam3 = _cam_scale_3_edges(device)
    for b in (8, 1):
        _profile_cases(out, {
            name: fn and functools.partial(fn, b) for name, fn in _dt_cases(
                cam3, (("dvo defaults 960x720 (cam_scale_3)", "960x720", (0, True, True)),)).items()
        }, b, reps)
    print(json.dumps(out), flush=True)
    return out


def _device_us(fn, reps: int) -> list:
    """[device us, kernel launches] per call of `fn` (every CUDA kernel it
    runs), from `reps` calls under the profiler (a window the profiler
    dropped is profiled again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.key_averages() if ev.device_time_total > 0]
        if kernels:
            return [sum(ev.device_time_total for ev in kernels) / reps,
                    sum(ev.count for ev in kernels) / reps]
    raise RuntimeError("profile_solve: no kernel record")


_PHASES = (("pass", 0, 1), ("sum", 1, 2), ("step", 2, 3), ("barrier", 3, 4),
           ("residual pass and sum", 4, 5), ("decision", 5, 6), ("barrier 2", 6, 7))


def _phase_cycles(clk, level_ids) -> dict:
    """Per level, the median cycles of an iteration and of each of its
    phases from the kernels' clock64() stamps (pair 0, first 64
    iterations; `csrc/level_lm.cu`, `csrc/level_sg.cu`)."""
    out = {}
    for lvl, c in zip(level_ids, clk):
        ran = int((c[:, 0] != 0).sum())
        if ran < 2:
            continue
        c = c[:ran]
        d = {"iteration": float(np.median(np.diff(c[:, 0])))}
        for name, a, b in _PHASES:
            if (c[:, b] != 0).all():
                d[name] = float(np.median(c[:, b] - c[:, a]))
        out[f"level {lvl}"] = d
    return out


def _digest(out, n: int = 4) -> str:
    """A hash of the first n outputs (a level's pose, energy curve and best
    iteration), bit for bit: two checkouts' runs on the same inputs agree
    exactly where their digests do."""
    import hashlib

    return hashlib.sha1(b"".join(x.detach().cpu().numpy().tobytes() for x in out[:n])).hexdigest()[:16]


def _solve_inputs(device, batch: int):
    """For each solver configuration, its levels' inputs (coarsest first) on
    `batch` rendered pairs (frame i against frame i + 1 of a rendered
    sequence, one sample a pixel): production_320 and production_vga
    (deferred LM), the `dvo` defaults (standard LM, normalized full DT) and
    cli_subgradient (the reference's sub-gradient, 50 iterations a level)."""
    import torch

    from rgbd_odometry_tpu_torch import PipelineConfig, SolverConfig, profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    p320, vga = profiles.production_320(), profiles.production_vga()
    dvo_caps = PipelineConfig().pyramid.max_points
    configs = {
        "production_320": (p320.solver, p320.max_points, p320.camera, p320.num_levels),
        "production_vga": (vga.solver, vga.max_points, vga.camera, vga.num_levels),
        "dvo": (SolverConfig(method="gauss_newton", iterations=(18, 6, 4, 3)), dvo_caps,
                p320.camera, 4),
        "cli_subgradient": (SolverConfig(method="subgradient", iterations=(50, 50, 50, 50)),
                            dvo_caps, p320.camera, 4),
    }
    out, rendered = {}, {}
    for name, (cfg, caps, cam, n_lv) in configs.items():
        if cam not in rendered:
            frames, _ = render_sequence(cam, _trajectory(batch + 1), seed=0, supersample=1)
            rendered[cam] = [torch.from_numpy(np.stack([f[i] for f in frames])).to(device)
                             for i in (0, 1)]
        gray, depth = rendered[cam]
        ref_pyr = build_pyramid(gray[:-1].contiguous(), depth[:-1].contiguous(), n_lv)
        now_pyr = build_pyramid(gray[1:].contiguous(), depth[1:].contiguous(), n_lv)
        intr = Intrinsics.from_config(cam)
        refs = edge_dvo.extract_ref_features(ref_pyr.gray, ref_pyr.depth, intr, cfg, caps)
        nows = edge_dvo.prepare_now_targets(now_pyr.gray, cfg)
        levels = []
        for lvl in range(n_lv - 1, -1, -1):
            n_iters = cfg.iterations[lvl] if lvl < len(cfg.iterations) else cfg.iterations[-1]
            if n_iters > 0:
                levels.append((lvl, refs[lvl], nows[lvl], intr.at_level(lvl), n_iters))
        out[name] = (cfg, levels)
    return out


def profile_solve(device, batches=(1, 8, 64), reps: int = 10,
                  sweep=(1, 2, 4, 8, 18)) -> dict:
    """Device us per launch of the level solvers (`level_lm` for the
    Gauss-Newton configurations, `level_sg` for cli_subgradient; every CUDA
    kernel of a call) at every level shape of production_320,
    production_vga, the `dvo` defaults and cli_subgradient, B = 1, 8, 64
    rendered pairs from the identity: at the level's iterations; at each of
    `sweep` iterations, with the least-squares slope (us an iteration) and
    intercept; with the first half of the points (the pass's share of the
    time is twice the difference over the whole); on every cluster size
    the level can be forced to, where the checkout has the keyword; and the
    whole pyramid as one `level_lm_pyramid` / `level_sg_pyramid` launch
    where the checkout has it, beside the levels' launches one by one.
    Prints one line per case and the whole as one JSON line."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import level_lm, level_sg
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    inputs = _solve_inputs(device, max(batches))
    out = {"path": "solve", "reps": reps, "cases": {}, "pyramid": {}}
    forced_lm = _forced(level_lm.level_lm)
    forced_sg = _forced(level_sg.level_sg)
    for name, (cfg, levels) in inputs.items():
        gn = cfg.method == "gauss_newton"
        for b in batches:
            one_by_one = []
            for lvl, ref, now, li, n_iters in levels:
                R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
                t0 = torch.zeros((b, 3), device=device)

                def call(n=n_iters, half=False, b=b, ref=ref, now=now, li=li, R0=R0, t0=t0,
                         **kw):
                    k = ref.pts3d.shape[1] // (2 if half else 1)
                    pts, valid = ref.pts3d[:b, :k].contiguous(), ref.valid[:b, :k].contiguous()
                    if gn:
                        jstride, stride = edge_dvo.level_strides(cfg, ref.pts3d.shape[1])
                        return level_lm.level_lm(R0, t0, pts, valid, ref.count[:b],
                                                 now.chans[:b, 0], now.scale[:b], *li, cfg, n,
                                                 jstride, stride, **kw)
                    return level_sg.level_sg(R0, t0, pts, valid, ref.count[:b], now.dt[:b], *li,
                                             cfg, n, **kw)

                case = {"k": int(ref.pts3d.shape[1]), "n_iters": n_iters,
                        "us": _device_us(call, reps), "digest": _digest(call())}
                one_by_one.append(case["us"][0])
                case["sweep"] = {n: _device_us(functools.partial(call, n), reps)[0] for n in sweep}
                xs = np.array(sweep, np.float64)
                ys = np.array([case["sweep"][n] for n in sweep])
                slope, intercept = np.polyfit(xs, ys, 1)
                case["slope_us"], case["intercept_us"] = float(slope), float(intercept)
                half = _device_us(functools.partial(call, half=True), reps)[0]
                case["half_points_us"] = half
                case["pass_share"] = 2.0 * (case["us"][0] - half) / case["us"][0]
                for c in forced_lm if gn else forced_sg:
                    try:
                        case[f"c={c}"] = _device_us(functools.partial(call, cluster=c), reps)[0]
                    except ValueError as exc:
                        case[f"c={c}"] = f"not supported: {exc}"
                key = f"{name} level {lvl} B={b}"
                out["cases"][key] = case
                print(f"solve {key}: K={case['k']} {n_iters} iterations "
                      f"{case['us'][0]:.2f} us ({case['us'][1]:.0f} kernels), slope "
                      f"{slope:.3f} us/iteration + {intercept:.2f}, half points {half:.2f} "
                      f"(pass share {case['pass_share']:.2f}); forced "
                      + ", ".join(f"{c}: {case[f'c={c}']}" if isinstance(case[f"c={c}"], str)
                                  else f"{c}: {case[f'c={c}']:.2f}"
                                  for c in (forced_lm if gn else forced_sg)), flush=True)
            pyr = getattr(level_lm if gn else level_sg,
                          "level_lm_pyramid" if gn else "level_sg_pyramid", None)
            entry = {"levels_one_by_one_us": float(sum(one_by_one))}
            if pyr is not None:
                R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
                t0 = torch.zeros((b, 3), device=device)
                if gn:
                    table = [level_lm.LmLevel(ref.pts3d[:b], ref.valid[:b], ref.count[:b],
                                              now.chans[:b, 0], now.scale[:b], *li, n,
                                              *edge_dvo.level_strides(cfg, ref.pts3d.shape[1]))
                             for _, ref, now, li, n in levels]
                else:
                    table = [level_sg.SgLevel(ref.pts3d[:b], ref.valid[:b], ref.count[:b],
                                              now.dt[:b], *li, n) for _, ref, now, li, n in levels]
                entry["pyramid_us"] = _device_us(lambda: pyr(R0, t0, table, cfg), reps)
                if "clocks" in inspect.signature(pyr).parameters:
                    clk = torch.zeros((len(table), 64, 8), dtype=torch.int64, device=device)
                    pyr(R0, t0, table, cfg, clocks=clk)
                    entry["cycles"] = _phase_cycles(clk.cpu().numpy(), [lv for lv, *_ in levels])
            out["pyramid"][f"{name} B={b}"] = entry
            print(f"solve {name} B={b}: levels one by one {entry['levels_one_by_one_us']:.2f} us"
                  + (f", one pyramid launch {entry['pyramid_us'][0]:.2f} us"
                     if "pyramid_us" in entry else "")
                  + (f"; cycles {json.dumps(entry['cycles'])}" if "cycles" in entry else ""),
                  flush=True)
    print(json.dumps(out), flush=True)
    return out


def _device_split(fn, reps: int) -> dict:
    """Device us per call of `fn` (kernels and copies), its kernel launches
    and its device copies, from `reps` calls under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        recs = [ev for ev in prof.key_averages() if ev.device_time_total > 0]
        if recs:
            copies = [ev for ev in recs if ev.key.startswith("Memcpy") or ev.key.startswith("Memset")]
            return {"us": sum(ev.device_time_total for ev in recs) / reps,
                    "kernels": sum(ev.count for ev in recs if ev not in copies) / reps,
                    "copies": sum(ev.count for ev in copies) / reps}
    raise RuntimeError("profile_map: no kernel record")


def _map_store(device):
    """chip_smoke.py's slot store: 32 rendered 320x240 frames along a path,
    16 of them again with sensor noise, the query (frame 12), its exact and
    its noisy duplicate, 14 empty slots; K = 384."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.ops.features import detect_and_describe

    rng = np.random.default_rng(0)
    frames, _ = render_sequence(CameraConfig(), _trajectory(32, step=0.004), seed=3)
    grays = [g for g, _ in frames]
    grays += [grays[i] + rng.normal(0, 2.0, grays[i].shape).astype(np.float32)
              for i in range(0, 32, 2)]
    query = grays[12]
    grays += [query, query + rng.normal(0, 1.0, query.shape).astype(np.float32)]
    kps = [detect_and_describe(torch.from_numpy(g).to(device), 384) for g in grays]
    empty = 64 - len(kps)
    desc = torch.cat([torch.stack([k.desc for k in kps]),
                      torch.zeros((empty, 384, 64), device=device)]).contiguous()
    valid = torch.cat([torch.stack([k.valid for k in kps]),
                       torch.zeros((empty, 384), dtype=torch.bool, device=device)]).contiguous()
    return desc, valid, kps[-2].desc.contiguous(), kps[-2].valid.contiguous()


def _pnp_problem(device, k: int = 384):
    """A PnP problem like chip_smoke.py's: K correspondences 1-3 m away,
    0.001 noise, 15% gross outliers, 90% valid; 64 hypotheses'
    uniforms."""
    import torch

    rng = np.random.default_rng(1)
    obj = np.stack([rng.uniform(-1.2, 1.2, k), rng.uniform(-0.9, 0.9, k),
                    rng.uniform(1.0, 3.0, k)], -1).astype(np.float32)
    th = np.array([0.02, -0.03, 0.01])
    c, s_ = np.cos(np.linalg.norm(th)), np.sin(np.linalg.norm(th))
    ax = th / np.linalg.norm(th)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    R = np.eye(3) + s_ * K + (1 - c) * K @ K
    pq = (obj - np.array([0.03, -0.02, 0.01])) @ R
    imn = pq[:, :2] / pq[:, 2:] + rng.normal(0, 0.001, (k, 2))
    bad = rng.random(k) < 0.15
    imn[bad] += rng.uniform(-0.1, 0.1, (int(bad.sum()), 2))
    valid = rng.random(k) < 0.9
    g = torch.Generator(device=device)
    g.manual_seed(0)
    u = torch.rand((64, k), generator=g, device=device)
    f = lambda a: torch.as_tensor(a).to(device).contiguous()  # noqa: E731
    return u, f(obj), f(imn.astype(np.float32)), f(valid)


def profile_map(device, reps: int = 20) -> dict:
    """The map backend (see the module docstring, `--paths map`). Prints one
    line per case and the whole as one JSON line."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig, LoopCloser
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.kernels import match
    from rgbd_odometry_tpu_torch.ops import features
    from rgbd_odometry_tpu_torch.pipeline import kf_matcher
    from rgbd_odometry_tpu_torch.pipeline.loop_closure import LoopClosureConfig
    from rgbd_odometry_tpu_torch.solvers import pnp

    out = {"path": "map", "reps": reps, "match": {}, "ransac_pnp": {}, "add_keyframe": {},
           "front_end": {}, "feature_vo": {}}
    desc, valid, qd, qv = _map_store(device)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    unit = torch.nn.functional.normalize(
        torch.randn((512, 384, 64), generator=g, device=device), dim=-1).contiguous()
    q_unit = torch.nn.functional.normalize(
        torch.randn((384, 64), generator=g, device=device), dim=-1).contiguous()
    every = torch.ones((512, 384), dtype=torch.bool, device=device)
    cases = {
        "rendered S=64": (desc, valid, qd, qv),
        "rendered S=512": (desc.repeat(8, 1, 1).contiguous(), valid.repeat(8, 1).contiguous(),
                           qd, qv),
        "full S=64": (unit[:64].contiguous(), every[:64].contiguous(), q_unit, every[0].contiguous()),
        "full S=512": (unit, every, q_unit, every[0].contiguous()),
    }
    for name, args in cases.items():
        case = {"valid_query": int(args[3].sum()), "valid_pairs": int(args[3].sum()) * int(args[1].sum()),
                **_device_split(lambda: match.match_mutual(*args), reps)}
        for floor in (1e-3, 0.2):
            case[f"digest floor={floor}"] = _digest(match.match_mutual(*args, dist_gate_floor=floor))
        out["match"][name] = case
        print(f"map match_mutual {name}: {case['us']:.2f} us, {case['kernels']:.0f} kernels, "
              f"{case['copies']:.0f} copies; {case['valid_pairs']} valid pairs; digests "
              f"{case['digest floor=0.001']} {case['digest floor=0.2']}", flush=True)

    u, obj, imn, pv = _pnp_problem(device)
    res = pnp.ransac_pnp(u, obj, imn, pv)
    rp = {**_device_split(lambda: pnp.ransac_pnp(u, obj, imn, pv), reps),
          "digest": _digest(res, 5), "best": int(res.best_hypothesis),
          "inliers": int(res.num_inliers)}
    out["ransac_pnp"] = rp
    print(f"map ransac_pnp: {rp['us']:.2f} us, {rp['kernels']:.0f} kernel launches, "
          f"{rp['copies']:.0f} copies a verification; best {rp['best']} with {rp['inliers']} "
          f"inliers; digest {rp['digest']}", flush=True)

    out["front_end"] = fe = _profile_front_end(device, reps)
    print(f"map front end: detect_and_describe (320x240, K=384) {fe['detect']['us']:.2f} us, "
          f"{fe['detect']['kernels']:.0f} kernels, {fe['detect']['copies']:.0f} copies, "
          f"{fe['detect']['syncs']:.0f} syncs a call (digest {fe['detect']['digest']}); "
          f"ransac_fundamental_filter (S=64, K=384) {fe['epipolar']['us']:.2f} us, "
          f"{fe['epipolar']['kernels']:.0f} kernels, {fe['epipolar']['copies']:.0f} copies, "
          f"{fe['epipolar']['syncs']:.0f} syncs a call (digest {fe['epipolar']['digest']})",
          flush=True)
    out["feature_vo"] = fv = _profile_feature_vo(device)
    print(f"map feature_vo frame (320x240, frames {fv['warmup']}-29): host ms a frame "
          f"{fv['ms_mean']:.3f} mean, {fv['ms_median']:.3f} median; {fv['kernels']:.2f} kernels, "
          f"{fv['launches']:.2f} launches ({fv['kernel_launches']:.2f} kernel, {fv['copies']:.2f} "
          f"copies), {fv['syncs']:.2f} syncs, {fv['kernel_ms']:.4f} device ms a frame; good "
          f"matches {fv['match_counts']}", flush=True)

    # one add_keyframe's split, each part synchronised on the host clock
    cam = CameraConfig()
    ts = np.sin(np.pi * np.arange(12) / 11)
    twists = np.stack([0.04 * ts, -0.02 * ts, 0.012 * ts, 0.008 * ts, -0.008 * ts, 0.004 * ts],
                      -1).astype(np.float32)
    frames, _ = render_sequence(cam, twists, seed=0)
    dev_frames = [tuple(torch.from_numpy(a).to(device) for a in f) for f in frames]
    parts = {"detect_and_describe": 0.0, "match_all": 0.0, "ransac_fundamental_filter": 0.0,
             "ransac_pnp": 0.0}
    calls = dict.fromkeys(parts, 0)

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] += (time.perf_counter() - t0) * 1000.0
            calls[name] += 1
            return r
        return wrapper

    def run(lc):
        wall = []
        for i, (gray, depth) in enumerate(dev_frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lc.add_keyframe(i, gray, depth)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1000.0)
        return wall

    cfg = LoopClosureConfig(min_separation=4, slot_capacity=4)
    intr = Intrinsics.from_config(cam)
    run(LoopCloser(intr, cfg, seed=0, device=device))  # warm-up
    lc = LoopCloser(intr, cfg, seed=0, device=device)
    wall = run(lc)
    saved = (features.detect_and_describe, kf_matcher.KeyframeMatcher.match_all,
             kf_matcher.ransac_fundamental_filter, pnp.ransac_pnp)
    # the keyframe's detection with its back-projection (one entry since the
    # front end's kernels; an older checkout detects through detect_and_describe)
    fused = getattr(features, "detect_describe_backproject", None)
    features.detect_and_describe = timed("detect_and_describe", saved[0])
    if fused is not None:
        features.detect_describe_backproject = timed("detect_and_describe", fused)
    kf_matcher.KeyframeMatcher.match_all = timed("match_all", saved[1])
    kf_matcher.ransac_fundamental_filter = timed("ransac_fundamental_filter", saved[2])
    pnp.ransac_pnp = timed("ransac_pnp", saved[3])
    try:
        split_wall = run(LoopCloser(intr, cfg, seed=0, device=device))
    finally:
        (features.detect_and_describe, kf_matcher.KeyframeMatcher.match_all,
         kf_matcher.ransac_fundamental_filter, pnp.ransac_pnp) = saved
        if fused is not None:
            features.detect_describe_backproject = fused
    prof = _profile_window(lambda: run(LoopCloser(intr, cfg, seed=0, device=device)), 12)
    n = len(dev_frames)
    ak = {"keyframes": n, "ms_median": float(np.median(wall[1:])), "ms_mean": float(np.mean(wall[1:])),
          "split_run_ms_mean": float(np.mean(split_wall)),
          "ms_per_keyframe": {k: v / n for k, v in parts.items()}, "calls": calls,
          "launches_per_keyframe": prof["kernel_launches"], "syncs_per_keyframe": prof["syncs"],
          "kernel_ms_per_keyframe": prof["kernel_ms"],
          "closures": [(int(c[0]), int(c[1]), int(c[4])) for c in lc.closures],
          "digest": _digest([torch.as_tensor(np.stack([c[2] for c in lc.closures] or [np.zeros((3, 3))])),
                             torch.as_tensor(np.stack([c[3] for c in lc.closures] or [np.zeros(3)]))])}
    out["add_keyframe"] = ak
    print(f"map add_keyframe: median {ak['ms_median']:.3f} ms, mean {ak['ms_mean']:.3f} ms; per "
          "keyframe (synchronised parts) " + ", ".join(
              f"{k} {v:.3f} ms ({calls[k]} calls)" for k, v in ak["ms_per_keyframe"].items())
          + f"; {ak['launches_per_keyframe']:.1f} launches, {ak['syncs_per_keyframe']:.1f} syncs a "
          f"keyframe; closures {ak['closures']} digest {ak['digest']}", flush=True)
    print(json.dumps(out), flush=True)
    return out


def _profile_front_end(device, reps: int) -> dict:
    """Device us, kernels, copies and host syncs of one `ops/features.
    detect_and_describe` call (a 320x240 frame of the `feature-vo` source,
    K = 384) and of one `ops/epipolar.ransac_fundamental_filter` call (S =
    64 seeded uniforms over that frame's matches with frame 2's), with a
    digest of each output; the syncs are the call's, those of an empty
    profiler window taken off."""
    import torch

    from rgbd_odometry_tpu_torch.ops import epipolar, features

    frames = _feature_vo_frames()
    g0, g2 = (torch.from_numpy(frames[i][0]).to(device) for i in (0, 2))
    ref, now = features.detect_and_describe(g0, 384), features.detect_and_describe(g2, 384)
    m = features.match(ref, now)
    uv2 = ref.uv[m.ref_idx].contiguous()
    valid = (m.good & now.valid & ref.valid[m.ref_idx]).contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    u = torch.rand((64, 384), generator=gen, device=device)
    # the window's own syncs (its closing synchronize), taken off each call's
    base = _profile_window(lambda: None, 1)["syncs"]
    out = {"window_syncs": base}
    for name, fn in (("detect", lambda: features.detect_and_describe(g0, 384)),
                     ("epipolar", lambda: epipolar.ransac_fundamental_filter(u, now.uv, uv2, valid))):
        split = _device_split(fn, reps)
        window = _profile_window(fn, 1)
        out[name] = {**split, "kernel_launches": window["kernel_launches"],
                     "syncs": window["syncs"] - base, "digest": _digest(fn(), 5)}
    out["epipolar"]["valid_pairs"] = int(valid.sum())
    return out


def _feature_vo_frames() -> list:
    """The `feature-vo` command's frames at its defaults (30 synthetic
    320x240 frames): (gray, depth, timestamp)."""
    from rgbd_odometry_tpu_torch.config import CameraConfig
    from rgbd_odometry_tpu_torch.io.stream import SyntheticCamera

    return list(SyntheticCamera(CameraConfig(), num_frames=30).frames())


def _profile_feature_vo(device, warmup: int = 10) -> dict:
    """The `feature-vo` command's frame (`FeatureVo` at --min-matches 40 over
    its 30 frames): host ms a frame over frames `warmup`..29 (each ending
    in a sync), then the same frames profiled from a fresh run brought to
    the same frame: launches, host syncs, kernels and device ms a frame."""
    import torch

    from rgbd_odometry_tpu_torch.config import CameraConfig
    from rgbd_odometry_tpu_torch.pipeline.feature_vo import FeatureVo, FeatureVoConfig

    frames = _feature_vo_frames()

    def fresh():
        vo = FeatureVo(CameraConfig(), FeatureVoConfig(min_good_matches=40), device=device)
        for gray, depth, ts in frames[:warmup]:
            vo.process_frame(gray, depth, ts)
        return vo

    vo, ms = fresh(), []
    for gray, depth, ts in frames[warmup:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vo.process_frame(gray, depth, ts)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000.0)
    again = fresh()
    prof = _profile_window(lambda: [again.process_frame(*f) for f in frames[warmup:]],
                           len(frames) - warmup)
    return {"warmup": warmup, "ms_mean": float(np.mean(ms)), "ms_median": float(np.median(ms)),
            "ms": ms, "match_counts": vo.match_counts, **prof}


def _event_us(fn, reps: int) -> float:
    """Device us per call of `fn` from CUDA events around `reps` calls
    queued behind a ~10 ms sleep kernel, so that the host has enqueued them
    all before the device reaches the first and they run back to back (a
    check on the profiler's sums, which can drop a window's records)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def _named_us(fn, reps: int, name: str) -> list:
    """[device us per launch, launches per call] of the kernels of `fn`
    whose name holds `name`, from `reps` calls under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        recs = [ev for ev in prof.key_averages() if ev.device_time_total > 0 and name in ev.key]
        n = sum(ev.count for ev in recs)
        if n:
            return [sum(ev.device_time_total for ev in recs) / n, n / reps]
    raise RuntimeError(f"profile_secondary: no {name} kernel record")


def _photo_cycles(clk, level_ids) -> dict:
    """Per level, pair 0's cycles from `level_photo`'s clock64() stamps
    (`csrc/level_photo.cu`): the wait for its staged data and its prologue,
    then per iteration the pass, the sum and the step (0 where skipped)."""
    out = {}
    start = clk[0, -1, 0]
    for lvl, c in zip(level_ids, clk):
        row = c[-1]
        out[f"level {lvl}"] = {
            "begin": int(row[1] - start), "wait and prologue": int(row[2] - row[1]),
            "pass": [int(x) for x in c[:-1, 1] - c[:-1, 0]],
            "sum": [int(x) for x in c[:-1, 2] - c[:-1, 1]],
            "step": [int(x) for x in c[:-1, 3] - c[:-1, 2]], "end": int(row[3] - start)}
    return out


def profile_secondary(device, reps: int = 20) -> dict:
    """The secondary solvers' kernels (see the module docstring, `--paths
    secondary`). Prints one JSON line."""
    import torch

    from rgbd_odometry_tpu_torch.config import CameraConfig, PhotometricConfig
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.io.synthetic import render_pair
    from rgbd_odometry_tpu_torch.kernels import imu, level_photo
    from rgbd_odometry_tpu_torch.solvers import photometric, pnp

    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    out = {"path": "secondary"}
    params = torch.tensor([0.03] * 3 + [-0.01] * 3 + [1e-2, 1e-4, 0.0, 9.7874, 0.0], **f32)
    for name, mode, b, n in (("imu_propagate_B1_T400", imu.PROPAGATE, 1, 400),
                             ("imu_propagate_B1_T1", imu.PROPAGATE, 1, 1),
                             ("imu_preintegrate_B29_T1", imu.PREINTEGRATE, 29, 1),
                             ("imu_preintegrate_B64_T10", imu.PREINTEGRATE, 64, 10)):
        a = torch.as_tensor(rng.normal(0, 2.0, (b, n, 3)), **f32)
        w = torch.as_tensor(rng.normal(0, 0.8, (b, n, 3)), **f32)
        s0 = torch.tensor([[0.0] * 9 + [1.0]], **f32).expand(b, 10).contiguous()
        call = lambda a=a, w=w, s0=s0, mode=mode: imu.imu_scan(mode, a, w, params, 0.01, s0)  # noqa: E731
        res = call()
        out[name] = _device_us(call, reps) + [_digest(res if isinstance(res, tuple) else (res,))]
    cfg = PhotometricConfig(use_huber=True)
    params = inspect.signature(level_photo.level_photo).parameters
    for width, b in ((640, 1), (320, 1), (640, 64), (1280, 1)):
        cam = CameraConfig().scaled(width / 320.0)
        (rg, rd), (ng, nd), _ = render_pair(
            cam, np.array([0.01, -0.006, 0.004, 0.003, -0.004, 0.002], np.float32), seed=0)
        t = lambda x: torch.as_tensor(x, **f32)[None].expand(b, -1, -1).contiguous()  # noqa: E731
        ref, now = build_pyramid(t(rg), t(rd), 4), build_pyramid(t(ng), t(nd), 4)
        intr = Intrinsics.from_config(cam)
        refs = photometric.extract_photo_ref(ref.gray, ref.depth, intr, cfg, cfg.max_points)
        call = lambda refs=refs, now=now, intr=intr: photometric.solve_pyramid(  # noqa: E731
            refs, now.gray, intr, cfg)
        R, tt, _ = call()
        key = f"level_photo_{width}_B{b}"
        out[key] = _device_us(call, reps) + [_digest((R, tt))]
        # the kernel alone, on the rule's route and on every forced cluster
        # size, and pair 0's phase cycles (a checkout whose wrapper takes them)
        lv = [photometric._levels(refs[lvl], now.gray[lvl], intr.at_level(lvl))
              for lvl in cfg.levels]
        R0 = torch.eye(3, **f32).expand(b, 3, 3).contiguous()
        t0 = torch.zeros((b, 3), **f32)
        routes = [None] + (list(level_photo.CLUSTERS) if "cluster" in params else [])
        for c in routes:
            kw = {} if c is None else {"cluster": c}
            res = level_photo.level_photo(R0, t0, lv, cfg, **kw)
            out[f"{key}_kernel" + ("" if c is None else f"_c{c}")] = _named_us(
                lambda kw=kw: level_photo.level_photo(R0, t0, lv, cfg, **kw), reps,
                "level_photo") + [_digest(res)]
        if "clocks" in params:
            clk = torch.zeros((len(lv), cfg.iterations_per_level + 1, 4), dtype=torch.int64,
                              device=device)
            level_photo.level_photo(R0, t0, lv, cfg, clocks=clk)
            torch.cuda.synchronize()
            out[f"{key}_cycles"] = _photo_cycles(clk.cpu().numpy(), cfg.levels)
        if width == 640 and b == 1:
            # a photometric frame as the command runs it: the keyframe's
            # pyramid and references, then an ordinary frame's pyramid, solve
            # and the pose's copy to the host
            def keyframe():
                pyr = build_pyramid(t(rg), t(rd), 4)
                photometric.extract_photo_ref(pyr.gray, pyr.depth, intr, cfg, cfg.max_points)

            def frame():
                pyr = build_pyramid(t(ng), t(nd), 4)
                Rf, tf, _ = photometric.solve_pyramid(refs, pyr.gray, intr, cfg)
                Rf.cpu(), tf.cpu()

            out["photometric_keyframe_640"] = _device_split(keyframe, reps)
            out["photometric_frame_640"] = _device_split(frame, reps)
    out.update(_profile_pnp(device, reps))
    print(json.dumps(out), flush=True)
    return out


def _gn_cycles(clk) -> dict:
    """The median cycles of a `pnp_gn` iteration and of its phases, and of
    the score, from problem 0's clock64() stamps (`csrc/pnp_gn.cu`)."""
    it = clk[:-1]
    d = {name: float(np.median(it[:, b] - it[:, a]))
         for name, a, b in (("pass", 0, 1), ("sum", 1, 2), ("step", 2, 3))}
    if len(it) > 1:
        d["iteration"] = float(np.median(np.diff(it[:, 0])))
    d["first pass"] = float(it[0, 1] - it[0, 0])  # its loads cold in L1
    d["score"] = float(clk[-1, 1] - clk[-1, 0])
    return d


def _profile_pnp(device, reps: int) -> dict:
    """`gn_pnp` on the `pnp` command's chessboard (54 points, 5 iterations),
    `pnp_gn` at the step-by-step RANSAC route's two shapes (the hypotheses:
    B = 64, 4 points each of K = 384, 4 iterations; the refine: B = 1 over
    the best hypothesis's inliers, 5 iterations) and `ransac_pnp` at K = 384
    and 2048: device us and launches a call, a digest of the outputs; where
    the checkout's `pnp_gn` takes `clocks`, problem 0's phase cycles."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import pnp_gn
    from rgbd_odometry_tpu_torch.solvers import pnp

    f32 = dict(dtype=torch.float32, device=device)
    params = inspect.signature(pnp_gn.pnp_gn).parameters
    out = {}
    obj = torch.as_tensor(pnp.chessboard_object_points(6, 9, 0.05), **f32) + torch.tensor(
        [0.0, 0.0, 1.5], **f32)
    imn = obj[:, :2] / obj[:, 2:3] + 0.01
    valid = torch.ones(obj.shape[0], dtype=torch.bool, device=device)
    call = lambda: pnp.gn_pnp(obj, imn, valid, iterations=5)  # noqa: E731
    out["pnp_gn_chessboard"] = _device_us(call, reps) + [_digest(call())]
    out["pnp_gn_chessboard_event_us"] = _event_us(call, reps)
    eye = torch.eye(3, **f32)
    shapes = {"chessboard": (obj, imn, valid[None], eye[None], torch.zeros((1, 3), **f32), 5, 0.0,
                             valid)}
    u, kobj, kimn, kv = _pnp_problem(device)
    sub = pnp_gn.select_sample(u, kv, 4)
    b = u.shape[0]
    hyp = (kobj, kimn, sub, eye.expand(b, 3, 3).contiguous(), torch.zeros((b, 3), **f32), 4, 0.01,
           kv)
    Rs, ts, counts, inl = pnp_gn.pnp_gn(*hyp, write_inliers=True)
    best = int(torch.argmax(counts))
    shapes["hypotheses"] = hyp
    shapes["refine"] = (kobj, kimn, inl[best][None].contiguous(), Rs[best][None].contiguous(),
                        ts[best][None].contiguous(), 5, 0.01, kv)
    for name, args in shapes.items():
        key = f"pnp_gn_{name}"
        # the chessboard as gn_pnp calls it (timed above): the norms requested
        kw = {"rnorm_out": torch.empty((1, 5), **f32)} if name == "chessboard" else {}
        if name != "chessboard":
            fn = lambda args=args: pnp_gn.pnp_gn(*args, write_inliers=True)  # noqa: E731
            out[key] = _named_us(fn, reps, "pnp_gn") + [_digest(fn())]
            out[f"{key}_event_us"] = _event_us(fn, reps)
        if "clocks" in params:
            clk = torch.zeros((args[5] + 1, 4), dtype=torch.int64, device=device)
            pnp_gn.pnp_gn(*args, write_inliers=True, clocks=clk, **kw)
            torch.cuda.synchronize()
            out[f"{key}_cycles"] = _gn_cycles(clk.cpu().numpy())
    for k in (384, 2048):
        u, kobj, kimn, kv = _pnp_problem(device, k)
        try:
            res = pnp.ransac_pnp(u, kobj, kimn, kv)
        except ValueError as exc:  # a checkout whose kernel caps K
            out[f"ransac_pnp_k{k}"] = {"error": str(exc)}
            continue
        fn = lambda u=u, kobj=kobj, kimn=kimn, kv=kv: pnp.ransac_pnp(u, kobj, kimn, kv)  # noqa: E731
        out[f"ransac_pnp_k{k}"] = {**_device_split(fn, reps), "event_us": _event_us(fn, reps),
                                   "digest": _digest(res, 5), "inliers": int(res.num_inliers)}
    for key, val in out.items():
        print(f"secondary {key}: {json.dumps(val)}", flush=True)
    return out


def profile_levels(device, reps: int = 20) -> dict:
    """Every level of production_320, production_vga, the `dvo` defaults
    and cli_subgradient (`_solve_inputs`, B = 1 and 64), one `level_lm` or
    `level_sg` call a level from the identity at its iterations: device us
    and kernel launches a call (`_device_us`) and a digest of every output,
    to compare checkouts bit for bit; where the checkout's wrappers take
    `traj=`, the same call with the trajectory output beside it (device us,
    the digest of the other outputs)."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import level_lm, level_sg
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    inputs = _solve_inputs(device, 64)
    out = {}
    for name, (cfg, levels) in inputs.items():
        gn = cfg.method == "gauss_newton"
        fn = level_lm.level_lm if gn else level_sg.level_sg
        traj_ok = "traj" in inspect.signature(fn).parameters and not (
            gn and cfg.lm_deferred_accept)
        for b in (1, 64):
            for lvl, ref, now, li, n in levels:
                R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
                t0 = torch.zeros((b, 3), device=device)

                def call(b=b, ref=ref, now=now, li=li, n=n, R0=R0, t0=t0, **kw):
                    if gn:
                        js, st = edge_dvo.level_strides(cfg, ref.pts3d.shape[1])
                        return fn(R0, t0, ref.pts3d[:b], ref.valid[:b], ref.count[:b],
                                  now.chans[:b, 0], now.scale[:b], *li, cfg, n, js, st, **kw)
                    return fn(R0, t0, ref.pts3d[:b], ref.valid[:b], ref.count[:b], now.dt[:b],
                              *li, cfg, n, **kw)

                res = call()
                case = {"us": _device_us(call, reps), "digest": _digest(res, len(res))}
                if traj_ok:
                    traj = torch.empty((b, n, 12), device=device)
                    with_t = functools.partial(call, traj=traj)
                    case["traj_us"] = _device_us(with_t, reps)
                    case["traj_digest"] = _digest(with_t(), len(res))
                key = f"{name} B={b} level {lvl}"
                out[key] = case
                print(f"levels {key}: {json.dumps(case)}", flush=True)
    out.update(profile_parity(device))
    return out


def _parity_configs() -> dict:
    """Each family of `point_sem.PARITY_FAMILIES`, the sub-gradient on
    `SolverConfig()`, Gauss-Newton on the `dvo` defaults' 18/6/4/3
    iterations (chip_smoke's `_parity_families`); none in a checkout
    without the module (whose parity levels ran plain PyTorch ops)."""
    from rgbd_odometry_tpu_torch import SolverConfig

    sg = SolverConfig()
    gn = SolverConfig(method="gauss_newton", iterations=(18, 6, 4, 3))
    if importlib.util.find_spec("rgbd_odometry_tpu_torch.kernels.point_sem") is None:
        return {}
    from rgbd_odometry_tpu_torch.kernels import point_sem

    return {name: cfg for name, (cfg, _) in point_sem.parity_families(sg, gn).items()}


def profile_parity(device, reps: int = 2) -> dict:
    """Each reference-parity family (`_parity_configs`) at the `dvo`
    defaults' capacities (8192/4096/2048/1024) on `_solve_inputs`' rendered
    pairs, B = 1 and 64: one `edge_dvo.solve_pyramid` call from the
    identity: device us and kernel launches a call (`_device_us`, `reps`
    calls), host ms a call ending in a sync (the median of `reps`) and a
    digest of the pose and the levels' energies; and pair 0's median step
    cycles at level 0 (the SVD's cost on the step)."""
    import torch

    from rgbd_odometry_tpu_torch import PipelineConfig
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    cam = _configs()["stream"].camera
    frames, _ = render_sequence(cam, _trajectory(65), seed=0, supersample=1)
    gray, depth = [torch.from_numpy(np.stack([f[i] for f in frames])).to(device) for i in (0, 1)]
    ref_pyr = build_pyramid(gray[:-1].contiguous(), depth[:-1].contiguous(), 4)
    now_pyr = build_pyramid(gray[1:].contiguous(), depth[1:].contiguous(), 4)
    intr = Intrinsics.from_config(cam)
    caps = PipelineConfig().pyramid.max_points
    out = {}
    for fam, cfg in _parity_configs().items():
        refs = edge_dvo.extract_ref_features(ref_pyr.gray, ref_pyr.depth, intr, cfg, caps)
        nows = edge_dvo.prepare_now_targets(now_pyr.gray, cfg)
        for b in (1, 64):
            rb = tuple(type(r)(*(x[:b] for x in r)) for r in refs)
            nb = tuple(type(n)(*(x[:b] for x in n)) for n in nows)

            def call(rb=rb, nb=nb, cfg=cfg):
                return edge_dvo.solve_pyramid(rb, nb, intr, cfg)

            res = call()
            torch.cuda.synchronize()
            host = []
            for _ in range(reps):
                tic = time.perf_counter()
                call()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - tic) * 1e3)
            us, launches = _device_us(call, reps)
            case = {"us": us, "launches": launches, "host_ms": float(np.median(host)),
                    "digest": _digest((res[0], res[1], *(d.energy for d in res[2])), 6)}
            case["step_cycles_level0"] = _parity_step_cycles(cfg, rb[0], nb[0], intr, device)
            key = f"parity {fam} B={b}"
            out[key] = case
            print(f"levels {key}: {json.dumps(case)}", flush=True)
    return out


def _parity_step_cycles(cfg, ref, now, intr, device):
    """Pair 0's median step cycles at level 0 under `cfg` (the kernels'
    clock stamps)."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import level_lm, level_sg
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    b = ref.pts3d.shape[0]
    R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
    t0 = torch.zeros((b, 3), device=device)
    clk = torch.zeros((1, 64, 8), dtype=torch.int64, device=device)
    n = cfg.iterations[0]
    if cfg.method == "gauss_newton":
        img, grads = edge_dvo.lm_planes(now, cfg)
        js, st = edge_dvo.level_strides(cfg, ref.pts3d.shape[1])
        lv = level_lm.LmLevel(ref.pts3d, ref.valid, ref.count, img, now.scale, *intr, n, js, st,
                              grads)
        level_lm.level_lm_pyramid(R0, t0, (lv,), cfg, clocks=clk)
    else:
        lv = level_sg.SgLevel(ref.pts3d, ref.valid, ref.count, now.dt, *intr, n)
        level_sg.level_sg_pyramid(R0, t0, (lv,), cfg, clocks=clk)
    torch.cuda.synchronize()
    c = clk[0].cpu().numpy()
    ran = int((c[:, 0] != 0).sum())
    return float(np.median(c[:ran, 3] - c[:ran, 2])) if ran > 1 else None


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
    # every source of the checkout built at once, one nvcc each
    build.load_all(sorted(p.stem for p in build._CSRC.glob("*.cu")))
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
        if name == "solve":
            profile_solve(device)
            continue
        if name == "map":
            profile_map(device)
            continue
        if name == "secondary":
            profile_secondary(device)
            continue
        if name == "levels":
            profile_levels(device)
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
