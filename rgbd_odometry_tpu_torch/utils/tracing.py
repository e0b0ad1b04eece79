"""Stage timers and a device trace: the port's copy of
`rgbd_odometry_tpu/utils/tracing.py`.

`Tracer` keeps named stage timers with running statistics; a stage given
tensors in `block_on` waits for them before it stops its clock: on a card
through a CUDA event recorded on each tensor's device's current stream (the
work queued so far there, not a device-wide synchronization). `profiler_trace`
wraps `torch.profiler` with CPU and CUDA activities and writes a Chrome trace
(TensorBoard's profiler plugin reads it) through
`torch.profiler.tensorboard_trace_handler`, which needs no `tensorboard`
package.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch


def block_until_ready(tree: Any) -> Any:
    """Wait for the work that produces every tensor in `tree` (nested
    tuples, lists, dicts): one CUDA event per device on its current stream;
    CPU tensors are ready already. Returns `tree`."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()
    return tree


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / max(self.count, 1)


@dataclass
class Tracer:
    """Named stage timers with running averages."""

    stats: Dict[str, StageStats] = field(default_factory=lambda: defaultdict(StageStats))
    enabled: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Any = None):
        """Time a stage; pass the stage's output tensors in `block_on` to
        include their device time (launches return before the work ends)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.stats[name].add(time.perf_counter() - t0)

    def timed(self, name: str):
        """Decorator version; waits for the function's own return value."""

        def deco(fn):
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                block_until_ready(out)
                self.stats[name].add(time.perf_counter() - t0)
                return out

            return wrapped

        return deco

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "count": s.count,
                "mean_ms": round(s.mean_ms, 3),
                "min_ms": round(1000 * s.min_s, 3),
                "max_ms": round(1000 * s.max_s, 3),
                "total_s": round(s.total_s, 3),
            }
            for k, s in self.stats.items()
        }

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.report(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a `torch.profiler` trace (CPU activity, and CUDA when a card
    is present) around a code region and write it to `logdir` as a Chrome
    trace (`*.pt.trace.json`). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
