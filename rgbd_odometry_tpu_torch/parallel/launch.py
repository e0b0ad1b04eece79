"""Ranks on one host: start W processes of a function, join them by a
deadline, and count the `torch.distributed` collectives a block of code
calls.

`Ranks(target, world, args, out_dir, timeout_s)` starts `target(rank,
world, *args)` in `world` processes with the `spawn` method (a process that
holds a CUDA context cannot fork), each writing its traceback to
`out_dir/rank{r}.err` when it raises; `join` waits for all of them until
the deadline, kills what is left and raises, with the tracebacks, if a rank
failed or hung. A function that spawns must be importable by the children,
so a script that starts ranks keeps its work under `if __name__ ==
"__main__":` (the children import it as `__mp_main__`).
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import socket
import time
import traceback

# every public collective and point-to-point call of `torch.distributed`
COLLECTIVES = (
    "all_gather", "all_gather_coalesced", "all_gather_into_tensor", "all_gather_object",
    "all_gather_single", "all_reduce", "all_reduce_coalesced", "all_to_all",
    "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "irecv", "isend", "monitored_barrier", "recv",
    "recv_object_list", "reduce", "reduce_scatter", "reduce_scatter_single",
    "reduce_scatter_tensor", "scatter", "scatter_object_list", "send", "send_object_list",
)


def free_port() -> int:
    """A TCP port of this host that is free now (for a rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def counted_collectives(counts: dict):
    """Count, by name into `counts`, every `torch.distributed` collective
    called inside through the module (`dist.all_reduce(...)`); a call one
    collective makes of another inside torch is not counted."""
    import torch.distributed as dist

    saved = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}

    def wrap(name, fn):
        def counted(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _guarded(target, rank: int, world: int, out_dir: str, *args):
    """A rank's entry: `target(rank, world, *args)`, its traceback written
    to `out_dir/rank{rank}.err` when it raises (the exit code is then
    non-zero)."""
    try:
        target(rank, world, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """`world` processes, started with the `spawn` method, each running
    `target(rank, world, *args)`; see the module docstring."""

    def __init__(self, target, world: int, args: tuple, out_dir: str, timeout_s: float):
        ctx = multiprocessing.get_context("spawn")
        self.out_dir, self.world = out_dir, world
        self.procs = [ctx.Process(target=_guarded, args=(target, r, world, out_dir, *args),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout_s

    def join(self):
        """Wait for every rank until the deadline; raise if one failed or
        hung (those left are killed)."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for r in hung:
            self.procs[r].kill()
            self.procs[r].join(10)
        failed = [(r, p.exitcode) for r, p in enumerate(self.procs) if p.exitcode != 0]
        if hung or failed:
            errors = []
            for r, _ in failed:
                path = os.path.join(self.out_dir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(f"{self.world} ranks: hung past the deadline {hung}; failed "
                               f"(rank, exit code) {failed}\n" + "\n".join(errors))
