"""The CPU cost of the port's two epipolar filter routes, per filter.

`ops/epipolar.ransac_fundamental_filter` sends CPU tensors to the plain
route (`ransac_fundamental_filter_plain`: float32 `eigh` and `svd`) and CUDA
tensors to kernel D, whose twin `kernels/epipolar.fundamental_ransac_steps`
runs on any device. This script times both on the CPU at S = 64 hypotheses
over K = 384 (the matcher's) and 512 (feature-vo's) match slots, a third of
them valid, pairs made from a seed with numpy, and prints one JSON line of
milliseconds a filter (the median of `--reps` calls after one warm-up).

Run: python tools/epipolar_cpu_cost.py [--threads 4] [--reps 7]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbd_odometry_tpu_torch.kernels import epipolar as kepi  # noqa: E402
from rgbd_odometry_tpu_torch.ops import epipolar as pepi  # noqa: E402


def _inputs(k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    uv1 = rng.uniform(0, 320, (k, 2)).astype(np.float32)
    uv2 = (uv1 + rng.normal(0, 2, (k, 2))).astype(np.float32)
    u = rng.random((64, k), dtype=np.float32)
    valid = rng.random(k) < 1 / 3
    return tuple(torch.from_numpy(a) for a in (u, uv1, uv2, valid))


def _median_ms(fn, args, reps: int) -> float:
    fn(*args)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    out = {"threads": args.threads}
    for k in (384, 512):
        inputs = _inputs(k)
        out[f"K={k}"] = {
            "twin_ms": _median_ms(kepi.fundamental_ransac_steps, inputs, args.reps),
            "plain_ms": _median_ms(pepi.ransac_fundamental_filter_plain, inputs, args.reps),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
