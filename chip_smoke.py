#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`rgbd_odometry_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds both CUDA kernels from `rgbd_odometry_tpu_torch/csrc/`, holds each
against its plain PyTorch version at the main path's shapes, then drives the
port's production_320 main path through its user entry points:

  stream  `EdgeDvoOdometry` over 30 rendered 320x240 frames, keyframe every 5:
          ATE < 8 mm against ground truth, keyframes, rollbacks, ms/frame;
  batch   `align_pair` on 64 distinct rendered pairs: every pair within
          2 cm of ground truth, median/max error, pairs per second.

Both kernels' launch counters are zeroed right before the main path and must
be above 0 right after it. Any failed check raises (exit code != 0). The
line before the last is the kernel summary as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits with
code 2 and prints no result. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

EDT_SHAPES = ((240, 320), (120, 160), (60, 80), (30, 40))  # the 4 levels
GN_KS = (512, 2048, 1000)  # LM iteration, level-0 all-point size, ragged
BATCH = 64
STREAM_FRAMES = 30


def _log(msg: str) -> None:
    print(msg, flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs (CUDA events, after one
    warm-up run)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def edge_masks(rng, b: int, h: int, w: int):
    """b edge masks of varied density; some columns (always including the
    first and last two) are edge-free, so the windowed EDT meets its 4e9
    border candidates; image 0 is empty and image 1 all edges."""
    dens = rng.uniform(0.002, 0.06, (b, 1, 1))
    m = rng.random((b, h, w)) < dens
    for i in range(2, b):
        cols = rng.choice(w, size=max(1, w // 8), replace=False)
        m[i][:, cols] = False
        m[i][:, [0, 1, w - 2, w - 1]] = False
    m[0] = False
    m[1] = True
    return m


def gn_inputs(rng, b: int, k: int, device):
    """Points in front of a 320x240 camera, small random poses, and a bf16
    DT channel from the squared EDT of random edge masks."""
    import torch

    from rgbd_odometry_tpu_torch.core.geometry import se3_exp
    from rgbd_odometry_tpu_torch.ops.distance_transform import edt_l2_squared_windowed

    pts = np.stack(
        [rng.uniform(-1.2, 1.2, (b, k)), rng.uniform(-0.9, 0.9, (b, k)), rng.uniform(1.0, 3.0, (b, k))],
        axis=-1,
    ).astype(np.float32)
    valid = rng.random((b, k)) < 0.9
    psi = (rng.uniform(-1, 1, (b, 6)) * 0.02).astype(np.float32)
    R, t = se3_exp(torch.from_numpy(psi))
    mask = torch.from_numpy(edge_masks(rng, b, 240, 320)).to(device)
    dt = torch.sqrt(edt_l2_squared_windowed(mask, 16)).to(torch.bfloat16)
    f = lambda a: torch.as_tensor(a).to(device).contiguous()  # noqa: E731
    return f(R), f(t), f(pts), f(valid), dt


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_edt(device, rng) -> dict:
    """Kernel 1 vs its plain version, bitwise, at the 4 level shapes."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import edt

    worst, out = 0.0, {}
    for h, w in EDT_SHAPES:
        mask = torch.from_numpy(edge_masks(rng, BATCH, h, w)).to(device)
        for radius in (16, 0):
            k = edt.edt_squared(mask, radius)
            p = edt.edt_squared_plain(mask, radius)
            torch.cuda.synchronize()
            _require(k.shape == (BATCH, h, w) and k.dtype == torch.float32, "edt shape/dtype")
            err = float((k - p).abs().max())
            _require(torch.equal(k, p), f"edt kernel != plain at {h}x{w} R={radius} (max {err})")
            k_ms = _time_ms(lambda: edt.edt_squared(mask, radius), 20)
            p_ms = _time_ms(lambda: edt.edt_squared_plain(mask, radius), 3 if radius == 0 else 10)
            _log(f"edt {h}x{w} B={BATCH} R={radius}: bitwise equal; kernel {k_ms:.4f} ms, "
                 f"plain {p_ms:.4f} ms")
            out[(h, w, radius)] = (k_ms, p_ms)
            worst = max(worst, err)
    k_ms, p_ms = out[(240, 320, 16)]
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}


def check_fused_gn(device, rng) -> dict:
    """Kernel 2 vs its plain version: 1e-4 relative on H and g and the
    energy, exact visible count, bitwise run-to-run."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import fused_iter

    intr = (262.5, 262.5, 159.75, 119.75)
    worst, out = 0.0, {}
    for k in GN_KS:
        R, t, pts, valid, img = gn_inputs(rng, BATCH, k, device)
        ker = fused_iter.fused_gn_terms(R, t, pts, valid, img, *intr, 1.0)
        again = fused_iter.fused_gn_terms(R, t, pts, valid, img, *intr, 1.0)
        pl = fused_iter.fused_gn_terms_plain(R, t, pts, valid, img, *intr, 1.0)
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b) for a, b in zip(ker, again)), f"GN K={k}: runs differ")
        H, g, e, n = ker
        _require(H.shape == (BATCH, 6, 6) and g.shape == (BATCH, 6), "GN output shapes")
        _require(bool(torch.isfinite(H).all() and torch.isfinite(g).all()), "GN non-finite")
        _require(torch.equal(n, pl[3]), f"GN K={k}: visible counts differ")
        _require(int(n.min()) > 0, f"GN K={k}: a pair has no visible point")
        rel = []
        for a, b in ((H, pl[0]), (g, pl[1]), (e, pl[2])):
            d = (a - b).abs().reshape(BATCH, -1).amax(-1)
            s = b.abs().reshape(BATCH, -1).amax(-1).clamp(min=1e-30)
            rel.append(float((d / s).max()))
            worst = max(worst, float(d.max()))
        _require(max(rel) <= 1e-4, f"GN K={k}: relative error {rel} > 1e-4")
        k_ms = _time_ms(lambda: fused_iter.fused_gn_terms(R, t, pts, valid, img, *intr, 1.0), 50)
        p_ms = _time_ms(lambda: fused_iter.fused_gn_terms_plain(R, t, pts, valid, img, *intr, 1.0), 20)
        _log(f"fused_gn K={k} B={BATCH}: rel err H {rel[0]:.2e} g {rel[1]:.2e} energy "
             f"{rel[2]:.2e}, counts equal, runs bitwise equal; kernel {k_ms:.4f} ms, "
             f"plain {p_ms:.4f} ms")
        out[k] = (k_ms, p_ms)
    k_ms, p_ms = out[512]
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}


def _trajectory(n: int, step: float = 0.002):
    ts = np.arange(n)
    return np.stack(
        [0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
         0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts],
        axis=-1,
    ).astype(np.float32)


def run_stream(device) -> dict:
    """EdgeDvoOdometry under production_320 over a rendered sequence."""
    import torch

    from rgbd_odometry_tpu_torch import (
        EdgeDvoOdometry, KeyframeConfig, PipelineConfig, PyramidConfig, profiles,
    )
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    prof = profiles.production_320()
    cfg = PipelineConfig(
        camera=prof.camera,
        pyramid=PyramidConfig(num_levels=prof.num_levels, max_points=prof.max_points),
        solver=prof.solver,
        keyframe=KeyframeConfig(force_every=5, rollback_resolve=True),
    )
    frames, poses = render_sequence(prof.camera, _trajectory(STREAM_FRAMES), seed=0)
    odo = EdgeDvoOdometry(cfg, device=device)
    odo.process_frame(*frames[0], timestamp=0.0)  # bootstrap (untimed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (g, d) in enumerate(frames[1:], start=1):
        odo.process_frame(g, d, timestamp=float(i))
    ms = (time.perf_counter() - t0) * 1000.0 / (len(frames) - 1)
    _, t_est, _ = odo.trajectory()
    gt_t = np.stack([p[1] for p in poses])
    _require(t_est.shape == gt_t.shape and np.isfinite(t_est).all(), "stream: bad trajectory")
    ate = float(np.sqrt(((t_est - gt_t) ** 2).sum(-1).mean()))  # unaligned ATE RMSE
    kf = odo.gop.keyframe_indices()
    rollbacks = sum(m.rolled_back for m in odo.metrics)
    _log(f"stream: {len(frames)} frames 320x240, ATE {ate * 1000:.3f} mm, keyframes {kf}, "
         f"rollbacks {rollbacks}, {ms:.3f} ms/frame")
    _require(ate < 0.008, f"stream: ATE {ate:.4f} m >= 8 mm")
    _require(rollbacks >= 1, "stream: no rollback re-solve happened")
    return {"ate_mm": ate * 1000.0, "ms_per_frame": ms}


def render_batch(cam, batch: int):
    """`batch` distinct pairs as bench.py renders them (16 scenes, per-pair
    twists around a base twist, supersample 1), with the port's se3_exp."""
    from rgbd_odometry_tpu_torch.io.synthetic import SyntheticScene, pose_from_twist

    base = np.array([0.01, -0.008, 0.005, 0.004, -0.006, 0.003], np.float32)
    rng = np.random.default_rng(97)
    psis = base[None, :] * (1.0 + 0.3 * rng.uniform(-1, 1, (batch, 6))) + (
        0.002 * rng.uniform(-1, 1, (batch, 6))
    )
    scenes = [SyntheticScene(seed=s) for s in range(16)]
    refs = [sc.render(cam, np.eye(3), np.zeros(3), supersample=1) for sc in scenes]
    rg = np.stack([refs[i % 16][0] for i in range(batch)])
    rd = np.stack([refs[i % 16][1] for i in range(batch)])
    ng, nd, gt = np.empty_like(rg), np.empty_like(rd), []
    for i in range(batch):
        R, t = pose_from_twist(psis[i])
        ng[i], nd[i] = scenes[i % 16].render(cam, R, t, 1)
        gt.append((R, t))
    return rg, rd, ng, nd, gt


def run_batch(device, batch: int = BATCH) -> dict:
    """align_pair on `batch` distinct pairs under production_320."""
    import torch

    from rgbd_odometry_tpu_torch import align_pair, profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid

    prof = profiles.production_320()
    rg, rd, ng, nd, gt = render_batch(prof.camera, batch)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    ref = build_pyramid(f(rg), f(rd), prof.num_levels)
    now = build_pyramid(f(ng), f(nd), prof.num_levels)
    intr = Intrinsics.from_config(prof.camera)

    def run():
        return align_pair(ref.gray, ref.depth, now.gray, intr, prof.solver, prof.max_points)

    R, t, diags = run()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    pps = batch * reps / (time.perf_counter() - t0)
    _require(R.shape == (batch, 3, 3) and t.shape == (batch, 3), "batch: output shapes")
    t_np = t.cpu().numpy().astype(np.float64)
    _require(np.isfinite(t_np).all(), "batch: non-finite poses")
    err = np.linalg.norm(t_np - np.stack([p[1] for p in gt]), axis=-1)
    _log(f"batch: align_pair on {batch} pairs 320x240, |t-t_gt| median {np.median(err) * 1000:.3f} "
         f"mm max {err.max() * 1000:.3f} mm, {pps:.1f} pairs/s")
    _require(bool((err < 0.02).all()), f"batch: {int((err >= 0.02).sum())} pairs off by >= 2 cm")
    return {"median_mm": float(np.median(err)) * 1000.0, "pairs_per_s": pps}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.kernels import build, edt, fused_iter

    device = resolve_device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    _log(smi.stdout.strip())
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    for name in ("edt", "fused_gn"):
        t0 = time.perf_counter()
        rec = build.build_record(name)
        regs = [ln.strip() for ln in rec["ptxas"].splitlines() if "registers" in ln]
        _log(f"build {name}: {'compiled' if rec['built'] else 'cached'} in "
             f"{time.perf_counter() - t0:.2f} s (nvcc {rec['seconds']:.2f} s) {regs}")

    rng = np.random.default_rng(0)
    edt_res = check_edt(device, rng)
    gn_res = check_fused_gn(device, rng)

    edt.edt_squared.launches = 0
    fused_iter.fused_gn_terms.launches = 0
    run_stream(device)
    _log(f"launches after stream: edt_squared {edt.edt_squared.launches}, "
         f"fused_gn_terms {fused_iter.fused_gn_terms.launches}")
    run_batch(device)
    torch.cuda.synchronize()
    launches = {"edt": edt.edt_squared.launches, "gn": fused_iter.fused_gn_terms.launches}
    _log(f"launches after stream + batch: edt_squared {launches['edt']}, "
         f"fused_gn_terms {launches['gn']}")
    _require(launches["edt"] > 0 and launches["gn"] > 0, "a kernel was not launched on the main path")

    kernels = [
        {"name": "edt_squared", "route": "cuda", "source": "rgbd_odometry_tpu_torch/csrc/edt.cu",
         "replaces": "rgbd_odometry_tpu/pallas/edt.py:58", "launches": launches["edt"], **edt_res},
        {"name": "fused_gn_terms", "route": "cuda",
         "source": "rgbd_odometry_tpu_torch/csrc/fused_gn.cu",
         "replaces": "rgbd_odometry_tpu/pallas/fused_iter.py:159", "launches": launches["gn"],
         **gn_res},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
