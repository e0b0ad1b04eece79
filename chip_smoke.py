#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`rgbd_odometry_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the four CUDA kernels from `rgbd_odometry_tpu_torch/csrc/` (one nvcc
per source, all at once), holds each against its plain PyTorch version at
the main paths' shapes, then drives the port's main paths through their user
entry points:

  stream           `EdgeDvoOdometry` under production_320 over 30 rendered
                   320x240 frames, keyframe every 5: ATE < 8 mm, keyframes,
                   rollbacks, ms/frame;
  batch            `align_pair` under production_320 on 64 distinct rendered
                   pairs: every pair within 2 cm of ground truth, pairs/s;
  cli_default      `rgbd_odometry_tpu_torch.cli dvo --frames 30` at the
                   command's defaults (standard LM on the normalized DT, full
                   EDT, the frame feeder): unaligned ATE < 20 mm; then again
                   with `--no-feeder`: the same trajectory file and metrics;
  cli_subgradient  `dvo --method subgradient --iterations 50,50,50,50
                   --frames 10`, the reference's solver: ATE < 25 mm.

All four kernels' launch counters are zeroed right before the main paths and
must each be above 0 right after them. Any failed check raises (exit code
!= 0). The line before the last is the kernel summary as JSON; the last line
is {"ok": true, "device": {...}}. Without a CUDA device the script exits
with code 2 and prints no result. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

EDT_SHAPES = ((240, 320), (120, 160), (60, 80), (30, 40))  # the 4 levels
GN_KS = (512, 2048, 1000)  # LM iteration, level-0 all-point size, ragged
RESIDUAL_KS = (512, 2048, 8192)  # LM accept pass; all-point passes up to parity's level 0
SG_KS = (1024, 2048, 4096, 8192)  # the parity capacities, coarse to fine
BATCH = 64
STREAM_FRAMES = 30
KERNELS = ("edt", "fused_gn", "residual", "sg_terms")


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


def points(rng, b: int, k: int, device):
    """Points in front of a 320x240 camera (90% valid) and small random
    poses: (R, t, pts, valid) on the device."""
    import torch

    from rgbd_odometry_tpu_torch.core.geometry import se3_exp

    pts = np.stack(
        [rng.uniform(-1.2, 1.2, (b, k)), rng.uniform(-0.9, 0.9, (b, k)), rng.uniform(1.0, 3.0, (b, k))],
        axis=-1,
    ).astype(np.float32)
    valid = rng.random((b, k)) < 0.9
    psi = (rng.uniform(-1, 1, (b, 6)) * 0.02).astype(np.float32)
    R, t = se3_exp(torch.from_numpy(psi))
    f = lambda a: torch.as_tensor(a).to(device).contiguous()  # noqa: E731
    return f(R), f(t), f(pts), f(valid)


def gn_inputs(rng, b: int, k: int, device):
    """`points` and a bf16 DT channel from the squared +-16 EDT of random
    edge masks (the production path's pixel-unit DT)."""
    import torch

    from rgbd_odometry_tpu_torch.ops.distance_transform import edt_l2_squared_windowed

    mask = torch.from_numpy(edge_masks(rng, b, 240, 320)).to(device)
    dt = torch.sqrt(edt_l2_squared_windowed(mask, 16)).to(torch.bfloat16)
    return (*points(rng, b, k, device), dt)


def normalized_targets(rng, b: int, method: str, device):
    """`NowLevel`s of random 240x320 edge masks (an empty and a full one
    among them) on the 0-255 normalized full DT, as the `dvo` defaults
    (gauss_newton: bf16 channels) or the sub-gradient (float32) build them."""
    import torch

    from rgbd_odometry_tpu_torch import SolverConfig
    from rgbd_odometry_tpu_torch.solvers.edge_dvo import prepare_now_level

    mask = torch.from_numpy(edge_masks(rng, b, 240, 320)).to(device)
    return prepare_now_level(None, SolverConfig(method=method), edges=mask)


def _rel(a, b) -> float:
    """Largest per-pair error relative to the pair's largest |b|."""
    bsz = b.shape[0]
    d = (a - b).abs().reshape(bsz, -1).amax(-1)
    s = b.abs().reshape(bsz, -1).amax(-1).clamp(min=1e-30)
    return float((d / s).max())


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
    energy, exact visible count, per-point eps and visibility bitwise,
    bitwise run-to-run; on the production pixel-unit DT and, with a per-pair
    scale != 1, on the `dvo` defaults' normalized DT."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import fused_iter, residual

    intr = (262.5, 262.5, 159.75, 119.75)
    worst, out = 0.0, {}
    cases = [(k, "pixels") for k in GN_KS] + [(k, "normalized") for k in (512, 2048)]
    for k, dt_kind in cases:
        if dt_kind == "pixels":
            R, t, pts, valid, img = gn_inputs(rng, BATCH, k, device)
            scale = None
        else:
            R, t, pts, valid = points(rng, BATCH, k, device)
            now = normalized_targets(rng, BATCH, "gauss_newton", device)
            img, scale = now.chans[:, 0], now.scale
            _require(bool((scale[2:] != 1.0).all()), "normalized DT: a scale is 1")
        ker = fused_iter.fused_gn_terms(R, t, pts, valid, img, *intr, 1.0, scale)
        again = fused_iter.fused_gn_terms(R, t, pts, valid, img, *intr, 1.0, scale)
        pl = fused_iter.fused_gn_terms_plain(R, t, pts, valid, img, *intr, 1.0, scale)
        torch.cuda.synchronize()
        what = f"GN K={k} {dt_kind}"
        _require(all(torch.equal(a, b) for a, b in zip(ker, again)), f"{what}: runs differ")
        H, g, e, n = ker
        _require(H.shape == (BATCH, 6, 6) and g.shape == (BATCH, 6), "GN output shapes")
        _require(bool(torch.isfinite(H).all() and torch.isfinite(g).all()), "GN non-finite")
        _require(torch.equal(n, pl[3]), f"{what}: visible counts differ")
        _require(int(n.min()) > 0, f"{what}: a pair has no visible point")
        rel = [_rel(a, b) for a, b in ((H, pl[0]), (g, pl[1]), (e, pl[2]))]
        worst = max(worst, *(float((a - b).abs().max()) for a, b in zip(ker[:3], pl[:3])))
        _require(max(rel) <= 1e-4, f"{what}: relative error {rel} > 1e-4")
        # the per-point outputs of a stride-1 scan: bitwise the plain version's
        # and the bilinear residual pass's; the sums unchanged by writing them
        pts_out = fused_iter.fused_gn_terms(R, t, pts, valid, img, *intr, 1.0, scale,
                                            write_points=True)
        pl_pts = fused_iter.fused_gn_terms_plain(R, t, pts, valid, img, *intr, 1.0, scale,
                                                 write_points=True)
        res = residual.residual_pass(R, t, pts, valid, img, *intr, True, write_points=True)
        torch.cuda.synchronize()
        _require(all(torch.equal(a, b) for a, b in zip(pts_out[:4], ker)),
                 f"{what}: write_points changes the sums")
        _require(torch.equal(pts_out[4], pl_pts[4]) and torch.equal(pts_out[5], pl_pts[5]),
                 f"{what}: per-point eps / visibility differ from the plain version")
        _require(torch.equal(pts_out[4], res[2]) and torch.equal(pts_out[5], res[3]),
                 f"{what}: per-point eps / visibility differ from the residual pass")
        k_ms = _time_ms(lambda: fused_iter.fused_gn_terms(R, t, pts, valid, img, *intr, 1.0, scale), 50)
        p_ms = _time_ms(lambda: fused_iter.fused_gn_terms_plain(R, t, pts, valid, img, *intr, 1.0, scale), 20)
        _log(f"fused_gn K={k} B={BATCH} {dt_kind} DT: rel err H {rel[0]:.2e} g {rel[1]:.2e} "
             f"energy {rel[2]:.2e}, counts and per-point eps / visibility equal, runs bitwise "
             f"equal; kernel {k_ms:.4f} ms, "
             f"plain {p_ms:.4f} ms")
        out[(k, dt_kind)] = (k_ms, p_ms)
    k_ms, p_ms = out[(512, "normalized")]
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}


def check_residual(device, rng) -> dict:
    """Kernel 3 vs its plain version on the normalized DT, bilinear (bf16
    channel) and floor (float32 DT): energy 1e-4 relative, counts exact,
    per-point eps and visibility bitwise, runs bitwise."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import residual

    intr = (262.5, 262.5, 159.75, 119.75)
    worst, out = 0.0, {}
    targets = {m: normalized_targets(rng, BATCH, m, device) for m in ("gauss_newton", "subgradient")}
    for k in RESIDUAL_KS:
        R, t, pts, valid = points(rng, BATCH, k, device)
        for bilinear in (True, False):
            img = targets["gauss_newton"].chans[:, 0] if bilinear else targets["subgradient"].dt
            args = (R, t, pts, valid, img, *intr, bilinear)
            ker = residual.residual_pass(*args, write_points=True)
            again = residual.residual_pass(*args, write_points=True)
            pl = residual.residual_pass_plain(*args, write_points=True)
            torch.cuda.synchronize()
            what = f"residual K={k} {'bilinear' if bilinear else 'floor'}"
            _require(all(torch.equal(a, b) for a, b in zip(ker, again)), f"{what}: runs differ")
            _require(torch.equal(ker[1], pl[1]), f"{what}: visible counts differ")
            _require(torch.equal(ker[2], pl[2]), f"{what}: per-point eps differ")
            _require(torch.equal(ker[3], pl[3]), f"{what}: per-point visibility differs")
            energy_only = residual.residual_pass(*args)
            _require(torch.equal(energy_only[0], ker[0]), f"{what}: write_points changes the energy")
            rel = _rel(ker[0], pl[0])
            worst = max(worst, float((ker[0] - pl[0]).abs().max()))
            _require(rel <= 1e-4, f"{what}: energy relative error {rel:.2e} > 1e-4")
            k_ms = _time_ms(lambda: residual.residual_pass(*args), 50)
            p_ms = _time_ms(lambda: residual.residual_pass_plain(*args), 20)
            _log(f"{what} B={BATCH}: energy rel err {rel:.2e}, counts, eps and visibility "
                 f"bitwise, runs bitwise equal; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            out[(k, bilinear)] = (k_ms, p_ms)
    k_ms, p_ms = out[(512, True)]
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}


def check_sg_terms(device, rng) -> dict:
    """Kernel 4 vs its plain version on the normalized float32 DT: g and the
    energy 1e-4 relative, counts and per-point eps / visibility exact, runs
    bitwise."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import sg_terms

    intr = (262.5, 262.5, 159.75, 119.75)
    worst, out = 0.0, {}
    dt = normalized_targets(rng, BATCH, "subgradient", device).dt
    for k in SG_KS:
        R, t, pts, valid = points(rng, BATCH, k, device)
        args = (R, t, pts, valid, dt, *intr, 0.25)
        ker = sg_terms.subgradient_terms(*args)
        again = sg_terms.subgradient_terms(*args)
        pl = sg_terms.subgradient_terms_plain(*args)
        torch.cuda.synchronize()
        what = f"subgradient_terms K={k}"
        _require(all(torch.equal(a, b) for a, b in zip(ker, again)), f"{what}: runs differ")
        _require(bool(torch.isfinite(ker[0]).all()), f"{what}: non-finite g")
        _require(torch.equal(ker[2], pl[2]), f"{what}: visible counts differ")
        _require(torch.equal(ker[3], pl[3]), f"{what}: per-point eps differ")
        _require(torch.equal(ker[4], pl[4]), f"{what}: per-point visibility differs")
        rel = [_rel(ker[0], pl[0]), _rel(ker[1], pl[1])]
        worst = max(worst, float((ker[0] - pl[0]).abs().max()), float((ker[1] - pl[1]).abs().max()))
        _require(max(rel) <= 1e-4, f"{what}: relative error {rel} > 1e-4")
        k_ms = _time_ms(lambda: sg_terms.subgradient_terms(*args), 50)
        p_ms = _time_ms(lambda: sg_terms.subgradient_terms_plain(*args), 20)
        _log(f"{what} B={BATCH}: rel err g {rel[0]:.2e} energy {rel[1]:.2e}, counts, eps and "
             f"visibility bitwise, runs bitwise equal; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        out[k] = (k_ms, p_ms)
    k_ms, p_ms = out[8192]
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


def run_cli(name: str, argv, ate_bar: float) -> dict:
    """`rgbd_odometry_tpu_torch.cli dvo` on the card as a user runs it, with
    a trajectory file in a temporary directory; its stdout JSON is checked
    against the bar. Returns the numbers, the trajectory file's text and the
    metrics line as printed."""
    from rgbd_odometry_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        est = os.path.join(tmp, "est.txt")
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            summary = cli.main(["dvo", *argv, "--out", est])
        wall = time.perf_counter() - t0
        rows = np.loadtxt(est, comments="#", ndmin=2)
        with open(est) as fh:
            text = fh.read()
    line = stdout.getvalue().strip().splitlines()[-1]
    stats = json.loads(line)
    ate = stats["ate_rmse"]
    _require(rows.shape == (summary["frames"], 8) and np.isfinite(rows).all(),
             f"{name}: bad trajectory file")
    _require(np.isfinite(ate) and ate == summary["ate_rmse"], f"{name}: bad metrics")
    _log(f"{name}: dvo {' '.join(argv)}: {summary['frames']} frames, ATE {ate * 1000:.3f} mm, "
         f"keyframes {summary['keyframes']}, {summary['avg_solve_ms']:.3f} ms/frame solve "
         f"(average over frames 1.., host clock), {wall:.1f} s wall incl. rendering")
    _require(ate < ate_bar, f"{name}: ATE {ate * 1000:.3f} mm >= {ate_bar * 1000:.0f} mm")
    return {"ate_mm": ate * 1000.0, "ms_per_frame": summary["avg_solve_ms"],
            "keyframes": summary["keyframes"], "trajectory": text, "metrics": line}


def run_cli_no_feeder(with_feeder: dict) -> dict:
    """cli_default again with `--no-feeder`: the pyramids are built on the
    card in the solve's stream instead of on the host and copied on the
    feeder's own stream. The trajectory file and the printed metrics (ATE
    and drift as float64 reprs, from the unrounded poses) must be identical
    to the feeder run's: a copy race or a reused block would change them."""
    out = run_cli("cli_default_no_feeder", ["--frames", "30", "--no-feeder"], 0.020)
    _require(out["keyframes"] == with_feeder["keyframes"], "no-feeder: keyframes differ")
    _require(out["trajectory"] == with_feeder["trajectory"],
             "no-feeder: trajectory file differs from the feeder run's")
    _require(out["metrics"] == with_feeder["metrics"],
             f"no-feeder: metrics {out['metrics']} != {with_feeder['metrics']}")
    _log("cli_default_no_feeder: trajectory file and metrics identical to the feeder run's")
    return out


def _launch_counters():
    from rgbd_odometry_tpu_torch.kernels import edt, fused_iter, residual, sg_terms

    return {"edt": edt.edt_squared, "gn": fused_iter.fused_gn_terms,
            "residual": residual.residual_pass, "sg": sg_terms.subgradient_terms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.kernels import build

    device = resolve_device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    _log(smi.stdout.strip())
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load_all(KERNELS)
    _log(f"built {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s (one nvcc each, in parallel)")
    for name in KERNELS:
        rec = build.build_record(name)
        regs = [ln.strip() for ln in rec["ptxas"].splitlines() if "registers" in ln]
        _log(f"build {name}: {'compiled' if rec['built'] else 'cached'} "
             f"(nvcc {rec['seconds']:.2f} s) {regs}")

    rng = np.random.default_rng(0)
    res = {
        "edt": check_edt(device, rng),
        "gn": check_fused_gn(device, rng),
        "residual": check_residual(device, rng),
        "sg": check_sg_terms(device, rng),
    }

    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    phases = (
        ("stream", lambda: run_stream(device)),
        ("batch", lambda: run_batch(device)),
        ("cli_default", lambda: run_cli("cli_default", ["--frames", "30"], 0.020)),
        ("cli_default_no_feeder", lambda: run_cli_no_feeder(results["cli_default"])),
        ("cli_subgradient", lambda: run_cli(
            "cli_subgradient",
            ["--method", "subgradient", "--iterations", "50,50,50,50", "--frames", "10"], 0.025)),
    )
    results = {}
    for name, phase in phases:
        before = {k: fn.launches for k, fn in counters.items()}
        results[name] = phase()
        torch.cuda.synchronize()
        _log(f"launches in {name}: " + ", ".join(
            f"{k} {fn.launches - before[k]}" for k, fn in counters.items()))
    launches = {k: fn.launches for k, fn in counters.items()}
    _log(f"launches on the main paths: {launches}")
    _require(all(n > 0 for n in launches.values()), "a kernel was not launched on the main paths")

    src = "rgbd_odometry_tpu_torch/csrc/"
    kernels = [
        {"name": "edt_squared", "route": "cuda", "source": src + "edt.cu",
         "replaces": "rgbd_odometry_tpu/pallas/edt.py:58", "launches": launches["edt"],
         **res["edt"]},
        {"name": "fused_gn_terms", "route": "cuda", "source": src + "fused_gn.cu",
         "replaces": "rgbd_odometry_tpu/pallas/fused_iter.py:159", "launches": launches["gn"],
         **res["gn"]},
        {"name": "residual_pass", "route": "cuda", "source": src + "residual.cu",
         "replaces": "rgbd_odometry_tpu/solvers/edge_dvo.py:261 (XLA, no Pallas kernel)",
         "launches": launches["residual"], **res["residual"]},
        {"name": "subgradient_terms", "route": "cuda", "source": src + "sg_terms.cu",
         "replaces": "rgbd_odometry_tpu/solvers/edge_dvo.py:293 (XLA, no Pallas kernel)",
         "launches": launches["sg"], **res["sg"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
