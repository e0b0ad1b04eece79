"""Command line of the PyTorch port: the JAX package's `dvo` and `eval`.

    python -m rgbd_odometry_tpu_torch.cli dvo --frames 30 --out est.txt
    python -m rgbd_odometry_tpu_torch.cli dvo --method subgradient --iterations 50,50,50,50
    python -m rgbd_odometry_tpu_torch.cli eval est.txt groundtruth.txt

`dvo` takes the JAX parser's flags and defaults (`rgbd_odometry_tpu/cli.py`)
plus `--device` (default `cuda`; the CPU runs the kernels' plain versions and
only when asked for). It prints the same lines: one per frame on stderr, and
last on stdout the JSON `{"ate_rmse", "drift_mean_per_s", "drift_rms_per_s"}`
against the synthetic ground truth. The flags of subsystems not ported yet
exit with an error naming their ROADMAP item instead of being ignored.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np

_Q1 = "ROADMAP.md Queue 1"
_UNPORTED = (
    ("loop_close", "--loop-close", "item 8 'Map backend'"),
    ("refine_every", "--refine-every", "item 8 'Map backend'"),
    ("weighted_refine", "--weighted-refine", "item 8 'Map backend'"),
    ("refine_mode", "--refine-mode", "item 8 'Map backend'"),
    ("map_out", "--map-out", "item 8 'Map backend'"),
    ("relocalize", "--relocalize", "item 4 'motion model, relocalization, feeder'"),
    ("pipelined", "--pipelined", "item 4 'motion model, relocalization, feeder'"),
    ("viz_dir", "--viz-dir", "item 10 'The CLI'"),
    ("checkpoint", "--checkpoint", "item 10 'The CLI'"),
    ("resume", "--resume", "item 10 'The CLI'"),
    ("trace_dir", "--trace-dir", "item 10 'The CLI'"),
)


def _unported(what: str, item: str):
    sys.exit(f"{what} is not ported to rgbd_odometry_tpu_torch yet; see {_Q1}, {item}")


def _make_source(args):
    """(frames iterator, camera or None, synthetic ground truth or None)."""
    from rgbd_odometry_tpu_torch.io.stream import SyntheticCamera, TumSource, skip_frames

    start = args.start or 0
    if args.source.startswith("xml:"):
        _unported("the xml: source", "item 10 'The CLI'")
    if args.source.startswith("tum:"):
        frames = TumSource(args.source[4:], start=start, end=args.end).frames()
        cam = None
        if args.calib:
            from rgbd_odometry_tpu.io.calib import read_calib_xml

            cam = read_calib_xml(args.calib)
        gt = None
    else:
        from rgbd_odometry_tpu.config import CameraConfig

        cam = CameraConfig()
        if args.cam_scale != 1.0:
            cam = cam.scaled(args.cam_scale)
        degrade = None
        if (args.noise > 0 or args.texture > 0 or args.illum_drift != 0 or args.depth_quantize
                or args.depth_holes > 0 or args.dropout_blobs > 0 or args.motion_blur > 0):
            from rgbd_odometry_tpu.io.synthetic import Degradations

            degrade = Degradations(
                texture_amp=args.texture,
                noise_sigma=args.noise,
                illum_gain_per_frame=args.illum_drift,
                depth_quantize_tum=args.depth_quantize,
                depth_shadow_px=args.depth_holes,
                depth_dropout_blobs=args.dropout_blobs,
                motion_blur_px=args.motion_blur,
            )
        synth = SyntheticCamera(cam, num_frames=args.frames, degrade=degrade)
        frames = synth.frames()
        if start:
            frames = itertools.islice(frames, start, None)
        gt = synth.ground_truth()
    if args.skip > 1:
        frames = skip_frames(frames, args.skip)
    return frames, cam, gt


def _add_source_args(p):
    p.add_argument("--source", default="synthetic", help="'synthetic' or 'tum:<dir>'")
    p.add_argument("--frames", type=int, default=30, help="synthetic frame count")
    p.add_argument("--cam-scale", type=float, default=1.0,
                   help="resolution scale for the synthetic camera (0.5 renders 160x120 "
                   "with matching intrinsics; data sources keep their native size)")
    p.add_argument("--start", type=int, default=None)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--skip", type=int, default=1, help="keep every Nth frame (bagManip harness)")
    p.add_argument("--noise", type=float, default=0.0, help="synthetic sensor noise sigma")
    p.add_argument("--texture", type=float, default=0.0, help="synthetic scene texture amplitude")
    p.add_argument("--illum-drift", type=float, default=0.0,
                   help="synthetic illumination gain drift per frame")
    p.add_argument("--depth-quantize", action="store_true",
                   help="TUM uint16 1/5000m depth quantization")
    p.add_argument("--depth-holes", type=int, default=0,
                   help="structured-light shadow band width (px)")
    p.add_argument("--dropout-blobs", type=int, default=0,
                   help="random depth dropout blobs per frame")
    p.add_argument("--motion-blur", type=float, default=0.0, help="motion blur kernel length (px)")
    p.add_argument("--calib", default=None, help="OpenCV-XML calibration file")
    p.add_argument("--out", default=None, help="TUM-format trajectory output path")


def cmd_dvo(args):
    """Edge-DVO odometry over a source; returns a summary dict (frames,
    keyframes, average solve ms, and the stdout metrics when printed)."""
    for attr, flag, item in _UNPORTED:
        if getattr(args, attr) != args.unported_defaults[attr]:
            _unported(flag, item)
    from rgbd_odometry_tpu.config import CameraConfig, KeyframeConfig, PipelineConfig, SolverConfig
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry

    frames, cam, gt = _make_source(args)
    cfg = PipelineConfig(
        camera=cam or CameraConfig(),
        solver=SolverConfig(
            method=args.method,
            iterations=tuple(int(x) for x in args.iterations.split(",")),
        ),
        keyframe=KeyframeConfig(force_every=args.keyframe_every),
        motion_model=args.motion_model,
    )
    device = resolve_device(args.device)
    odo = EdgeDvoOdometry(cfg, device=device)

    def _after(m):
        print(
            f"frame {m.frame_num:4d}  {m.solve_ms:7.1f} ms  E={m.best_energy:9.2f} "
            f"vis={m.visible_ratio:.2f} b^={m.b_cap:6.2f} kf={m.keyframe_reason}",
            file=sys.stderr,
        )

    n = 0
    if args.dry:
        n = sum(1 for _ in frames)
        print(f"dry loop: ingested {n} frames", file=sys.stderr)
        return {"frames": n}
    if args.feeder:
        # host build + copy to the card of frame n+1 overlap frame n's solve
        from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder

        for pyr, ts in FrameFeeder(frames, num_levels=cfg.pyramid.num_levels, device=device):
            odo.process_pyramid(pyr, ts)
            n += 1
            _after(odo.metrics[-1])
    else:
        for gray, depth, ts in frames:
            odo.process_frame(gray, depth, ts)
            n += 1
            _after(odo.metrics[-1])
    print(f"avg solve: {odo.average_solve_ms():.2f} ms over {n} frames", file=sys.stderr)
    R, t, ts = odo.trajectory()
    summary = {"frames": n, "keyframes": odo.gop.keyframe_indices(),
               "avg_solve_ms": odo.average_solve_ms()}
    if args.out:
        from rgbd_odometry_tpu_torch.io.tum import write_trajectory

        write_trajectory(args.out, R, t, ts)
        print(f"trajectory -> {args.out}", file=sys.stderr)
    if args.gt:
        # GT files are ~100 Hz mocap vs ~30 Hz frames: pair by nearest
        # timestamp, rebase both to their first pose, normalize drift by
        # the elapsed time
        from rgbd_odometry_tpu.eval.ate import ate_rmse, drift_stats
        from rgbd_odometry_tpu_torch.io.tum import associate_trajectories, read_trajectory

        gt_R, gt_t, gt_ts = read_trajectory(args.gt)
        assoc = associate_trajectories(R, t, ts, gt_R, gt_t, gt_ts, max_dt=args.gt_max_dt)
        if assoc is None:
            print(json.dumps({"error": f"no est/GT pairs within {args.gt_max_dt}s"}))
        else:
            R_e, t_e, R_g, t_g, dur = assoc
            ds = drift_stats(t_e, t_g, duration_s=dur if dur > 0 else None)
            print(json.dumps({
                "ate_rmse_vs_gt_file": ate_rmse(t_e, t_g, align=True),
                "drift_mean_per_s": ds.mean,
                "drift_rms_per_s": ds.rms,
                "frames_compared": len(t_e),
            }))
    if gt is not None:
        from rgbd_odometry_tpu.eval.ate import ate_rmse, drift_stats, rebase_to_first

        gt_R, gt_t = gt
        start = args.start or 0
        if start:
            # a run offset into the synthetic stream is relative to its
            # first processed frame
            gt_R, gt_t = rebase_to_first(gt_R[start:], gt_t[start:])
        n2 = min(len(t), len(gt_t))
        ds = drift_stats(t[:n2], gt_t[:n2])
        metrics = {
            "ate_rmse": ate_rmse(t[:n2], gt_t[:n2], align=False),
            "drift_mean_per_s": ds.mean,
            "drift_rms_per_s": ds.rms,
        }
        print(json.dumps(metrics))
        summary.update(metrics)
    return summary


def cmd_eval(args):
    from rgbd_odometry_tpu.eval.ate import ate_rmse, drift_stats, rpe
    from rgbd_odometry_tpu_torch.io.tum import associate_trajectories, read_trajectory

    R_e, t_e, ts_e = read_trajectory(args.est)
    R_g, t_g, ts_g = read_trajectory(args.gt, skip_lines=args.gt_skip)
    assoc = associate_trajectories(
        R_e, t_e, ts_e, R_g, t_g, ts_g, max_dt=args.max_dt, rebase=args.rebase
    )
    if assoc is None:
        sys.exit(f"no est/GT timestamp pairs within {args.max_dt}s")
    R_e, t_e, R_g, t_g, dur = assoc
    tr, rr = rpe(R_e, t_e, R_g, t_g)
    ds = drift_stats(t_e, t_g, duration_s=dur if dur > 0 else None)
    out = {
        "ate_rmse_aligned": ate_rmse(t_e, t_g, align=True),
        "ate_rmse_raw": ate_rmse(t_e, t_g, align=False),
        "rpe_trans_rmse": tr,
        "rpe_rot_rmse": rr,
        "drift_mean_per_s": ds.mean,
        "drift_median_per_s": ds.median,
        "drift_rms_per_s": ds.rms,
        "frames": len(t_e),
    }
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rgbd-odometry-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("dvo", help="edge-DVO odometry (the reference's dvo node)")
    _add_source_args(p)
    p.add_argument("--method", default="gauss_newton", choices=["gauss_newton", "subgradient"])
    p.add_argument("--iterations", default="18,6,4,3")
    p.add_argument("--keyframe-every", type=int, default=5)
    p.add_argument("--dry", action="store_true", help="ingest-only (loopDry)")
    p.add_argument("--gt", default=None, help="GT trajectory file for drift comparison")
    p.add_argument("--gt-max-dt", type=float, default=0.02,
                   help="max timestamp gap for est/GT association")
    p.add_argument("--feeder", action=argparse.BooleanOptionalAction, default=True,
                   help="async prefetch thread overlapping host decode and the copy to the "
                   "card with the solve")
    p.add_argument("--motion-model", default="hold", choices=["hold", "constant_velocity"],
                   help="streaming warm start: hold the previous relative pose, or "
                   "extrapolate it by the last inter-frame motion (on the device)")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu' (the kernels' plain versions)")
    # flags of the JAX CLI whose subsystems are not ported yet: accepted by
    # the parser so that using one exits with its ROADMAP item
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--viz-dir", default=None)
    p.add_argument("--viz-every", type=int, default=5)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--loop-close", action="store_true")
    p.add_argument("--refine-mode", default="reanchor", choices=["reanchor", "graph"])
    p.add_argument("--map-out", default=None)
    p.add_argument("--refine-every", type=int, default=0)
    p.add_argument("--weighted-refine", action="store_true")
    p.add_argument("--pipelined", action="store_true")
    p.add_argument("--relocalize", action="store_true")
    p.set_defaults(fn=cmd_dvo, unported_defaults={a: p.get_default(a) for a, _, _ in _UNPORTED})

    p = sub.add_parser("eval", help="ATE/RPE/drift vs a GT trajectory (loadGTPath role)")
    p.add_argument("est")
    p.add_argument("gt")
    p.add_argument("--gt-skip", type=int, default=0)
    p.add_argument("--rebase", action="store_true")
    p.add_argument("--max-dt", type=float, default=0.02, help="max timestamp gap for association")
    p.set_defaults(fn=cmd_eval)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
