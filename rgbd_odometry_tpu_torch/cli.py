"""Command line of the PyTorch port: the JAX package's `dvo`, `refine`,
`multistream`, `eval`, `calib`, `probe`, `dump`, `photometric`,
`feature-vo`, `pnp`, `imu` and `fused`.

    python -m rgbd_odometry_tpu_torch.cli dvo --frames 30 --out est.txt
    python -m rgbd_odometry_tpu_torch.cli dvo --method subgradient --iterations 50,50,50,50
    python -m rgbd_odometry_tpu_torch.cli dvo --pipelined --frames 30 --out est.txt
    python -m rgbd_odometry_tpu_torch.cli dvo --loop-close --map-out map.ply --out est.txt
    python -m rgbd_odometry_tpu_torch.cli refine est.txt --constraints lc.txt --out ref.txt
    python -m rgbd_odometry_tpu_torch.cli multistream --streams 16 --frames 20 --out-dir streams
    python -m rgbd_odometry_tpu_torch.cli eval est.txt groundtruth.txt
    python -m rgbd_odometry_tpu_torch.cli dvo --frames 15 --checkpoint c.npz
    python -m rgbd_odometry_tpu_torch.cli dvo --frames 30 --resume c.npz --out est.txt
    python -m rgbd_odometry_tpu_torch.cli dvo --viz-dir viz --trace-dir trace
    python -m rgbd_odometry_tpu_torch.cli dump --frames 30 --out-dir dumps
    python -m rgbd_odometry_tpu_torch.cli dvo --source xml:dumps --calib cam_320x240.xml
    python -m rgbd_odometry_tpu_torch.cli probe --method gauss_newton --iterations 100
    python -m rgbd_odometry_tpu_torch.cli calib --write-freiburg calib_dir
    python -m rgbd_odometry_tpu_torch.cli photometric --frames 30 --cam-scale 2 --huber
    python -m rgbd_odometry_tpu_torch.cli feature-vo --frames 30 --out fv.txt
    python -m rgbd_odometry_tpu_torch.cli pnp
    python -m rgbd_odometry_tpu_torch.cli imu --steps 400
    python -m rgbd_odometry_tpu_torch.cli fused --frames 30 --imu-refine --imu-noise 0.01

The subcommands take the JAX parser's flags and defaults
(`rgbd_odometry_tpu/cli.py`), and those that compute take `--device`
(default `cuda`; the CPU runs the kernels' plain versions and only when asked
for). They print the same lines: for `dvo` one per frame on stderr, the map
backend's lines (`loop closures: ...`, `online refine @frame ...`, `map:
...`, `relocalizer: ...`), `checkpoint -> ...`, `viz: ...`, `torch.profiler
trace -> ...`, and last on stdout the JSON `{"ate_rmse", "drift_mean_per_s",
"drift_rms_per_s"}` against the synthetic ground truth; for `refine`,
`probe`, `calib`, `dump`, `pnp` and `imu` their JSON; for `multistream`
the JSON `{"streams", "devices", "frames", "aggregate_frames_per_s",
"ate_rmse_per_stream", "ate_rmse_max"}`, where `devices` is 1 (one card);
for `photometric` and `feature-vo` a line a frame on stderr; for `fused` a
line a frame on stderr and the JSON `{"frames", "fallback_frames",
"ate_rmse"[, "ate_rmse_unrefined"]}`. The JAX subcommand not ported yet
(`bench`) exits naming its ROADMAP item. Imports no JAX and no OpenCV.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import sys

import numpy as np

_Q1 = "ROADMAP.md Queue 1"
# the JAX subcommand not ported yet, and its ROADMAP.md Queue 1 item
_UNPORTED_COMMANDS = {
    "bench": "item 1 'H100 bench protocol'",
}


def _unported(what: str, item: str):
    sys.exit(f"{what} is not ported to rgbd_odometry_tpu_torch yet; see {_Q1}, {item}")


def _make_source(args):
    """(frames iterator, camera or None, synthetic ground truth or None)."""
    from rgbd_odometry_tpu_torch.io.stream import SyntheticCamera, TumSource, skip_frames

    start = args.start or 0
    if args.source.startswith(("tum:", "xml:")):
        if args.source.startswith("tum:"):
            frames = TumSource(args.source[4:], start=start, end=args.end).frames()
        else:
            from rgbd_odometry_tpu_torch.io.xml_dump import XmlDumpSource

            frames = XmlDumpSource(args.source[4:], start=start, end=args.end).frames()
        cam = None
        if args.calib:
            from rgbd_odometry_tpu_torch.io.calib import read_calib_xml

            cam = read_calib_xml(args.calib)
        gt = None
    else:
        from rgbd_odometry_tpu_torch.config import CameraConfig

        cam = CameraConfig()
        if args.cam_scale != 1.0:
            cam = cam.scaled(args.cam_scale)
        degrade = None
        if (args.noise > 0 or args.texture > 0 or args.illum_drift != 0 or args.depth_quantize
                or args.depth_holes > 0 or args.dropout_blobs > 0 or args.motion_blur > 0):
            from rgbd_odometry_tpu_torch.io.synthetic import Degradations

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
    p.add_argument("--source", default="synthetic",
                   help="'synthetic', 'tum:<dir>' or 'xml:<dir>' (reference XML pyramid dumps)")
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
    from rgbd_odometry_tpu_torch.config import (
        CameraConfig, KeyframeConfig, PipelineConfig, RelocalizeConfig, SolverConfig,
    )
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry

    device = resolve_device(args.device)
    if args.pipelined and not args.dry and (args.viz_dir or args.loop_close or args.map_out):
        sys.exit("--pipelined is incompatible with --viz-dir/--loop-close/"
                 "--map-out (they need per-frame host access)")
    if args.resume:
        from rgbd_odometry_tpu_torch.utils.checkpoint import load_odometry, read_checkpoint

        # read once for every loader below; the checkpoint counts processed
        # frames: with the original run's source flags the stream continues
        # at the first unprocessed frame
        snap = read_checkpoint(args.resume)
        odo = load_odometry(snap, device=device)
        resume_next = odo._frame_num + 1
        frames, cam, gt = _make_source(args)
        frames = itertools.islice(frames, resume_next, None)
        print(f"resumed at frame {odo._frame_num} from {args.resume}; "
              f"skipping {resume_next} already-processed frames of the source", file=sys.stderr)
    else:
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
        if args.relocalize:
            cfg = dataclasses.replace(cfg, relocalize=RelocalizeConfig(enabled=True))
        odo = EdgeDvoOdometry(cfg, device=device)
    viz = None
    if args.viz_dir:
        from rgbd_odometry_tpu_torch.viz.live import LiveViz

        viz = LiveViz(args.viz_dir, every=args.viz_every)
        odo.keep_residuals = True
    closer = None
    if args.loop_close:
        from rgbd_odometry_tpu_torch.pipeline.loop_closure import LoopCloser

        if args.resume:
            # post-resume keyframes close loops onto the keyframes stored
            # before the checkpoint (None: saved without --loop-close)
            from rgbd_odometry_tpu_torch.utils.checkpoint import load_loop_closer

            closer = load_loop_closer(snap, odo.intr, device=device)
            if closer is not None:
                print(f"loop closer restored: {len(closer.keyframes)} keyframes, "
                      f"{len(closer.closures)} closures", file=sys.stderr)
        if closer is None:
            closer = LoopCloser(odo.intr, device=device)
    # --weighted-refine weights odometry edges, which exist only in graph
    # mode: it implies the pose-graph path
    refine_mode = args.refine_mode
    info_recs = None
    if args.weighted_refine:
        if not args.loop_close:
            sys.exit("--weighted-refine requires --loop-close")
        refine_mode = "graph"
        info_recs = []
    refine_every = int(args.refine_every or 0)
    if refine_every and not args.loop_close:
        sys.exit("--refine-every requires --loop-close")
    map_clouds = [] if args.map_out else None
    # raw consecutive-frame relative poses, captured before any online
    # refinement rewrites the trajectory: every (re-)refinement derives its
    # odometry edges from them (LoopCloser.refine's edge_traj)
    raw_rels: list = []
    refine_state = {"kf": 0, "closures": 0 if closer is None else len(closer.closures)}
    if args.resume:
        from rgbd_odometry_tpu_torch.utils.checkpoint import load_raw_rels, load_refine_state

        raw_rels = load_raw_rels(snap) or []
        if closer is not None:
            # the counter and closure baseline at the checkpoint, so closures
            # found before it but not yet refined still trigger a refine
            refine_state = load_refine_state(snap, len(closer.closures))

    def _refine_report(norms) -> str:
        if refine_mode == "reanchor":
            if len(norms) == 0:
                return "no closure passed the re-anchor separation gate"
            return (f"{len(norms)} re-anchor corrections applied, "
                    f"{1000.0 * float(np.sum(norms)):.1f} mm total")
        return f"graph residual {norms[0]:.4f} -> {norms[-1]:.4f}"

    def _capture_raw_rel():
        els = odo.gop.elements
        if len(els) >= 2:
            a, b = els[-2], els[-1]
            raw_rels.append((a.R.T @ b.R, a.R.T @ (b.t - a.t)))

    def _raw_traj():
        Rs, ts_ = [np.eye(3)], [np.zeros(3)]
        for Rr, tr in raw_rels:
            ts_.append(ts_[-1] + Rs[-1] @ tr)
            Rs.append(Rs[-1] @ Rr)
        return np.stack(Rs), np.stack(ts_)

    def _per_frame(gray, depth):
        """After a frame: the live viz, the raw chain, the keyframe's
        registration (closure detection, map cloud, online refinement) and
        the information record."""
        if refine_every:
            _capture_raw_rel()
        if viz is not None:
            viz.on_frame(odo, gray, depth)
        m = odo.metrics[-1]
        if m.keyframe_reason != 0 and (closer is not None or map_clouds is not None):
            if closer is not None:
                closer.add_keyframe(m.frame_num, gray, depth)
            if map_clouds is not None:
                map_clouds.append(odo.keyframe_cloud())
            if refine_every and closer is not None:
                refine_state["kf"] += 1
                if (refine_state["kf"] >= refine_every
                        and len(closer.closures) > refine_state["closures"]
                        and len(raw_rels) + 1 == len(odo.gop)):
                    norms = closer.refine_inplace(odo.gop, edge_traj=_raw_traj(),
                                                  mode=refine_mode)
                    if norms is not None:
                        refine_state["kf"] = 0
                        refine_state["closures"] = len(closer.closures)
                        odo.sync_reloc_db()
                        print(f"online refine @frame {m.frame_num}: "
                              f"{len(closer.closures)} closures, " + _refine_report(norms),
                              file=sys.stderr)
        if info_recs is not None:
            pi = odo.pose_information()
            info_recs.append(None if pi is None else pi[0] / max(pi[1], 1e-12))

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
    trace = contextlib.nullcontext()
    if args.trace_dir:
        from rgbd_odometry_tpu_torch.utils.tracing import profiler_trace

        trace = profiler_trace(args.trace_dir)
    with trace:
        if args.pipelined:
            # frame n+1 is launched off frame n's in-flight outputs; bitwise
            # the sequential loop (the speculation is discarded where the
            # chain breaks)
            from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder

            feeder = FrameFeeder(frames, num_levels=odo.cfg.pyramid.num_levels, device=device)
            for _pose in odo.process_stream(feeder):
                n += 1
                _after(odo.metrics[-1])
        elif args.feeder:
            # host build + copy to the card of frame n+1 overlap frame n's solve
            from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder

            for pyr, ts in FrameFeeder(frames, num_levels=odo.cfg.pyramid.num_levels,
                                       device=device):
                odo.process_pyramid(pyr, ts)
                _per_frame(pyr.gray[0][0], pyr.depth[0][0])
                n += 1
                _after(odo.metrics[-1])
        else:
            for gray, depth, ts in frames:
                odo.process_frame(gray, depth, ts)
                _per_frame(gray, depth)
                n += 1
                _after(odo.metrics[-1])
    if args.trace_dir:
        print(f"torch.profiler trace -> {args.trace_dir}", file=sys.stderr)
    if args.checkpoint:
        from rgbd_odometry_tpu_torch.utils.checkpoint import save_odometry

        save_odometry(odo, args.checkpoint, closer=closer,
                      raw_rels=raw_rels if refine_every else None, refine_state=refine_state)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    print(f"avg solve: {odo.average_solve_ms():.2f} ms over {n} frames", file=sys.stderr)
    summary = {"frames": n, "keyframes": odo.gop.keyframe_indices(),
               "avg_solve_ms": odo.average_solve_ms()}
    if odo._reloc is not None:
        print(f"relocalizer: {len(odo._reloc)} keyframes in database, "
              f"{odo._reloc.successes}/{odo._reloc.attempts} recoveries", file=sys.stderr)
        summary["recoveries"] = odo._reloc.successes
        summary["reloc_attempts"] = odo._reloc.attempts
    R, t, ts = odo.trajectory()
    summary["poses"] = len(t)
    if closer is not None and len(t) > 1:
        odo_si = None
        if info_recs is not None:
            # edge k (frame k -> k+1) is weighted by frame k+1's information;
            # frames without a measurement take the batch mean
            infos = info_recs[1:len(t)]
            if len(infos) != len(t) - 1:
                # a resumed run: the nodes before it have no information
                print("weighted-refine: trajectory has nodes without collected "
                      "information (resumed run?) — using isotropic edges", file=sys.stderr)
                infos = []
            have = [x for x in infos if x is not None]
            if have:
                import torch

                from rgbd_odometry_tpu_torch.solvers.pose_graph import normalized_information_sqrt

                fill = np.mean(np.stack(have), axis=0)
                arr = np.stack([x if x is not None else fill for x in infos])
                odo_si = normalized_information_sqrt(
                    torch.as_tensor(arr, dtype=torch.float32)).numpy()
        R, t, norms = closer.refine(
            R, t, odo_sqrt_info=odo_si, mode=refine_mode,
            edge_traj=_raw_traj() if (refine_every and len(raw_rels) + 1 == len(t)) else None,
        )
        print(f"loop closures: {len(closer.closures)}; " + _refine_report(norms)
              + (" (information-weighted odometry edges)" if odo_si is not None else ""),
              file=sys.stderr)
        summary["closures"] = [(int(c[0]), int(c[1]), int(c[4])) for c in closer.closures]
        summary["closure_poses"] = [(c[2], c[3]) for c in closer.closures]
    if map_clouds:
        from rgbd_odometry_tpu_torch.viz.pointcloud import compose_map, write_ply

        pts, _ids = compose_map(map_clouds, R, t)
        write_ply(args.map_out, pts)
        print(f"map: {len(pts)} edge points from {len(map_clouds)} keyframes -> {args.map_out}",
              file=sys.stderr)
        summary["map_points"] = len(pts)
    if viz is not None and n > 0:
        written = viz.finalize(odo, gt_t=gt[1][: len(t)] if gt is not None else None)
        print(f"viz: {len(written)} images -> {args.viz_dir}", file=sys.stderr)
        summary["viz"] = written
    if args.out:
        from rgbd_odometry_tpu_torch.io.tum import write_trajectory

        write_trajectory(args.out, R, t, ts)
        print(f"trajectory -> {args.out}", file=sys.stderr)
    if args.gt:
        # GT files are ~100 Hz mocap vs ~30 Hz frames: pair by nearest
        # timestamp, rebase both to their first pose, normalize drift by
        # the elapsed time
        from rgbd_odometry_tpu_torch.eval.ate import ate_rmse, associate_trajectories, drift_stats
        from rgbd_odometry_tpu_torch.io.tum import read_trajectory

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
        from rgbd_odometry_tpu_torch.eval.ate import ate_rmse, drift_stats, rebase_to_first

        gt_R, gt_t = gt
        start = args.start or 0
        if start and not args.resume:
            # a fresh run offset into the synthetic stream is relative to
            # its first processed frame
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


def cmd_refine(args):
    """Keyframe pose-graph refinement of a TUM trajectory with odometry edges
    and optional loop-closure constraints (lines `i j tx ty tz qx qy qz qw
    [weight]`, the pose of j in i's frame); prints the JAX command's JSON
    summary and returns it."""
    import torch

    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.io.tum import read_trajectory, write_trajectory
    from rgbd_odometry_tpu_torch.solvers.pose_graph import (
        PoseGraphEdges, concat_edges, edge_robust_weights, marginal_covariance, odometry_edges,
        refine_pose_graph,
    )

    device = resolve_device(args.device)
    f32 = dict(dtype=torch.float32, device=device)
    R, t, ts = read_trajectory(args.est)
    R0, t0 = torch.as_tensor(R, **f32), torch.as_tensor(t, **f32)
    edges = odometry_edges(R0, t0)
    n_lc = 0
    if args.constraints:
        rows = np.loadtxt(args.constraints, comments="#", ndmin=2)
        w = rows[:, 9] if rows.shape[1] > 9 else np.ones(len(rows))
        lc = PoseGraphEdges(
            i=torch.as_tensor(rows[:, 0].astype(np.int64), device=device),
            j=torch.as_tensor(rows[:, 1].astype(np.int64), device=device),
            R_rel=geo.rotmat_from_quat(torch.as_tensor(rows[:, 5:9], **f32)),
            t_rel=torch.as_tensor(rows[:, 2:5], **f32),
            weight=torch.as_tensor(w, **f32),
        )
        edges = concat_edges(edges, lc)
        n_lc = len(rows)
    R_f, t_f, norms = refine_pose_graph(R0, t0, edges, iterations=args.iterations,
                                        robust=args.robust, robust_delta=args.robust_delta)
    write_trajectory(args.out, R_f.cpu().numpy().astype(np.float64),
                     t_f.cpu().numpy().astype(np.float64), ts)
    summary = {
        "nodes": len(t),
        "loop_closures": n_lc,
        "residual_norms": [round(float(x), 6) for x in norms.cpu().numpy()],
        "out": args.out,
    }
    if args.robust and n_lc:
        w_all = edge_robust_weights(R_f, t_f, edges, args.robust, args.robust_delta).cpu().numpy()
        summary["closure_robust_weights"] = [round(float(x), 4) for x in w_all[-n_lc:]]
    if args.covariance_out:
        cov = marginal_covariance(R_f, t_f, edges, robust=args.robust,
                                  robust_delta=args.robust_delta).cpu().numpy().astype(np.float64)
        np.save(args.covariance_out, cov)
        summary["covariance_out"] = args.covariance_out
        summary["covariance_trace_max"] = round(
            float(np.trace(cov, axis1=-2, axis2=-1).max()), 6)
    print(json.dumps(summary))
    return summary


def cmd_eval(args):
    from rgbd_odometry_tpu_torch.eval.ate import ate_rmse, associate_trajectories, drift_stats, rpe
    from rgbd_odometry_tpu_torch.io.tum import read_trajectory

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


def cmd_dump(args):
    """Write a source as reference-format XML pyramid dumps (one
    framemono_NNNN.xml a frame with mono_0.. and depth_0..), the pyramid
    built on the device; prints and returns {"frames_written", "dir"}."""
    import os

    import torch

    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.io.xml_dump import write_frame_dump

    device = resolve_device(args.device)
    f32 = dict(dtype=torch.float32, device=device)
    frames, cam, gt = _make_source(args)
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for i, (gray, depth, ts) in enumerate(frames):
        pyr = build_pyramid(torch.as_tensor(gray, **f32)[None], torch.as_tensor(depth, **f32)[None],
                            args.levels)
        write_frame_dump(args.out_dir, i, [g[0].cpu().numpy() for g in pyr.gray],
                         [d[0].cpu().numpy() for d in pyr.depth])
        n += 1
    out = {"frames_written": n, "dir": args.out_dir}
    print(json.dumps(out))
    return out


def cmd_calib(args):
    """Read an OpenCV-XML calibration file (prints its CameraConfig as JSON)
    or write the converter's Freiburg pair into a directory."""
    from rgbd_odometry_tpu_torch.config import CameraConfig
    from rgbd_odometry_tpu_torch.io.calib import read_calib_xml, write_freiburg_pair

    if args.write_freiburg:
        cam = CameraConfig(width=640, height=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5)
        out = {"written": list(write_freiburg_pair(args.write_freiburg, cam))}
    else:
        out = dataclasses.asdict(read_calib_xml(args.file))
    print(json.dumps(out))
    return out


def cmd_probe(args):
    """Two-frame convergence probe (the reference's `casualTestFunction`):
    align one rendered 320x240 pair at one level for N iterations on the
    device (extraction, the now-frame targets and one `level_sg` or
    `level_lm` launch) and print the energy-per-iteration curve as the JAX
    command's JSON; returns it with the unrounded curve, the pose, the
    level's diagnostics, its inputs (`ref`, `now`, `intr`) and `cfg`."""
    import torch

    from rgbd_odometry_tpu_torch.config import CameraConfig, SolverConfig
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.io.synthetic import render_pair
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    device = resolve_device(args.device)
    f32 = dict(dtype=torch.float32, device=device)
    cam = CameraConfig()
    intr = Intrinsics.from_config(cam)
    psi = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
    (rg, rd), (ng, nd), _ = render_pair(cam, psi, seed=args.seed)
    t = lambda a: torch.as_tensor(a, **f32)[None]  # noqa: E731
    ref = build_pyramid(t(rg), t(rd), args.level + 1)
    now = build_pyramid(t(ng), t(nd), args.level + 1)
    cfg = SolverConfig(method=args.method)
    max_pts = (4096, 2048, 1024, 512)[: args.level + 1]
    feats = edge_dvo.extract_ref_features(ref.gray, ref.depth, intr, cfg, max_pts)
    tgts = edge_dvo.prepare_now_targets(now.gray, cfg)
    R0 = torch.eye(3, **f32)[None]
    t0 = torch.zeros((1, 3), **f32)
    R, t, diag = edge_dvo.run_level(feats[args.level], tgts[args.level],
                                    intr.at_level(args.level), R0, t0, cfg, args.iterations)
    e = diag.energy[0].cpu().numpy()
    out = {
        "level": args.level,
        "energy": [round(float(x), 3) for x in e],
        "best_iter": int(diag.best_iter[0]),
        "best_energy": round(float(diag.best_energy[0]), 3),
        "visible_ratio": round(float(diag.visible_ratio[0]), 4),
    }
    print(json.dumps(out))
    return {**out, "energy_raw": e, "R": R, "t": t, "diag": diag, "ref": feats[args.level],
            "now": tgts[args.level], "intr": intr.at_level(args.level), "cfg": cfg}


def cmd_photometric(args):
    """The legacy dense photometric DVO over a source (the reference's
    rgbdSubsc node): the first frame is the reference (refreshed every
    `ref_refresh_every` frames), every other frame one `solve_pyramid` from
    the identity (one `level_photo` launch on the card); prints `frame N
    |eps| E` a frame on stderr (the last level's last |eps|) and writes the
    trajectory to --out. Returns {"frames", "R", "t", "stamps", "eps"}."""
    import torch

    from rgbd_odometry_tpu_torch.config import CameraConfig, PhotometricConfig
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.pipeline.gop import REASON_FIRST_FRAME, Gop
    from rgbd_odometry_tpu_torch.solvers import photometric

    device = resolve_device(args.device)
    f32 = dict(dtype=torch.float32, device=device)
    frames, cam, gt = _make_source(args)
    intr = Intrinsics.from_config(cam or CameraConfig())
    cfg = PhotometricConfig(use_huber=args.huber)
    gop = Gop()
    refs = None
    eps = []
    for i, (gray, depth, ts) in enumerate(frames):
        pyr = build_pyramid(torch.as_tensor(gray, **f32)[None], torch.as_tensor(depth, **f32)[None],
                            4)
        grays = [g[0] for g in pyr.gray]
        if i % cfg.ref_refresh_every == 0:
            refs = photometric.extract_photo_ref(grays, [d[0] for d in pyr.depth], intr, cfg,
                                                 cfg.max_points)
            gop.push_keyframe(i, REASON_FIRST_FRAME, np.eye(3), np.zeros(3), ts)
            continue
        R, t, hist = photometric.solve_pyramid(refs, grays, intr, cfg)
        gop.push_ordinary(i, R.cpu().numpy().astype(np.float64),
                          t.cpu().numpy().astype(np.float64), ts)
        e = float(list(hist.values())[-1][-1])
        eps.append(e)
        print(f"frame {i:4d}  |eps| {e:9.1f}", file=sys.stderr)
    R, t, stamps = gop.poses()
    if args.out:
        from rgbd_odometry_tpu_torch.io.tum import write_trajectory

        write_trajectory(args.out, R, t, stamps)
    return {"frames": len(gop), "R": R, "t": t, "stamps": stamps, "eps": eps}


def cmd_feature_vo(args):
    """Sparse feature VO over a source (the reference's opencvpnp node):
    prints `frame N  good matches M` a frame on stderr and writes the
    trajectory to --out. Returns {"frames", "R", "t", "stamps",
    "match_counts", "gt"}."""
    from rgbd_odometry_tpu_torch.config import CameraConfig
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.pipeline.feature_vo import FeatureVo, FeatureVoConfig

    device = resolve_device(args.device)
    frames, cam, gt = _make_source(args)
    vo = FeatureVo(cam or CameraConfig(), FeatureVoConfig(min_good_matches=args.min_matches),
                   device=device)
    for i, (gray, depth, ts) in enumerate(frames):
        vo.process_frame(gray, depth, ts)
        print(f"frame {i:4d}  good matches {vo.match_counts[-1]}", file=sys.stderr)
    R, t, stamps = vo.trajectory()
    if args.out:
        from rgbd_odometry_tpu_torch.io.tum import write_trajectory

        write_trajectory(args.out, R, t, stamps)
    return {"frames": len(t), "R": R, "t": t, "stamps": stamps, "match_counts": vo.match_counts,
            "gt": gt}


def cmd_pnp(args):
    """The chessboard Gauss-Newton PnP demo (the reference's pnp node) on a
    synthetic 9x6 board of 5 cm squares 1.5 m away, seen from a known pose:
    `gn_pnp` from the identity (one `pnp_gn` launch on the card); prints
    and returns {"residual_norms", "t_err"}."""
    import torch

    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.solvers import pnp

    device = resolve_device(args.device)
    f32 = dict(dtype=torch.float32, device=device)
    obj = torch.as_tensor(pnp.chessboard_object_points(6, 9, 0.05), **f32)
    obj = obj + torch.tensor([0.0, 0.0, 1.5], **f32)
    psi_gt = torch.tensor([0.08, -0.05, 0.03, 0.05, -0.06, 0.04], **f32)
    R_gt, t_gt = geo.se3_exp(psi_gt)
    pb = (obj - t_gt) @ R_gt
    imn_gt = pb[:, :2] / pb[:, 2:3]
    valid = torch.ones(obj.shape[0], dtype=torch.bool, device=device)
    R, t, rnorms = pnp.gn_pnp(obj, imn_gt, valid, iterations=5)
    out = {
        "residual_norms": [round(float(x), 6) for x in rnorms.cpu().numpy()],
        "t_err": float(np.linalg.norm(t.cpu().numpy() - t_gt.cpu().numpy())),
    }
    print(json.dumps(out))
    return {**out, "residual_norms_raw": rnorms.cpu().numpy()}


def cmd_imu(args):
    """IMU dead reckoning (the reference's imuDR node) over a csv of `t, ax,
    ay, az, wx, wy, wz` rows or `--steps` synthetic samples of a 0.1 rad/s
    yaw at rest, at 100 Hz with the reference's gravity: one `imu_scan`
    launch on the card; prints and returns {"final_p", "final_q", "steps"}."""
    import torch

    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.solvers import imu

    device = resolve_device(args.device)
    if args.csv:
        data = np.loadtxt(args.csv, delimiter=",")  # t, ax..az, wx..wz
        accels, gyros = data[:, 1:4], data[:, 4:7]
    else:
        accels = np.zeros((args.steps, 3))
        gyros = np.tile([0.0, 0.0, 0.1], (args.steps, 1))
    intr = imu.ImuIntrinsics.from_scalars(accel_bias=args.accel_bias, gyro_bias=args.gyro_bias,
                                          device=device)
    f32 = dict(dtype=torch.float32, device=device)
    final, _ = imu.propagate_batch(imu.ImuState.identity(device=device),
                                   torch.as_tensor(accels, **f32), torch.as_tensor(gyros, **f32),
                                   intr)
    out = {
        "final_p": [float(x) for x in final.p.cpu().numpy()],
        "final_q": [float(x) for x in final.q.cpu().numpy()],
        "steps": int(accels.shape[0]),
    }
    print(json.dumps(out))
    return out


def cmd_fused(args):
    """The full pipeline (BASELINE.json config 5): IMU-prior warm starts,
    edge DVO and the quality-gated sparse-PnP fallback over a source. With
    the synthetic source each frame's IMU window is one sample that dead
    reckons the ground truth's inter-frame motion from rest (plus
    `--imu-noise` on the gyro, 10x on the accelerometer), the reference's
    ImuDeadReckon node's role. Prints a line a frame on stderr and the JSON
    {"frames", "fallback_frames", "ate_rmse"[, "ate_rmse_unrefined"]};
    returns it with the trajectory."""
    import torch

    from rgbd_odometry_tpu_torch.config import (
        CameraConfig, KeyframeConfig, PipelineConfig, SolverConfig,
    )
    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.pipeline.fused import FusedConfig, FusedOdometry
    from rgbd_odometry_tpu_torch.solvers import imu as imu_mod

    device = resolve_device(args.device)
    frames, cam, gt = _make_source(args)
    cfg = PipelineConfig(
        camera=cam or CameraConfig(),
        solver=SolverConfig(method=args.method,
                            iterations=tuple(int(x) for x in args.iterations.split(","))),
        keyframe=KeyframeConfig(force_every=args.keyframe_every, enable_quality_triggers=True),
    )
    # the sensor's noise model: it weighs the IMU edges of --imu-refine
    imu_intr = imu_mod.ImuIntrinsics.from_scalars(
        gyro_var=args.imu_noise ** 2, accel_var=(10.0 * args.imu_noise) ** 2, device=device)
    fused = FusedOdometry(cfg, FusedConfig(use_imu_prior=not args.no_imu),
                          imu_intrinsics=imu_intr, device=device)
    rng = np.random.default_rng(0)
    dt = 1.0 / 30.0
    prev_R = prev_t = None
    n = 0
    for gray, depth, ts in frames:
        imu_window = None
        if gt is not None and not args.no_imu and n > 0:
            # the ground truth's inter-frame motion as a 1-sample window that
            # reproduces it by dead reckoning from rest
            gt_R, gt_t = gt
            i = min(n, len(gt_t) - 1)
            dR = prev_R.T @ gt_R[i]
            dtr = prev_R.T @ (gt_t[i] - prev_t)
            w = geo.so3_log(torch.as_tensor(dR, dtype=torch.float32)).numpy() / dt
            a = 2.0 * dtr / (dt * dt)
            w = w + rng.normal(0, args.imu_noise, 3)
            a = a + rng.normal(0, args.imu_noise * 10, 3)
            imu_window = (a[None, :], w[None, :], dt)
        if gt is not None:
            gt_R, gt_t = gt
            i = min(n, len(gt_t) - 1)
            prev_R, prev_t = gt_R[i], gt_t[i]
        fused.process_frame(gray, depth, ts, imu_window=imu_window)
        m = fused.odo.metrics[-1]
        print(f"frame {m.frame_num:4d}  E={m.best_energy:9.2f} vis={m.visible_ratio:.2f} "
              f"b^={m.b_cap:6.2f} kf={m.keyframe_reason}"
              + (" [PnP fallback]" if m.frame_num in fused.fallback_frames else ""),
              file=sys.stderr)
        n += 1
    R, t, ts_arr = fused.trajectory()
    R0, t0 = R, t
    if args.imu_refine:
        # the synthetic windows are gravity-free and from rest: gravity and
        # the velocities are exactly zero for them
        R, t, ts_arr = fused.refine_with_imu(gravity=(0.0, 0.0, 0.0),
                                             velocities=np.zeros_like(t0),
                                             imu_weight=args.imu_weight)
    if args.out:
        from rgbd_odometry_tpu_torch.io.tum import write_trajectory

        write_trajectory(args.out, R, t, ts_arr)
    summary = {"frames": n, "fallback_frames": fused.fallback_frames}
    if gt is not None:
        from rgbd_odometry_tpu_torch.eval.ate import ate_rmse

        n2 = min(len(t), len(gt[1]))
        summary["ate_rmse"] = ate_rmse(t[:n2], gt[1][:n2], align=False)
        if args.imu_refine:
            summary["ate_rmse_unrefined"] = ate_rmse(t0[:n2], gt[1][:n2], align=False)
    print(json.dumps(summary))
    return {**summary, "R": R, "t": t, "stamps": ts_arr}


def cmd_unported(args):
    _unported(f"the {args.cmd} subcommand", _UNPORTED_COMMANDS[args.cmd])


def multistream_config(cam, iterations=(18, 6, 4, 3), keyframe_every: int = 5,
                       quality_triggers: bool = False, motion_model: str = "hold"):
    """The `multistream` command's `PipelineConfig` (the JAX command's):
    Gauss-Newton at the given iterations a level, capacities 2048/1024/
    512/512, the naive ref update (rollback off)."""
    from rgbd_odometry_tpu_torch.config import (
        KeyframeConfig, PipelineConfig, PyramidConfig, SolverConfig,
    )

    levels = len(iterations)
    return PipelineConfig(
        camera=cam,
        pyramid=PyramidConfig(num_levels=levels, max_points=(2048, 1024, 512, 512)[:levels]),
        solver=SolverConfig(method="gauss_newton", iterations=tuple(iterations)),
        keyframe=KeyframeConfig(force_every=keyframe_every,
                                enable_quality_triggers=quality_triggers, rollback_resolve=False),
        motion_model=motion_model,
    )


def render_streams(cam, n_streams: int, n_frames: int):
    """Each stream's rendered frames and ground-truth positions: a distinct
    smooth out-and-back trajectory per stream (the JAX command's), each
    stream one `render_sequence` call in a thread pool (numpy releases the
    GIL in the renderer's array math)."""
    from concurrent.futures import ThreadPoolExecutor

    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    phase = np.sin(np.pi * np.arange(n_frames) / max(n_frames - 1, 1))

    def render(s):
        amp = 0.02 + 0.004 * s
        psis = np.stack([amp * phase, -0.5 * amp * phase, 0.3 * amp * phase,
                         0.2 * amp * phase, -0.15 * amp * phase, 0.1 * amp * phase],
                        -1).astype(np.float32)
        return render_sequence(cam, psis, seed=s)

    with ThreadPoolExecutor(max_workers=8) as pool:
        out = list(pool.map(render, range(n_streams)))
    return [f for f, _ in out], [np.stack([p[1] for p in ps]) for _, ps in out]


def cmd_multistream(args):
    """N synthetic cameras tracked in lockstep on one device
    (`parallel/streams.MultiStreamOdometry`): every step advances all
    streams by one frame in one batched solve. Each stream runs an
    independent synthetic trajectory; prints one JSON line with the
    per-stream ATE against exact ground truth and the aggregate frame rate
    of the lockstep loop (rendering excluded, as in the JAX command), and
    returns it with the loop's wall time and each stream's keyframes."""
    import time

    from rgbd_odometry_tpu_torch.config import CameraConfig
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.eval.ate import ate_rmse
    from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry

    device = resolve_device(args.device)
    n_streams = args.streams or 2
    cam = CameraConfig()
    if args.cam_scale != 1.0:
        cam = cam.scaled(args.cam_scale)
    pcfg = multistream_config(cam, tuple(int(x) for x in args.iterations.split(",")),
                              args.keyframe_every, args.quality_triggers, args.motion_model)
    t0 = time.perf_counter()
    seqs, gts = render_streams(cam, n_streams, args.frames)
    print(f"rendered {n_streams} x {args.frames} frames in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)

    ms = MultiStreamOdometry(n_streams, pcfg, device=device)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for f in range(args.frames):
        gray_b = np.stack([seqs[s][f][0] for s in range(n_streams)])
        depth_b = np.stack([seqs[s][f][1] for s in range(n_streams)])
        ms.process_batch(gray_b, depth_b, timestamp=f / 30.0)
    wall = time.perf_counter() - t0

    ates = []
    for s, (R_est, t_est, stamps) in enumerate(ms.trajectories()):
        ates.append(ate_rmse(np.asarray(t_est), gts[s]))
        if args.out_dir:
            import os

            from rgbd_odometry_tpu_torch.io.tum import write_trajectory

            os.makedirs(args.out_dir, exist_ok=True)
            write_trajectory(os.path.join(args.out_dir, f"stream{s:02d}.txt"), R_est, t_est, stamps)
    out = {
        "streams": n_streams,
        "devices": 1,
        "frames": args.frames,
        "aggregate_frames_per_s": round(n_streams * args.frames / wall, 2),
        "ate_rmse_per_stream": [round(float(a), 6) for a in ates],
        "ate_rmse_max": round(float(max(ates)), 6),
    }
    print(json.dumps(out))
    return {**out, "wall_s": wall, "keyframes": [g.keyframe_indices() for g in ms.gops]}


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
    p.add_argument("--checkpoint", default=None,
                   help="save the odometry state (and the loop closer's) at the end (.npz)")
    p.add_argument("--resume", default=None,
                   help="resume from a state snapshot: rerun with the original source flags; "
                   "the frames it processed are skipped")
    p.add_argument("--viz-dir", default=None,
                   help="write debug PNGs (overlay/residue/energy/histogram per sampled frame, "
                   "trajectory and reprojection at the end)")
    p.add_argument("--viz-every", type=int, default=5, help="sample every Nth frame for viz")
    p.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace (Chrome/TensorBoard format) here")
    p.add_argument("--pipelined", action="store_true",
                   help="pipelined streaming: the next frame is launched off the previous "
                   "one's unresolved outputs (the trajectory is bitwise the sequential one)")
    p.add_argument("--loop-close", action="store_true",
                   help="detect loop closures between keyframes and refine the trajectory "
                   "(rigid re-anchoring by default, see --refine-mode)")
    p.add_argument("--refine-mode", default="reanchor", choices=["reanchor", "graph"],
                   help="with --loop-close: 'reanchor' applies each closure's correction "
                   "rigidly at its revisit node; 'graph' runs the pose-graph Gauss-Newton "
                   "over odometry and closure edges")
    p.add_argument("--map-out", default=None,
                   help="write the fused semi-dense edge-point map (PLY), every keyframe's "
                   "edge cloud composed through the final trajectory")
    p.add_argument("--refine-every", type=int, default=0, metavar="K",
                   help="with --loop-close: online refinement every K keyframes when new "
                   "closures exist, written back into the live trajectory")
    p.add_argument("--weighted-refine", action="store_true",
                   help="with --loop-close: weight odometry edges by the solver's per-frame "
                   "6x6 information matrix (implies the graph mode)")
    p.add_argument("--relocalize", action="store_true",
                   help="recover from tracking loss against a database of healthy keyframes")
    p.set_defaults(fn=cmd_dvo)

    p = sub.add_parser("refine", help="pose-graph refinement of a trajectory (+ loop closures)")
    p.add_argument("est", help="TUM-format trajectory to refine")
    p.add_argument("--constraints", default=None, help="file: i j tx ty tz qx qy qz qw [weight]")
    p.add_argument("--out", required=True)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--robust", default=None, choices=["huber", "geman"],
                   help="IRLS kernel on edge residuals: huber bounds an outlier edge's pull, "
                   "geman switches false loop closures off")
    p.add_argument("--robust-delta", type=float, default=1.0,
                   help="robust kernel scale in whitened-residual units")
    p.add_argument("--covariance-out", default=None,
                   help="save per-node anchor-relative 6x6 marginal covariance blocks (N,6,6 "
                   ".npy) at the refined solution")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    p.set_defaults(fn=cmd_refine)

    p = sub.add_parser("multistream",
                       help="N lockstep odometry streams on one device (parallel/streams.py)")
    p.add_argument("--streams", type=int, default=0,
                   help="stream count (default 2: the JAX command's device count, min 2, on "
                   "one card)")
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--cam-scale", type=float, default=1.0)
    p.add_argument("--iterations", default="18,6,4,3")
    p.add_argument("--keyframe-every", type=int, default=5)
    p.add_argument("--quality-triggers", action="store_true",
                   help="enable per-stream Laplacian/visibility keyframe triggers")
    p.add_argument("--out-dir", default=None, help="write per-stream TUM trajectories here")
    p.add_argument("--motion-model", default="hold", choices=["hold", "constant_velocity"],
                   help="per-stream warm-start model (see dvo --motion-model)")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu' (the kernels' plain versions)")
    p.set_defaults(fn=cmd_multistream)

    p = sub.add_parser("eval", help="ATE/RPE/drift vs a GT trajectory (loadGTPath role)")
    p.add_argument("est")
    p.add_argument("gt")
    p.add_argument("--gt-skip", type=int, default=0)
    p.add_argument("--rebase", action="store_true")
    p.add_argument("--max-dt", type=float, default=0.02, help="max timestamp gap for association")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("calib", help="read/write OpenCV-XML calibration files")
    p.add_argument("--file", default=None)
    p.add_argument("--write-freiburg", default=None, metavar="DIR")
    p.set_defaults(fn=cmd_calib)

    p = sub.add_parser("probe", help="two-frame energy-curve probe (casualTestFunction)")
    p.add_argument("--level", type=int, default=0)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--method", default="subgradient", choices=["subgradient", "gauss_newton"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu' (the kernels' plain versions)")
    p.set_defaults(fn=cmd_probe)

    p = sub.add_parser("dump", help="write reference-format XML pyramid dumps")
    _add_source_args(p)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    p.set_defaults(fn=cmd_dump)

    dev_help = "torch device: 'cuda' (default) or 'cpu' (the kernels' plain versions)"
    p = sub.add_parser("photometric", help="legacy dense DVO (rgbdSubsc node)")
    _add_source_args(p)
    p.add_argument("--huber", action="store_true")
    p.add_argument("--device", default="cuda", help=dev_help)
    p.set_defaults(fn=cmd_photometric)

    p = sub.add_parser("feature-vo", help="sparse feature VO (opencvpnp node)")
    _add_source_args(p)
    p.add_argument("--min-matches", type=int, default=40)
    p.add_argument("--device", default="cuda", help=dev_help)
    p.set_defaults(fn=cmd_feature_vo)

    p = sub.add_parser("pnp", help="chessboard GN-PnP demo (pnp node)")
    p.add_argument("--device", default="cuda", help=dev_help)
    p.set_defaults(fn=cmd_pnp)

    p = sub.add_parser("imu", help="IMU dead reckoning (imuDR node)")
    p.add_argument("--csv", default=None, help="csv with t,ax,ay,az,wx,wy,wz rows")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--accel-bias", type=float, default=0.0)
    p.add_argument("--gyro-bias", type=float, default=0.0)
    p.add_argument("--device", default="cuda", help=dev_help)
    p.set_defaults(fn=cmd_imu)

    p = sub.add_parser("fused",
                       help="IMU prior + edge DVO + sparse-PnP fallback (BASELINE config 5)")
    _add_source_args(p)
    p.add_argument("--method", default="gauss_newton", choices=["gauss_newton", "subgradient"])
    p.add_argument("--iterations", default="18,6,4,3")
    p.add_argument("--keyframe-every", type=int, default=5)
    p.add_argument("--no-imu", action="store_true")
    p.add_argument("--imu-noise", type=float, default=0.0,
                   help="gyro noise sigma (rad/s); accel gets 10x")
    p.add_argument("--imu-refine", action="store_true",
                   help="post-run visual-inertial polish: preintegrated IMU edges and the "
                   "visual odometry chain in one pose graph")
    p.add_argument("--imu-weight", type=float, default=3.0,
                   help="IMU edge weight relative to weight-1 visual edges (--imu-refine)")
    p.add_argument("--device", default="cuda", help=dev_help)
    p.set_defaults(fn=cmd_fused)

    # the JAX subcommand not ported yet, with the JAX parser's flags: it
    # exits naming its ROADMAP.md item
    p = sub.add_parser("bench", help="batched-alignment throughput benchmark (not ported yet)")
    p.add_argument("--batch", type=int, default=32)
    for name in _UNPORTED_COMMANDS:
        sub.choices[name].set_defaults(fn=cmd_unported)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
