#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`rgbd_odometry_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the fourteen CUDA sources of `rgbd_odometry_tpu_torch/csrc/` (sixteen
kernel entries; one nvcc per source, all at once), holds each against its plain
PyTorch version at the main paths' shapes, then drives the port's main paths
through their user entry points:

  stream           `EdgeDvoOdometry` under production_320 over 30 rendered
                   320x240 frames, keyframe every 5: ATE < 8 mm, keyframes,
                   rollbacks, ms/frame;
  stream_vga       the same under production_vga (5 levels from 640x480,
                   capacities 4096/2048/1024/512/512, LM 4/18/6/4/3) over the
                   same trajectory rendered at 640x480: ATE < 8 mm, ms/frame
                   beside production_320's;
  batch            `align_pair` under production_320 on 64 distinct rendered
                   pairs: every pair within 2 cm of ground truth, pairs/s;
  batch_vga        the same under production_vga on 64 distinct 640x480
                   pairs rendered as bench.py's `_vga_extras` renders them;
  cli_default      `rgbd_odometry_tpu_torch.cli dvo --frames 30` at the
                   command's defaults (standard LM on the normalized DT, full
                   EDT, the frame feeder): unaligned ATE < 20 mm; then again
                   with `--no-feeder`, and with `--pipelined` (cli_pipelined:
                   `process_stream` fed by the feeder): the same trajectory
                   file and metrics;
  cli_subgradient  `dvo --method subgradient --iterations 50,50,50,50
                   --frames 10`, the reference's solver, every level one
                   `level_sg` launch: ATE < 25 mm;
  loop_closure     `LoopCloser` over a rendered 320x240 out-and-back sequence
                   (384 keypoints, 64 hypotheses, slot capacity 4, so that
                   the store doubles): >= 1 closure, each within 2 cm / 0.02
                   of ground truth, the same closures from a second run;
  relocalize       the blackout-teleport run through `EdgeDvoOdometry` with
                   relocalization: a REASON_RELOCALIZED keyframe, the last 3
                   frames within 25 mm;
  stream_pipelined `EdgeDvoOdometry.process_stream` fed by a `FrameFeeder`
                   against `process_pyramid` from a feeder and `process_frame`:
                   production_320 over the stream phase's frames in hold mode
                   and with constant velocity, and the relocalize run; poses,
                   keyframes and every FrameMetrics field but solve_ms bitwise
                   equal three ways; ms/frame of each, the discarded
                   speculative solves;
  stream_vga_ingest  the stream's trajectory rendered as a distorting VGA
                   RGB-D sensor delivers it (RGB, metres, TUM freiburg1's
                   distortion) through `io.stream.preprocess_vga` on the card
                   into production_320: ATE < 8 mm;
  cli_loop_close   `dvo --frames 30 --loop-close --map-out map.ply`: >= 1
                   closure, ATE < 20 mm, a PLY with vertices;
  cli_weighted_refine  `dvo --frames 30 --loop-close --weighted-refine`: the
                   information-weighted refinement, ATE < 20 mm;
  cli_refine       `refine` of cli_loop_close's trajectory and closures with
                   `--robust geman --covariance-out`: no residual norm grows
                   from one iteration to the next, (N, 6, 6) covariance;
  multistream      `MultiStreamOdometry`, 8 of the `multistream` command's
                   rendered 320x240 streams, 12 frames, hold and constant
                   velocity, against 8 `EdgeDvoOdometry` runs each (rollback
                   off): the same keyframes, hold's poses bitwise equal,
                   constant velocity's within 1e-2 and bitwise unless
                   `cv_extrapolate` itself differs at B = 8 from B = 1;
  cli_multistream  `multistream --streams 16 --frames 12 --quality-triggers`:
                   every stream's ATE < 20 mm, aggregate frames/s, the
                   kernels' calls per lockstep step;
  align_sequence   `parallel.sequence.align_sequence` over the stream phase's
                   30 frames under production_320, keyframe-anchored every 5:
                   the last frame within tests/test_sharding.py's bar;
  multigpu         the port's multi-GPU path over `torch.distributed` ranks
                   (every kernel built here first; the ranks are spawned
                   processes that load them): (a) NCCL at world 1 on the
                   card, the sharded train step over the batch phase's 64
                   pairs bitwise `build_batch_step`'s; (b) 4 ranks sharing
                   the card over gloo: the sharded aligner and train step
                   over the 64 pairs, lockstep at 16 streams x 12 frames
                   (hold and constant velocity) and `align_sequence`, each
                   bitwise the one-process call, no collective inside a
                   lockstep step, one `all_reduce` a train step; `multistream
                   --world-size 4` as 4 processes, every ATE < 20 mm; each
                   job (aligner, train step, each lockstep model, the timed
                   loops, the sequence, the command) counted on its own on
                   every rank, launching the four path kernels;
                   lockstep frames/s at W = 1, 2 and 4 on the card; (c)
                   NCCL across cards, a rank a card, where there are two
                   or more (else a line says it was not run);
  cli_checkpoint   `dvo --frames 30 --loop-close --refine-every 2 --relocalize`
                   against 15 frames with `--checkpoint` and `--resume` for
                   the rest, in hold and constant-velocity modes: the same
                   trajectory file, closures, keyframes and relocalizer
                   counters; save and load times with 8, 128 and 256
                   keyframes in each store (the load reads each array once,
                   and its cost per keyframe from 128 to 256 must not exceed
                   twice that from 8 to 128);
  cli_viz          `dvo --frames 30 --viz-dir`: the JAX sink's file set, each
                   PNG decoded (the port's reader) to its shape, the
                   trajectory file of cli_default;
  cli_trace        `dvo --frames 30 --trace-dir`: the trace names every
                   frame step replay (`frame_step`; the step is captured
                   before the trace starts) and `extract_pyramid` call
                   (host ranges) and holds the `canny_pyramid`,
                   `dt_pyramid`, `level_lm` and `extract_pyramid` kernels
                   (device events); the trajectory file of cli_default;
  cli_xml          `dump --frames 15 --levels 4`, every level read back
                   bitwise, then `dvo --source xml:<dir>`: ATE < 20 mm;
  probe            `probe --method subgradient` and `--method gauss_newton`
                   at level 0, 100 iterations, on the card against the plain
                   version of its level on the same card inputs, within the
                   level kernels' bars;
  cli_cam_scale_3  `dvo --cam-scale 3 --frames 4` (level 0 at 960x720):
                   ATE < 20 mm;
  cli_cam_scale_4  `dvo --cam-scale 4 --frames 6` (level 0 at 1280x960,
                   Canny's hysteresis and extraction on clusters of
                   blocks): ATE < 20 mm;
  cli_photometric  `photometric --frames 30 --cam-scale 2 --huber` (640x480,
                   levels 3 and 2): 30 rows, one `level_photo` launch a
                   solved frame, the trajectory within 1e-4 of the plain
                   route's over the same frames;
  cli_fused        `fused --frames 30 --imu-refine --imu-noise 0.01`: ATE <
                   20 mm, refined no worse than unrefined (+1e-4), `imu_scan`
                   and `level_lm` launched (no frame trips the fallback's
                   gate here, so `match_mutual` does not run);
  fused_fallback   `FusedOdometry` as JAX's `test_fused_fallback_fires` sets
                   it up, at 320x240: a fallback frame, the last frame within
                   0.12 m, `detect_describe`, `match_mutual` and `ransac_pnp`
                   launched;
  cli_feature_vo   `feature-vo --frames 30`: 30 rows, the JAX package's
                   good-match counts a frame, frames 0-15 within 0.1 m and
                   the track lost from frame 16, where JAX's loses it (NaN
                   from frame 25 on the CPU in both packages);
                   `detect_describe`, `match_mutual`,
                   `fundamental_ransac` and `ransac_pnp` launched, one
                   epipolar filter a PnP verification at least, every
                   filter (K = 512) bitwise the twin on CPU copies of its
                   inputs;
  cli_imu          `imu --steps 400`: the JSON within 1e-6 of `--device
                   cpu`'s;
  cli_pnp          `pnp`: t_err < 1e-4; its `gn_pnp` call one `pnp_gn`
                   launch and no other device work (no aten operation but
                   unfilled allocations and views);
  parity_batch     `align_pair` in the reference-parity mode on the batch
                   phase's 64 pairs (8192/4096/2048/1024 points), once per
                   family (`point_sem.PARITY_FAMILIES`: the sub-gradient
                   with `interpolate_dt` by mxu and take, with the SVD
                   `rotationize`, with the textbook Jacobian; Gauss-Newton
                   with take, with "channels" and float32 channels, with
                   the reference Jacobian, with the SVD): the pyramid in
                   one `level_lm` or `level_sg` launch beside the path's 7
                   target and extraction launches a call, no
                   `run_level_loop` solve, ms a call, pairs 0-3 within the
                   family's bar of the port's CPU run (the plain twins) of
                   the same inputs;
  parity_stream    `EdgeDvoOdometry` under parity_320 + `interpolate_dt` +
                   the SVD `rotationize` over the stream phase's 30 frames:
                   ATE under the JAX package's CPU ATE + 5 mm
                   (`PARITY_STREAM_ATE_MM`), ms/frame, launches a frame
                   (one `level_sg` a solve);
  uncaptured       the paths again on both routes of the drivers: the frame
                   step's CUDA graphs (every phase above runs on them) and
                   the uncaptured route (`graphs=False`): stream,
                   stream_vga, parity_stream, cli_default (the feeder,
                   `--no-feeder`, `--pipelined`), cli_subgradient and
                   `MultiStreamOdometry` at N = 16 (`--quality-triggers`,
                   hold and constant velocity): poses, keyframes and every
                   FrameMetrics field but solve_ms bitwise equal; each
                   route's kernel launches, graph launches, copies and host
                   syncs a frame from the profiler, the step's capture time
                   and pool bytes a slot.

A solved frame of `EdgeDvoOdometry` and a lockstep step are one CUDA graph
replay (`pipeline/step.py`); the kernels' launch counters (and the solve
counts, registered in `step.COUNTED`) are put back after a capture and
advanced by its delta at every replay, so every count below is per frame
as the uncaptured route's would be.

`check_canny_pyramid` and `check_dt_pyramid` hold the now-frame target
kernels against their plain versions bitwise at the 4 level shapes and at
production_vga's (5 levels from 640x480, rendered frames), B = 64 and B = 1
(Canny on rendered frames, on a serpentine weak chain and on noise; the
distance transforms for the +-16 window and the whole row, with and
without normalization, bf16 and float32 channels; each the whole pyramid
in one call, timed beside one single-level call a level, and every level
alone; Canny with the fixpoints' pass counts, `dt_pyramid` on every forced
cluster size).
`check_level_lm` holds the LM pyramid kernel, one level a launch, against
its plain version on rendered pairs at both Gauss-Newton configurations'
level shapes (the `dvo` defaults and production_320, all 4 levels, and
production_vga, all 5 levels, B = 64 and B = 1) on the route rule's
cluster size and forced to every other (1, 2, 4, 8 blocks a pair), pair 5
alone bitwise pair 5 of the batch, its all-point tail bitwise against
`residual_pass` at the returned pose on every route, and each
configuration's whole pyramid in one launch bitwise the levels launched
one by one; it times each level on each route beside the per-iteration
route it replaced. `check_level_sg` does the same for the sub-gradient
pyramid kernel at the four parity capacities (50 iterations, B = 64 and B
= 1), after `check_se3_log` has held the step's `warp_se3_log` against its
plain twin in all three branches and `check_rotationize_svd` the step's SVD
projection bitwise against its twin. Both then hold their reference-parity
semantics (`_check_parity_lm`: "take", "channels" on float32 and bf16,
"interpolant" on float32, the reference Jacobian by mxu and take, the SVD,
the deferred accept; `_check_parity_sg`: `interpolate_dt` by mxu and take,
the textbook Jacobian, the SVD) at the four parity capacities, B = 64 and
1, on the rule's route and forced to every other: runs bitwise, the
per-point values (the LM's all-point tail, the sub-gradient's best
iterate) bitwise the plain point terms on the CPU, each sub-gradient step
and the LM's first step against the plain terms and step, the
free-running plain twins within the level checks' bars. `check_extract` holds keyframe extraction
over a pyramid bitwise against its plain version on every output, invalid
slots included (production_320's, the `dvo` defaults' and production_vga's
capacities, B = 64 and 1, rendered, edge-free, all-edge and shallow-depth
inputs). `check_canny_pyramid`, `check_dt_pyramid` and `check_extract`
also hold their kernels at 720x960 and 1280x960 (`dvo --cam-scale 3` and
`4`, B = 8 and 1) and on single levels of 1600x2560 and 2560x1600 (B = 1),
timed beside their bounds; each on every route (one block or a cluster of
2, 4 or 8 blocks a (level, image)) the levels fit, forced, bitwise the
route its rule takes. Every
kernel's launch counter is set to 0 before the path phases and read around
each one: each kernel of the paths must launch; `canny_pyramid` and
`dt_pyramid` in every Gauss-Newton phase, in cli_subgradient and the
parity phases, one `dt_pyramid` launch for each target preparation
(`prepare_now_targets`, counted and required: no call a level);
(`edt_squared`, whose phases `dt_pyramid` runs, keeps its check and
launches on no path); `level_lm` in every Gauss-Newton phase, one launch
for each pyramid solve (`solve_pyramid`) and each single level
(`run_level`), counted and required, where the per-iteration
`fused_gn_terms` and the `residual_pass` that `level_lm`'s tail replaced
must launch not at all (both keep their checks); `level_sg` in
cli_subgradient, one launch a pyramid solve too, where the per-iteration
`subgradient_terms` must launch not at all (it keeps its check too); the matching and PnP kernels in each of
the loop_closure, relocalize, cli_loop_close, cli_weighted_refine and
cli_checkpoint phases; `level_sg` in probe too; `extract_pyramid` in every phase that extracts keyframe features
(every Gauss-Newton phase, the lockstep and sequence phases among them, and
cli_subgradient); `imu_scan`, `level_photo` and `pnp_gn` in the secondary
solvers' phases (`PHASE_KERNELS`); a level kernel in the parity phases
(`PARITY_PHASES`), one a pyramid solve; no phase solves a level on
`run_level_loop`. `check_level_traj` holds the two level kernels'
trajectory output (JAX's `collect_trajectory`) at the `dvo` commands'
level 0, B = 64 and 1: every other output bitwise the launch without it,
`level_sg`'s rows bitwise its trace's next pose, the plain twins' rows
within each level check's pose bar, timed with and without it (the
kernels' JSON entries' "trajectory"). `check_imu` and `check_level_photo` hold
the two secondary kernels against their plain versions at the paths' shapes
(propagate B = 1 T = 400 and B = 64 T = 100, preintegrate B = 64 T = 10
and 1; the photometric pyramid at 320x240 and 640x480, B = 1 and 64, every
option). `check_pnp` holds `pnp_gn` bitwise to its plain version (R, t,
counts, inliers, residual norms) at the chessboard, the RANSAC route's
hypotheses and refine of K = 384, and B = 3 and 65 at K = 1, 33, 1025 and
4096; `check_ransac` the fused `ransac_pnp` bitwise to the step-by-step
routes over the kernel and over the plain `pnp_gn`, at K = 384 and past
the small route at K = 1025, 2048, 4097, 8192, 16384 and the card's
largest K, one launch a verification at each K ("k2048", "k8192",
"k16384", "k_max": its time and bound there). `check_detect` holds the
front end's detection (`detect_describe`, `csrc/features.cu`: Harris,
peaks, top-K, descriptors and the back-projection in one launch) bitwise to
its plain version on every output: rendered 320x240 frames exact and with
noise, a flat image, checkerboards (ties), 37x45 and 640x480, K = 16, 384,
512 and 1024, with and without depth; `check_epipolar` the 8-point RANSAC
(`fundamental_ransac`, `csrc/epipolar.cu`, one launch) bitwise to its twin
`fundamental_ransac_steps` (each hypothesis's count included), on the card
and on CPU copies of the inputs, and against the plain cuSOLVER route on
rendered matches (K = 384 and 512) and a well-posed two-view scene, with
both pass-through guards; in loop_closure, relocalize and cli_feature_vo
every epipolar filter is also held bitwise to the twin on the CPU. The map
phases must launch detection, matching, the epipolar filter and RANSAC PnP.
Any failed check raises (exit code
!= 0). The line before the last is the kernel summary as JSON: per kernel its launches on the paths, its
error against the plain version, its and the plain version's CUDA-event
time, and its bound (the larger of the bytes it must move over 3.35 TB/s
and its float32 operations over 67 TFLOP/s, from the check's own inputs);
for the four kernels of the VGA path the same at production_vga's shapes
under "vga" (launches: those of stream_vga and batch_vga), and for
`dt_pyramid` and `extract_pyramid` at 720x960 under "cam_scale_3"
(launches: those of cli_cam_scale_3), and for the three target kernels at
1280x960 under "cam_scale_4" (launches: those of cli_cam_scale_4) and at
the large single levels under "large"; "cluster" is the route the rule
took there and "cluster_ms" the time of each forced route (for `dt_pyramid`
"ranks" the blocks a level its rule took, "ms" the device time of one call
queued behind a sleep kernel and "levels_ms" that of one `dt_channels`
call a level).
The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits with code 2 and prints no result. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

EDT_SHAPES = ((240, 320), (120, 160), (60, 80), (30, 40))  # the 4 levels
# beside the 4 levels, for the target kernels, 3 images each: odd sizes (unaligned paths,
# ragged tiles) and VGA
EXTRA_SHAPES = ((37, 45), (480, 640))
GN_KS = (512, 2048, 1000)  # LM iteration, level-0 all-point size, ragged
RESIDUAL_KS = (512, 2048, 8192)  # LM accept pass; all-point passes up to parity's level 0
SG_KS = (1024, 2048, 4096, 8192)  # the parity capacities, coarse to fine
BATCH = 64
STREAM_FRAMES = 30
MATCH_SLOTS, MATCH_K = 64, 384  # the slot store at capacity, the keypoints per frame
FEATURE_VO_K = 512  # FeatureVoConfig.max_keypoints: feature-vo's keypoints per frame
PNP_K, PNP_HYPOTHESES = 384, 64
KERNELS = ("edt", "canny", "fused_gn", "residual", "sg_terms", "match", "pnp_gn", "level_lm",
           "level_sg", "extract", "imu", "level_photo", "features", "epipolar")
TARGET_KERNELS = ("canny_pyramid", "dt_pyramid")  # every frame's targets launch both
# entries that keep their check and launch on no path
OFF_PATH = ("edt", "gn", "residual", "sg")
# the launch counters the map-backend phases must move (a verification runs in each)
MAP_KERNELS = ("detect", "match", "epipolar", "ransac")
# the secondary solvers' phases: the kernels each must launch (True) or not (False)
PHASE_KERNELS = {
    "cli_photometric": (("level_photo", True), ("level_lm", False)),
    "cli_fused": (("imu", True), ("level_lm", True), ("canny_pyramid", True),
                  ("extract", True)),
    "fused_fallback": (("detect", True), ("match", True), ("ransac", True), ("level_lm", True)),
    "cli_feature_vo": (("detect", True), ("match", True), ("epipolar", True), ("ransac", True),
                       ("level_lm", False)),
    "cli_imu": (("imu", True),),
    "cli_pnp": (("pnp", True), ("ransac", False)),
}
# the phases that solve Gauss-Newton levels: level_lm must launch there, and
# the per-iteration fused_gn_terms (which level_lm replaced) must not
GN_PHASES = ("stream", "stream_vga", "batch", "batch_vga", "cli_default",
             "cli_default_no_feeder", "cli_pipelined", "relocalize", "stream_pipelined",
             "stream_vga_ingest", "cli_loop_close", "cli_weighted_refine", "multistream",
             "cli_multistream", "align_sequence", "multigpu", "cli_checkpoint", "cli_viz",
             "cli_trace", "cli_xml", "probe", "cli_cam_scale_3", "cli_cam_scale_4")
# the map-backend phases: the matching and PnP kernels must launch there
# `feature-vo --frames 30` (320x240, --min-matches 40): the JAX package's
# good-match counts a frame and the first frame its FeatureVo puts past 0.1 m
# of the ground truth (it loses this synthetic track there);
# tests/test_torch_feature_vo.py holds both packages to them on the CPU
FEATURE_VO_COUNTS = (61, 5, 28, 43, 15, 18, 40, 13, 15, 43, 20, 33, 20, 32, 16, 13, 5, 27, 34,
                     18, 32, 26, 21, 32, 4, 1, 6, 3, 22, 26)
FEATURE_VO_LOST_FROM = 16
MAP_PHASES = ("loop_closure", "relocalize", "cli_loop_close", "cli_weighted_refine",
              "cli_checkpoint")
# the phases at production_vga's 640x480 (their launches go in the kernels' "vga" entries)
VGA_PHASES = ("stream_vga", "batch_vga")
# the phases that extract keyframe features: extract_pyramid must launch there
# the reference-parity phases: the targets, extraction and level solves on the
# kernels (the level kernels under the reference-parity semantics)
PARITY_PHASES = ("parity_batch", "parity_stream")
EXTRACT_PHASES = GN_PHASES + ("cli_subgradient",) + PARITY_PHASES
# parity_stream's bar: cli_subgradient's 25 mm, but the JAX package's own CPU
# run of the same 30 frames under the same configuration misses it (ATE
# 25.097 mm; PERF.md), so JAX's ATE + 5 mm
PARITY_STREAM_ATE_MM = 25.097 + 5.0
MULTI_STREAMS, MULTI_FRAMES = 8, 12  # the multistream phase: N streams, frames each
FR1_DISTORTION = (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)  # TUM freiburg1's RGB camera
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores, same source
# float32 operations per point, counted in the CUDA sources
OPS_GN_POINT = 150  # gn_point (project.cuh): projection 25, bilinear sample 30, weight 7,
#                     Jacobian 25, 6 products and 27 multiply-adds into the sums
OPS_RESIDUAL_POINT = 50  # projection, bilinear sample, the e2 multiply-add
OPS_SG_POINT = 60  # sg_point (project.cuh): sg_terms.cu and level_sg.cu
OPS_SG_STEP = 750  # level_sg.cu, the serial step per iteration (warp 0, counted once):
#                    se3_log 150, the normalized pull, momentum and preconditioner 60, trust
#                    region 20, se3_exp 120, compose 60, 3 Newton-Schulz steps 330
OPS_PNP_POINT = 130  # pnp_gn.cu, per masked point and iteration
OPS_PNP_SCORE = 25  # pnp_gn.cu scoring: R^T (P - t), dehomogenize, |r| < threshold
OPS_LM_STEP = 600  # level_lm.cu, the serial step per iteration (warp 0, counted once):
#                    damped 6x6 Cholesky solve, se3_exp, compose, 3 Newton-Schulz steps
OPS_CANNY_PIXEL = 34  # what one pixel of Canny needs (canny.cu): rounding and clamping 3,
#                       one Sobel 14, the squared magnitude 3, the sector test (two |.|,
#                       four products, an add, three compares) and the keep rule with both
#                       thresholds (four compares) 14; a design's recomputed halo is not counted
OPS_DT_TAIL = 12  # edt.cu: G^2 1, sqrt 1, two gradients 4, normalization 2, conversions 3
OPS_DT_COLUMN = 4  # the column distance g: a compare, a select, an add, the square
# the whole row (R = 0) as the linear-time lower envelope of parabolas
# (Felzenszwalb-Huttenlocher) computes it, amortized per pixel: at most two
# intersections (two squares, two adds, a subtract, a divide, a compare) and
# the fill (a subtract, a square, an add, a compare)
OPS_DT_ROW_ENVELOPE = 2 * 7 + 4
OPS_EXTRACT_PIXEL = 3  # extract.cu, per pixel: the depth compare, the class test, the count
OPS_EXTRACT_SLOT = 8  # per written slot: 2 subtractions, 5 products (3 reciprocals a launch)
OPS_IMU_SAMPLE = 130  # imu.cu propagate, a sample: rotation 30, specific force 12, p and v 12,
#                       the quaternion from the rotation vector 15 (sin and cos counted
#                       once each), the product 28, the normalization 13
OPS_IMU_PRE_SAMPLE = 4200  # imu.cu preintegrate, a sample: Exp, the right Jacobian and dR
#                       hat(a) ~150, A cov (81 x 9 multiply-adds) and (A cov) A^T (81 x 9),
#                       (B Q) B^T (81 x 6 x 2), the nominal update ~60; 2 operations a
#                       multiply-add
OPS_PHOTO_POINT = 60  # level_photo.cu, a point and iteration: warp 15, projection 6, tests 6,
#                       snaps 8, the floor lookup 4, eps and its square 3, 6 products and 7
#                       adds into the sums (+12 bilinear, +4 Huber, +42 reweighting)
OPS_PHOTO_STEP = 500  # the serial step a pair and iteration: the 6x6 Cholesky solve, the
#                       clamp, se3_exp and the inverse compose
OPS_HARRIS_PIXEL = 60  # features.cu, a pixel: two Sobel sums 14, the products 3, three box
#                       sums 24, det, trace and the response 7, the peak test 8, threshold and
#                       border 5
OPS_DESCRIPTOR = 320  # features.cu, a valid slot: the mean 64, the centring 64, the squares
#                       and their sum 127, the norm 2, the divisions 64
OPS_EPIPOLAR_HYPOTHESIS = 3000  # epipolar.cu, a hypothesis, the least any route needs: the
#                       normal matrix (45 entries x 8 points x 2) 720, a 9x9 symmetric
#                       eigensolve (~4/3 n^3, float64 counted twice) ~2000, F, its rank 2 ~300
OPS_SAMPSON = 30  # epipolar.cu, a valid pair and hypothesis: F x1, F^T x2, the residual,
#                   the denominator, the division and the test


def _log(msg: str) -> None:
    print(msg, flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _timed_once(fn):
    """(fn(), its device time in ms): CUDA events around one call, no
    warm-up (for plain versions that take seconds)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def _same_bits(a, b) -> bool:
    """Bitwise equality of two tensors (NaNs included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(a.dtype)
    if bits is not None:
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def _bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for work that must move `nbytes`
    (each input read once, each output written once) and do `flops` float32
    operations: the larger of the two over the H100's published peaks. No
    single PyTorch call computes any kernel's function, so `library_ms` is
    null for all of them."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def _dt_pyramid_bound(b: int, shapes, radius: int, bf16: bool) -> dict:
    """The targets' bound over the levels `shapes` of B images: the masks
    read; dt, dgx, dgy, the channels and the scales written; per pixel the
    column distance, the row's min-plus (R = 16: the 33 candidates of the
    window, a multiply-add and a min each; R = 0: the linear-time envelope,
    the least any whole-row method needs) and the tail."""
    n = b * sum(h * w for h, w in shapes)
    row = 2 * (2 * radius + 1) if radius else OPS_DT_ROW_ENVELOPE
    return _bound(n * (1 + 12 + (6 if bf16 else 12)) + 4 * b * len(shapes),
                  n * (OPS_DT_COLUMN + row + OPS_DT_TAIL))


@functools.lru_cache(maxsize=2)
def cam_scale_inputs(device, scale: int):
    """8 rendered pairs' now-frames at `dvo --cam-scale <scale>`'s level 0
    (3: 960x720, 4: 1280x960) as a 4-level pyramid on the card, its Canny
    edges at the `dvo` defaults, and the camera."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig, SolverConfig
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import canny

    cam = CameraConfig().scaled(scale)
    _, _, ng, nd, _ = render_batch(cam, 8)
    pyr = build_pyramid(torch.from_numpy(ng).to(device), torch.from_numpy(nd).to(device), 4)
    cfg = SolverConfig()
    return pyr, canny.canny_pyramid(pyr.gray, cfg.canny_low, cfg.canny_high), cam


@functools.lru_cache(maxsize=1)
def large_level_inputs(device) -> dict:
    """Single levels at the kernels' largest sides, B = 1: a rendered
    640x480 frame and its depth upsampled 4x (nearest) and cut to 1600x2560,
    and the same transposed to 2560x1600 (the edge density of a real frame),
    with their Canny edges at the `dvo` defaults; and the serpentine image
    at 2560x1600 for the hysteresis, whose chain crosses every band
    boundary many times. Values: (gray, depth, edges), (1, H, W) each."""
    import torch

    from rgbd_odometry_tpu_torch import SolverConfig, profiles
    from rgbd_odometry_tpu_torch.io.synthetic import SyntheticScene
    from rgbd_odometry_tpu_torch.kernels import canny

    cfg = SolverConfig()
    gray, depth = SyntheticScene(seed=3).render(profiles.production_vga().camera, np.eye(3),
                                                np.zeros(3), 1)
    up = lambda a: np.repeat(np.repeat(a, 4, 0), 4, 1)  # noqa: E731  (1920, 2560)
    out = {}
    for name, g, d in (("1600x2560", up(gray)[:1600], up(depth)[:1600]),
                       ("2560x1600", up(gray).T[:, :1600], up(depth).T[:, :1600])):
        g = torch.from_numpy(np.ascontiguousarray(g)[None]).to(device)
        d = torch.from_numpy(np.ascontiguousarray(d)[None]).to(device)
        out[name] = (g, d, canny.canny(g, cfg.canny_low, cfg.canny_high))
    serp = torch.from_numpy(serpentine_image(2560, 1600)[None]).to(device)
    out["serpentine 2560x1600"] = (serp, None, None)
    return out


IMU_CASES = (("propagate", 1, 400), ("propagate", 64, 100), ("preintegrate", 64, 10),
             ("preintegrate", 64, 1))
# every window length at every batch: one chunk or less (1, 37), the `imu`
# command's 400, and 4000 (62 or 125 chunks and a short one)
IMU_LENGTHS, IMU_BATCHES = (1, 37, 400, 4000), (1, 29, 64)


def _imu_inputs(rng, mode, b: int, n: int, device):
    import torch

    from rgbd_odometry_tpu_torch.kernels import imu as kimu

    f32 = dict(dtype=torch.float32, device=device)
    a = torch.as_tensor(rng.normal(0.0, 2.0, (b, n, 3)), **f32).contiguous()
    w = torch.as_tensor(rng.normal(0.0, 0.8, (b, n, 3)), **f32).contiguous()
    s0 = None
    if mode == kimu.PROPAGATE:
        q = rng.normal(size=(b, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        s0 = torch.as_tensor(np.concatenate([rng.normal(0, 0.5, (b, 3)),
                                             rng.normal(0, 0.3, (b, 3)), q], 1), **f32).contiguous()
    return a, w, s0


def _imu_case(what, mode, ker, pl) -> dict:
    """Hold one `imu_scan` result against its plain version's: states, dR,
    dv and dp bitwise, the covariance within 1e-5 of its largest entry (its
    sums run in another order than torch.matmul's)."""
    from rgbd_odometry_tpu_torch.kernels import imu as kimu

    if mode == kimu.PROPAGATE:
        ker, pl = (ker,), (pl,)
    nominal = list(zip(ker, pl))[:3] if mode == kimu.PREINTEGRATE else list(zip(ker, pl))
    err = max(float((x - y).abs().max()) / max(1.0, float(y.abs().max())) for x, y in nominal)
    bitwise = all(_same_bits(x, y.contiguous()) for x, y in nominal)
    _require(bitwise, f"{what}: states, dR, dv or dp not bitwise the plain version's "
             f"(relative error {err:.2e})")
    cov_err = 0.0
    if mode == kimu.PREINTEGRATE:
        cov_err = _rel(ker[3], pl[3])
        _require(cov_err <= 1e-5, f"{what}: covariance error {cov_err:.2e} > 1e-5")
    return {"max_abs_err": err, "cov_rel_err": cov_err, "bitwise": bitwise}


def check_imu(device, rng) -> dict:
    """`imu_scan` against its plain version `imu_plain` on the card:
    propagate at B = 1, T = 400 (the `imu` command's window) and B = 64, T
    = 100 from random states; preintegrate at B = 64, T = 10 and T = 1
    (`fused --imu-refine` preintegrates one-sample windows), with noise and
    biases; then both modes at T = 1, 37, 400 and 4000 (the kernel's chunks
    hold 64 and 32 samples) at B = 1, 29 and 64, the plain version run once
    a (mode, T) over the 94 windows and each batch held to its slice.
    States, dR, dv and dp bitwise (the kernel performs the plain version's
    operations), the covariance within 1e-5 of its largest entry (its sums
    run in another order than torch.matmul's); runs bitwise. Timed beside
    the bound: the bytes in and out over 3.35 TB/s, or the float32
    operations."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import imu as kimu

    f32 = dict(dtype=torch.float32, device=device)
    params = torch.tensor([0.03, 0.03, 0.03, -0.01, -0.01, -0.01, 0.08 ** 2, 0.02 ** 2, 0.0,
                           9.7874, 0.0], **f32)

    def bound(mode, b, n):
        nbytes = b * n * 24 + 44 + (b * 40 + b * n * 40 if mode == kimu.PROPAGATE else b * 96 * 4)
        return _bound(nbytes, b * n * (OPS_IMU_SAMPLE if mode == kimu.PROPAGATE
                                       else OPS_IMU_PRE_SAMPLE))

    cases, errs = [], []
    for mode_name, b, n in IMU_CASES:
        mode = kimu.PROPAGATE if mode_name == "propagate" else kimu.PREINTEGRATE
        a, w, s0 = _imu_inputs(rng, mode, b, n, device)
        args = (mode, a, w, params, 0.01, s0)
        ker, again = kimu.imu_scan(*args), kimu.imu_scan(*args)
        pl, p_ms = _timed_once(lambda: kimu.imu_plain(*args))
        what = f"imu_scan {mode_name} B={b} T={n}"
        pairs = zip(ker, again) if mode == kimu.PREINTEGRATE else ((ker, again),)
        _require(all(_same_bits(x, y) for x, y in pairs), f"{what}: runs differ")
        res = _imu_case(what, mode, ker, pl)
        k_ms = _time_ms(lambda: kimu.imu_scan(*args), 20)
        bd = bound(mode, b, n)
        _log(f"{what}: nominal bitwise, covariance {res['cov_rel_err']:.2e}; kernel {k_ms:.4f} "
             f"ms, plain {p_ms:.2f} ms, bound {bd['bound_ms'] * 1000:.3f} us ({bd['bound_by']})")
        errs.append(max(res["max_abs_err"], res["cov_rel_err"]))
        cases.append({"mode": mode_name, "batch": b, "samples": n, **res, "ms": k_ms,
                      "plain_ms": p_ms, **bd})
    for mode_name in ("propagate", "preintegrate"):
        mode = kimu.PROPAGATE if mode_name == "propagate" else kimu.PREINTEGRATE
        for n in IMU_LENGTHS:
            a, w, s0 = _imu_inputs(rng, mode, sum(IMU_BATCHES), n, device)
            pl, p_ms = _timed_once(lambda: kimu.imu_plain(mode, a, w, params, 0.01, s0))
            pl = pl if isinstance(pl, tuple) else (pl,)
            at = 0
            for b in IMU_BATCHES:
                sl = slice(at, at + b)
                at += b
                args = (mode, a[sl].contiguous(), w[sl].contiguous(), params, 0.01,
                        None if s0 is None else s0[sl].contiguous())
                ker = kimu.imu_scan(*args)
                want = tuple(x[sl] for x in pl)
                what = f"imu_scan {mode_name} B={b} T={n}"
                res = _imu_case(what, mode, ker, want if len(want) > 1 else want[0])
                k_ms = _time_ms(lambda: kimu.imu_scan(*args), 5)
                bd = bound(mode, b, n)
                _log(f"{what}: nominal bitwise, covariance {res['cov_rel_err']:.2e}; kernel "
                     f"{k_ms:.4f} ms, bound {bd['bound_ms'] * 1000:.3f} us ({bd['bound_by']}); "
                     f"plain {p_ms:.2f} ms for the {sum(IMU_BATCHES)} windows")
                errs.append(max(res["max_abs_err"], res["cov_rel_err"]))
                cases.append({"mode": mode_name, "batch": b, "samples": n, **res, "ms": k_ms,
                              "plain_ms": p_ms, **bd})
    main = cases[0]
    return {"max_abs_err": max(errs), "ms": main["ms"], "plain_ms": main["plain_ms"],
            **{k: main[k] for k in ("bound_ms", "bound_by", "library_ms")}, "cases": cases}


@functools.lru_cache(maxsize=3)
def photo_pairs(width: int, device, pairs: int = 2):
    """`pairs` rendered frame pairs at width x 3/4 width (distinct scenes and
    twists): the reference frames' 4-level pyramids and references
    (`extract_photo_ref`, on the card) and the now frames' pyramids."""
    import torch

    from rgbd_odometry_tpu_torch.config import CameraConfig, PhotometricConfig
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.io.synthetic import render_pair
    from rgbd_odometry_tpu_torch.solvers import photometric

    cam = CameraConfig().scaled(width / 320.0)
    rs = [render_pair(cam, np.array([0.01, -0.006, 0.004, 0.003, -0.004, 0.002], np.float32)
                      * (1.0 + 0.2 * i), seed=i) for i in range(pairs)]
    t = lambda k, c: torch.as_tensor(np.stack([r[k][c] for r in rs])).to(device)  # noqa: E731
    ref = build_pyramid(t(0, 0), t(0, 1), 4)
    now = build_pyramid(t(1, 0), t(1, 1), 4)
    intr = Intrinsics.from_config(cam)
    cfg = PhotometricConfig()
    refs = photometric.extract_photo_ref(ref.gray, ref.depth, intr, cfg, cfg.max_points)
    return intr, refs, now.gray


def _photo_levels(width: int, batch: int, device, pairs: int = 2):
    """The `level_photo` levels (3, 2) of `batch` pairs (`pairs` rendered
    pairs tiled) at width x 3/4 width."""
    import torch

    from rgbd_odometry_tpu_torch.kernels.level_photo import PhotoLevel

    intr, refs, now = photo_pairs(width, device, pairs)
    idx = torch.arange(batch, device=now[0].device) % now[0].shape[0]
    out = []
    for lvl in (3, 2):
        r, li = refs[lvl], intr.at_level(lvl)
        out.append(PhotoLevel(r.pts3d[idx].contiguous(), r.intensity[idx].contiguous(),
                              r.J[idx].contiguous(), r.A[idx].contiguous(),
                              r.valid[idx].contiguous(), now[lvl][idx].contiguous(), li.fx,
                              li.fy, li.cx, li.cy))
    return out


def _photo_bound(levels, batch: int, iters: int, cfg) -> dict:
    """The photometric pyramid's least time: every input read once (points
    3, intensity, J 6, validity, A), of the now image only the pixels the
    valid points sample (iters x 1 read a point, 4 bilinear, at most the
    image: `_sampled_bytes`), and the pose and history written; iters x K
    point updates a level of OPS_PHOTO_POINT float32 operations (with
    bilinear sampling and reweighting more)."""
    ops_point = (OPS_PHOTO_POINT + (12 if cfg.bilinear else 0) + (4 if cfg.use_huber else 0)
                 + (42 if cfg.reweight_normal_matrix else 0))
    reads = iters * (4 if cfg.bilinear else 1)
    nbytes = sum(batch * (lv.pts.shape[1] * 41 + 144)
                 + _sampled_bytes(lv.valid.sum(-1), lv.img.shape[1] * lv.img.shape[2], reads, 4)
                 for lv in levels) + batch * (48 + 48 + len(levels) * iters * 4)
    ops = sum(batch * iters * (lv.pts.shape[1] * ops_point + OPS_PHOTO_STEP) for lv in levels)
    return _bound(nbytes, ops)


PHOTO_CLUSTER_WIDTHS = (320, 640, 1280)  # `photometric --cam-scale` 1, 2, 4: levels 3 and 2


def check_level_photo(device, rng) -> dict:
    """`level_photo` (levels 3 and 2, 3 iterations each, the reference's
    schedule) against `level_photo_plain` on the card: at 320x240 and
    640x480 (K = 1024 and 2048), B = 1 and 64 (rendered pairs tiled, each
    pair from its own random start pose), floor and bilinear sampling, Huber
    on and off, the normal matrix cached and reweighted, on the rule's
    route; then at B = 1 forced to every cluster size (1, 2, 4, 8 blocks a
    pair) at 320x240, 640x480 and 1280x960, every option set again. Poses and |eps| histories bitwise (the kernel performs the
    plain version's operations in its order, on the same ranks); runs
    bitwise. Each rule-route configuration timed beside its bound and its
    plain version's one call; the entry's numbers are the `photometric`
    phase's configuration (640x480, B = 1, floor, Huber, cached normal
    matrix)."""
    import torch

    from rgbd_odometry_tpu_torch.config import PhotometricConfig
    from rgbd_odometry_tpu_torch.core.geometry import se3_exp
    from rgbd_odometry_tpu_torch.kernels import level_photo as klp

    options = [PhotometricConfig(bilinear=bilinear, use_huber=huber,
                                 reweight_normal_matrix=reweight)
               for bilinear in (False, True) for huber in (False, True)
               for reweight in (False, True)]

    def compare(what, args, cluster=None):
        kw = {} if cluster is None else {"cluster": cluster}
        ker, again = klp.level_photo(*args, **kw), klp.level_photo(*args, **kw)
        pl, p_ms = _timed_once(lambda: klp.level_photo_plain(*args, cluster))
        _require(all(_same_bits(x, y) for x, y in zip(ker, again)), f"{what}: runs differ")
        err = max(float((ker[0] - pl[0]).abs().max()), float((ker[1] - pl[1]).abs().max()))
        herr = _rel(ker[2], pl[2])
        bitwise = all(_same_bits(x, y) for x, y in zip(ker, pl))
        _require(bitwise, f"{what}: not bitwise the plain version (pose error {err:.2e}, "
                 f"history {herr:.2e})")
        return err, herr, p_ms

    cases, errs = [], []
    for width in (320, 640):
        for batch in (1, 64):
            levels = _photo_levels(width, batch, device)
            psi = torch.as_tensor(rng.normal(0, 0.004, (batch, 6)), dtype=torch.float32,
                                  device=device)
            R0, t0 = (x.contiguous() for x in se3_exp(psi))
            ranks = [klp.level_ranks(lv.pts.shape[1]) for lv in levels]
            for cfg in options:
                args = (R0, t0, levels, cfg)
                what = (f"level_photo {width}x{width * 3 // 4} B={batch} "
                        f"{'bilinear' if cfg.bilinear else 'floor'} huber={cfg.use_huber} "
                        f"reweight={cfg.reweight_normal_matrix} ranks={ranks}")
                err, herr, p_ms = compare(what, args)
                k_ms = _time_ms(lambda: klp.level_photo(*args), 20)
                bound = _photo_bound(levels, batch, cfg.iterations_per_level, cfg)
                _log(f"{what}: bitwise; kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, bound "
                     f"{bound['bound_ms'] * 1000:.3f} us ({bound['bound_by']})")
                errs.append(err)
                cases.append({"size": f"{width}x{width * 3 // 4}", "batch": batch,
                              "bilinear": cfg.bilinear, "huber": cfg.use_huber,
                              "reweight": cfg.reweight_normal_matrix, "ranks": ranks,
                              "max_abs_err": err, "history_rel_err": herr, "bitwise": True,
                              "ms": k_ms, "plain_ms": p_ms, **bound})
    forced = []
    for width in PHOTO_CLUSTER_WIDTHS:
        levels = _photo_levels(width, 1, device, pairs=1 if width > 640 else 2)
        psi = torch.as_tensor(rng.normal(0, 0.004, (1, 6)), dtype=torch.float32, device=device)
        R0, t0 = (x.contiguous() for x in se3_exp(psi))
        for cluster in klp.CLUSTERS:
            for cfg in options:
                what = (f"level_photo {width}x{width * 3 // 4} B=1 cluster={cluster} "
                        f"{'bilinear' if cfg.bilinear else 'floor'} huber={cfg.use_huber} "
                        f"reweight={cfg.reweight_normal_matrix}")
                err, herr, _ = compare(what, (R0, t0, levels, cfg), cluster)
                errs.append(err)
            forced.append(f"{width}x{width * 3 // 4} c={cluster}")
    _log(f"level_photo B=1 at every forced cluster size, 8 option sets each, bitwise: "
         f"{', '.join(forced)}")
    main = next(c for c in cases if c["size"] == "640x480" and c["batch"] == 1 and c["huber"]
                and not c["bilinear"] and not c["reweight"])
    return {"max_abs_err": max(errs), "ms": main["ms"], "plain_ms": main["plain_ms"],
            **{k: main[k] for k in ("bound_ms", "bound_by", "library_ms")}, "cases": cases,
            "forced_clusters": forced}


def _sampled_bytes(n_vis, hw: int, reads: int, size: int) -> float:
    """Bytes of an image that `n_vis` (B,) visible points must read: `reads`
    samples of `size` bytes each, at most the whole H*W image per pair."""
    return float(sum(min(hw, reads * int(n)) * size for n in n_vis.tolist()))


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
    """Kernel 1 vs its plain version, bitwise, at the 4 level shapes (B =
    64) and at 37x45 and 480x640 (B = 3)."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import edt

    worst, out = 0.0, {}
    for h, w in EDT_SHAPES + EXTRA_SHAPES:
        b = 3 if (h, w) in EXTRA_SHAPES else BATCH
        mask = torch.from_numpy(edge_masks(rng, b, h, w)).to(device)
        for radius in (16, 0):
            k = edt.edt_squared(mask, radius)
            p = edt.edt_squared_plain(mask, radius)
            torch.cuda.synchronize()
            _require(k.shape == (b, h, w) and k.dtype == torch.float32, "edt shape/dtype")
            err = float((k - p).abs().max())
            _require(torch.equal(k, p), f"edt kernel != plain at {h}x{w} R={radius} (max {err})")
            k_ms = _time_ms(lambda: edt.edt_squared(mask, radius), 20)
            p_ms = _time_ms(lambda: edt.edt_squared_plain(mask, radius), 3 if radius == 0 else 10)
            _log(f"edt {h}x{w} B={b} R={radius}: bitwise equal; kernel {k_ms:.4f} ms, "
                 f"plain {p_ms:.4f} ms")
            out[(h, w, radius)] = (k_ms, p_ms)
            worst = max(worst, err)
    k_ms, p_ms = out[(240, 320, 16)]
    n = BATCH * 240 * 320  # the mask read, D^2 written; 4 ops per pixel in the column
    # phase, an add and a min per candidate of the row phase's 2R + 1
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms,
            **_bound(n * (1 + 4), n * (4 + 2 * (2 * 16 + 1)))}


def serpentine_image(h: int, w: int):
    """A band 3 pixels wide, 30 grey levels over the background (a step of
    30 gives a Sobel magnitude of 120: weak, not strong), that winds through
    the whole image; its first 3 pixels stand 70 over (strong). The
    hysteresis must walk the band's outline: thousands of one-pixel steps."""
    img = np.full((h, w), 40.0, np.float32)
    rows = list(range(3, h - 6, 8))
    for k, y in enumerate(rows):
        img[y:y + 3, 3:w - 3] = 70.0
        if k + 1 < len(rows):
            x = w - 6 if k % 2 == 0 else 3
            img[y:y + 11, x:x + 3] = 70.0
    img[rows[0]:rows[0] + 3, 3:6] = 110.0
    return img


def check_canny_pyramid(device, rng) -> dict:
    """`canny_pyramid` vs its plain version (`canny_plain` on each level),
    `torch.equal` on every level, a second launch equal, on the hysteresis
    route its rule takes: the 4-level 320x240 pyramid of 64 rendered frames,
    of the serpentine image (each level's own, with its flips) and of 8-bit
    noise, at B = 64 and B = 1; a 5-level 640x480 noise pyramid of 3 images
    (the hysteresis kernel's shared-memory opt-in) and a 4-level one from
    74x90 (widths no multiple of 4 or 32: the unaligned loads and stores),
    B = 3 and 1; production_vga's 5-level pyramid of 64 rendered 640x480
    frames, B = 64 and 1; the 4-level pyramid of 8 rendered 1280x960 frames
    (`dvo --cam-scale 4`: level 0 on a cluster), B = 8 and 1; one level of
    1600x2560 and one of 2560x1600 (a rendered 640x480 frame upsampled) and
    the serpentine image at 2560x1600, B = 1. On the rendered pyramids every
    cluster size the levels fit is forced too (c = 1, 2, 4, 8 blocks a
    (level, image): bitwise the rule's route), timed. Then `canny` of one
    level on the card: one pyramid launch, equal to the plain version. Logs
    the route (blocks a level, c) and the fixpoints' pass counts per level;
    on the rendered pyramids, times the call beside one single-level `canny`
    call a level (the same inputs, this run)."""
    import torch

    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import canny

    def flips(h, w):
        s = serpentine_image(h, w)
        return torch.from_numpy(np.stack([s, s[::-1], s[:, ::-1], s[::-1, ::-1]] * (BATCH // 4))).to(
            device)

    noise = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, 256, shape).astype(np.float32)).to(device)
    _, _, ng, nd, _ = render_batch(profiles.production_320().camera, BATCH)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    vga, odd = noise(3, 480, 640), noise(3, 74, 90)
    vga_prof = profiles.production_vga()
    _, _, vg, vd, _ = render_batch(vga_prof.camera, BATCH)
    large = large_level_inputs(device)
    cases = {
        "rendered": build_pyramid(f(ng), f(nd), 4).gray,
        "rendered vga": build_pyramid(f(vg), f(vd), vga_prof.num_levels).gray,
        "rendered 1280x960": cam_scale_inputs(device, 4)[0].gray,
        "serpentine": tuple(flips(h, w) for h, w in EDT_SHAPES),
        "noise": tuple(noise(BATCH, h, w) for h, w in EDT_SHAPES),
        "vga noise": build_pyramid(vga, torch.full_like(vga, 1000.0), 5).gray,
        "odd noise": build_pyramid(odd, torch.full_like(odd, 1000.0), 4).gray,
        **{name: (g,) for name, (g, _, _) in large.items()},
    }
    timed = ("rendered", "rendered vga", "rendered 1280x960", "1600x2560", "2560x1600")
    _require(tuple(cases["rendered"][0].shape) == (BATCH, *EDT_SHAPES[0]), "canny: pyramid shape")
    summaries = {}
    for kind, pyr in cases.items():
        for b in sorted({pyr[0].shape[0], 1}, reverse=True):
            levels = tuple(g[:b].contiguous() for g in pyr)
            shapes = [tuple(g.shape[1:]) for g in levels]
            ranks, c_rule = canny.hysteresis_route(shapes, b)
            plain = canny.canny_pyramid_plain(levels, 100.0, 150.0)
            what = (f"canny_pyramid {kind} {len(levels)} levels from "
                    f"{levels[0].shape[1]}x{levels[0].shape[2]} B={b}")
            passes = torch.zeros((len(levels), b), dtype=torch.int32, device=device)
            k = canny.canny_pyramid(levels, 100.0, 150.0, passes=passes)
            again = canny.canny_pyramid(levels, 100.0, 150.0)
            torch.cuda.synchronize()
            for lvl, (a, a2, q) in enumerate(zip(k, again, plain)):
                at = f"{what} level {lvl}"
                _require(a.shape == q.shape and a.dtype == torch.bool and a.is_contiguous(),
                         f"{at}: shape/dtype/layout")
                _require(torch.equal(a, a2), f"{at}: runs differ")
                diff = int((a != q).sum())
                _require(diff == 0, f"{at}: kernel != plain at {diff} pixels")
            _require(bool((passes >= 1).all()), f"{what}: a fixpoint ran no pass")
            _require(bool(k[0].flatten(1).any(1).all()), f"{what}: an image has no edge")
            line = (f"{what}: equal to plain, runs equal, {float(k[0].float().mean()) * 100:.2f}% "
                    f"edges at level 0; rule: blocks a level {list(ranks)} (c={c_rule}); passes "
                    f"per level (most of any image) {passes.max(1).values.tolist()}")
            routes = {}
            if kind in timed:
                for c in canny.CLUSTERS:
                    if any(canny.hysteresis_smem(h, w, c) > 227 * 1024 for h, w in shapes):
                        continue
                    pc = torch.zeros_like(passes)
                    forced = canny.canny_pyramid(levels, 100.0, 150.0, passes=pc, cluster=c)
                    torch.cuda.synchronize()
                    for lvl, (a, q) in enumerate(zip(forced, k)):
                        _require(torch.equal(a, q), f"{what} level {lvl}: cluster {c} != rule's")
                    routes[c] = _time_ms(lambda c=c: canny.canny_pyramid(levels, cluster=c), 20)
                    line += f"; c={c}: equal, passes {pc.max(1).values.tolist()}"
                line += " (ms: " + ", ".join(f"c={c} {t:.4f}" for c, t in routes.items()) + ")"
                k_ms = _time_ms(lambda: canny.canny_pyramid(levels), 20)
                before = _time_ms(lambda: [canny.canny(g) for g in levels], 20)
                p_ms = _time_ms(lambda: canny.canny_pyramid_plain(levels), 3)
                n = sum(g.numel() for g in levels)  # every level's image read, edge map written
                bound = _bound(n * (4 + 1), n * OPS_CANNY_PIXEL)
                line += (f"; canny_pyramid {k_ms:.4f} ms, {len(levels)} single-level canny calls "
                         f"{before:.4f} ms, plain {p_ms:.4f} ms; bound "
                         f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']})")
                summaries[(kind, b)] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
                                        "cluster": c_rule, "cluster_ms": routes, **bound}
            _log(line)
    one = cases["odd noise"][1]
    n0 = canny.canny_pyramid.launches
    k = canny.canny(one, 100.0, 150.0)
    torch.cuda.synchronize()
    _require(canny.canny_pyramid.launches == n0 + 1, "canny of one level: not one pyramid launch")
    _require(torch.equal(k, canny.canny_plain(one, 100.0, 150.0)), "canny of one level != plain")
    _log(f"canny {one.shape[1]}x{one.shape[2]} B={one.shape[0]}: one canny_pyramid launch, "
         f"equal to plain")
    return {**summaries[("rendered", BATCH)], "b1": summaries[("rendered", 1)],
            "vga": {"shape": "5 levels from 480x640, B=64", **summaries[("rendered vga", BATCH)],
                    "b1": summaries[("rendered vga", 1)]},
            "cam_scale_4": {"shape": "4 levels from 960x1280, B=8",
                            **summaries[("rendered 1280x960", 8)],
                            "b1": summaries[("rendered 1280x960", 1)]},
            "large": {"shape": "one level of 1600x2560 and of 2560x1600, B=1",
                      "1600x2560": summaries[("1600x2560", 1)],
                      "2560x1600": summaries[("2560x1600", 1)]}}


def _queued_ms(fn, reps: int) -> float:
    """Device ms per call of fn(): CUDA events around `reps` calls queued
    behind a ~10 ms sleep kernel, so that the host has enqueued them all
    before the device reaches the first and they run back to back (the
    host's dispatch is not in the number)."""
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
    return start.elapsed_time(end) / reps


DT_VARIANTS = tuple((r, n, bf) for r in (16, 0) for n in (False, True) for bf in (True, False))
# the `dvo` defaults (the whole row, normalized, bf16) and production's (+-16, pixels, bf16)
DT_MAIN = ((0, True, True), (16, False, True))


def check_dt_pyramid(device, rng) -> dict:
    """`dt_pyramid` vs its plain twin (`dt_channels_plain` a level): every
    output of every level bitwise equal, a second launch bitwise equal, on
    the rule's route and forced to each cluster size (1, 2, 4, 8 blocks a
    (level, image)) and to the per-level route (the largest levels'), for
    R = 16 / 0, normalization on / off, bf16 / float32
    channels: the 4 level shapes as one pyramid and each level alone, B =
    64 (an empty and a full mask among them) and B = 1; 37x45 (odd sizes:
    no vector loads, ragged tiles) and 480x640, B = 3, as a pyramid and
    alone; for the `dvo` defaults and production's flags the Canny edges of
    rendered frames: production_vga's 5 levels from 640x480, B = 64 and 1,
    `dvo --cam-scale 3`'s and `4`'s 4 levels from 720x960 and 960x1280, B =
    8 and 1 (each pyramid whole and its level 0 alone); one level of
    1600x2560 and one of 2560x1600, B = 1. A pyramid's call is timed (device
    ms, queued) beside one call a level and the plain twin, with its bound
    summed over the levels. Then `dt_channels` on the card: one pyramid
    launch, equal to the plain version."""
    import torch

    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import build, canny, edt

    names = ("dt", "dgx", "dgy", "scale", "chans")
    vga = profiles.production_vga()
    # (label, levels, variants, the levels also checked alone, whether the plain twin is timed)
    cases = []
    masks = tuple(torch.from_numpy(edge_masks(rng, BATCH, h, w)).to(device) for h, w in EDT_SHAPES)
    one = tuple(m[2:3].contiguous() for m in masks)
    for levels in (masks, one):
        cases.append(("4 levels from 240x320", levels, DT_VARIANTS, 4, True))
    extra = tuple(torch.from_numpy(edge_masks(rng, 3, h, w)).to(device)
                  for h, w in reversed(EXTRA_SHAPES))
    cases.append(("480x640 and 37x45", extra, DT_VARIANTS, 2, False))
    _, _, ng, nd, _ = render_batch(vga.camera, BATCH)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    vga_pyr = build_pyramid(f(ng), f(nd), vga.num_levels).gray
    vga_edges = canny.canny_pyramid(vga_pyr, vga.solver.canny_low, vga.solver.canny_high)
    rendered = {"production_vga rendered, 5 levels from 480x640": (vga_edges, (BATCH, 1)),
                "cam_scale_3 rendered, 4 levels from 720x960": (cam_scale_inputs(device, 3)[1],
                                                                 (8, 1)),
                "cam_scale_4 rendered, 4 levels from 960x1280": (cam_scale_inputs(device, 4)[1],
                                                                  (8, 1))}
    for label, (edges, batches) in rendered.items():
        for b in batches:
            levels = tuple(e[:b].contiguous() for e in edges)
            cases.append((label, levels, DT_MAIN, 1, True))
    large = large_level_inputs(device)
    cases += [(f"upsampled rendered edges {name}", (large[name][2],), DT_MAIN, 0, True)
              for name in ("1600x2560", "2560x1600")]
    out = {}
    for label, levels, variants, alone, timed in cases:
        b = levels[0].shape[0]
        shapes = [tuple(e.shape[1:]) for e in levels]
        ranks, c_rule = edt.dt_route(shapes, b, sms=build.sm_count(device.index or 0))
        for variant in variants:
            radius, normalize, bf16 = variant
            what = (f"dt_pyramid {label} B={b} R={radius} "
                    f"{'normalized' if normalize else 'pixels'} {'bf16' if bf16 else 'f32'}")
            plain = edt.dt_pyramid_plain(levels, *variant)
            k = edt.dt_pyramid(levels, *variant)
            again = edt.dt_pyramid(levels, *variant)
            forced = {c: edt.dt_pyramid(levels, *variant, cluster=c)
                      for c in (0,) + edt.CLUSTERS}
            torch.cuda.synchronize()
            for lvl, (got, got2, want) in enumerate(zip(k, again, plain)):
                for name, a, a2, d in zip(names, got, got2, want):
                    at = f"{what} level {lvl} {name}"
                    _require(a.shape == d.shape and a.dtype == d.dtype and a.is_contiguous(),
                             f"{at}: shape/dtype/layout")
                    _require(_same_bits(a, a2), f"{at}: runs differ")
                    _require(_same_bits(a, d), f"{at}: kernel != plain")
                for c, route in forced.items():
                    for name, a, d in zip(names, route[lvl], want):
                        _require(_same_bits(a, d), f"{what} level {lvl} {name}: cluster {c} "
                                 f"!= plain")
                if lvl < alone:  # the level alone: a pyramid of one, on its rule and forced
                    for c in (None, 0) + edt.CLUSTERS:
                        single = edt.dt_pyramid(levels[lvl:lvl + 1], *variant, cluster=c)[0]
                        for name, a, d in zip(names, single, want):
                            _require(_same_bits(a, d), f"{what} level {lvl} alone {name}: "
                                     f"cluster {c or 'rule'} != plain")
            line = (f"{what}: {len(levels)} level(s) x 5 outputs bitwise plain, runs bitwise, "
                    f"every forced route (per level, c=1, 2, 4, 8) bitwise, the first {alone} "
                    f"level(s) alone too; rule: blocks a level {list(ranks)} (0: the per-level "
                    f"route; c={c_rule})")
            if timed:
                k_ms = _queued_ms(lambda: edt.dt_pyramid(levels, *variant), 20)
                lvl_ms = _queued_ms(lambda: [edt.dt_channels(e, *variant) for e in levels], 20)
                p_ms = (_time_ms(lambda: edt.dt_pyramid_plain(levels, *variant), 2)
                        if timed and variant in DT_MAIN + ((16, False, False),) else float("nan"))
                bound = _dt_pyramid_bound(b, shapes, radius, bf16)
                line += (f"; dt_pyramid {k_ms * 1e3:.2f} us (device, queued), one dt_channels "
                         f"call a level {lvl_ms * 1e3:.2f} us, plain {p_ms:.4f} ms; bound "
                         f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']})")
                out[(label, b, *variant)] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
                                             "levels_ms": lvl_ms, "ranks": list(ranks),
                                             **bound}
            _log(line)
    one_level = masks[1]
    n0 = edt.dt_pyramid.launches
    k = edt.dt_channels(one_level, 16, False, True)
    torch.cuda.synchronize()
    _require(edt.dt_pyramid.launches == n0 + 1, "dt_channels: not one dt_pyramid launch")
    for name, a, d in zip(names, k, edt.dt_channels_plain(one_level, 16, False, True)):
        _require(_same_bits(a, d), f"dt_channels {name} != plain")
    _log(f"dt_channels {one_level.shape[1]}x{one_level.shape[2]} B={one_level.shape[0]}: one "
         f"dt_pyramid launch, bitwise plain")
    p320 = "4 levels from 240x320"
    vga_label = "production_vga rendered, 5 levels from 480x640"
    cam = {s: (f"cam_scale_{s} rendered, 4 levels from {w}", w)
           for s, w in ((3, "720x960"), (4, "960x1280"))}
    return {"shape": "4 levels from 240x320 R=16 pixels bf16 (production_320), B=64",
            **out[(p320, BATCH, *DT_MAIN[1])], "b1": out[(p320, 1, *DT_MAIN[1])],
            "dvo": {"shape": "R=0 normalized bf16 (the dvo defaults)",
                    **out[(p320, BATCH, *DT_MAIN[0])], "b1": out[(p320, 1, *DT_MAIN[0])]},
            "vga": {"shape": "5 levels from 480x640 R=16 pixels bf16, B=64",
                    **out[(vga_label, BATCH, *DT_MAIN[1])], "b1": out[(vga_label, 1, *DT_MAIN[1])]},
            **{f"cam_scale_{s}": {"shape": f"4 levels from {w} R=0 normalized bf16, B=8",
                                  **out[(label, 8, *DT_MAIN[0])],
                                  "b1": out[(label, 1, *DT_MAIN[0])],
                                  "r16": out[(label, 8, *DT_MAIN[1])]}
               for s, (label, w) in cam.items()},
            "large": {"shape": "one level, R=0 normalized bf16, B=1",
                      **{name: out[(f"upsampled rendered edges {name}", 1, *DT_MAIN[0])]
                         for name in ("1600x2560", "2560x1600")}}}


def _extract_equal(what: str, got, want) -> None:
    """Every output of two `extract_pyramid` results bitwise equal, level by
    level, with the first differing entries in the message."""
    for lvl, (a, q) in enumerate(zip(got, want)):
        for name, x, z in zip(("pts3d", "uv", "valid", "count"), a, q):
            at = f"{what} level {lvl} {name}"
            _require(x.shape == z.shape and x.dtype == z.dtype and x.is_contiguous(),
                     f"{at}: shape/dtype/layout {tuple(x.shape)} {x.dtype}")
            if not _same_bits(x, z):
                bad = (x != z).reshape(-1).nonzero()[:4].reshape(-1).tolist()
                raise AssertionError(
                    f"{at}: != reference at {int((x != z).sum())} entries, first "
                    f"{bad}: {x.reshape(-1)[bad].tolist()} vs {z.reshape(-1)[bad].tolist()}")


def check_extract(device, rng) -> dict:
    """`extract_pyramid` vs its plain version (`extract_ref_level` on each
    level), every output bitwise equal, invalid slots included, and a
    second launch bitwise equal, on the route its rule takes:
    production_320's capacities (segmented levels) and the `dvo` defaults'
    (exact) on the 4-level 320x240 pyramid, and production_vga's (5 levels,
    4096 at level 0, segmented and exact) on a 640x480 pyramid (the
    rendered frames doubled) and on 640x480 renders, at B = 64 and 1; the
    `dvo` defaults' on the 4-level pyramids of 960x720 and 1280x960 renders
    (`dvo --cam-scale 3` and `4`), at B = 8 and 1; and 8192 slots, both
    branches, on one level of 1600x2560 and one of 2560x1600 (a rendered
    640x480 frame upsampled), B = 1; on rendered frames (their own Canny
    edges and depth), edge-free and all-edge maps, and rendered edges over a
    depth half below `min_depth_mm`. On the rendered frames every cluster
    size the level fits is forced too (c = 1, 2, 4, 8: bitwise the rule's
    route) and timed. Times the kernel and its plain version on the
    rendered 320x240 pyramid at both 4-level configurations, on the rendered
    640x480 pyramid at production_vga's, on the 960x720 and 1280x960 ones
    and on the large levels."""
    import torch

    from rgbd_odometry_tpu_torch import SolverConfig, profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import canny, extract

    p320, vga = profiles.production_320(), profiles.production_vga()
    _, _, ng, nd, _ = render_batch(p320.camera, BATCH)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    gray, depth = f(ng), f(nd)
    _, _, vg, vd, _ = render_batch(vga.camera, BATCH)
    up = lambda x: x.repeat_interleave(2, 1).repeat_interleave(2, 2)  # noqa: E731
    dvo_caps = (8192, 4096, 2048, 1024)
    batches = (BATCH, 1)
    large = large_level_inputs(device)
    big_cam = vga.camera.scaled(4)
    configs = {  # config, capacities, batch sizes, level 0's gray and depth (or the
        #          pyramid and its edges), camera
        "production_320": (p320.solver, p320.max_points, batches, 4, gray, depth, p320.camera),
        "dvo defaults": (SolverConfig(), dvo_caps, batches, 4, gray, depth, p320.camera),
        "production_vga": (vga.solver, vga.max_points, batches, 5, up(gray), up(depth),
                           vga.camera),
        "production_vga exact": (dataclasses.replace(vga.solver, extract_selection="exact"),
                                 vga.max_points, batches, 5, up(gray), up(depth), vga.camera),
        "production_vga rendered": (vga.solver, vga.max_points, batches, 5, f(vg), f(vd),
                                    vga.camera),
        "cam_scale_3": (SolverConfig(), dvo_caps, (8, 1), 4, *cam_scale_inputs(device, 3)),
        "cam_scale_4": (SolverConfig(), dvo_caps, (8, 1), 4, *cam_scale_inputs(device, 4)),
    }
    for name in ("1600x2560", "2560x1600"):
        g, d, e = large[name]
        pyr = types.SimpleNamespace(gray=(g,), depth=(d,))
        configs[f"{name} segmented"] = (p320.solver, (8192,), (1,), 1, pyr, (e,), big_cam)
        configs[f"{name} exact"] = (SolverConfig(), (8192,), (1,), 1, pyr, (e,), big_cam)
    timed = ("production_320", "dvo defaults", "production_vga rendered", "cam_scale_3",
             "cam_scale_4", "1600x2560 segmented", "2560x1600 exact")
    out = {}
    for cname, (cfg, caps, b_sizes, n_lv, g0, d0, cam) in configs.items():
        if isinstance(g0, torch.Tensor):
            pyr = build_pyramid(g0, d0, n_lv)
            edges = canny.canny_pyramid(pyr.gray, cfg.canny_low, cfg.canny_high)
        else:  # a pyramid and its edges, built once for the other checks too
            pyr, edges = g0, d0
        intr = Intrinsics.from_config(cam)
        shallow = tuple(torch.where(torch.from_numpy(rng.random(tuple(d.shape)) < 0.5).to(device),
                                    torch.full_like(d, 50.0), d) for d in pyr.depth)
        cases = {
            "rendered": (edges, pyr.depth),
            "edge-free": (tuple(torch.zeros_like(e) for e in edges), pyr.depth),
            "all-edge": (tuple(torch.ones_like(e) for e in edges), pyr.depth),
            "shallow depth": (edges, shallow),
        }
        for kind, (e_pyr, d_pyr) in cases.items():
            for b in b_sizes:
                e_b = tuple(e[:b].contiguous() for e in e_pyr)
                d_b = tuple(d[:b].contiguous() for d in d_pyr)
                args = (e_b, d_b, intr, cfg, caps)
                n_max = max(e.shape[1] * e.shape[2] for e in e_b)
                rule = extract.cluster_size(n_max, b, len(e_b))
                k = extract.extract_pyramid(*args)
                again = extract.extract_pyramid(*args)
                plain = extract.extract_pyramid_plain(*args)
                torch.cuda.synchronize()
                what = f"extract_pyramid {cname} {kind} {n_lv} levels B={b}"
                _extract_equal(f"{what} (second run)", again, k)
                _extract_equal(f"{what} (kernel vs plain)", k, plain)
                counts = [int(a.count.sum()) for a in k]
                line = (f"{what}: 4 outputs bitwise equal at every level, runs equal, rule's "
                        f"cluster c={rule}; counts {counts}")
                if kind == "edge-free":
                    _require(sum(counts) == 0, f"{what}: an edge-free image has points")
                if kind == "rendered":
                    routes = {}
                    for c in extract.CLUSTERS:
                        if not extract.chunk_size(n_max, c):
                            continue
                        forced = extract.extract_pyramid(*args, cluster=c)
                        _extract_equal(f"{what} (cluster {c} vs the rule's)", forced, k)
                        if cname in timed:
                            routes[c] = _time_ms(
                                lambda c=c: extract.extract_pyramid(*args, cluster=c), 20)
                    line += f"; forced c={sorted(routes) or 'all'} bitwise equal"
                    if routes:
                        line += " (ms: " + ", ".join(f"c={c} {t:.4f}" for c, t in
                                                     routes.items()) + ")"
                if kind == "rendered" and cname in timed:
                    k_ms = _time_ms(lambda: extract.extract_pyramid(*args), 20)
                    p_ms = _time_ms(lambda: extract.extract_pyramid_plain(*args), 3)
                    # every image's edge map read (1 byte a pixel), its depth only
                    # under an edge (what the mask needs), the order tables read
                    # once, the slots and counts written
                    n_px = sum(e.numel() for e in e_b)
                    under_edge = sum(int(e.sum()) for e in e_b)
                    tables = sum(extract._order_table(e.shape[1] * e.shape[2], str(device)).numel()
                                 * 4 for e in e_b)
                    slots = sum(a.valid.numel() for a in k)
                    bound = _bound(n_px + 4 * under_edge + tables + slots * 21 + 4 * b * len(k),
                                   n_px * OPS_EXTRACT_PIXEL + slots * OPS_EXTRACT_SLOT)
                    line += (f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; bound "
                             f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']})")
                    out[(cname, b)] = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
                                       "cluster": rule, "cluster_ms": routes, **bound}
                _log(line)
    return {**out[("production_320", BATCH)],
            "b1": out[("production_320", 1)],
            "dvo_defaults": {**out[("dvo defaults", BATCH)], "b1": out[("dvo defaults", 1)]},
            "vga": {"shape": "production_vga, 5 levels from 480x640, B=64",
                    **out[("production_vga rendered", BATCH)],
                    "b1": out[("production_vga rendered", 1)]},
            "cam_scale_3": {"shape": "4 levels from 720x960, dvo defaults' capacities, B=8",
                            **out[("cam_scale_3", 8)], "b1": out[("cam_scale_3", 1)]},
            "cam_scale_4": {"shape": "4 levels from 960x1280, dvo defaults' capacities, B=8",
                            **out[("cam_scale_4", 8)], "b1": out[("cam_scale_4", 1)]},
            "large": {"shape": "one level of 1600x2560 (segmented) and of 2560x1600 (exact), "
                               "8192 slots, B=1",
                      "1600x2560": out[("1600x2560 segmented", 1)],
                      "2560x1600": out[("2560x1600 exact", 1)]}}


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
        # points, the sampled DT corners, pose and scale in; H, g, e2, n out
        nbytes = BATCH * k * 13 + _sampled_bytes(n, img.shape[1] * img.shape[2], 4, 2) + BATCH * (
            52 + 176)
        out[(k, dt_kind)] = (k_ms, p_ms, _bound(nbytes, int(n.sum()) * OPS_GN_POINT))
    k_ms, p_ms, bound = out[(512, "normalized")]
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, **bound}


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
            nbytes = BATCH * k * 13 + _sampled_bytes(ker[1], img.shape[1] * img.shape[2], 4, 2) + (
                BATCH * (48 + 8))
            out[(k, bilinear)] = (k_ms, p_ms,
                                  _bound(nbytes, int(ker[1].sum()) * OPS_RESIDUAL_POINT))
    k_ms, p_ms, bound = out[(512, True)]
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, **bound}


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
        # points and pose in, five float32 DT reads per visible point; g, e2,
        # n and the per-point eps and visibility out
        nbytes = BATCH * k * 13 + _sampled_bytes(ker[2], dt.shape[1] * dt.shape[2], 5, 4) + (
            BATCH * (48 + 32 + 5 * k))
        out[k] = (k_ms, p_ms, _bound(nbytes, int(ker[2].sum()) * OPS_SG_POINT))
    k_ms, p_ms, bound = out[8192]
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, **bound}


def match_inputs(rng, device):
    """A query frame's descriptors and a full slot store, from rendered
    320x240 frames: 32 frames along a path, 16 of them again with sensor
    noise, the query frame itself (an exact duplicate: every true distance
    is within a few ulps of 0), the query with noise (a near-duplicate) and
    14 empty slots. The query is frame 12 of the path."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.ops.features import detect_and_describe

    frames, _ = render_sequence(CameraConfig(), _trajectory(32, step=0.004), seed=3)
    grays = [g for g, _ in frames]
    grays += [grays[i] + rng.normal(0, 2.0, grays[i].shape).astype(np.float32)
              for i in range(0, 32, 2)]
    query = grays[12]
    grays += [query, query + rng.normal(0, 1.0, query.shape).astype(np.float32)]
    kps = [detect_and_describe(torch.from_numpy(g).to(device), MATCH_K) for g in grays]
    q = kps[-2]
    empty = MATCH_SLOTS - len(kps)
    desc = torch.cat([torch.stack([k.desc for k in kps]),
                      torch.zeros((empty, MATCH_K, 64), device=device)]).contiguous()
    valid = torch.cat([torch.stack([k.valid for k in kps]),
                       torch.zeros((empty, MATCH_K), dtype=torch.bool, device=device)]).contiguous()
    return desc, valid, q.desc.contiguous(), q.valid.contiguous()


def full_match_inputs(device, slots: int):
    """Every keypoint valid: `slots` slots and a query of K = 384 random unit
    descriptors (a textured scene at max_keypoints), from seed 0."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(0)
    unit = lambda *shape: torch.nn.functional.normalize(  # noqa: E731
        torch.randn(shape + (64,), generator=g, device=device), dim=-1).contiguous()
    every = torch.ones((slots, MATCH_K), dtype=torch.bool, device=device)
    return unit(slots, MATCH_K), every, unit(MATCH_K), every[0].contiguous()


def _check_match_case(what, args, floor) -> tuple:
    """One case of check_match: the kernel on its rule's route and forced
    to every cluster size, bitwise alike; against the plain version:
    ref_idx, good and num_good equal except at near-ties (rows whose best
    two candidates, or whose match's column, lie within 1e-6 in the plain
    version's d2), dist within 1e-6, runs bitwise."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import match

    sd, sv, qd, qv = args
    d2 = match.pair_d2(sd, sv, qd, qv)
    two_r = d2.topk(2, dim=2, largest=False).values
    two_c = d2.topk(2, dim=1, largest=False).values
    row_tie = (two_r[..., 1] - two_r[..., 0] <= 1e-6) & (two_r[..., 0] < 5e8)
    col_tie = (two_c[:, 1] - two_c[:, 0] <= 1e-6) & (two_c[:, 0] < 5e8)
    del d2, two_r, two_c
    full = (*args, 3.0, 0.9, floor)
    ker = match.match_mutual(*full)
    again = match.match_mutual(*full)
    pl = match.match_mutual_plain(*full)
    torch.cuda.synchronize()
    _require(all(_same_bits(a, b) for a, b in zip(ker, again)), f"{what}: runs differ")
    for c in match.CLUSTERS:
        forced = match.match_mutual(*full, cluster=c)
        _require(all(_same_bits(a, b) for a, b in zip(ker, forced)),
                 f"{what}: {c} blocks a slot differ from the rule's route")
    near = row_tie | col_tie.gather(1, pl[0])
    diff = (ker[0] != pl[0]) | (ker[2] != pl[2])
    _require(not bool((diff & ~near).any()), f"{what}: rows differ away from near-ties")
    slack = (diff & near).sum(1)
    _require(bool(((ker[3] - pl[3]).abs() <= slack).all()), f"{what}: num_good differs")
    same = ker[0] == pl[0]
    err = float((ker[1] - pl[1]).abs()[same].max())
    _require(err <= 1e-6, f"{what}: dist error {err:.2e} > 1e-6")
    _log(f"{what}: {int(near.sum())} near-tie rows, {int(diff.sum())} rows differ, dist err "
         f"{err:.2e}, runs and every cluster size bitwise equal; "
         f"{int(pl[3].sum())} good matches")
    return pl, err


def _match_bound(args) -> dict:
    """The least time for one match_mutual call on these inputs: the masks
    and the valid keypoints' descriptors in, (ref_idx int64, dist, good)
    per row and num_good out; each valid pair's 64-long multiply-add chain
    once (two float32 operations a link)."""
    sd, sv, qd, qv = args
    s_n, k_n, d_n = sd.shape
    nq, nr = int(qv.sum()), int(sv.sum())
    nbytes = (s_n + 1) * k_n + (nq + nr) * 4 * d_n + s_n * k_n * 13 + s_n * 4
    return _bound(nbytes, nq * nr * d_n * 2)


def check_match(device, rng) -> dict:
    """Kernel A vs its plain version (`_check_match_case`) at the loop
    closer's and the relocalizer's gate floors on the rendered store (S =
    64, K = 384, ~80 valid keypoints a frame), at full validity (S = 64)
    and at S = 512 (the rendered store eight times; full validity)."""
    from rgbd_odometry_tpu_torch.kernels import match

    sd, sv, qd, qv = match_inputs(rng, device)
    rendered = (sd, sv, qd, qv)
    worst, out = 0.0, {}
    for floor in (1e-3, 0.2):
        what = f"match S={MATCH_SLOTS} K={MATCH_K} floor={floor}"
        pl, err = _check_match_case(what, rendered, floor)
        worst = max(worst, err)
        goods = pl[3].tolist()
        _require(goods[48] >= 30 and goods[49] >= 20 and max(goods[50:]) == 0,
                 f"{what}: duplicate / near-duplicate / empty slots give {goods[48:51]}")
        _log(f"{what}: good matches duplicate {goods[48]} near-duplicate {goods[49]} "
             f"path {goods[:32]}")
    cases = {
        "rendered S=64": rendered,
        "rendered S=512": (sd.repeat(8, 1, 1).contiguous(), sv.repeat(8, 1).contiguous(), qd, qv),
        "full S=64": full_match_inputs(device, MATCH_SLOTS),
        "full S=512": full_match_inputs(device, 512),
    }
    for name, args in cases.items():
        if name != "rendered S=64":
            for floor in (1e-3, 0.2):
                _, err = _check_match_case(f"match {name} floor={floor}", args, floor)
                worst = max(worst, err)
        k_ms = _time_ms(lambda: match.match_mutual(*args), 20)
        p_ms = _time_ms(lambda: match.match_mutual_plain(*args), 2)
        bound = _match_bound(args)
        _log(f"match {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
             f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']})")
        out[name] = {"ms": k_ms, "plain_ms": p_ms, **bound}
    return {"max_abs_err": worst, **out["rendered S=64"],
            "full": out["full S=64"], "s512": out["rendered S=512"], "full_s512": out["full S=512"]}


def pnp_inputs(rng, device, k: int = PNP_K):
    """K correspondences of a PnP problem: points 1-3 m in front of the
    stored camera, their normalized projections in the query camera with
    0.001 noise, 15% gross outliers, 90% valid; 64 four-point hypothesis
    masks drawn from the valid points."""
    import torch

    from rgbd_odometry_tpu_torch.core.geometry import se3_exp

    obj = np.stack([rng.uniform(-1.2, 1.2, k), rng.uniform(-0.9, 0.9, k), rng.uniform(1.0, 3.0, k)],
                   -1).astype(np.float32)
    R, t = (x.numpy().astype(np.float64) for x in se3_exp(torch.tensor(
        [0.03, -0.02, 0.01, 0.02, -0.03, 0.01], dtype=torch.float32)))
    pq = (obj - t) @ R  # R^T (P - t)
    imn = pq[:, :2] / pq[:, 2:] + rng.normal(0, 0.001, (k, 2))
    bad = rng.random(k) < 0.15
    imn[bad] += rng.uniform(-0.1, 0.1, (int(bad.sum()), 2))
    valid = rng.random(k) < 0.9
    masks = np.zeros((PNP_HYPOTHESES, k), bool)
    idx = np.nonzero(valid)[0]
    for b in range(PNP_HYPOTHESES):
        masks[b, rng.choice(idx, min(4, len(idx)), replace=False)] = True
    f = lambda a: torch.as_tensor(a).to(device).contiguous()  # noqa: E731
    return f(obj), f(imn.astype(np.float32)), f(valid), f(masks)


def chessboard_inputs(device):
    """The `pnp` command's problem (cli.cmd_pnp): the 9x6 board of 5 cm
    squares 1.5 m away seen from a known pose, every corner valid."""
    import torch

    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.solvers import pnp

    f32 = dict(dtype=torch.float32, device=device)
    obj = torch.as_tensor(pnp.chessboard_object_points(6, 9, 0.05), **f32)
    obj = obj + torch.tensor([0.0, 0.0, 1.5], **f32)
    R_gt, t_gt = geo.se3_exp(torch.tensor([0.08, -0.05, 0.03, 0.05, -0.06, 0.04], **f32))
    pb = (obj - t_gt) @ R_gt
    return obj.contiguous(), (pb[:, :2] / pb[:, 2:3]).contiguous()


def _pnp_case(what, args, norm: bool) -> tuple:
    """`pnp_gn` on the card against its plain version on the same card
    inputs: R, t, counts, inliers and (with `norm`) the residual norms
    bitwise, and two runs bitwise. Returns the kernel's CUDA-event ms and
    the largest |kernel - plain| over R and t."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import pnp_gn

    b, iters = args[2].shape[0], args[5]

    def run(fn):
        rn = torch.empty((b, iters), dtype=torch.float32, device=args[0].device) if norm else None
        out = fn(*args, write_inliers=True, rnorm_out=rn)
        return tuple(out) + ((rn,) if norm else ())

    pl = run(pnp_gn.pnp_gn_plain)
    ker, again = run(pnp_gn.pnp_gn), run(pnp_gn.pnp_gn)
    torch.cuda.synchronize()
    _require(all(_same_bits(x, y) for x, y in zip(ker, again)), f"{what}: runs differ")
    for field, x, y in zip(("R", "t", "counts", "inliers", "residual norms"), ker, pl):
        _require(_same_bits(x, y), f"{what}: {field} differ from the plain version")
    err = max(float((x - y).abs().max()) for x, y in zip(ker[:2], pl[:2]))
    ms = _time_ms(lambda: pnp_gn.pnp_gn(*args), 50)
    _log(f"{what}: every output bitwise the plain version's, runs bitwise; "
         f"inliers max {int(pl[2].max())} of {int(args[7].sum())}; kernel {ms:.4f} ms")
    return ms, err


def check_pnp(device, rng) -> dict:
    """Kernel B's `pnp_gn` vs its plain version, bitwise (R, t, counts,
    inliers, residual norms): the `pnp` command's chessboard (B = 1, K =
    54, 5 iterations from the identity, the norms requested), both RANSAC phases of K = 384 (the
    hypotheses: B = 64, 4 points each, 4 iterations; the refine: B = 1 over
    the best hypothesis's inliers, 5 iterations) and ragged shapes (B = 3
    and 65, K = 1, 33, 1025 and 4096, random masks and start poses)."""
    import torch

    from rgbd_odometry_tpu_torch.core.geometry import se3_exp
    from rgbd_odometry_tpu_torch.kernels import pnp_gn

    thresh = 0.01
    cobj, cimn = chessboard_inputs(device)
    every = torch.ones(cobj.shape[0], dtype=torch.bool, device=device)
    c_ms, c_err = _pnp_case(f"pnp_gn chessboard B=1 K={cobj.shape[0]} iters=5",
                            (cobj, cimn, every[None], None, None, 5, 0.0, every), True)
    obj, imn, valid, masks = pnp_inputs(rng, device)
    eye = torch.eye(3, device=device).expand(PNP_HYPOTHESES, 3, 3).contiguous()
    zero = torch.zeros((PNP_HYPOTHESES, 3), device=device)
    args = (obj, imn, masks, eye, zero, 4, thresh, valid)
    k_ms, k_err = _pnp_case(f"pnp_gn hypotheses B={PNP_HYPOTHESES} K={PNP_K} iters=4", args, False)
    p_ms = _time_ms(lambda: pnp_gn.pnp_gn_plain(*args), 5)
    pl = pnp_gn.pnp_gn_plain(*args, write_inliers=True)
    b = int(torch.argmax(pl[2]))
    _require(int(pl[2][b]) >= 250, f"pnp_gn: the best hypothesis has {int(pl[2][b])} inliers")
    r_ms, r_err = _pnp_case(f"pnp_gn refine B=1 K={PNP_K} iters=5 over {int(pl[2][b])} inliers",
                            (obj, imn, pl[3][b : b + 1].contiguous(), pl[0][b : b + 1],
                             pl[1][b : b + 1], 5, thresh, valid), True)
    errs = [c_err, k_err, r_err]
    for k in (1, 33, 1025, 4096):
        o, i_, v, _ = pnp_inputs(rng, device, k)
        if k == 1:
            v = torch.ones_like(v)
        for bb in (3, 65):
            frac = torch.linspace(0.05, 0.95, bb, device=device)[:, None]
            m = (torch.as_tensor(rng.random((bb, k)), device=device) < frac) & v
            tw = torch.as_tensor(rng.normal(0, 0.01, (bb, 6)), dtype=torch.float32, device=device)
            R0, t0 = se3_exp(tw)
            errs.append(_pnp_case(
                f"pnp_gn ragged B={bb} K={k} iters=4",
                (o, i_, m.contiguous(), R0.contiguous(), t0.contiguous(), 4, thresh, v),
                bb == 3)[1])
    # correspondences, masks and start poses in; poses, counts, inliers out
    b_n, k_n = masks.shape
    bound = _bound(k_n * 21 + b_n * k_n + b_n * 48 + b_n * (52 + k_n),
                   4 * int(masks.sum()) * OPS_PNP_POINT + b_n * int(valid.sum()) * OPS_PNP_SCORE)
    _log(f"pnp_gn: hypotheses kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
         f"{bound['bound_ms'] * 1e3:.4f} us; chessboard {c_ms:.4f} ms; refine {r_ms:.4f} ms")
    return {"max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms, "chessboard_ms": c_ms,
            "refine_ms": r_ms, **bound}


@contextlib.contextmanager
def _ransac_against_steps(tally: list):
    """Every `solvers/pnp.ransac_pnp` call of the block (the fused kernel on
    the card) is recorded with its inputs; after the block the step-by-step
    route runs on each, and must give every field bitwise. `tally` gets each
    verification's inlier count. The route's `pnp_gn` launches are a
    comparison's and are taken off its counter."""
    from rgbd_odometry_tpu_torch.kernels import pnp_gn
    from rgbd_odometry_tpu_torch.solvers import pnp

    fused, calls = pnp.ransac_pnp, []

    def recorded(*a, **k):
        res = fused(*a, **k)
        calls.append(([x.clone() if hasattr(x, "clone") else x for x in a], k, res))
        return res

    pnp.ransac_pnp = recorded
    try:
        yield
    finally:
        pnp.ransac_pnp = fused
    before = pnp_gn.pnp_gn.launches
    for n, (a, k, res) in enumerate(calls):
        steps = pnp_gn.ransac_pnp_steps(*a, **k)
        _require(all(_same_bits(x, y) for x, y in zip(res, steps)),
                 f"ransac_pnp: verification {n} differs from the step-by-step route")
        tally.append(int(res.num_inliers))
    pnp_gn.pnp_gn.launches = before


def _kernel_launches(fn) -> int:
    """The CUDA kernels one call of fn() runs (device copies apart), from the
    profiler (a window whose records the profiler dropped is profiled
    again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(ev.count for ev in prof.key_averages()
                if ev.device_time_total > 0 and not ev.key.startswith(("Memcpy", "Memset")))
        if n:
            return n
    return 0


def _captured_kernels(fn) -> int:
    """The CUDA kernels one call of fn() enqueues, counted exactly: after a
    call outside it, one call is captured into a CUDA graph and the graph's
    kernel nodes are counted through the driver (copies and memsets apart).
    The profiler's windows sometimes record no device event at all for
    such a call (six in a row for one `detect_describe` call on an H100), so
    launch requirements count here. A call that synchronizes with the host
    cannot be captured and raises, so a count also shows that fn() makes no
    host sync."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    _require(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    _require(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        _require(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
                 "cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def check_ransac(device, rng) -> dict:
    """Kernel B's fused `ransac_pnp` (one launch a verification) against the
    step-by-step route on the card (`ransac_pnp_steps`: the sample, the
    hypotheses' and the refine's `pnp_gn` launches and the torch ops
    between them), every field bitwise, on chip_smoke's PnP problem with
    six draws of 64 hypotheses' uniforms, with 3 valid points and with
    none, and past the small route's 1024 points at K = 1025, 2048, 4097
    and 8192 (the correspondences staged in shared memory), 16384 and the
    card's largest K, `max_points` (read through L1), one draw each; and
    against the route over `pnp_gn`'s plain version, bitwise. Records the
    launches a verification of both (the kernel's by graph capture, which
    shows it makes no host sync; the route's by the profiler)."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import pnp_gn

    obj, imn, valid, _ = pnp_inputs(rng, device)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    few = torch.zeros_like(valid)
    few[torch.nonzero(valid)[:3, 0]] = True
    cases = [(f"draw {i}", torch.rand((PNP_HYPOTHESES, PNP_K), generator=g, device=device),
              obj, imn, valid) for i in range(6)]
    u = cases[0][1]
    cases += [("3 valid", u, obj, imn, few), ("none valid", u, obj, imn, torch.zeros_like(valid))]
    large = {}
    for k in (1025, 2048, 4097, 8192, 16384, pnp_gn.max_points(device)):
        o, i_, v, _ = pnp_inputs(rng, device, k)
        large[k] = (torch.rand((PNP_HYPOTHESES, k), generator=g, device=device), o, i_, v)
        cases.append((f"K={k}", *large[k]))
    plain = lambda: _patched(pnp_gn, pnp_gn=pnp_gn.pnp_gn_plain)  # noqa: E731
    err = 0.0
    for name, *args in cases:
        ker = pnp_gn.ransac_pnp(*args)
        again = pnp_gn.ransac_pnp(*args)
        steps = pnp_gn.ransac_pnp_steps(*args)
        with plain():
            pl = pnp_gn.ransac_pnp_steps(*args)
        torch.cuda.synchronize()
        what = f"ransac_pnp {name}"
        _require(all(_same_bits(a, b) for a, b in zip(ker, again)), f"{what}: runs differ")
        _require(all(_same_bits(a, b) for a, b in zip(ker, steps)),
                 f"{what}: differs from the step-by-step route on the card")
        _require(all(_same_bits(a, b) for a, b in zip(ker, pl)),
                 f"{what}: differs from the route over the plain pnp_gn")
        err = max([err] + [float((a - b).abs().max()) for a, b in zip(ker[:2], pl[:2])])
        _log(f"{what}: every field bitwise the step-by-step route's and the plain route's; "
             f"best hypothesis {int(ker.best_hypothesis)} with {int(ker.num_inliers)} inliers")
    args = (u, obj, imn, valid)
    fused_n = _captured_kernels(lambda: pnp_gn.ransac_pnp(*args))
    steps_n = _kernel_launches(lambda: pnp_gn.ransac_pnp_steps(*args))
    _require(fused_n == 1, f"ransac_pnp: {fused_n} kernels a verification, not 1")
    for k, a in large.items():
        n = _captured_kernels(lambda a=a: pnp_gn.ransac_pnp(*a))
        _require(n == 1, f"ransac_pnp K={k}: {n} kernels a verification, not 1")
    k_ms = _time_ms(lambda: pnp_gn.ransac_pnp(*args), 50)
    s_ms = _time_ms(lambda: pnp_gn.ransac_pnp_steps(*args), 20)
    with plain():
        p_ms = _time_ms(lambda: pnp_gn.ransac_pnp_steps(*args), 3)
    large_ms = {k: _time_ms(lambda a=a: pnp_gn.ransac_pnp(*a), 20) for k, a in large.items()}

    def ransac_bound(u_, obj_, imn_, v_) -> dict:
        # uniforms, correspondences and the mask in; the pose, inliers, count
        # and index out; the hypotheses' iterations on their sample points,
        # the scores, the refine's iterations on the winner's inliers
        res = pnp_gn.ransac_pnp(u_, obj_, imn_, v_)
        sub = pnp_gn.select_sample(u_, v_, 4)
        s_n, k_n = u_.shape
        return _bound(s_n * k_n * 4 + k_n * 21 + 48 + k_n + 12,
                      4 * int(sub.sum()) * OPS_PNP_POINT + s_n * k_n * OPS_PNP_SCORE
                      + 5 * int(res.num_inliers) * OPS_PNP_POINT)

    bound = ransac_bound(*args)
    _log(f"ransac_pnp: {fused_n} kernel a verification at every K (the step-by-step route "
         f"{steps_n}); kernel {k_ms:.4f} ms, the route on the card {s_ms:.4f} ms, over the plain "
         f"pnp_gn {p_ms:.4f} ms; bound {bound['bound_ms'] * 1e3:.4f} us ({bound['bound_by']}); "
         + ", ".join(f"K={k} {ms:.4f} ms" for k, ms in large_ms.items())
         + f"; the kernel takes K <= {pnp_gn.max_points(device)} on this card")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "steps_ms": s_ms,
            "launches_per_verification": fused_n, "steps_launches_per_verification": steps_n,
            "max_points": pnp_gn.max_points(device),
            "k2048": {"ms": large_ms[2048], **ransac_bound(*large[2048])},
            "k8192": {"ms": large_ms[8192], **ransac_bound(*large[8192])},
            "k16384": {"ms": large_ms[16384], **ransac_bound(*large[16384])},
            "k_max": {"k": max(large), "ms": large_ms[max(large)],
                      **ransac_bound(*large[max(large)])}, **bound}


def _on(a, device):
    """A float32 array as a contiguous tensor on `device`."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _checkerboard(h: int, w: int, cell: int = 6):
    """A checkerboard of 200 / 40 squares: many equal Harris responses, so
    the selection's tie order decides the slots."""
    y, x = np.mgrid[:h, :w]
    return np.where(((y // cell) + (x // cell)) % 2 == 0, 200.0, 40.0).astype(np.float32)


def detect_cases(device, rng) -> list:
    """check_detect's inputs: (name, gray, depth or None, k_max) on the card."""
    frames, _ = stream_frames()
    vga, _ = vga_frames()
    t = functools.partial(_on, device=device)
    g0, d0 = frames[0]
    g9, d9 = frames[9]
    noisy = g9 + rng.normal(0, 2.0, g9.shape).astype(np.float32)
    cases = []
    for k in (16, 384, 512, 1024):
        cases += [(f"rendered 320x240 K={k}", t(g0), t(d0), k),
                  (f"rendered 320x240 K={k} no depth", t(g0), None, k),
                  (f"noisy 320x240 K={k}", t(noisy), t(d9), k)]
    cases += [
        ("flat 320x240 K=384", t(np.full((240, 320), 87.0)), t(d0), 384),
        ("checkerboard 320x240 K=384", t(_checkerboard(240, 320)), t(d0), 384),
        ("checkerboard 320x240 K=1024", t(_checkerboard(240, 320)), None, 1024),
        ("ragged 37x45 K=384", t(noisy[100:137, 150:195]), t(d9[100:137, 150:195]), 384),
        ("rendered 640x480 K=512", t(vga[3][0]), t(vga[3][1]), 512),
        ("rendered 640x480 K=1024 no depth", t(vga[3][0]), None, 1024),
        ("checkerboard 640x480 K=512", t(_checkerboard(480, 640)), None, 512),
    ]
    return cases


def _detect_bound(gray, k: int, count: int, depth: bool) -> dict:
    """The least time for one detect_describe call: the image read once (and
    a depth a slot), every output written once; the response, the peak test
    and the threshold a pixel, the descriptor of every valid slot."""
    h, w = gray.shape
    out = k * (8 + 4 + 256 + 1) + 4 + (k * 13 if depth else 0)
    return _bound(h * w * 4 + (k * 4 if depth else 0) + out,
                  h * w * OPS_HARRIS_PIXEL + count * OPS_DESCRIPTOR)


def check_detect(device, rng) -> dict:
    """Kernel C against its plain version on the card, every output bitwise
    (uv, score, desc, valid, count and, with depth, pts3d and pts_valid):
    rendered 320x240 frames exact and with noise, a flat image (count 0,
    every slot -inf in pixel order), checkerboards (equal responses: the tie
    order), a 37x45 image (ragged tiles) and 640x480, K = 16, 384, 512,
    1024, with and without depth; two runs bitwise. One kernel a call (its
    header's memset apart) and no host sync, by graph capture, at the
    matcher's call (320x240, K = 384, depth) and feature-vo's (640x480, K =
    512); timed at both beside the plain version."""
    import torch

    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.kernels import features as kfeat
    from rgbd_odometry_tpu_torch.ops import features as pf
    from rgbd_odometry_tpu_torch import profiles

    intr = Intrinsics.from_config(profiles.production_320().camera)

    def plain(g, d, k):
        kps = pf.detect_and_describe_plain(g, k)
        return tuple(kps) + (pf.backproject_keypoints_plain(kps, d, intr) if d is not None else ())

    def kernel(g, d, k):
        return kfeat.detect_describe(g, k, depth=d, intr=None if d is None else intr)

    for name, g, d, k in detect_cases(device, rng):
        ker, again, pl = kernel(g, d, k), kernel(g, d, k), plain(g, d, k)
        torch.cuda.synchronize()
        what = f"detect {name}"
        _require(len(ker) == len(pl), f"{what}: {len(ker)} outputs, plain {len(pl)}")
        _require(all(_same_bits(a, b) for a, b in zip(ker, again)), f"{what}: runs differ")
        for field, a, b in zip(("uv", "score", "desc", "valid", "count", "pts3d", "pts_valid"),
                               ker, pl):
            _require(_same_bits(a, b), f"{what}: {field} differs from the plain version")
        count = int(ker[4])
        if name.startswith("flat"):
            _require(count == 0 and bool(torch.isinf(ker[1]).all()) and torch.equal(
                ker[0][:, 0] + g.shape[1] * ker[0][:, 1],
                torch.arange(k, dtype=torch.float32, device=device)),
                f"{what}: not every slot -inf in pixel order")
        _log(f"{what}: every output bitwise the plain version's, {count} corners"
             + (f", {int(ker[6].sum())} with depth" if d is not None else ""))
    frames, _ = stream_frames()
    g = torch.from_numpy(frames[0][0]).to(device)
    d = torch.from_numpy(frames[0][1]).to(device)
    vga, _ = vga_frames()
    gv = torch.from_numpy(vga[3][0]).to(device)
    n_kernels = _captured_kernels(lambda: kernel(g, d, 384))
    v_kernels = _captured_kernels(lambda: kernel(gv, None, 512))
    _require(n_kernels == 1 and v_kernels == 1,
             f"detect: {n_kernels} kernels a call at 320x240 K=384 with depth and {v_kernels} at "
             "640x480 K=512, not 1")
    k_ms = _time_ms(lambda: kernel(g, d, 384), 50)
    p_ms = _time_ms(lambda: plain(g, d, 384), 10)
    v_ms = _time_ms(lambda: kernel(gv, None, 512), 50)
    vp_ms = _time_ms(lambda: plain(gv, None, 512), 10)
    count = int(kernel(g, d, 384)[4])
    bound = _detect_bound(g, 384, count, True)
    vbound = _detect_bound(gv, 512, int(kernel(gv, None, 512)[4]), False)
    _log(f"detect: {n_kernels} kernel a call (the memset apart; captured: no host sync); "
         f"320x240 K=384 with depth "
         f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound['bound_ms'] * 1e3:.3f} us "
         f"({bound['bound_by']}); 640x480 K=512 kernel {v_ms:.4f} ms, plain {vp_ms:.4f} ms, "
         f"bound {vbound['bound_ms'] * 1e3:.3f} us")
    return {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "kernels_per_call": n_kernels,
            "vga": {"ms": v_ms, "plain_ms": vp_ms, **vbound}, **bound}


def _rendered_matches(device, pairs, k: int = MATCH_K) -> list:
    """Matched pixel pairs of the stream phase's frames (a stored, b query)
    through the port's own detection and matching on the card: (name, uv1,
    uv2, valid) as `KeyframeMatcher.verify` (K = 384) and `FeatureVo` (K =
    512) form them."""
    from rgbd_odometry_tpu_torch.ops import features as pf

    frames, _ = stream_frames()
    out = []
    for a, b in pairs:
        ref = pf.detect_and_describe(_on(frames[a][0], device), k)
        now = pf.detect_and_describe(_on(frames[b][0], device), k)
        m = pf.match(ref, now)
        valid = m.good & now.valid & ref.valid[m.ref_idx]
        out.append((f"K={k} frames {a}->{b}", now.uv.contiguous(), ref.uv[m.ref_idx].contiguous(),
                    valid.contiguous()))
    return out


def _general_scene(seed: int, device, n: int = 96):
    """tests/test_torch_ransac.py's well-posed two-view scene: random points
    at spread depths seen from two poses (numpy Rodrigues), a quarter of the
    pairs corrupted, the last 6 invalid."""
    import torch

    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), rng.uniform(1.5, 5, n)], -1)
    w = np.array([0.02, 0.05, -0.01])
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    Q = (P - np.array([0.12, -0.04, 0.03])) @ R

    def proj(X):
        return np.stack([176.0 * X[:, 0] / X[:, 2] + 79.5, 176.0 * X[:, 1] / X[:, 2] + 59.5], -1)

    uv1, uv2 = proj(Q), proj(P)
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)
    bad = rng.random(n) < 0.25
    uv1[bad] += rng.uniform(-25, 25, (int(bad.sum()), 2))
    valid = np.ones(n, bool)
    valid[-6:] = False
    return _on(uv1, device), _on(uv2, device), torch.from_numpy(valid).to(device)


def _F_close(a, b, tol: float) -> bool:
    a, b = a / a.norm(), b / b.norm()
    return min(float((a - b).abs().max()), float((a + b).abs().max())) < tol


def _eigen_gaps(u, uv1, uv2, valid):
    """Each hypothesis's relative gap between the two smallest eigenvalues
    of its normal matrix (float64 `eigvalsh` of the float32 matrix)."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import epipolar as kepi

    ev = torch.linalg.eigvalsh(kepi.normal_matrices(u, uv1, uv2, valid).double())
    return (ev[:, 1] - ev[:, 0]) / ev[:, -1].abs().clamp(min=1e-300)


def check_epipolar(device, rng) -> dict:
    """Kernel D (one launch a filter) against its twin
    `fundamental_ransac_steps`, every output and each hypothesis's count
    bitwise, on the card and on CPU copies of the inputs (the route the CPU
    tests hold to JAX's filter, the well-posed scene included), and against
    the plain cuSOLVER route (`ransac_fundamental_filter_plain`): on
    rendered matches (the stream phase's frames through the port's detection
    and matching, at the matcher's K = 384 and feature-vo's K = 512, three
    draws each) the count of every hypothesis whose normal matrix separates its
    two smallest eigenvalues by 1e-3 relative or more equal (below, float32's
    eigh leaves F off by eps / gap, 1e-4 or more, and a pair near the
    threshold may fall either side: those are logged with their gaps, beside
    the tally of the 62-of-64 bar), and the inlier set identical wherever the
    kernel's best count leads the next by 2 or more; on the well-posed
    two-view scene (two seeds, three draws each) 60% of the valid pairs
    inliers at least, and identical inliers and F within 1e-3 up to sign and
    scale where both routes' best is one hypothesis float32 resolves (gap
    1e-3 or more; the winning 8-point samples' gaps run 1e-8 to 3e-4, and
    the tally over every draw is logged); the two pass-through guards.
    One kernel a filter and no host sync (graph capture) at K = 384 and
    512. Timed at S = 64, K = 384."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import epipolar as kepi
    from rgbd_odometry_tpu_torch.ops import epipolar as pepi

    g = torch.Generator(device=device)
    g.manual_seed(0)
    cases = []
    rendered = _rendered_matches(device, ((0, 2), (0, 5), (10, 13), (20, 24)))
    rendered += _rendered_matches(device, ((0, 1), (10, 12), (20, 23)), FEATURE_VO_K)
    for name, uv1, uv2, valid in rendered:
        for i in range(3):
            u = torch.rand((PNP_HYPOTHESES, uv1.shape[0]), generator=g, device=device)
            cases.append((f"{name} draw {i}", u, uv1, uv2, valid))
    scenes = [(f"two-view scene {s} draw {i}",
               torch.rand((PNP_HYPOTHESES, 96), generator=g, device=device),
               *_general_scene(s, device)) for s in (0, 1) for i in range(3)]
    bar_held, tally, scene_bar = 0, [], []
    for name, *args in cases + scenes:
        ker = kepi.fundamental_ransac(*args)
        again = kepi.fundamental_ransac(*args)
        twin = kepi.fundamental_ransac_steps(*args)
        host = kepi.fundamental_ransac_steps(*(a.cpu() for a in args))
        pl = pepi.ransac_fundamental_filter_plain(*args)
        _, pc = pepi.hypotheses_plain(*args)
        torch.cuda.synchronize()
        what = f"epipolar {name}"
        _require(all(_same_bits(a, b) for a, b in zip(ker, again)), f"{what}: runs differ")
        for field, a, b, c in zip(("inliers", "num_inliers", "F", "counts"), ker, twin, host):
            _require(_same_bits(a, b), f"{what}: {field} differs from the twin")
            _require(_same_bits(a.cpu(), c), f"{what}: {field} differs from the twin on the CPU")
        counts = ker[3]
        differ = torch.nonzero(counts != pc)[:, 0].tolist()
        gaps = _eigen_gaps(*args)
        held = len(differ) <= 2 and int((counts - pc).abs().max()) <= 1
        bar_held += held
        tally.append(64 - len(differ))
        firm = [h for h in differ if float(gaps[h]) >= 1e-3]
        _require(not firm, f"{what}: hypotheses {firm} (relative eigen-gaps "
                           f"{[float(gaps[h]) for h in firm]}) count otherwise than the plain route")
        top2 = torch.topk(counts, 2).values.tolist()
        kb, pb = int(torch.argmax(counts)), int(torch.argmax(pc))
        same_in, close = torch.equal(ker[0], pl.inliers), _F_close(ker[2], pl.F, 1e-3)
        _log(f"{what}: bitwise the twin on the card and on the CPU; {int(ker[1])} inliers "
             f"(plain {int(pl.num_inliers)}), "
             f"best counts {top2}, best hypothesis {kb} gap {float(gaps[kb]):.1e} (plain {pb} "
             f"gap {float(gaps[pb]):.1e}); inliers {'identical' if same_in else 'differ'}, F "
             f"{'within' if close else 'not within'} 1e-3 of the plain route's; "
             f"{64 - len(differ)} of 64 counts equal the plain route's (differing: "
             + ", ".join(f"h{h} {int(counts[h])}/{int(pc[h])} gap {float(gaps[h]):.1e}"
                         for h in differ) + ")")
        if name.startswith("two-view"):
            scene_bar.append(same_in and close)
            n_valid = int(args[3].sum())
            _require(int(ker[1]) >= int(0.6 * n_valid),
                     f"{what}: {int(ker[1])} inliers of {n_valid} valid pairs")
            if kb == pb and float(gaps[kb]) >= 1e-3:
                _require(same_in and close, f"{what}: inliers or F differ from the plain route "
                         "on a hypothesis float32 resolves")
        elif top2[0] - top2[1] >= 2:
            _require(same_in, f"{what}: the inliers differ from the plain route's where the "
                     f"best count leads by {top2[0] - top2[1]}")
    _log(f"epipolar: the strict bar (62 of 64 counts equal the plain route's, the rest within "
         f"1) held in {bar_held} of {len(cases) + len(scenes)} cases; equal counts {tally}; on "
         f"the two-view scene identical inliers and F within 1e-3 of the plain route in "
         f"{sum(scene_bar)} of {len(scene_bar)} draws")
    # the guards: fewer than 8 slots (no launch), fewer than min_points valid
    name, u, uv1, uv2, valid = cases[0]
    before = kepi.fundamental_ransac.launches
    five = pepi.ransac_fundamental_filter(u[:, :5], uv1[:5], uv2[:5], valid[:5])
    _require(torch.equal(five.inliers, valid[:5]) and not bool(five.F.any())
             and kepi.fundamental_ransac.launches == before, "epipolar: the 5-slot guard")
    few = torch.zeros_like(valid)
    few[torch.nonzero(valid)[:6, 0]] = True
    got = pepi.ransac_fundamental_filter(u, uv1, uv2, few)
    _require(torch.equal(got.inliers, few) and int(got.num_inliers) == 6,
             "epipolar: the min_points guard")
    kepi.fundamental_ransac.launches = before
    args = (u, uv1, uv2, valid)
    n_kernels = _captured_kernels(lambda: kepi.fundamental_ransac(*args))
    v_args = cases[-1][1:]
    v_kernels = _captured_kernels(lambda: kepi.fundamental_ransac(*v_args))
    _require(n_kernels == 1 and v_kernels == 1,
             f"epipolar: {n_kernels} kernels a filter at K={MATCH_K} and {v_kernels} at "
             f"K={FEATURE_VO_K}, not 1")
    k_ms = _time_ms(lambda: kepi.fundamental_ransac(*args), 50)
    t_ms = _time_ms(lambda: kepi.fundamental_ransac_steps(*args), 3)
    p_ms = _time_ms(lambda: pepi.ransac_fundamental_filter_plain(*args), 10)
    s_n, k_n = u.shape
    bound = _bound(s_n * k_n * 4 + k_n * 17 + k_n + 4 + 36 + s_n * 4,
                   s_n * (OPS_EPIPOLAR_HYPOTHESIS + int(valid.sum()) * OPS_SAMPSON))
    _log(f"epipolar: {n_kernels} kernel a filter (captured: no host sync); S={s_n} K={k_n} "
         f"kernel {k_ms:.4f} ms, twin on "
         f"the card {t_ms:.4f} ms, plain route (cuSOLVER) {p_ms:.4f} ms, bound "
         f"{bound['bound_ms'] * 1e3:.4f} us ({bound['bound_by']})")
    return {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "twin_ms": t_ms,
            "kernels_per_call": n_kernels, "strict_bar_held": bar_held,
            "scene_bar_held": sum(scene_bar), "cases": len(cases) + len(scenes), **bound}


@contextlib.contextmanager
def _epipolar_against_twin(tally: list, caller):
    """Every `ransac_fundamental_filter` call that module `caller` makes in
    the block (kernel D on the card) is recorded with its inputs; after the
    block the twin runs on CPU copies of each (the route the CPU tests hold
    to JAX's filter) and must give every output bitwise. `tally` gets each
    filter's inlier count."""
    from rgbd_odometry_tpu_torch.kernels import epipolar as kepi

    filt, calls = caller.ransac_fundamental_filter, []

    def recorded(u, uv1, uv2, valid, **k):
        res = filt(u, uv1, uv2, valid, **k)
        calls.append(([x.clone() for x in (u, uv1, uv2, valid)], k, res))
        return res

    caller.ransac_fundamental_filter = recorded
    try:
        yield
    finally:
        caller.ransac_fundamental_filter = filt
    for n, (a, k, res) in enumerate(calls):
        twin = kepi.fundamental_ransac_steps(*(x.cpu() for x in a), **k)
        _require(all(_same_bits(x.cpu(), y) for x, y in zip(res, twin[:3])),
                 f"epipolar: filter {n} (K={a[1].shape[0]}) differs from the twin on the CPU")
        tally.append(int(res.num_inliers))


@contextlib.contextmanager
def _patched(module, **fns):
    """`module`'s names in `fns` replaced for the length of the block."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _render_once() -> dict:
    """Install a memo on `SyntheticScene.render` for the rest of the run:
    each synthetic frame is rendered once (keyed on the scene's contents,
    the camera, the pose and the supersampling) and every later request
    gets a copy. The phases replay the same 320x240 sequence ~15 times, and
    the host's rendering, not the card, was most of their wall time.
    Returns the live {"rendered", "reused"} tally."""
    from rgbd_odometry_tpu_torch.io import synthetic

    render, memo, tally = synthetic.SyntheticScene.render, {}, {"rendered": 0, "reused": 0}

    def once(self, cam, R, t, supersample=3):
        R, t = np.asarray(R), np.asarray(t)
        key = (pickle.dumps(self.__dict__), repr(cam), R.dtype.str, R.tobytes(), t.dtype.str,
               t.tobytes(), supersample)
        if key in memo:
            tally["reused"] += 1
        else:
            memo[key] = render(self, cam, R, t, supersample)
            tally["rendered"] += 1
        return tuple(np.copy(a) for a in memo[key])

    synthetic.SyntheticScene.render = once
    return tally


def _per_iteration_route():
    """`level_lm_plain` with the per-iteration kernels `fused_gn_terms` and
    `residual_pass` in place of their plain versions: the route every
    Gauss-Newton level took before `level_lm` (a Python loop of two kernel
    launches and ~200 small PyTorch ops per iteration)."""
    from rgbd_odometry_tpu_torch.kernels import fused_iter, level_lm, residual

    return _patched(level_lm, fused_gn_terms_plain=fused_iter.fused_gn_terms,
                    residual_pass_plain=residual.residual_pass)


def _per_iteration_sg_route():
    """`level_sg_plain` with the per-iteration kernel `subgradient_terms` in
    place of its plain version: the route every sub-gradient level took
    before `level_sg` (a Python loop of one kernel launch and ~230 small
    PyTorch ops per iteration)."""
    from rgbd_odometry_tpu_torch.kernels import level_sg, sg_terms

    return _patched(level_sg, subgradient_terms_plain=sg_terms.subgradient_terms)


def _check_level_curves(what: str, cfg, ker, pl) -> float:
    """The CPU tests' bars (tests/test_torch_level_lm.py) between the kernel
    and its plain version, pair by pair: energies within 1e-3 relative
    (standard LM) or 3e-3 (deferred accept); the best iteration equal or on
    a plateau below 1e-3; poses within 1e-3; the standard LM's moves equal
    except on plateaus below 1e-3. A pair may stop at another iteration only
    on such a plateau: a step below the termination norm accepted by one and
    not by the other, after which the other's energies stay within 1e-3 of
    its last common one. Returns the largest pose difference."""
    e_k, e_p = ker.energy.cpu().numpy(), pl.energy.cpu().numpy()
    n_k, n_p = (e_k != 0).sum(1), (e_p != 0).sum(1)
    common = np.minimum(n_k, n_p)
    cols = np.arange(e_k.shape[1])[None, :]
    head = cols < common[:, None]
    longer = np.where((n_k > n_p)[:, None], e_k, e_p)
    last = longer[np.arange(len(common)), np.maximum(common - 1, 0)][:, None]
    tail = (cols >= common[:, None]) & (longer != 0)
    bad = []
    if (np.abs(longer - last) > 1e-3 * last)[tail].any():
        bad.append("a pair stops at another iteration off a plateau")
    rtol = 3e-3 if cfg.lm_deferred_accept else 1e-3
    rel = np.where(head, np.abs(e_k - e_p) / np.maximum(np.abs(e_p), 1e-30), 0.0)
    if rel.max() > rtol:
        bad.append(f"energy relative error {rel.max():.2e} > {rtol}")
    e_any = np.where(e_p != 0, e_p, e_k)
    bk, bp = ker.best_iter.cpu().numpy(), pl.best_iter.cpu().numpy()
    rows = np.arange(len(bk))
    if (np.abs(e_any[rows, bk] - e_any[rows, bp]) > 1e-3 * e_any[rows, bp]).any():
        bad.append("best iterations differ off a plateau")
    if not cfg.lm_deferred_accept:
        live = head[:, 1:]
        d_k = (e_k[:, :-1] - e_k[:, 1:]) / np.maximum(e_k[:, :-1], 1e-30)
        d_p = (e_p[:, :-1] - e_p[:, 1:]) / np.maximum(e_p[:, :-1], 1e-30)
        differ = live & ((d_k != 0) != (d_p != 0))
        if (np.abs(d_k[differ]) >= 1e-3).any() or (np.abs(d_p[differ]) >= 1e-3).any():
            bad.append("accept/reject decisions differ off a plateau")
    err = max(float((ker.R - pl.R).abs().max()), float((ker.t - pl.t).abs().max()))
    if err >= 1e-3:
        bad.append(f"pose error {err:.2e} >= 1e-3")
    if bad:
        for i in np.nonzero((n_k != n_p) | (bk != bp) | (rel.max(1) > rtol))[0][:4]:
            _log(f"  {what} pair {i}: kernel {e_k[i].tolist()} best {bk[i]}; "
                 f"plain {e_p[i].tolist()} best {bp[i]}")
    _require(not bad, f"{what}: " + "; ".join(bad))
    stops = int((n_k != n_p).sum())
    if stops:
        _log(f"  {what}: {stops} pairs stop at another iteration, on a plateau")
    return err


def _check_tail(what: str, ker, pts, valid, count, img, li) -> None:
    """A level's all-point tail bitwise `residual_pass` at the returned
    pose (the launch it replaced): eps, visibility, energy, visible ratio."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import residual

    res = residual.residual_pass(ker.R, ker.t, pts, valid, img, *li, True, write_points=True)
    ratio = res[1].to(torch.float32) / torch.clamp(count, min=1).to(torch.float32)
    torch.cuda.synchronize()
    _require(_same_bits(ker.final_energy, res[0]) and torch.equal(ker.eps, res[2])
             and torch.equal(ker.visible, res[3]) and _same_bits(ker.visible_ratio, ratio),
             f"{what}: the all-point tail differs from residual_pass at the returned pose")


def _check_alone(what: str, fn, args: tuple, batched, p: int = 5) -> None:
    """Pair p launched alone (every batched argument cut to row p) is
    bitwise pair p of the batch: a pair's bits do not depend on B."""
    import torch

    b = args[0].shape[0]
    cut = tuple(x[p:p + 1] if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == b else x
                for x in args)
    one = fn(*cut)
    torch.cuda.synchronize()
    _require(all(_same_bits(x[p:p + 1], y) for x, y in zip(batched, one)),
             f"{what}: pair {p} alone differs from pair {p} of the batch of {b}")


def _forced_routes(rule, *shape) -> tuple:
    """The cluster sizes a level of this shape can be forced to."""
    out = []
    for c in (1, 2, 4, 8):
        try:
            rule(*shape, cluster=c)
        except ValueError:
            continue
        out.append(c)
    return tuple(out)


def check_level_lm(device, rng) -> dict:
    """Kernel 5 vs its plain version at the Gauss-Newton configurations'
    level shapes: the `dvo` defaults (standard LM on the normalized DT,
    capacities 8192/4096/2048/1024, 18/6/4/3 iterations), production_320
    (deferred accept, pixel-unit windowed DT, 2048/1024/512/512) and
    production_vga (the same at 640x480 over 5 levels, 4096/2048/1024/512/512,
    4/18/6/4/3), each on 64 rendered pairs and on one, at every level from
    the identity, one level a launch (`level_lm`, a pyramid of one). The
    CPU tests' bars against the plain version on the rule's route
    (`level_ranks`) and on every cluster size the level can be forced to
    (1, 2, 4, 8 blocks a pair), the rule's own bitwise the route it takes;
    iteration 0's energy equal to `fused_gn_terms`' at the start pose (1e-6
    relative); a second launch bitwise equal; pair 5 alone bitwise pair 5
    of the 64; the diagnostics: where they are not the best iterate's own
    (deferred, or a Jacobian stride > 1) the all-point tail's eps,
    visibility, energy and visible ratio bitwise those of `residual_pass`
    at the returned pose on every route, else the best iterate's energy.
    Then every level of each configuration in one `level_lm_pyramid`
    launch, bitwise the levels launched one by one, each from the pose the
    one before returned. CUDA-event times per level of the kernel on each
    route, the per-iteration route it replaced, the plain version and that
    `residual_pass`, and of the pyramid launch beside the chained ones."""
    import torch

    from rgbd_odometry_tpu_torch import PipelineConfig, SolverConfig, profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import fused_iter, level_lm, residual
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    prof, vga = profiles.production_320(), profiles.production_vga()
    configs = {
        "dvo": (SolverConfig(method="gauss_newton", iterations=(18, 6, 4, 3)),
                PipelineConfig().pyramid.max_points, prof),
        "production_320": (prof.solver, prof.max_points, prof),
        "production_vga": (vga.solver, vga.max_points, vga),
    }
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    worst, worst_by, summary, pyramids = 0.0, {}, {}, {}
    for name, (cfg, max_points, shapes) in configs.items():
        rg, rd, ng, nd, _ = render_batch(shapes.camera, BATCH)
        n_lv = shapes.num_levels
        ref_pyr, now_pyr = build_pyramid(f(rg), f(rd), n_lv), build_pyramid(f(ng), f(nd), n_lv)
        intr = Intrinsics.from_config(shapes.camera)
        refs = edge_dvo.extract_ref_features(ref_pyr.gray, ref_pyr.depth, intr, cfg, max_points)
        nows = edge_dvo.prepare_now_targets(now_pyr.gray, cfg)
        if name == "dvo":
            dvo_inputs = (refs, now_pyr, intr)
        deferred = cfg.lm_deferred_accept
        for b in (BATCH, 1):
            table = []
            for lvl in range(n_lv - 1, -1, -1):
                ref, now = refs[lvl], nows[lvl]
                pts, valid, count = ref.pts3d[:b], ref.valid[:b], ref.count[:b]
                img, scale = now.chans[:b, 0], now.scale[:b]
                li, n_iters = intr.at_level(lvl), cfg.iterations[lvl]
                k_all = pts.shape[1]
                jstride, stride = edge_dvo.level_strides(cfg, k_all)
                table.append(level_lm.LmLevel(pts, valid, count, img, scale, *li, n_iters,
                                              jstride, stride))
                R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
                t0 = torch.zeros((b, 3), device=device)
                args = (R0, t0, pts, valid, count, img, scale, *li, cfg, n_iters, jstride, stride)
                ranks = level_lm.level_ranks(k_all, jstride, stride, deferred)
                ker = level_lm.level_lm(*args)
                again = level_lm.level_lm(*args)
                pl = level_lm.level_lm_plain(*args)
                pj, vj = pts[:, ::jstride].contiguous(), valid[:, ::jstride].contiguous()
                e0 = fused_iter.fused_gn_terms(R0, t0, pj, vj, img, *li, cfg.gn_weight_sigma2_px,
                                               scale)[2]
                torch.cuda.synchronize()
                what = f"level_lm {name} B={b} level {lvl}"
                _require(all(_same_bits(a, c) for a, c in zip(ker, again)), f"{what}: runs differ")
                _require(bool(torch.isfinite(ker.R).all() and torch.isfinite(ker.t).all()),
                         f"{what}: non-finite pose")
                rel0 = _rel(ker.energy[:, :1], e0[:, None])
                _require(rel0 <= 1e-6, f"{what}: iteration 0 energy vs fused_gn_terms {rel0:.2e}")
                err = _check_level_curves(what, cfg, ker, pl)
                tail = deferred or jstride > 1
                r_args = (ker.R, ker.t, pts, valid, img, *li, True)
                if tail:
                    _check_tail(what, ker, pts, valid, count, img, li)
                    res_ms = _time_ms(lambda: residual.residual_pass(*r_args, write_points=True), 20)
                else:
                    _require(_same_bits(ker.final_energy, ker.best_energy),
                             f"{what}: the diagnostics' energy is not the best iterate's")
                    res_ms = float("nan")
                if b == BATCH:
                    _check_alone(what, level_lm.level_lm, args, ker)
                # every route the level can take, forced
                by_c = {}
                for c in _forced_routes(level_lm.level_ranks, k_all, jstride, stride, deferred):
                    kc = level_lm.level_lm(*args, cluster=c)
                    torch.cuda.synchronize()
                    if c == ranks:
                        _require(all(_same_bits(a, x) for a, x in zip(ker, kc)),
                                 f"{what}: forced to c={c}, the rule's route, it differs")
                    else:
                        err = max(err, _check_level_curves(f"{what} c={c}", cfg, kc, pl))
                        if tail:
                            _check_tail(f"{what} c={c}", kc, pts, valid, count, img, li)
                    by_c[c] = _time_ms(lambda: level_lm.level_lm(*args, cluster=c), 20)
                worst = max(worst, err)
                worst_by[name] = max(worst_by.get(name, 0.0), err)
                k_ms = _time_ms(lambda: level_lm.level_lm(*args), 20)
                with _per_iteration_route():
                    r_ms = _time_ms(lambda: level_lm.level_lm_plain(*args), 3)
                p_ms = _time_ms(lambda: level_lm.level_lm_plain(*args), 2)
                k_jac = pj.shape[1]
                ran = (ker.energy != 0).sum(-1)
                n_valid = vj.sum(-1)
                passes = OPS_GN_POINT + (0 if deferred else
                                         OPS_RESIDUAL_POINT * (2 if stride > 1 else 1) / stride)
                flops = float((ran * n_valid).sum()) * passes + float(ran.sum()) * OPS_LM_STEP + (
                    float(valid.sum()) * OPS_RESIDUAL_POINT if tail else 0.0)
                # the points (all K with the tail, else the Jacobian subset)
                # and their sampled DT corners, pose, count and scale in; pose,
                # curve, best iteration, energy and the diagnostics out
                hw = img.shape[1] * img.shape[2]
                k_read = k_all if tail else k_jac
                nbytes = b * (k_read * 13 + min(hw, 4 * k_read) * 2 + 56 + 56 + 4 * n_iters
                              + k_all * 5 + 8)
                bound = _bound(nbytes, flops)
                _log(f"{what} (jstride {jstride}, stride {stride}, {k_jac} points, {n_iters} "
                     f"iterations, {int(ran.sum())} run, diagnostics "
                     f"{'by the all-point tail' if tail else 'of the best iterate'}, rule c="
                     f"{ranks}): pose err {err:.2e}, runs bitwise equal"
                     f"{', the tail bitwise residual_pass' if tail else ''}; level_lm "
                     f"{k_ms:.4f} ms (forced "
                     + ", ".join(f"c={c}: {t:.4f}" for c, t in by_c.items())
                     + f"), per-iteration kernels {r_ms:.4f} ms, plain {p_ms:.4f} ms, "
                     f"residual_pass at the returned pose {res_ms:.4f} ms; bound "
                     f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']})")
                if lvl == 0:
                    summary[(name, b)] = {"ms": k_ms, "plain_ms": p_ms, **bound,
                                          "cluster": ranks,
                                          "cluster_ms": {str(c): t for c, t in by_c.items()}}
            # the whole pyramid in one launch against the levels one by one
            R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
            t0 = torch.zeros((b, 3), device=device)
            pyr = level_lm.level_lm_pyramid(R0, t0, table, cfg)

            def chained():
                R, t, outs = R0, t0, []
                for lv in table:
                    o = level_lm.level_lm(R, t, *lv[:9], cfg, *lv[9:12], grads=lv.grads)
                    outs.append(o)
                    R, t = o.R, o.t
                return outs

            one_by_one = chained()
            torch.cuda.synchronize()
            for lv, x, y in zip(range(n_lv - 1, -1, -1), pyr, one_by_one):
                _require(all(_same_bits(a, c) for a, c in zip(x, y)),
                         f"level_lm {name} B={b}: level {lv} of the pyramid launch differs from "
                         "its own launch")
            pyr_ms = _time_ms(lambda: level_lm.level_lm_pyramid(R0, t0, table, cfg), 20)
            chain_ms = _time_ms(chained, 20)
            pyramids[f"{name} B={b}"] = {"ms": pyr_ms, "levels_one_by_one_ms": chain_ms}
            _log(f"level_lm {name} B={b}: the {n_lv}-level pyramid in one launch bitwise the "
                 f"levels one by one; {pyr_ms:.4f} ms against {chain_ms:.4f} ms")
    parity = _check_parity_lm(device, *dvo_inputs, (BATCH, 1))
    return {"max_abs_err": max(worst, parity["max_abs_err"]), **summary[("dvo", BATCH)],
            "pyramid": pyramids, "parity": parity["variants"],
            "vga": {"shape": "production_vga level 0 (jstride 8, 512 + 4096 points, 4 "
                             "iterations, 480x640), B=64",
                    "max_abs_err": worst_by["production_vga"],
                    **summary[("production_vga", BATCH)], "b1": summary[("production_vga", 1)]}}


def se3_log_poses(rng):
    """Poses (R (n,3,3), t (n,3), CPU float32) over every branch of
    `se3_log`: rotations of ~1 and ~0.3 rad (generic), ~3e-2 (generic log,
    Taylor V^-1), 3e-4 and 1e-6 (Taylor log), pi - [0, 1.5e-3] (the near-pi
    branch and the generic one beside it) and the identity; every second
    pose carries 1e-7 of noise, as a composed pose is not exactly orthogonal."""
    import torch

    from rgbd_odometry_tpu_torch.core.geometry import se3_exp

    n = 4096
    psis = [rng.standard_normal((n, 6)) * s for s in (1.0, 0.3, 3e-2, 3e-4, 1e-6)]
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.pi - rng.uniform(0, 1.5e-3, n)
    psis.append(np.concatenate([rng.standard_normal((n, 3)) * 0.3, axis * theta[:, None]], 1))
    psis.append(np.zeros((4, 6)))
    R, t = se3_exp(torch.from_numpy(np.concatenate(psis).astype(np.float32)))
    noise = torch.from_numpy(rng.standard_normal(tuple(R.shape)).astype(np.float32))
    return R + 1e-7 * noise * (torch.arange(len(R)) % 2)[:, None, None], t


def _check_se3_log(device, rng) -> None:
    """The step's device function `warp_se3_log` (`csrc/warp.cuh`), one
    warp a pose, against its plain twin `kernels/se3_plain.se3_log` evaluated on the CPU
    (IEEE operations; the card's PyTorch divides by a constant through its
    reciprocal): at least 1000 poses in each of so3_log's three branches and
    on both sides of V^-1's threshold; every element within 1e-6 of the
    twin's, relative to max(1, |twin|) (the two double-precision arccos, sin
    and cos may round apart once in many poses; the rest is bitwise)."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import level_sg, se3_plain

    R, t = se3_log_poses(rng)
    twin = se3_plain.from_rows(se3_plain.se3_log(se3_plain.to_rows(R), se3_plain.to_rows(t)))
    dev = level_sg.se3_log_device(R.to(device), t.to(device))
    again = level_sg.se3_log_device(R.to(device), t.to(device))
    torch.cuda.synchronize()
    _require(_same_bits(dev, again), "se3_log: runs differ")
    dev = dev.cpu()
    cos = torch.clamp((R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    theta2 = (twin[:, 3:] ** 2).sum(-1)
    branches = {"taylor": int((cos > 1.0 - 1e-6).sum()), "near_pi": int((cos < -(1.0 - 5e-7)).sum()),
                "generic": int(((cos <= 1.0 - 1e-6) & (cos >= -(1.0 - 5e-7))).sum()),
                "vinv_taylor": int((theta2 < 1e-3).sum()), "vinv_generic": int((theta2 >= 1e-3).sum())}
    _require(min(branches.values()) >= 1000, f"se3_log: a branch is hardly exercised: {branches}")
    _require(bool(torch.isfinite(dev).all()), "se3_log: non-finite twist")
    err = float(((dev - twin).abs() / twin.abs().clamp(min=1.0)).max())
    differ = int((dev != twin).any(1).sum())
    _log(f"se3_log device function vs twin: {len(R)} poses, branches {branches}, {differ} poses "
         f"not bitwise equal, max error {err:.2e}, runs bitwise equal")
    _require(err <= 1e-6, f"se3_log: error {err:.2e} > 1e-6")


def check_se3_log(device, rng) -> None:
    """`_check_se3_log` with torch's CPU work held to one thread: its twin
    runs on CPU tensors, and a first parallel CPU op would start the main
    thread's intra-op pool, which then competes with the frame feeder's
    worker in the path phases (cli_default read 4.8-5.6 ms/frame instead of
    1.7-3.2 after an unguarded check)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_se3_log(device, rng)
    finally:
        torch.set_num_threads(threads)


def _check_sg_steps(what: str, cfg, args, ker, trace, terms=None) -> float:
    """Every iteration of a `level_sg` launch held on its own, from the
    launch's trace (the pose entering each iteration and its g): the
    sub-gradient descent revisits poses and does not contract, so two free
    runs may part for good at one floor decision, but a single step cannot.
    At every pose of the trace, against the `subgradient_terms` kernel there:
    energy within 1e-5 relative, g within 1e-4 of its largest element. From
    the trace's pose and g, the plain step (`subgradient_step`, se3_exp,
    compose, Newton-Schulz) must give the trace's next pose within 1e-6, and
    a norm on the right side of the termination norm (0.1% slack) where the
    pair stops or goes on. The result is the curve's last minimum exactly
    (<=, later ties win), its energy, and that trace pose, re-orthogonalized,
    within 1e-6. `terms` replaces `subgradient_terms` (a reference-parity
    configuration: its plain point terms on the card); the steps
    re-orthogonalize as `cfg` does (`level_lm.rotationize`: Newton-Schulz
    or the device SVD's twin). Returns the largest one-step pose
    difference."""
    import torch

    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.kernels import level_lm, level_sg, sg_terms

    R0, t0, pts, valid, count, dt, fx, fy, cx, cy, _, n_iters = args
    b, dev = R0.shape[0], R0.device
    ran = (ker.energy != 0).sum(-1)
    precond = torch.tensor([1.0] * 3 + [cfg.precondition_rot] * 3, device=dev)
    descent = torch.zeros((b, 6), device=dev)
    e_err = g_err = step_err = 0.0
    for i in range(n_iters):
        live = ran > i
        if not bool(live.any()):
            break
        R, t, g = trace[:, i, :9].reshape(b, 3, 3), trace[:, i, 9:12], trace[:, i, 12:]
        at = (terms or sg_terms.subgradient_terms)(R.contiguous(), t.contiguous(), pts, valid, dt,
                                                   fx, fy, cx, cy, cfg.weight_sigma2)
        e_err = max(e_err, _rel(ker.energy[live, i, None], at[1][live, None]))
        g_err = max(g_err, _rel(g[live], at[0][live]))
        psi, descent = level_sg.subgradient_step(R, t, g, descent, i, cfg, precond)
        norm = torch.linalg.vector_norm(psi, dim=-1)
        stops = live & (ran == i + 1) & (i + 1 < n_iters)
        goes = ran > i + 1
        _require(bool((norm[stops] < cfg.psi_norm_termination * 1.001).all())
                 and bool((norm[goes] > cfg.psi_norm_termination * 0.999).all()),
                 f"{what}: iteration {i}: a pair stops or goes on against its step's norm")
        if bool(goes.any()):
            xR, xt = geo.se3_exp(psi)
            nR, nt = geo.compose(R, t, xR, xt)
            nR = level_lm.rotationize(nR, cfg)
            nxt = torch.cat([nR.reshape(b, 9), nt], -1)
            step_err = max(step_err, float((nxt - trace[:, i + 1, :12])[goes].abs().max()))
    _require(e_err <= 1e-5 and g_err <= 1e-4,
             f"{what}: a pass differs from subgradient_terms at its pose: energy {e_err:.2e}, "
             f"g {g_err:.2e}")
    _require(step_err <= 1e-6, f"{what}: a step differs from the plain step by {step_err:.2e}")
    # the best iterate, from the launch's own curve
    e = torch.where(ker.energy != 0, ker.energy, torch.full_like(ker.energy, float("inf")))
    best = (n_iters - 1 - torch.argmin(e.flip(-1), dim=-1)).to(torch.int32)
    rows = torch.arange(b, device=dev)
    _require(torch.equal(best, ker.best_iter), f"{what}: the best iteration is not the curve's "
                                               "last minimum")
    _require(torch.equal(ker.best_energy, ker.energy[rows, best.long()]),
             f"{what}: the best energy is not the curve's minimum")
    at_best = trace[rows, best.long()]
    bR = at_best[:, :9].reshape(b, 3, 3)
    if cfg.rotationize:
        bR = level_lm.rotationize(bR, cfg)
        best_err = max(float((ker.R - bR).abs().max()), float((ker.t - at_best[:, 9:12]).abs().max()))
        _require(best_err <= 1e-6, f"{what}: the result is not the best iterate ({best_err:.2e})")
    else:
        _require(torch.equal(ker.R, bR) and torch.equal(ker.t, at_best[:, 9:12]),
                 f"{what}: the result is not the best iterate, bit for bit")
    _log(f"  {what}: every step alone: energy {e_err:.2e}, g {g_err:.2e} against "
         f"subgradient_terms, next pose {step_err:.2e} against the plain step; best iterate "
         f"is the curve's last minimum")
    return step_err


def _check_sg_curves(what: str, ker, pl) -> tuple:
    """The free-running kernel against the free-running plain version, pair
    by pair. The two part where a floor decision falls differently (a point
    within an ulp of a pixel boundary) and then descend apart, so: iteration
    0 within 1e-5; at the first iteration where the energies are more than
    1e-5 apart they are less than 5e-2 apart (a few points' DT values, not
    another computation); both stop at the same iteration unless they
    parted; for the pairs that never part the best iteration is equal or
    ties to 1e-5, and where it is equal the poses agree within 1e-5 and the
    visible ratios within 1e-6. Returns (the pairs that never part and share
    the best iteration, as a mask; the largest pose difference among them;
    the number of pairs that never part, which a caller with a population
    of pairs holds to a share)."""
    import torch

    e_k, e_p = ker.energy.cpu().numpy(), pl.energy.cpu().numpy()
    n_k, n_p = (e_k != 0).sum(1), (e_p != 0).sum(1)
    head = np.arange(e_k.shape[1])[None, :] < np.minimum(n_k, n_p)[:, None]
    rel = np.where(head, np.abs(e_k - e_p) / np.maximum(np.abs(e_p), 1e-30), 0.0)
    apart = rel > 1e-5
    parted = apart.any(1)
    first = np.where(parted, apart.argmax(1), 0)
    rows = np.arange(len(first))
    bk, bp = ker.best_iter.cpu().numpy(), pl.best_iter.cpu().numpy()
    together = ~parted
    same = together & (bk == bp)
    mask = torch.from_numpy(same).to(ker.R.device)
    err = 0.0
    if same.any():
        err = max(float((ker.R - pl.R)[mask].abs().max()),
                  float((ker.t - pl.t)[mask].abs().max()))
    bad = []
    if rel[:, 0].max() > 1e-5:
        bad.append(f"iteration 0 differs by {rel[:, 0].max():.2e}")
    if (rel[rows, first][parted] > 5e-2).any():
        bad.append(f"a pair parts by {rel[rows, first][parted].max():.2e}")
    if (n_k != n_p)[together].any():
        bad.append("a pair that never parts stops at another iteration")
    if (np.abs(e_p[rows, bk] - e_p[rows, bp]) > 1e-5 * e_p[rows, bp])[together].any():
        bad.append("best iterations differ off a tie")
    if same.any() and float((ker.visible_ratio - pl.visible_ratio)[mask].abs().max()) > 1e-6:
        bad.append("visible ratios differ")
    if err > 1e-5:
        bad.append(f"pose error {err:.2e} > 1e-5")
    if bad:
        for i in np.nonzero(parted | (bk != bp) | (n_k != n_p))[0][:3]:
            _log(f"  {what} pair {i}: kernel {e_k[i].tolist()} best {bk[i]}; "
                 f"plain {e_p[i].tolist()} best {bp[i]}")
    _require(not bad, f"{what}: " + "; ".join(bad))
    gaps = rel[rows, first][parted]
    _log(f"  {what}: against the free-running plain version {int(parted.sum())} of {len(rows)} "
         f"pairs part (first at iteration {int(first[parted].min()) if parted.any() else -1}, "
         f"by at most {gaps.max() if parted.any() else 0.0:.2e}); the others within "
         f"{rel[together].max() if together.any() else 0.0:.2e}, "
         f"{int((together & (bk != bp)).sum())} best iterations on a "
         f"tie, pose err {err:.2e}")
    return mask, err, int(together.sum())


def check_level_sg(device, rng) -> dict:
    """Kernel 8 on 64 rendered pairs and on one, at the four parity
    capacities (8192/4096/2048/1024 points at 240x320 ... 30x40), 50
    iterations from the identity, under `SolverConfig()` (the reference's
    sub-gradient: L2 pull, re-orthogonalization; every step there is cut to
    the trust region); at K = 4096 also without the pull, without the
    re-orthogonalization and with a step length (1e-6) and a termination
    norm (1e-4) at which steps lie inside the trust region and pairs finish
    early at different iterations. A second launch bitwise equal, and equal
    with and without the trace; every iteration on its own against
    `subgradient_terms` and the plain step (`_check_sg_steps`; iteration 0 is
    the start pose); the free-running plain version within the bars of
    `_check_sg_curves`, under `SolverConfig()` also on every cluster size
    the level can be forced to (1, 2, 4, 8 blocks a pair; the rule's
    `level_ranks` bitwise the route it takes), and pair 5 alone bitwise
    pair 5 of the 64; the returned per-point values consistent with the
    best iterate (|eps| equal to the best energy within 1e-5, the visible
    share equal to the visible ratio), bitwise those of `subgradient_terms`
    at the returned pose when it is not re-orthogonalized, and bitwise the
    plain version's on at least 99.9% of the points of the pairs that never
    part from it. Then the four levels in one `level_sg_pyramid` launch,
    bitwise the levels launched one by one. CUDA-event times per level of
    the kernel on each route and at each block size, of the per-iteration
    route it replaced and of the plain version, and of the pyramid launch
    beside the chained ones."""
    import dataclasses

    import torch

    from rgbd_odometry_tpu_torch import PipelineConfig, SolverConfig, profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import level_sg, sg_terms
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    check_se3_log(device, rng)
    svd = check_rotationize_svd(device, rng)
    cam = profiles.production_320().camera
    base = SolverConfig()
    _require(base.method == "subgradient" and base.iterations == (50, 50, 50, 50),
             "level_sg: SolverConfig() is not the reference's sub-gradient")
    variants = {
        "": base,
        " no pull": dataclasses.replace(base, enable_l2_regularization=False),
        " no rotationize": dataclasses.replace(base, rotationize=False),
        " early stop": dataclasses.replace(base, step_length=1e-6, psi_norm_termination=1e-4),
    }
    rg, rd, ng, nd, _ = render_batch(cam, BATCH)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    ref_pyr, now_pyr = build_pyramid(f(rg), f(rd), 4), build_pyramid(f(ng), f(nd), 4)
    intr = Intrinsics.from_config(cam)
    refs = edge_dvo.extract_ref_features(ref_pyr.gray, ref_pyr.depth, intr, base,
                                         PipelineConfig().pyramid.max_points)
    nows = edge_dvo.prepare_now_targets(now_pyr.gray, base)
    worst, summary, pyramids = 0.0, None, {}
    for b in (BATCH, 1):
        table = []
        for lvl in range(3, -1, -1):
            ref, now = refs[lvl], nows[lvl]
            pts, valid, count, dt = ref.pts3d[:b], ref.valid[:b], ref.count[:b], now.dt[:b]
            k, (h, w) = pts.shape[1], dt.shape[1:]
            _require((k, (h, w)) == (SG_KS[3 - lvl], EDT_SHAPES[lvl]), "level_sg: level shape")
            li = intr.at_level(lvl)
            R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
            t0 = torch.zeros((b, 3), device=device)
            for tag, cfg in variants.items():
                if tag and (lvl != 1 or b != BATCH):
                    continue
                n_iters = cfg.iterations[lvl]
                args = (R0, t0, pts, valid, count, dt, *li, cfg, n_iters)
                if not tag:
                    table.append(level_sg.SgLevel(pts, valid, count, dt, *li, n_iters))
                trace = torch.zeros((b, n_iters, 18), device=device)
                ker = level_sg.level_sg(*args, trace=trace)
                again = level_sg.level_sg(*args)
                pl = level_sg.level_sg_plain(*args)
                torch.cuda.synchronize()
                what = f"level_sg B={b} level {lvl} K={k}{tag}"
                _require(all(_same_bits(a, c) for a, c in zip(ker, again)), f"{what}: runs differ")
                _require(bool(torch.isfinite(ker.R).all() and torch.isfinite(ker.t).all()),
                         f"{what}: non-finite pose")
                _require(torch.equal(trace[:, 0, :9].reshape(b, 3, 3), R0)
                         and torch.equal(trace[:, 0, 9:12], t0), f"{what}: iteration 0's pose")
                worst = max(worst, _check_sg_steps(what, cfg, args, ker, trace))
                together, err, never = _check_sg_curves(what, ker, pl)
                _require(2 * never >= b, f"{what}: only {never} pairs never part")
                worst = max(worst, err)
                ran = (ker.energy != 0).sum(-1)
                if "early" in tag:
                    _require(int(ran.max()) < n_iters and len(set(ran.tolist())) > 1,
                             f"{what}: pairs do not finish early at different iterations")
                # the returned per-point values belong to the best iterate
                e_pts = torch.sqrt((ker.eps * ker.eps).sum(-1))
                _require(_rel(e_pts[:, None], ker.best_energy[:, None]) <= 1e-5,
                         f"{what}: |eps| is not the best energy")
                share = ker.visible.sum(-1).float() / count.clamp(min=1).float()
                _require(float((share - ker.visible_ratio).abs().max()) <= 1e-6,
                         f"{what}: the visible share is not the visible ratio")
                _require(not bool((ker.visible & ~valid).any()), f"{what}: an invalid point is visible")
                if not cfg.rotationize:
                    at = sg_terms.subgradient_terms(ker.R, ker.t, pts, valid, dt, *li,
                                                    cfg.weight_sigma2)
                    _require(torch.equal(ker.eps, at[3]) and torch.equal(ker.visible, at[4]),
                             f"{what}: per-point values differ from subgradient_terms at the "
                             "returned pose")
                differ = ((ker.eps != pl.eps) | (ker.visible != pl.visible))[together]
                frac = float(differ.float().mean()) if differ.numel() else 0.0
                _require(frac <= 1e-3, f"{what}: {frac:.3%} of the per-point values differ from "
                                       "the plain version's")
                ranks, by_c = level_sg.level_ranks(k), {}
                if not tag:
                    if b == BATCH:
                        _check_alone(what, level_sg.level_sg, args, ker)
                    # every route the level can take, forced
                    for c in _forced_routes(level_sg.level_ranks, k):
                        trace_c = torch.zeros((b, n_iters, 18), device=device)
                        kc = level_sg.level_sg(*args, trace=trace_c, cluster=c)
                        torch.cuda.synchronize()
                        if c == ranks:
                            _require(all(_same_bits(a, x) for a, x in zip(ker, kc)),
                                     f"{what}: forced to c={c}, the rule's route, it differs")
                        else:
                            worst = max(worst, _check_sg_steps(f"{what} c={c}", cfg, args, kc,
                                                               trace_c))
                            _, err_c, never_c = _check_sg_curves(f"{what} c={c}", kc, pl)
                            _require(2 * never_c >= b, f"{what} c={c}: only {never_c} pairs "
                                                       "never part")
                            worst = max(worst, err_c)
                        by_c[c] = _time_ms(lambda: level_sg.level_sg(*args, cluster=c), 10)
                by_threads = {n: _time_ms(lambda: level_sg.level_sg(*args, threads=n), 10)
                              for n in level_sg.THREADS}
                k_ms = _time_ms(lambda: level_sg.level_sg(*args), 20)
                with _per_iteration_sg_route():
                    r_ms = _time_ms(lambda: level_sg.level_sg_plain(*args), 2)
                p_ms = _time_ms(lambda: level_sg.level_sg_plain(*args), 2)
                # points, the sampled DT, start pose and count in; pose, curve, best
                # iteration, energy, ratio and the per-point values out
                n_vis = ker.visible.sum(-1)
                nbytes = b * (k * 13 + 52 + 60 + 4 * n_iters + 5 * k) + _sampled_bytes(
                    n_vis * ran, h * w, 5, 4)
                flops = float((ran * n_vis).sum()) * OPS_SG_POINT + float(ran.sum()) * OPS_SG_STEP
                bound = _bound(nbytes, flops)
                _log(f"{what} ({n_iters} iterations, {int(ran.sum())} run, best iterations "
                     f"{int(ker.best_iter.min())}..{int(ker.best_iter.max())}, "
                     f"{frac:.4%} of per-point values differ): runs bitwise equal; level_sg "
                     f"{k_ms:.4f} ms (rule c={ranks}, {level_sg.block_threads(k)} threads a "
                     "pair; forced " + ", ".join(f"c={c}: {t:.4f}" for c, t in by_c.items())
                     + "; by threads " + ", ".join(f"{n}: {t:.4f}" for n, t in by_threads.items())
                     + f"), per-iteration kernel {r_ms:.4f} ms, plain {p_ms:.4f} ms; bound "
                     f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']})")
                if not tag and b == BATCH and lvl == 0:
                    summary = {"ms": k_ms, "plain_ms": p_ms, **bound, "cluster": ranks,
                               "cluster_ms": {str(c): t for c, t in by_c.items()}}
        # the whole pyramid in one launch against the levels one by one
        R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
        t0 = torch.zeros((b, 3), device=device)
        pyr = level_sg.level_sg_pyramid(R0, t0, table, base)

        def chained():
            R, t, outs = R0, t0, []
            for lv in table:
                o = level_sg.level_sg(R, t, *lv[:8], base, lv.n_iters)
                outs.append(o)
                R, t = o.R, o.t
            return outs

        one_by_one = chained()
        torch.cuda.synchronize()
        for lv, x, y in zip(range(3, -1, -1), pyr, one_by_one):
            _require(all(_same_bits(a, c) for a, c in zip(x, y)),
                     f"level_sg B={b}: level {lv} of the pyramid launch differs from its own "
                     "launch")
        pyr_ms = _time_ms(lambda: level_sg.level_sg_pyramid(R0, t0, table, base), 10)
        chain_ms = _time_ms(chained, 10)
        pyramids[f"cli_subgradient B={b}"] = {"ms": pyr_ms, "levels_one_by_one_ms": chain_ms}
        _log(f"level_sg B={b}: the 4-level pyramid in one launch bitwise the levels one by one; "
             f"{pyr_ms:.4f} ms against {chain_ms:.4f} ms")
    parity = _check_parity_sg(device, refs, now_pyr, intr, (BATCH, 1))
    return {"max_abs_err": max(worst, parity["max_abs_err"]), **summary, "pyramid": pyramids,
            "parity": parity["variants"], "rotationize_svd": svd}


def check_rotationize_svd(device, rng) -> dict:
    """The step's SVD projection `lane_rotationize_svd` (`csrc/warp.cuh`,
    one warp a matrix) bitwise its twin `kernels/se3_plain.rotationize_svd`
    on the CPU (float64 operations, each correctly rounded on both): 4096
    composed near-rotations (the solver's inputs), 1024 of them with 1e-3
    of noise, 1024 reflections, 1024 Gaussian matrices, a rank-2 matrix and
    the zero matrix; and within 1e-6 of `core/geometry.rotationize_svd`
    (`torch.linalg.svd`) on the near-rotations. Its cycles on the step are
    `profile_paths.py --paths solve`'s."""
    import torch

    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.kernels import level_sg, se3_plain

    psi = torch.from_numpy(rng.standard_normal((4096, 6)).astype(np.float32))
    R, _ = geo.se3_exp(psi * 0.5)
    xR, _ = geo.se3_exp(psi.roll(1, 0) * 3e-3)
    near = R @ xR
    noise = rng.standard_normal((1024, 3, 3)).astype(np.float32)
    noisy = near[:1024] + torch.from_numpy(noise) * 1e-3
    refl = near[:1024] * torch.tensor([1.0, 1.0, -1.0])
    gauss = torch.from_numpy(rng.standard_normal((1024, 3, 3)).astype(np.float32))
    rank2 = torch.from_numpy((np.outer([1.0, 2.0, 3.0], [0.5, -1.0, 0.25])
                              + np.outer([0.0, 1.0, 0.0], [1.0, 0.0, 0.0])).astype(np.float32))
    A = torch.cat([near, noisy, refl, gauss, rank2[None], torch.zeros(1, 3, 3)])
    twin = se3_plain.from_rows(se3_plain.rotationize_svd(se3_plain.to_rows(A)))
    dev = level_sg.rotationize_svd_device(A.to(device))
    again = level_sg.rotationize_svd_device(A.to(device))
    torch.cuda.synchronize()
    _require(_same_bits(dev, again), "rotationize_svd: runs differ")
    dev = dev.cpu()
    differ = int((dev != twin).any(-1).any(-1).sum())
    lapack = float((twin[:4096] - geo.rotationize_svd(near)).abs().max())
    _log(f"rotationize_svd device function vs twin: {len(A)} matrices, {differ} not bitwise "
         f"equal, max {float((dev - twin).abs().max()):.2e}; the twin within {lapack:.2e} of "
         "torch.linalg.svd's on the near-rotations")
    _require(differ == 0, f"rotationize_svd: {differ} matrices differ from the twin")
    _require(lapack <= 1e-6, f"rotationize_svd: {lapack:.2e} from torch.linalg.svd's")
    return {"matrices": len(A), "max_abs_err": float((dev - twin).abs().max()),
            "lapack_err": lapack}


def _parity_lm_variants():
    """Gauss-Newton reference-parity configurations of `level_lm`
    (`point_sem.parity`), each on the `dvo` defaults' standard LM (18/6/4/3
    iterations, the normal equations on every 4th point, the all-point
    tail): the Gauss-Newton families of `point_sem.PARITY_FAMILIES`, the
    reference Jacobian on the bf16 channels too, float32 channels with
    interpolant gradients, and two on the deferred accept."""
    from rgbd_odometry_tpu_torch import SolverConfig
    from rgbd_odometry_tpu_torch.kernels import point_sem

    gn = SolverConfig(method="gauss_newton", iterations=(18, 6, 4, 3))
    rep = dataclasses.replace
    fams = point_sem.parity_families(SolverConfig(), gn)
    return {
        **{name: cfg for name, (cfg, _) in fams.items() if cfg.method == "gauss_newton"},
        "gn_take_deferred": rep(gn, gather_mode="take", lm_deferred_accept=True),
        "gn_channels_bf16_deferred": rep(gn, gn_gradient_mode="channels",
                                         lm_deferred_accept=True),
        "gn_interpolant_float32": rep(gn, gather_dtype="float32"),
        "gn_reference_jacobian_mxu": rep(gn, jacobian_mode="reference"),
    }


def _parity_sg_variants():
    """The sub-gradient families of `point_sem.PARITY_FAMILIES` on the
    reference's `SolverConfig()` (50 iterations a level)."""
    from rgbd_odometry_tpu_torch import SolverConfig
    from rgbd_odometry_tpu_torch.kernels import point_sem

    fams = point_sem.parity_families(SolverConfig(), SolverConfig(method="gauss_newton"))
    return {name: cfg for name, (cfg, _) in fams.items() if cfg.method == "subgradient"}


# at most one pair in this many may part from the plain twin: the reference
# Jacobian's (measured 9 of 64 at the `dvo` defaults' level 0 with bf16
# gathers, 2 of 64 with "take"; 12 of 64 allowed), the textbook Jacobian's
PARITY_LM_PARTED_REFERENCE = 5
PARITY_LM_PARTED = 16
# where a parting pair first parts, its energy gap (measured <= 1.19e-4)
PARITY_LM_FIRST_GAP = 1e-3
# the first step's direction against the plain normal equations (measured
# <= 2.3e-5 with the plain twin's own step on the CPU; one column of the
# reference Jacobian negated gives 0.088-0.35)
PARITY_LM_STEP = 1e-2


def _parity_lm_curves(what: str, cfg, ker, pl) -> float:
    """A reference-parity `level_lm` launch against its free-running plain
    twin: `_check_level_curves`' bars on the pairs that do not part, where
    a pair parts when its energies leave those bars. The reference
    Jacobian's normal equations are ill-conditioned (the translation block
    scaled by each point's depth), so the last bits of two sum orders can
    send a pair's damped step elsewhere after the first iteration; a pair
    that parts must start within 1e-5 (iteration 0) and part by less than
    `PARITY_LM_FIRST_GAP` where it first parts by more than 1e-5 (the same
    function, rounded otherwise), and at most one pair in
    `PARITY_LM_PARTED_REFERENCE` may part (with the textbook Jacobian one in
    `PARITY_LM_PARTED`). The first step itself is held on its own
    (`_check_lm_first_step`). Returns the largest pose difference over the
    pairs that do not part."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import point_sem

    e_k, e_p = ker.energy.cpu().numpy(), pl.energy.cpu().numpy()
    n_k, n_p = (e_k != 0).sum(1), (e_p != 0).sum(1)
    head = np.arange(e_k.shape[1])[None, :] < np.minimum(n_k, n_p)[:, None]
    rel = np.where(head, np.abs(e_k - e_p) / np.maximum(np.abs(e_p), 1e-30), 0.0)
    rtol = 3e-3 if cfg.lm_deferred_accept else 1e-3
    parted = rel.max(1) > rtol
    b = len(parted)
    if parted.any():
        apart = rel > 1e-5
        first = apart.argmax(1)
        rows = np.nonzero(parted)[0]
        ref = point_sem.point_sem(cfg).reference
        cap = PARITY_LM_PARTED_REFERENCE if ref else PARITY_LM_PARTED
        _require(rel[rows, 0].max() <= 1e-5, f"{what}: a pair parts at its start pose")
        _require(rel[rows, first[rows]].max() < PARITY_LM_FIRST_GAP,
                 f"{what}: a pair parts by {rel[rows, first[rows]].max():.2e}")
        _require(int(parted.sum()) * cap <= max(b, cap),
                 f"{what}: {int(parted.sum())} of {b} pairs part from the plain twin")
        _log(f"  {what}: {int(parted.sum())} of {b} pairs part from the plain twin (first at "
             f"iteration {int(first[rows].min())}, by at most {rel[rows, first[rows]].max():.2e})")
    keep = torch.from_numpy(~parted).to(ker.R.device)
    if not bool(keep.any()):
        return 0.0
    return _check_level_curves(what, cfg, type(ker)(*(x[keep] for x in ker)),
                               type(pl)(*(x[keep] for x in pl)))


def _check_lm_first_step(what: str, cfg, args, grads, cluster=None) -> float:
    """A reference-parity `level_lm` launch's first step, from the identity,
    against the plain normal equations there: the launch at 2 iterations
    returns the proposal of iteration 0 (rotationized) where it was taken
    and scored best; its twist psi (`se3_log`, float64) must solve the
    plain damped system (H + lam0 diag(H)) psi = -g of the plain point
    terms (`fused_gn_terms_plain` under the configuration's semantics, on
    the card) in direction, the trust region scaling only its length:
    |A psi / |A psi| + g / |g|| within `PARITY_LM_STEP`. The kernel's H
    and g are never written out; a wrong Jacobian or weight turns this
    direction (the twin's own step measured <= 2.3e-5, on the CPU). Returns
    the largest direction error."""
    import torch

    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.kernels import fused_iter, level_lm, point_sem

    R0, t0, pts, valid, count, img, scale, fx, fy, cx, cy, _, _, js, st = args
    ker = level_lm.level_lm(R0, t0, pts, valid, count, img, scale, fx, fy, cx, cy, cfg, 2, js,
                            st, cluster=cluster, grads=grads)
    H, g, _, _ = fused_iter.fused_gn_terms_plain(
        R0, t0, pts[:, ::js], valid[:, ::js], img, fx, fy, cx, cy, cfg.gn_weight_sigma2_px, scale,
        sem=point_sem.point_sem(cfg), planes=(img, *grads))
    H, g = H.double(), g.double()
    A = H + cfg.lm_damping * torch.diag_embed(
        torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-8))
    moved = (ker.best_iter == 1) & (ker.t != t0).any(-1) & (g.norm(dim=-1) > 0)
    _require(bool(moved.any()) or R0.shape[0] == 1, f"{what}: no pair took its first step")
    if not bool(moved.any()):
        return 0.0
    psi = geo.se3_log(ker.R.double(), ker.t.double())
    Ap = (A @ psi[..., None])[..., 0]
    d = (Ap / Ap.norm(dim=-1, keepdim=True) + g / g.norm(dim=-1, keepdim=True)).norm(dim=-1)
    err = float(d[moved].max())
    _require(err <= PARITY_LM_STEP, f"{what}: the first step is {err:.2e} off the plain normal "
                                    f"equations' direction")
    return err


def _plain_tail(what, cfg, ker, pts, valid, count, img, li) -> None:
    """A reference-parity level's all-point tail at the returned pose
    against the plain point terms there, evaluated on the CPU: residuals
    and visibility bitwise, the visible ratio bitwise, the energy within
    1e-6 (the two sum in other orders)."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import point_sem
    from rgbd_odometry_tpu_torch.kernels.residual import residual_pass_plain

    e, n, eps, vis = residual_pass_plain(ker.R.cpu(), ker.t.cpu(), pts.cpu(), valid.cpu(),
                                         img.cpu(), *li, True, write_points=True,
                                         sem=point_sem.point_sem(cfg))
    ratio = n.float() / torch.clamp(count.cpu(), min=1).float()
    _require(torch.equal(ker.eps.cpu(), eps) and torch.equal(ker.visible.cpu(), vis)
             and _same_bits(ker.visible_ratio.cpu(), ratio),
             f"{what}: the all-point tail differs from the plain point terms at the returned "
             "pose")
    _require(_rel(ker.final_energy.cpu()[:, None], e[:, None]) <= 1e-6,
             f"{what}: the tail's energy is off the plain one")


def _check_parity_lm(device, refs, now_pyr, intr, batches) -> dict:
    """`level_lm` under the reference-parity semantics (`_parity_lm_variants`)
    at the four parity capacities (the `dvo` defaults' 8192/4096/2048/1024
    points on the batch phase's rendered pairs, 240x320 ... 30x40), each
    variant's own targets (`prepare_now_targets`), B = 64 and 1, every
    level from the identity: a second launch bitwise equal; against the
    plain twin (`level_lm_plain` on the card) within `check_level_lm`'s
    bars (`_parity_lm_curves`: a pair of the ill-conditioned reference
    Jacobian may part) and its first step on the plain normal equations
    (`_check_lm_first_step`); the all-point tail bitwise the plain point
    terms at the returned pose on the CPU (`_plain_tail`); on every cluster
    size the level can be forced to, the rule's bitwise the route it takes,
    the others within the bars, their first steps and their tails bitwise.
    CUDA-event ms of level 0 at B = 64 beside the plain twin's."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import level_lm, point_sem
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    out, worst, worst_step = {}, 0.0, 0.0
    for tag, cfg in _parity_lm_variants().items():
        _require(point_sem.parity(cfg), f"level_lm parity {tag}: not a parity configuration")
        nows = edge_dvo.prepare_now_targets(now_pyr.gray, cfg)
        deferred = cfg.lm_deferred_accept
        for b in batches:
            for lvl in range(3, -1, -1):
                ref, now = refs[lvl], nows[lvl]
                pts, valid, count = ref.pts3d[:b], ref.valid[:b], ref.count[:b]
                img, grads = edge_dvo.lm_planes(now, cfg)
                img, grads, scale = img[:b], tuple(g[:b] for g in grads), now.scale[:b]
                li, n_iters, k = intr.at_level(lvl), cfg.iterations[lvl], pts.shape[1]
                js, st = edge_dvo.level_strides(cfg, k)
                R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
                t0 = torch.zeros((b, 3), device=device)
                args = (R0, t0, pts, valid, count, img, scale, *li, cfg, n_iters, js, st)
                ker = level_lm.level_lm(*args, grads=grads)
                again = level_lm.level_lm(*args, grads=grads)
                pl = level_lm.level_lm_plain(*args, grads=grads)
                torch.cuda.synchronize()
                what = f"level_lm parity {tag} B={b} level {lvl}"
                _require(all(_same_bits(a, c) for a, c in zip(ker, again)), f"{what}: runs differ")
                _require(bool(torch.isfinite(ker.R).all() and torch.isfinite(ker.t).all()),
                         f"{what}: non-finite pose")
                err = _parity_lm_curves(what, cfg, ker, pl)
                step = _check_lm_first_step(what, cfg, args, grads)
                tail = deferred or js > 1
                if tail:
                    _plain_tail(what, cfg, ker, pts, valid, count, img, li)
                ranks = level_lm.level_ranks(k, js, st, deferred)
                for c in _forced_routes(level_lm.level_ranks, k, js, st, deferred):
                    kc = level_lm.level_lm(*args, cluster=c, grads=grads)
                    torch.cuda.synchronize()
                    if c == ranks:
                        _require(all(_same_bits(a, x) for a, x in zip(ker, kc)),
                                 f"{what}: forced to c={c}, the rule's route, it differs")
                    else:
                        err = max(err, _parity_lm_curves(f"{what} c={c}", cfg, kc, pl))
                        step = max(step, _check_lm_first_step(f"{what} c={c}", cfg, args, grads,
                                                              c))
                        if tail:
                            _plain_tail(f"{what} c={c}", cfg, kc, pts, valid, count, img, li)
                worst, worst_step = max(worst, err), max(worst_step, step)
                if lvl == 0 and b == batches[0]:
                    k_ms = _time_ms(lambda: level_lm.level_lm(*args, grads=grads), 20)
                    p_ms = _time_ms(lambda: level_lm.level_lm_plain(*args, grads=grads), 2)
                    # check_level_lm's count: the points and their sampled
                    # corners (of every plane read) in, the outputs out
                    ran, n_valid = (ker.energy != 0).sum(-1), valid[:, ::js].sum(-1)
                    passes = OPS_GN_POINT + (0 if deferred else OPS_RESIDUAL_POINT)
                    flops = (float((ran * n_valid).sum()) * passes + float(ran.sum()) * OPS_LM_STEP
                             + (float(valid.sum()) * OPS_RESIDUAL_POINT if tail else 0.0))
                    hw, planes = img.shape[1] * img.shape[2], 1 + len(grads)
                    k_read = k if tail else -(-k // js)
                    nbytes = b * (k_read * 13 + planes * min(hw, 4 * k_read) * img.element_size()
                                  + 120 + 4 * n_iters + k * 5)
                    out[tag] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err,
                                **_bound(nbytes, flops)}
                    _log(f"{what} (jstride {js}, {n_iters} iterations, rule c={ranks}): runs "
                         f"bitwise equal, pose err {err:.2e} against the plain twin, the first "
                         f"step {step:.2e} off the plain normal equations"
                         f"{', the tail bitwise the plain point terms' if tail else ''}; "
                         f"level_lm {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    _log(f"level_lm parity: the first step at most {worst_step:.2e} off the plain normal "
         f"equations' direction (bar {PARITY_LM_STEP:g})")
    return {"max_abs_err": worst, "first_step_err": worst_step, "variants": out}


def _check_parity_sg(device, refs, now_pyr, intr, batches) -> dict:
    """`level_sg` under the reference-parity semantics (`_parity_sg_variants`)
    at the four parity capacities, each variant's own targets, B = 64 and
    1, 50 iterations a level from the identity: a second launch bitwise
    equal; every iteration on its own from the launch's trace against the
    plain point terms on the card and the plain step with the configured
    re-orthogonalization (`_check_sg_steps`); the returned per-point values
    bitwise the plain point terms on the CPU at the trace's best pose; the
    free-running plain twin within `_check_sg_curves`' bars (no share of
    pairs is held to never parting, as `check_level_sg` holds half: the
    interpolated DT's residual is continuous in the pose, so two runs
    drift apart in every pair, slowly, and the steps are held one by one);
    on every
    cluster size the level can be forced to the rule's bitwise its route,
    the others through the same per-point and curve checks (the steps,
    held on the rule's route, are the same code on every route). CUDA-event
    ms of level 0 at B = 64 beside the plain twin's."""
    import torch

    from rgbd_odometry_tpu_torch.kernels import level_sg, point_sem, sg_terms
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    out, worst = {}, 0.0
    for tag, cfg in _parity_sg_variants().items():
        _require(point_sem.parity(cfg), f"level_sg parity {tag}: not a parity configuration")
        sem = point_sem.point_sem(cfg)
        terms = functools.partial(sg_terms.subgradient_terms_plain, sem=sem)
        nows = edge_dvo.prepare_now_targets(now_pyr.gray, cfg)
        for b in batches:
            for lvl in range(3, -1, -1):
                ref, dt = refs[lvl], nows[lvl].dt[:b]
                pts, valid, count = ref.pts3d[:b], ref.valid[:b], ref.count[:b]
                li, n_iters, k = intr.at_level(lvl), cfg.iterations[lvl], pts.shape[1]
                R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
                t0 = torch.zeros((b, 3), device=device)
                args = (R0, t0, pts, valid, count, dt, *li, cfg, n_iters)
                trace = torch.zeros((b, n_iters, 18), device=device)
                ker = level_sg.level_sg(*args, trace=trace)
                again = level_sg.level_sg(*args)
                pl = level_sg.level_sg_plain(*args)
                torch.cuda.synchronize()
                what = f"level_sg parity {tag} B={b} level {lvl} K={k}"
                _require(all(_same_bits(a, c) for a, c in zip(ker, again)), f"{what}: runs differ")
                _require(bool(torch.isfinite(ker.R).all() and torch.isfinite(ker.t).all()),
                         f"{what}: non-finite pose")
                err = _check_sg_steps(what, cfg, args, ker, trace, terms)

                def best_points(what, ker, trace):
                    rows = torch.arange(b, device=device)
                    bp = trace[rows, ker.best_iter.long()].cpu()
                    _, eps, _, vis = sg_terms.sg_point_terms(
                        bp[:, :9].reshape(b, 3, 3), bp[:, 9:12], pts.cpu(), valid.cpu(),
                        dt.cpu(), *li, cfg.weight_sigma2, sem)
                    _require(torch.equal(ker.eps.cpu(), eps)
                             and torch.equal(ker.visible.cpu(), vis),
                             f"{what}: the returned per-point values differ from the plain "
                             "point terms at the best iterate")

                best_points(what, ker, trace)
                worst = max(worst, err, _check_sg_curves(what, ker, pl)[1])
                ranks = level_sg.level_ranks(k)
                for c in _forced_routes(level_sg.level_ranks, k):
                    trace_c = torch.zeros((b, n_iters, 18), device=device)
                    kc = level_sg.level_sg(*args, trace=trace_c, cluster=c)
                    torch.cuda.synchronize()
                    if c == ranks:
                        _require(all(_same_bits(a, x) for a, x in zip(ker, kc)),
                                 f"{what}: forced to c={c}, the rule's route, it differs")
                    else:
                        best_points(f"{what} c={c}", kc, trace_c)
                        worst = max(worst, _check_sg_curves(f"{what} c={c}", kc, pl)[1])
                if lvl == 0 and b == batches[0]:
                    k_ms = _time_ms(lambda: level_sg.level_sg(*args), 20)
                    p_ms = _time_ms(lambda: level_sg.level_sg_plain(*args), 2)
                    # check_level_sg's count (the SVD's ~500 double operations
                    # a step beside it, counted as float32 ones)
                    ran, n_vis = (ker.energy != 0).sum(-1), ker.visible.sum(-1)
                    h, w = dt.shape[1:]
                    nbytes = b * (k * 13 + 52 + 60 + 4 * n_iters + 5 * k) + _sampled_bytes(
                        n_vis * ran, h * w, 5, 4)
                    step = OPS_SG_STEP + (500 if point_sem.svd(cfg) else 0)
                    flops = float((ran * n_vis).sum()) * OPS_SG_POINT + float(ran.sum()) * step
                    out[tag] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err,
                                **_bound(nbytes, flops)}
                    _log(f"{what} (rule c={ranks}): runs bitwise equal, every step within the "
                         "bars of the plain terms and step, the per-point values bitwise the "
                         f"plain terms at the best iterate; level_sg {k_ms:.4f} ms, plain "
                         f"{p_ms:.4f} ms")
    return {"max_abs_err": worst, "variants": out}


def _level0_inputs(device, cfg, batch: int):
    """Level 0 (240x320, the parity capacity 8192) of the batch phase's
    rendered pairs under `cfg`, through the path's own extraction and
    targets: (RefLevel, NowLevel, level intrinsics)."""
    import torch

    from rgbd_odometry_tpu_torch import PipelineConfig, profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    cam = profiles.production_320().camera
    rg, rd, ng, nd, _ = render_batch(cam, batch)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    ref_pyr, now_pyr = build_pyramid(f(rg), f(rd), 4), build_pyramid(f(ng), f(nd), 4)
    intr = Intrinsics.from_config(cam)
    refs = edge_dvo.extract_ref_features(ref_pyr.gray, ref_pyr.depth, intr, cfg,
                                         PipelineConfig().pyramid.max_points)
    return refs[0], edge_dvo.prepare_now_targets(now_pyr.gray, cfg)[0], intr.at_level(0)


def _traj_frozen(what: str, traj, ran) -> None:
    """A pair done after `ran` iterations holds the pose it ended on in every
    later row of its trajectory, bit for bit."""
    n = traj.shape[1]
    for b in range(traj.shape[0]):
        d = int(ran[b])
        if 0 < d < n:
            _require(_same_bits(traj[b, d:], traj[b, d - 1].expand(n - d, -1).contiguous()),
                     f"{what}: pair {b}'s rows after it is done are not its frozen pose")


def check_level_traj(device) -> dict:
    """The trajectory output of the two level kernels (JAX's
    `collect_trajectory` on a production configuration, `run_level`'s route
    on the card) at the `dvo` commands' level 0 of the batch phase's pairs
    (240x320, 8192 points), B = 64 and 1, from the identity: `level_sg`
    under `SolverConfig()` (50 iterations, the reference's sub-gradient) and
    `level_lm` on the standard LM of the `dvo` defaults (18 iterations, the
    normal equations on every 4th point, the all-point tail). Every other
    output bitwise the same with and without the trajectory (the trace
    too); for a pair still running, `level_sg`'s trace row i+1's pose bitwise
    trajectory row i, and a done pair's frozen pose in every later row; the
    result the best row's pose re-orthogonalized (1e-6). Against the plain
    twins with their trajectory: `check_level_sg`'s bars (`_check_sg_curves`)
    and the rows of the pairs that never part within its pose bar, 1e-5;
    `check_level_lm`'s bars (`_check_level_curves`) and the rows of the pairs
    whose decisions all agree within its pose bar, 1e-3 (the LM's damped
    step turns the sums' last bits into ~1e-5 of pose). CUDA-event times
    with and without the output, in turns (with, without, without, with)."""
    import torch

    from rgbd_odometry_tpu_torch import SolverConfig
    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.kernels import level_lm, level_sg
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    out = {}
    for name, cfg in (("level_sg", SolverConfig()),
                      ("level_lm", SolverConfig(method="gauss_newton", iterations=(18, 6, 4, 3)))):
        ref, now, li = _level0_inputs(device, cfg, BATCH)
        n = cfg.iterations[0]
        for b in (BATCH, 1):
            pts, valid, count = ref.pts3d[:b], ref.valid[:b], ref.count[:b]
            R0 = torch.eye(3, device=device).expand(b, 3, 3).contiguous()
            t0 = torch.zeros((b, 3), device=device)
            traj = torch.full((b, n, 12), float("nan"), device=device)
            traj_p = torch.full((b, n, 12), float("nan"), device=device)
            what = f"{name} B={b} level 0 with its trajectory"
            if name == "level_sg":
                args = (R0, t0, pts, valid, count, now.dt[:b], *li, cfg, n)
                trace, trace2 = (torch.zeros((b, n, 18), device=device) for _ in range(2))
                ker = level_sg.level_sg(*args, trace=trace, traj=traj)
                bare = level_sg.level_sg(*args, trace=trace2)
                pl = level_sg.level_sg_plain(*args, traj=traj_p)
                run = lambda t=None: level_sg.level_sg(*args, traj=t)  # noqa: E731
            else:
                jstride, stride = edge_dvo.level_strides(cfg, pts.shape[1])
                args = (R0, t0, pts, valid, count, now.chans[:b, 0], now.scale[:b], *li, cfg, n,
                        jstride, stride)
                ker = level_lm.level_lm(*args, traj=traj)
                bare = level_lm.level_lm(*args)
                pl = level_lm.level_lm_plain(*args, traj=traj_p)
                run = lambda t=None: level_lm.level_lm(*args, traj=t)  # noqa: E731
            torch.cuda.synchronize()
            _require(all(_same_bits(a, c) for a, c in zip(ker, bare)),
                     f"{what}: an output differs from the launch without the trajectory")
            _require(bool(torch.isfinite(traj).all()), f"{what}: a row was not written")
            ran = (ker.energy != 0).sum(-1)
            _traj_frozen(what, traj, ran)
            if name == "level_sg":
                _require(torch.equal(trace, trace2), f"{what}: the trace differs without it")
                steps = 0
                for i in range(n - 1):
                    live = ran > i + 1
                    if bool(live.any()):
                        _require(_same_bits(traj[live, i], trace[live, i + 1, :12]),
                                 f"{what}: row {i} is not trace row {i + 1}'s pose")
                        steps += int(live.sum())
                together, err, never = _check_sg_curves(what, ker, pl)
                _require(2 * never >= b, f"{what}: only {never} pairs never part")
            else:
                err = _check_level_curves(what, cfg, ker, pl)
                e_k, e_p = ker.energy.cpu().numpy(), pl.energy.cpu().numpy()
                together = torch.from_numpy(((e_k == 0) == (e_p == 0)).all(1) & (
                    np.sign(np.diff(e_k, axis=1)) == np.sign(np.diff(e_p, axis=1))).all(1)
                    & (ker.best_iter == pl.best_iter).cpu().numpy()).to(device)
            rows = (traj - traj_p)[together].abs()
            row_err = float(rows.max()) if rows.numel() else 0.0
            row_bar = 1e-5 if name == "level_sg" else 1e-3  # each check's pose bar
            _require(row_err <= row_bar,
                     f"{what}: rows differ from the plain twin's by {row_err:.2e}")
            # the result is the best row's pose (the start at iteration 0), re-orthogonalized
            best = ker.best_iter.long()
            prev = traj[torch.arange(b, device=device), (best - 1).clamp(min=0)]
            bR = torch.where((best > 0)[:, None, None], prev[:, :9].reshape(b, 3, 3), R0)
            bt = torch.where((best > 0)[:, None], prev[:, 9:], t0)
            best_err = max(float((geo.rotationize_newton(bR) - ker.R).abs().max()),
                           float((bt - ker.t).abs().max()))
            _require(best_err <= 1e-6, f"{what}: the result is not the best row's pose "
                                       f"({best_err:.2e})")
            # with, without, without, with, after 50 calls that bring the card's
            # clock back up from the plain twin's idle stretch
            _time_ms(run, 50)
            times = [_time_ms(lambda: run(traj), 50), _time_ms(run, 50), _time_ms(run, 50),
                     _time_ms(lambda: run(traj), 50)]
            with_ms, without_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            rows_how = (f"{steps} rows bitwise the trace's next pose" if name == "level_sg"
                        else "the rows after a pair is done its frozen pose")
            _log(f"{what} ({n} iterations, {int(ran.sum())} run): every other output bitwise "
                 f"the launch without it, {rows_how}, "
                 f"{int(together.sum())} pairs' rows within {row_err:.2e} of the plain twin's, "
                 f"pose err {err:.2e}; {with_ms * 1e3:.1f} us with the trajectory, "
                 f"{without_ms * 1e3:.1f} us without")
            out[f"{name} B={b}"] = {"ms": with_ms, "ms_without": without_ms,
                                    "max_abs_err": max(err, row_err)}
    return out


# parity_batch's pose bar between the card and the CPU by the kind of a
# family's residual: the 1e-4 of tests/test_torch_parity_drivers.py where
# every gather is float32 and 2e-3 where the gathers are bf16; the
# sub-gradient's (`PARITY_SG_BAR`) whatever its residual
PARITY_BARS = {"float32": 1e-4, "bf16": 2e-3}
PARITY_SG_BAR = 1e-2


def _parity_families():
    """Each family of `point_sem.PARITY_FAMILIES` (the sub-gradient on
    `SolverConfig()`, Gauss-Newton on the `dvo` defaults' 18/6/4/3
    iterations) with the pose bar of its comparison between the card and
    the CPU (`PARITY_BARS`, `PARITY_SG_BAR`). The sub-gradient's steps keep
    the trust region's length (3e-3) through all 200 iterations, so two
    free runs that part where a reduction's last bit differs (a floor
    decision, or the interpolated DT's descent) wander apart within the few
    steps of its oscillation around the optimum and return other visited
    poses as their best."""
    from rgbd_odometry_tpu_torch import SolverConfig
    from rgbd_odometry_tpu_torch.kernels import point_sem

    gn = SolverConfig(method="gauss_newton", iterations=(18, 6, 4, 3))
    return {name: (cfg, PARITY_SG_BAR if cfg.method == "subgradient" else PARITY_BARS[kind])
            for name, (cfg, kind) in point_sem.parity_families(SolverConfig(), gn).items()}


PARITY_CPU_PAIRS = 4  # the pairs of parity_batch held against the CPU run
# an align_pair call in the parity mode: Canny of both pyramids, the 4 levels'
# targets in one launch, the keyframe's extraction and the pyramid's one level launch
# ("level": `level_lm` for Gauss-Newton, `level_sg` for the sub-gradient)
PARITY_CALL_LAUNCHES = {"canny_pyramid": 2, "dt_pyramid": 1, "extract": 1, "level": 1}
PARITY_TIMED_CALLS = 5  # parity_batch's ms a call: the median of these, after the checked call


def run_parity_batch(device) -> dict:
    """`align_pair` in the reference-parity mode on the batch phase's 64
    rendered 320x240 pairs (capacities 8192/4096/2048/1024) from a generic
    start pose, once per
    family of `_parity_families`: the kernels' targets and extraction
    (`canny_pyramid`, `dt_pyramid`, `extract_pyramid`) and the pyramid in
    one `level_lm` or `level_sg` launch (`PARITY_CALL_LAUNCHES`), every
    pose finite, the pose error against ground truth, the launches and host
    ms a call (the median of `PARITY_TIMED_CALLS` calls ending in a sync;
    for the first family of each method every CUDA kernel of a call, from
    the profiler), and the first `PARITY_CPU_PAIRS` pairs against the
    port's CPU run (the plain twins) of the same inputs: the coarsest
    level's first energy (the start pose, before the runs can part) within
    1e-5 relative, the poses within the family's bar."""
    import torch

    from rgbd_odometry_tpu_torch import PipelineConfig, align_pair, profiles
    from rgbd_odometry_tpu_torch.core import geometry as geo
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import point_sem
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    cam = profiles.production_320().camera
    caps = PipelineConfig().pyramid.max_points
    rg, rd, ng, nd, gt = render_batch(cam, BATCH)
    intr = Intrinsics.from_config(cam)
    gt_t = np.stack([p[1] for p in gt])
    # a generic start, as the JAX package's oracle tests take: at the identity
    # every point lies on a pixel boundary, where the last bit of u (the card
    # divides the back-projection by a scalar's reciprocal, the CPU truly)
    # flips floor lookups and border visibility between the two devices
    start = geo.se3_exp(torch.tensor([0.003, -0.002, 0.001, 0.002, 0.001, -0.002]))
    counters = _launch_counters()
    out = {}
    for card, (dev, n) in enumerate(((device, BATCH), (torch.device("cpu"), PARITY_CPU_PAIRS))):
        card = card == 0
        f = lambda a: torch.from_numpy(a[:n]).to(dev)  # noqa: E731
        pyr = (build_pyramid(f(rg), f(rd), 4), build_pyramid(f(ng), f(nd), 4))
        R0 = start[0].expand(n, 3, 3).contiguous().to(dev)
        t0 = start[1].expand(n, 3).contiguous().to(dev)
        for fam, (cfg, bar) in _parity_families().items():
            _require(edge_dvo.kernel_route(cfg) and point_sem.parity(cfg),
                     f"parity_batch {fam}: not a parity configuration on the kernels' route")
            before = {k: fn.launches for k, fn in counters.items()}
            _sync(dev)
            tic = time.perf_counter()
            R, t, diags = align_pair(pyr[0].gray, pyr[0].depth, pyr[1].gray, intr, cfg, caps,
                                     R0, t0)
            e0 = diags[-1].energy[:PARITY_CPU_PAIRS, 0].cpu()
            _sync(dev)
            ms = (time.perf_counter() - tic) * 1000.0
            if card:
                n_l = {k: fn.launches - before[k] for k, fn in counters.items()}
                times = []
                for _ in range(PARITY_TIMED_CALLS):
                    _sync(dev)
                    tic = time.perf_counter()
                    align_pair(pyr[0].gray, pyr[0].depth, pyr[1].gray, intr, cfg, caps, R0, t0)
                    _sync(dev)
                    times.append((time.perf_counter() - tic) * 1000.0)
                ms_first, ms = ms, float(np.median(times))
                kernels = None
                if fam in ("sg_interpolate_dt_mxu", "gn_take"):
                    kernels = _kernel_launches(lambda: align_pair(
                        pyr[0].gray, pyr[0].depth, pyr[1].gray, intr, cfg, caps, R0, t0))
                t_np = t.cpu().numpy().astype(np.float64)
                _require(np.isfinite(t_np).all() and bool(torch.isfinite(R).all()),
                         f"parity_batch {fam}: non-finite poses")
                err = np.linalg.norm(t_np - gt_t, axis=-1)
                level = "level_lm" if cfg.method == "gauss_newton" else "level_sg"
                want = {level if k == "level" else k: v for k, v in PARITY_CALL_LAUNCHES.items()}
                _require({k: v for k, v in n_l.items() if v} == want,
                         f"parity_batch {fam}: launches {n_l}, not {want}")
                out[fam] = {"R": R[:PARITY_CPU_PAIRS].cpu(), "t": t[:PARITY_CPU_PAIRS].cpu(),
                            "e0": e0,
                            "median_mm": float(np.median(err)) * 1000.0,
                            "max_mm": float(err.max()) * 1000.0, "ms": ms,
                            "ms_first_call": ms_first,
                            "launches": {k: v for k, v in n_l.items() if v},
                            "cuda_kernels": kernels}
            else:
                gap = max(float((out[fam]["R"] - R).abs().max()),
                          float((out[fam]["t"] - t).abs().max()))
                e0_gap = _rel(out[fam]["e0"][:, None], e0[:, None])
                out[fam]["cpu_gap"], out[fam]["cpu_ms"] = gap, ms
                _log(f"parity_batch {fam}: {BATCH} pairs, |t-t_gt| median "
                     f"{out[fam]['median_mm']:.3f} mm max {out[fam]['max_mm']:.3f} mm, "
                     f"{out[fam]['ms']:.3f} ms a call on the card (median of "
                     f"{PARITY_TIMED_CALLS}; the checked call {out[fam]['ms_first_call']:.1f} "
                     f"ms; launches {out[fam]['launches']}, {out[fam]['cuda_kernels']} CUDA "
                     "kernels in "
                     f"all), pairs 0-{n - 1} within {gap:.2e} of the CPU run ({ms:.0f} ms; "
                     f"bar {bar:g}), first energy {e0_gap:.2e}")
                _require(e0_gap <= 1e-5, f"parity_batch {fam}: the first energy is {e0_gap:.2e} "
                                         "from the CPU's")
                _require(gap <= bar, f"parity_batch {fam}: the card is {gap:.2e} from the CPU")
    return {fam: {k: v for k, v in r.items() if k not in ("R", "t", "e0")}
            for fam, r in out.items()}


def run_parity_stream(device) -> dict:
    """`EdgeDvoOdometry` over the stream phase's 30 frames under
    parity_320 with the reference's own switches, `interpolate_dt` and the
    SVD `rotationize` (keyframe every 5 with rollback): ATE, ms/frame and
    the launches a frame (the kernels' counters over the run, and every
    CUDA kernel of frame 2, a frame solved against keyframe 0, from the
    profiler). The bar is `PARITY_STREAM_ATE_MM`."""
    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    from rgbd_odometry_tpu_torch.kernels import point_sem

    prof = profiles.parity_320()
    solver = dataclasses.replace(prof.solver, interpolate_dt=True, rotationize_method="svd")
    _require(edge_dvo.kernel_route(solver) and point_sem.parity(solver),
             "parity_stream: not a parity configuration on the kernels' route")
    frames, poses = stream_frames()
    counters = _launch_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    out = _run_stream(_stream_config(prof._replace(solver=solver)), frames, poses, device)
    per_frame = {k: (fn.launches - before[k]) / len(frames) for k, fn in counters.items()
                 if fn.launches != before[k]}
    from rgbd_odometry_tpu_torch import EdgeDvoOdometry

    odo = EdgeDvoOdometry(_stream_config(prof._replace(solver=solver)), device=device)
    for i in range(2):
        odo.process_frame(*frames[i], timestamp=float(i))
    per_frame["cuda_kernels_frame_2"] = _kernel_launches(
        lambda: odo.process_frame(*frames[2], timestamp=2.0))
    _log(f"parity_stream: {len(frames)} frames 320x240, parity_320 + interpolate_dt + svd, ATE "
         f"{out['ate_mm']:.3f} mm, keyframes {out['keyframes']}, rollbacks {out['rollbacks']}, "
         f"{out['ms_per_frame']:.3f} ms/frame, launches a frame {per_frame}")
    _require(out["ate_mm"] < PARITY_STREAM_ATE_MM,
             f"parity_stream: ATE {out['ate_mm']:.3f} mm >= {PARITY_STREAM_ATE_MM} mm")
    return {"ate_mm": out["ate_mm"], "ms_per_frame": out["ms_per_frame"],
            "launches_a_frame": per_frame}


# the `dvo` runs the uncaptured phase repeats on both routes
UNCAPTURED_CLI = (
    ("cli_default", ["--frames", "30"]),
    ("cli_default_no_feeder", ["--frames", "30", "--no-feeder"]),
    ("cli_pipelined", ["--frames", "30", "--pipelined"]),
    ("cli_subgradient", ["--method", "subgradient", "--iterations", "50,50,50,50",
                         "--frames", "10"]),
)
# runtime calls counted a frame: kernel launches, graph launches, copies, syncs
_API_KERNEL = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
_API_SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _api_calls(fn, steps: int) -> dict:
    """fn() under the profiler: its kernel launches, graph launches,
    cudaMemcpyAsync calls and host syncs, a step of `steps`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()

    def count(keys):
        return sum(e.count for e in avg if e.key in keys) / steps

    out = {"kernel_launches": count(_API_KERNEL), "graph_launches": count(("cudaGraphLaunch",)),
           "copies": count(("cudaMemcpyAsync",)), "syncs": count(_API_SYNC)}
    out["launches"] = out["kernel_launches"] + out["graph_launches"] + out["copies"]
    return out


def _same_drivers(what: str, a, b) -> None:
    """Two `EdgeDvoOdometry` runs: poses, keyframes and every FrameMetrics
    field but solve_ms bitwise equal."""
    R1, t1, ts1 = a.trajectory()
    R2, t2, ts2 = b.trajectory()
    _require(_np_same(R1, R2) and _np_same(t1, t2) and _np_same(ts1, ts2),
             f"{what}: the poses differ between the routes")
    _require([e.reason for e in a.gop.elements] == [e.reason for e in b.gop.elements],
             f"{what}: the keyframes differ between the routes")
    _require(len(a.metrics) == len(b.metrics), f"{what}: metrics count")
    for m1, m2 in zip(a.metrics, b.metrics):
        bad = [f for f in METRIC_FIELDS if not _np_same(getattr(m1, f), getattr(m2, f))]
        _require(not bad, f"{what}: frame {m1.frame_num} FrameMetrics {bad} differ")


@contextlib.contextmanager
def _drivers(graphs: bool, made: list):
    """`pipeline.odometry.EdgeDvoOdometry` (the name the `dvo` command
    imports) on the route `graphs` picks, each driver made appended to
    `made`."""
    from rgbd_odometry_tpu_torch.pipeline import odometry

    base = odometry.EdgeDvoOdometry

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, graphs=graphs, **k)
            made.append(self)

    odometry.EdgeDvoOdometry = Recorded
    try:
        yield
    finally:
        odometry.EdgeDvoOdometry = base


def run_uncaptured(device) -> dict:
    """The paths again on both routes: the frame step's CUDA graphs (the
    drivers' default) and the uncaptured route (`graphs=False`, each
    frame's work launched op by op into fresh tensors). stream,
    stream_vga and parity_stream through `EdgeDvoOdometry.process_frame`,
    the `dvo` runs of cli_default (the feeder, `--no-feeder`,
    `--pipelined`) and cli_subgradient, and `MultiStreamOdometry` at N =
    16 over the `multistream` command's streams (`--quality-triggers`, hold
    and constant velocity): poses, keyframes and every FrameMetrics field
    but solve_ms bitwise equal (the `dvo` runs: the trajectory file and the
    printed metrics too; the lockstep runs: every stream's poses and
    keyframes). The runtime calls a frame (kernel launches, graph launches,
    copies, host syncs) of each route's driver runs after two warm frames
    (bootstrap, first solved frame and capture), from the profiler, and the
    step's capture time and pool bytes a slot."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig, EdgeDvoOdometry, profiles
    from rgbd_odometry_tpu_torch.cli import multistream_config, render_streams
    from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry

    frames, _ = stream_frames()
    parity = profiles.parity_320()
    parity = parity._replace(solver=dataclasses.replace(parity.solver, interpolate_dt=True,
                                                         rotationize_method="svd"))
    paths = (("stream", _stream_config(profiles.production_320()), frames),
             ("stream_vga", _stream_config(profiles.production_vga()), vga_frames()[0]),
             ("parity_stream", _stream_config(parity), frames))
    out = {}
    for name, cfg, seq in paths:
        runs, calls = {}, {}
        for graphs in (True, False):
            odo = EdgeDvoOdometry(cfg, device=device, graphs=graphs)
            odo.keep_residuals = True
            for i in range(2):
                odo.process_frame(*seq[i], timestamp=float(i))

            def rest(odo=odo):
                for i in range(2, len(seq)):
                    odo.process_frame(*seq[i], timestamp=float(i))

            calls[graphs] = _api_calls(rest, len(seq) - 2)
            runs[graphs] = odo
        _same_drivers(f"uncaptured {name}", runs[True], runs[False])
        step = runs[True].frame_steps()[0]
        out[name] = {"graphs": calls[True], "uncaptured": calls[False],
                     "capture_s": step.capture_s,
                     "pool_bytes_a_slot": [s.pool_bytes for s in step.slots]}
        _log(f"uncaptured {name}: {len(seq)} frames bitwise equal on both routes (poses, "
             f"keyframes {runs[True].gop.keyframe_indices()}, every FrameMetrics field but "
             f"solve_ms); a frame: graphs {calls[True]}, uncaptured {calls[False]}; capture "
             f"{step.capture_s * 1000:.1f} ms, pool bytes a slot {out[name]['pool_bytes_a_slot']}")

    for name, argv in UNCAPTURED_CLI:
        runs, made = {}, {True: [], False: []}
        for graphs in (True, False):
            with _drivers(graphs, made[graphs]):
                runs[graphs] = _quiet(run_cli, f"uncaptured {name}", argv, 0.025)[0]
        a, b = runs[True], runs[False]
        _require(a["trajectory"] == b["trajectory"] and a["metrics"] == b["metrics"]
                 and a["keyframes"] == b["keyframes"],
                 f"uncaptured {name}: the trajectory file, metrics or keyframes differ")
        _require(len(made[True]) == len(made[False]) == 1, f"uncaptured {name}: drivers made")
        _same_drivers(f"uncaptured {name}", made[True][0], made[False][0])
        _log(f"uncaptured {name}: dvo {' '.join(argv)}: trajectory file, metrics, keyframes and "
             f"every FrameMetrics field but solve_ms bitwise equal on both routes")
        out[name] = {"bitwise": True}

    n, steps = 16, MULTI_FRAMES
    seqs, _ = render_streams(CameraConfig(), n, steps)
    gray = np.stack([np.stack([sq[f][0] for sq in seqs]) for f in range(steps)])
    depth = np.stack([np.stack([sq[f][1] for sq in seqs]) for f in range(steps)])
    for model in ("hold", "constant_velocity"):
        cfg = multistream_config(CameraConfig(), motion_model=model, quality_triggers=True)
        runs, calls = {}, {}
        for graphs in (True, False):
            multi = MultiStreamOdometry(n, cfg, device=device, graphs=graphs)
            for f in range(2):
                multi.process_batch(gray[f], depth[f], timestamp=f / 30.0)

            def rest(multi=multi):
                for f in range(2, steps):
                    multi.process_batch(gray[f], depth[f], timestamp=f / 30.0)

            calls[graphs] = _api_calls(rest, steps - 2)
            runs[graphs] = _gops_out(multi.gops)
        a, b = runs[True], runs[False]
        _require(_np_same(a["R"], b["R"]) and _np_same(a["t"], b["t"])
                 and a["keyframes"] == b["keyframes"],
                 f"uncaptured multistream {model}: the routes differ")
        out[f"multistream_{model}"] = {"graphs": calls[True], "uncaptured": calls[False]}
        _log(f"uncaptured multistream {model}: {n} streams x {steps} frames, --quality-triggers, "
             f"every stream's poses and keyframes bitwise equal on both routes; a step: graphs "
             f"{calls[True]}, uncaptured {calls[False]}")
    torch.cuda.synchronize()
    return out


def _trajectory(n: int, step: float = 0.002):
    ts = np.arange(n)
    return np.stack(
        [0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
         0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts],
        axis=-1,
    ).astype(np.float32)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


@functools.lru_cache(maxsize=1)
def stream_frames():
    """The stream phase's rendered 320x240 frames and ground-truth poses."""
    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    return render_sequence(profiles.production_320().camera, _trajectory(STREAM_FRAMES), seed=0)


@functools.lru_cache(maxsize=1)
def vga_frames():
    """The stream phase's trajectory and scene rendered at 640x480 with
    production_vga's camera, one sample a pixel (as bench.py renders VGA;
    three a pixel take ~3 s a frame on the host)."""
    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    return render_sequence(profiles.production_vga().camera, _trajectory(STREAM_FRAMES), seed=0,
                           supersample=1)


def distorted_vga_frames(cam):
    """The stream phase's trajectory and scene as a VGA RGB-D sensor with
    the plumb-bob distortion of `cam` delivers it: (rgb (480, 640, 3) 0..255,
    depth (480, 640) metres, 0 where no surface) per frame. Each pixel's ray
    is its distorted normalized coordinate undistorted by fixed-point
    iteration (to 1e-12), one sample a pixel."""
    from rgbd_odometry_tpu_torch.io.synthetic import SyntheticScene, pose_from_twist

    k1, k2, p1, p2, k3 = cam.distortion
    gy, gx = np.meshgrid(np.arange(cam.height, dtype=np.float64),
                         np.arange(cam.width, dtype=np.float64), indexing="ij")
    xd, yd = (gx - cam.cx) / cam.fx, (gy - cam.cy) / cam.fy
    x, y = xd.copy(), yd.copy()
    for _ in range(200):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        x_new = (xd - 2.0 * p1 * x * y - p2 * (r2 + 2.0 * x * x)) / radial
        y_new = (yd - p1 * (r2 + 2.0 * y * y) - 2.0 * p2 * x * y) / radial
        step = max(float(np.abs(x_new - x).max()), float(np.abs(y_new - y).max()))
        x, y = x_new, y_new
        if step < 1e-12:
            break
    _require(step < 1e-12, f"distorted_vga_frames: the ray inversion did not converge ({step})")
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    scene = SyntheticScene(seed=0)
    out = []
    for psi in _trajectory(STREAM_FRAMES):
        R, t = pose_from_twist(psi)
        gray, depth_m = scene._render_rays(rays @ R.T, t, R)
        gray = np.round(np.clip(gray, 0, 255)).astype(np.float32)
        out.append((np.repeat(gray[..., None], 3, axis=-1),
                    np.where(depth_m > 0, depth_m, 0.0).astype(np.float32)))
    return out


def _stream_config(prof, **kw):
    """A profile's streaming configuration: keyframe every 5 with rollback."""
    from rgbd_odometry_tpu_torch import KeyframeConfig, PipelineConfig, PyramidConfig

    return PipelineConfig(
        camera=prof.camera,
        pyramid=PyramidConfig(num_levels=prof.num_levels, max_points=prof.max_points),
        solver=prof.solver,
        keyframe=KeyframeConfig(force_every=5, rollback_resolve=True),
        **kw,
    )


def _run_stream(cfg, frames, poses, device, ingest=None) -> dict:
    """`EdgeDvoOdometry.process_frame` over `frames` (each through
    `ingest` first, when given): ms/frame over frames 1.. (host clock; every
    frame ends in its result copy; the frame step captured before the
    clock starts), unaligned ATE RMSE, keyframes and rollbacks."""
    from rgbd_odometry_tpu_torch import EdgeDvoOdometry

    feed = ingest or (lambda f: f)
    odo = EdgeDvoOdometry(cfg, device=device)
    odo.process_frame(*feed(frames[0]), timestamp=0.0)  # bootstrap (untimed)
    odo.prepare("process_frame")  # the frame step's capture (untimed, set-up)
    _sync(device)
    t0 = time.perf_counter()
    for i, f in enumerate(frames[1:], start=1):
        odo.process_frame(*feed(f), timestamp=float(i))
    ms = (time.perf_counter() - t0) * 1000.0 / (len(frames) - 1)
    _, t_est, _ = odo.trajectory()
    gt_t = np.stack([p[1] for p in poses])
    _require(t_est.shape == gt_t.shape and np.isfinite(t_est).all(), "stream: bad trajectory")
    ate = float(np.sqrt(((t_est - gt_t) ** 2).sum(-1).mean()))  # unaligned ATE RMSE
    return {"ate_mm": ate * 1000.0, "ms_per_frame": ms, "keyframes": odo.gop.keyframe_indices(),
            "rollbacks": sum(m.rolled_back for m in odo.metrics)}


def run_stream(device) -> dict:
    """EdgeDvoOdometry under production_320 over a rendered sequence."""
    from rgbd_odometry_tpu_torch import profiles

    frames, poses = stream_frames()
    out = _run_stream(_stream_config(profiles.production_320()), frames, poses, device)
    ate, ms, rollbacks = out["ate_mm"] / 1000.0, out["ms_per_frame"], out["rollbacks"]
    _log(f"stream: {len(frames)} frames 320x240, ATE {ate * 1000:.3f} mm, keyframes "
         f"{out['keyframes']}, rollbacks {rollbacks}, {ms:.3f} ms/frame")
    _require(ate < 0.008, f"stream: ATE {ate:.4f} m >= 8 mm")
    _require(rollbacks >= 1, "stream: no rollback re-solve happened")
    return {"ate_mm": ate * 1000.0, "ms_per_frame": ms}


def run_stream_vga(device, p320: dict) -> dict:
    """EdgeDvoOdometry under production_vga (5 levels from 640x480,
    capacities 4096/2048/1024/512/512, LM 4/18/6/4/3) over the stream
    phase's trajectory rendered at 640x480: ATE < 8 mm (the stream's bar),
    ms/frame beside production_320's."""
    from rgbd_odometry_tpu_torch import profiles

    frames, poses = vga_frames()
    out = _run_stream(_stream_config(profiles.production_vga()), frames, poses, device)
    _log(f"stream_vga: {len(frames)} frames 640x480 production_vga, ATE {out['ate_mm']:.3f} mm, "
         f"keyframes {out['keyframes']}, rollbacks {out['rollbacks']}, "
         f"{out['ms_per_frame']:.3f} ms/frame; production_320 at 320x240 on the same trajectory "
         f"(the stream phase): ATE {p320['ate_mm']:.3f} mm, {p320['ms_per_frame']:.3f} ms/frame")
    _require(out["ate_mm"] < 8.0, f"stream_vga: ATE {out['ate_mm']:.3f} mm >= 8 mm")
    _require(out["rollbacks"] >= 1, "stream_vga: no rollback re-solve happened")
    return out


def run_stream_vga_ingest(device) -> dict:
    """The VGA sensor's stream through the ingest: each frame rendered as a
    distorting 640x480 sensor delivers it (RGB, depth in metres, TUM
    freiburg1's plumb-bob distortion), then `io.stream.preprocess_vga` on
    the card (metres to mm, sanitize, undistortion, gray, half resolution)
    into `EdgeDvoOdometry.process_frame` under production_320 at the halved
    camera: ATE < 8 mm (the stream's bar); ms/frame with the ingest, and the
    ingest's own ms/frame (host clock, synchronised)."""
    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.io.stream import preprocess_vga

    cam_vga = dataclasses.replace(profiles.production_vga().camera, distortion=FR1_DISTORTION)
    t0 = time.perf_counter()
    frames = distorted_vga_frames(cam_vga)
    render_s = time.perf_counter() - t0
    _, poses = vga_frames()
    cfg = dataclasses.replace(_stream_config(profiles.production_320()),
                              camera=cam_vga.scaled(0.5))
    ingest = lambda f: preprocess_vga(*f, cam_vga, device=device)  # noqa: E731
    gray, depth = ingest(frames[0])
    _require(tuple(gray.shape) == (240, 320) and gray.device == device
             and tuple(depth.shape) == (240, 320) and float(depth.min()) >= 1.0,
             "stream_vga_ingest: preprocess_vga output")
    _sync(device)
    t0 = time.perf_counter()
    for f in frames:
        ingest(f)
    _sync(device)
    ingest_ms = (time.perf_counter() - t0) * 1000.0 / len(frames)
    out = _run_stream(cfg, frames, poses, device, ingest=ingest)
    _log(f"stream_vga_ingest: {len(frames)} distorted 640x480 RGB-D frames (distortion "
         f"{FR1_DISTORTION}) through preprocess_vga into production_320, ATE "
         f"{out['ate_mm']:.3f} mm, keyframes {out['keyframes']}, rollbacks {out['rollbacks']}, "
         f"{out['ms_per_frame']:.3f} ms/frame with the ingest, preprocess_vga alone "
         f"{ingest_ms:.3f} ms/frame (rendering {render_s:.1f} s apart)")
    _require(out["ate_mm"] < 8.0, f"stream_vga_ingest: ATE {out['ate_mm']:.3f} mm >= 8 mm")
    return {**out, "ingest_ms_per_frame": ingest_ms}


@functools.lru_cache(maxsize=2)
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


def _run_batch(device, prof, batch: int) -> dict:
    """align_pair under `prof` on `batch` distinct pairs rendered as bench.py
    renders them: the pose errors against ground truth and pairs/s (host
    clock over 3 calls after a warm-up, ending in a sync)."""
    import torch

    from rgbd_odometry_tpu_torch import align_pair
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid

    rg, rd, ng, nd, gt = render_batch(prof.camera, batch)
    f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    ref = build_pyramid(f(rg), f(rd), prof.num_levels)
    now = build_pyramid(f(ng), f(nd), prof.num_levels)
    intr = Intrinsics.from_config(prof.camera)

    def run():
        return align_pair(ref.gray, ref.depth, now.gray, intr, prof.solver, prof.max_points)

    R, t, diags = run()
    _sync(device)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    _sync(device)
    pps = batch * reps / (time.perf_counter() - t0)
    _require(R.shape == (batch, 3, 3) and t.shape == (batch, 3), "batch: output shapes")
    t_np = t.cpu().numpy().astype(np.float64)
    _require(np.isfinite(t_np).all(), "batch: non-finite poses")
    err = np.linalg.norm(t_np - np.stack([p[1] for p in gt]), axis=-1)
    return {"err": err, "pairs_per_s": pps}


def run_batch(device, batch: int = BATCH) -> dict:
    """align_pair on `batch` distinct pairs under production_320."""
    from rgbd_odometry_tpu_torch import profiles

    out = _run_batch(device, profiles.production_320(), batch)
    err, pps = out["err"], out["pairs_per_s"]
    _log(f"batch: align_pair on {batch} pairs 320x240, |t-t_gt| median {np.median(err) * 1000:.3f} "
         f"mm max {err.max() * 1000:.3f} mm, {pps:.1f} pairs/s")
    _require(bool((err < 0.02).all()), f"batch: {int((err >= 0.02).sum())} pairs off by >= 2 cm")
    return {"median_mm": float(np.median(err)) * 1000.0, "pairs_per_s": pps}


def run_batch_vga(device, p320: dict, batch: int = BATCH) -> dict:
    """align_pair on `batch` distinct 640x480 pairs under production_vga,
    rendered as bench.py's `_vga_extras` renders them: every pair within
    2 cm of ground truth, pairs/s beside production_320's."""
    from rgbd_odometry_tpu_torch import profiles

    out = _run_batch(device, profiles.production_vga(), batch)
    err, pps = out["err"], out["pairs_per_s"]
    _log(f"batch_vga: align_pair on {batch} pairs 640x480 production_vga, |t-t_gt| median "
         f"{np.median(err) * 1000:.3f} mm max {err.max() * 1000:.3f} mm, {pps:.1f} pairs/s; "
         f"production_320 (the batch phase): {p320['pairs_per_s']:.1f} pairs/s")
    _require(bool((err < 0.02).all()),
             f"batch_vga: {int((err >= 0.02).sum())} pairs off by >= 2 cm")
    return {"median_mm": float(np.median(err)) * 1000.0, "max_mm": float(err.max()) * 1000.0,
            "pairs_per_s": pps}


def run_cli(name: str, argv, ate_bar: float, inspect=None) -> dict:
    """`rgbd_odometry_tpu_torch.cli dvo` on the card as a user runs it, with
    a trajectory file in a temporary directory ("{tmp}" in `argv` names it);
    its stdout JSON is checked against the bar, and its stderr lines other
    than the per-frame ones are echoed. `inspect(tmp)` may read what the
    command wrote there. Returns the numbers, the trajectory file's text,
    the metrics line as printed, the command's summary and its stderr."""
    from rgbd_odometry_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        est = os.path.join(tmp, "est.txt")
        stdout, stderr = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            summary = cli.main(["dvo", *(a.format(tmp=tmp) for a in argv), "--out", est])
        wall = time.perf_counter() - t0
        rows = np.loadtxt(est, comments="#", ndmin=2)
        with open(est) as fh:
            text = fh.read()
        extra = inspect(tmp) if inspect is not None else {}
    err = stderr.getvalue()
    for ln in err.splitlines():
        if not ln.startswith("frame "):
            _log(f"  [{name}] {ln}")
    line = stdout.getvalue().strip().splitlines()[-1]
    stats = json.loads(line)
    ate = stats["ate_rmse"]
    _require(rows.shape == (summary["poses"], 8) and np.isfinite(rows).all(),
             f"{name}: bad trajectory file")
    _require(np.isfinite(ate) and ate == summary["ate_rmse"], f"{name}: bad metrics")
    _log(f"{name}: dvo {' '.join(argv)}: {summary['frames']} frames, ATE {ate * 1000:.3f} mm, "
         f"keyframes {summary['keyframes']}, {summary['avg_solve_ms']:.3f} ms/frame solve "
         f"(average over frames 1.., host clock), {wall:.1f} s wall incl. rendering")
    _require(ate < ate_bar, f"{name}: ATE {ate * 1000:.3f} mm >= {ate_bar * 1000:.0f} mm")
    return {"ate_mm": ate * 1000.0, "ms_per_frame": summary["avg_solve_ms"],
            "keyframes": summary["keyframes"], "trajectory": text, "metrics": line,
            "summary": summary, "stderr": err, **extra}


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


def _out_and_back(n: int, amp: float = 0.04):
    """Absolute twists out and back to the start (tests/test_loop_closure.py):
    frames t and n-1-t share a pose."""
    phase = np.sin(np.pi * np.arange(n) / (n - 1))
    return np.stack([amp * phase, -0.5 * amp * phase, 0.3 * amp * phase,
                     0.2 * amp * phase, -0.2 * amp * phase, 0.1 * amp * phase],
                    -1).astype(np.float32)


def run_loop_closure(device) -> dict:
    """`LoopCloser` over a 12-frame out-and-back sequence at 320x240, every
    frame a keyframe, slot capacity 4 (the store doubles twice on the card):
    each closure within 2 cm / 0.02 of ground truth; a second run with the
    same seed finds the same closures. ms per add_keyframe (host clock
    around a synchronised call; frames already on the card)."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig, LoopCloser
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.pipeline.loop_closure import LoopClosureConfig

    cam = CameraConfig()
    frames, poses = render_sequence(cam, _out_and_back(12), seed=0)
    dev_frames = [tuple(torch.from_numpy(a).to(device) for a in f) for f in frames]
    cfg = LoopClosureConfig(min_separation=4, slot_capacity=4)

    def run():
        lc = LoopCloser(Intrinsics.from_config(cam), cfg, seed=0, device=device)
        ms = []
        for i, (g, d) in enumerate(dev_frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lc.add_keyframe(i, g, d)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1000.0)
        return lc, ms

    lc, ms = run()
    again, _ = run()
    _require(len(lc.closures) >= 1, "loop_closure: no closure found")
    _require(lc.matcher.num_slots() == 16, f"loop_closure: {lc.matcher.num_slots()} slots, not 16")
    for i, j, R_rel, t_rel, n_inl in lc.closures:
        (R_i, t_i), (R_j, t_j) = poses[i], poses[j]
        dt = np.linalg.norm(t_rel - R_i.T @ (t_j - t_i))
        dR = np.linalg.norm(R_rel - R_i.T @ R_j)
        _require(dt < 0.02 and dR < 0.02 and n_inl >= 20,
                 f"loop_closure: closure {i}->{j} off by {dt * 1000:.1f} mm / {dR:.4f}")
    key = [(c[0], c[1], c[4]) for c in lc.closures]
    _require(key == [(c[0], c[1], c[4]) for c in again.closures]
             and all(np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
                     for a, b in zip(lc.closures, again.closures)),
             "loop_closure: a second run with the same seed gives other closures")
    _log(f"loop_closure: 12 keyframes 320x240, closures (i, j, inliers) {key}, "
         f"{lc.skipped_candidates} candidates skipped, store {lc.matcher.num_slots()} slots; "
         f"add_keyframe median {np.median(ms[1:]):.3f} ms, mean {np.mean(ms[1:]):.3f} ms "
         f"(host clock, synchronised), second run identical")
    return {"closures": len(key), "ms_per_keyframe": float(np.median(ms[1:]))}


@functools.lru_cache(maxsize=1)
def reloc_case():
    """tests/test_relocalize.py's blackout-teleport run at 320x240: its
    configuration (relocalization on, quality triggers, keyframe every 5
    with rollback), its 13 frames (6 fast ones, 3 blank, 4 slow ones
    teleported back near the start) and the last 4 frames' true poses."""
    from rgbd_odometry_tpu_torch import (
        CameraConfig, KeyframeConfig, PipelineConfig, PyramidConfig, RelocalizeConfig,
        SolverConfig,
    )
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5)
    cfg = PipelineConfig(
        camera=cam,
        pyramid=PyramidConfig(num_levels=3, max_points=(2048, 1024, 512)),
        solver=SolverConfig(method="gauss_newton", iterations=(50, 8, 5)),
        keyframe=KeyframeConfig(force_every=5, enable_quality_triggers=True, rollback_resolve=True),
        relocalize=RelocalizeConfig(enabled=True, trigger_consecutive=1, min_matches=20,
                                    min_inliers=12),
    )
    frames_a, _ = render_sequence(cam, _trajectory(6, step=0.012), seed=0)
    frames_b, poses_b = render_sequence(cam, _trajectory(4, step=0.002), seed=0)
    blank = (np.zeros((240, 320), np.float32),) * 2
    return cfg, list(frames_a) + [blank] * 3 + list(frames_b), poses_b


def run_relocalize(device) -> dict:
    """The blackout-teleport run of tests/test_relocalize.py at 320x240: 6
    fast frames, 3 blank ones, 4 slow frames teleported back near the start,
    through `EdgeDvoOdometry` with relocalization. ms per relocalize call
    (host clock around a synchronised call)."""
    import torch

    from rgbd_odometry_tpu_torch import EdgeDvoOdometry
    from rgbd_odometry_tpu_torch.pipeline.gop import REASON_RELOCALIZED

    cfg, seq, poses_b = reloc_case()
    odo = EdgeDvoOdometry(cfg, device=device)
    reloc, calls = odo._reloc, []
    query = reloc.relocalize

    def timed(gray):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = query(gray)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1000.0)
        return res

    reloc.relocalize = timed
    for i, (g, d) in enumerate(seq):
        odo.process_frame(g, d, timestamp=float(i))
    _, t_est, _ = odo.trajectory()
    err = 1000 * np.linalg.norm(t_est[-3:] - np.stack([p[1] for p in poses_b])[-3:], axis=1)
    reasons = [e.reason for e in odo.gop.elements]
    _log(f"relocalize: 13 frames 320x240, {reloc.successes}/{reloc.attempts} recoveries, "
         f"{len(reloc)} keyframes in the database, last 3 frames off by {np.round(err, 3).tolist()} "
         f"mm; relocalize {np.mean(calls):.3f} ms per call (host clock, synchronised)")
    _require(REASON_RELOCALIZED in reasons, f"relocalize: no recovery ({reasons})")
    _require(float(err.max()) < 25.0, f"relocalize: post-recovery error {err.max():.1f} mm")
    return {"recoveries": reloc.successes, "ms_per_call": float(np.mean(calls))}


# FrameMetrics fields held bitwise across the streaming modes (solve_ms is
# the host clock)
METRIC_FIELDS = ("frame_num", "best_energy", "best_iter", "visible_ratio", "b_cap", "num_points",
                 "keyframe_reason", "rolled_back", "diverged", "energy_curve", "final_epsilons",
                 "final_valid")


def _np_same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def run_stream_pipelined(device) -> dict:
    """`EdgeDvoOdometry.process_stream` fed by a `FrameFeeder`, against the
    sequential `process_pyramid` from a feeder and `process_frame`: the
    stream phase's production_320 run in hold mode and with constant
    velocity, and the relocalize phase's run. Poses, keyframes and every
    FrameMetrics field but the host-clock solve_ms must be bitwise equal
    three ways. ms/frame of each way (host clock over all frames, ending
    in a sync, after an untimed `process_frame` run of the same frames) and
    the speculative solves `process_stream` discarded."""
    from rgbd_odometry_tpu_torch import EdgeDvoOdometry, profiles
    from rgbd_odometry_tpu_torch.pipeline.feeder import FrameFeeder

    prof = profiles.production_320()
    frames, _ = stream_frames()
    reloc_cfg, reloc_frames, _ = reloc_case()
    cases = {
        "hold": (_stream_config(prof), frames),
        "constant_velocity": (_stream_config(prof, motion_model="constant_velocity"), frames),
        "relocalize": (reloc_cfg, reloc_frames),
    }
    ways = ("process_stream", "process_pyramid", "process_frame")
    out = {}
    for mode, (cfg, seq) in cases.items():
        def source():
            return ((g, d, float(i)) for i, (g, d) in enumerate(seq))

        def run(way):
            odo = EdgeDvoOdometry(cfg, device=device)
            odo.keep_residuals = True
            feeder = FrameFeeder(source(), num_levels=cfg.pyramid.num_levels, device=device)
            if way == "process_stream":
                for _pose in odo.process_stream(feeder):
                    pass
            elif way == "process_pyramid":
                for pyr, ts in feeder:
                    odo.process_pyramid(pyr, ts)
            else:
                for g, d, ts in source():
                    odo.process_frame(g, d, ts)
            return odo

        run("process_frame")  # warm-up
        runs, ms = {}, {}
        for way in ways:
            _sync(device)
            t0 = time.perf_counter()
            runs[way] = run(way)
            _sync(device)
            ms[way] = (time.perf_counter() - t0) * 1000.0 / len(seq)
        ref = runs["process_frame"]
        R1, t1, ts1 = ref.trajectory()
        for way in ways[:2]:
            odo = runs[way]
            what = f"stream_pipelined {mode}: {way}"
            R2, t2, ts2 = odo.trajectory()
            _require(_np_same(R1, R2) and _np_same(t1, t2) and _np_same(ts1, ts2),
                     f"{what}: poses differ from process_frame's")
            _require([e.reason for e in odo.gop.elements] == [e.reason for e in ref.gop.elements],
                     f"{what}: keyframes differ from process_frame's")
            _require(len(odo.metrics) == len(ref.metrics) == len(seq), f"{what}: metrics count")
            for m1, m2 in zip(ref.metrics, odo.metrics):
                bad = [f for f in METRIC_FIELDS if not _np_same(getattr(m1, f), getattr(m2, f))]
                _require(not bad, f"{what}: frame {m1.frame_num} FrameMetrics {bad} differ")
        pipe = runs["process_stream"]
        # a keyframe decided at a frame with a successor breaks the chain
        switches = sum(m.keyframe_reason != 0 for m in list(ref.metrics)[1:-1])
        _require(pipe.discarded_dispatches >= switches >= 1,
                 f"stream_pipelined {mode}: {pipe.discarded_dispatches} discarded dispatches for "
                 f"{switches} keyframe switches")
        if mode == "relocalize":
            _require(pipe._reloc.successes >= 1, "stream_pipelined relocalize: no recovery")
        _log(f"stream_pipelined {mode}: {len(seq)} frames {cfg.camera.width}x{cfg.camera.height}, "
             f"process_stream, process_pyramid and process_frame bitwise equal (poses, "
             f"keyframes {ref.gop.keyframe_indices()}, every FrameMetrics field); ms/frame "
             + ", ".join(f"{w} {ms[w]:.3f}" for w in ways)
             + f"; {pipe.discarded_dispatches} speculative solves discarded and launched again")
        out[mode] = {"ms_per_frame": ms, "discarded": pipe.discarded_dispatches}
    return out


def run_cli_pipelined(sequential: dict) -> dict:
    """`dvo --pipelined --frames 30`: the trajectory file and the printed
    metrics (ATE and drift as float64 reprs) identical to cli_default's."""
    out = run_cli("cli_pipelined", ["--frames", "30", "--pipelined"], 0.020)
    _require(out["keyframes"] == sequential["keyframes"], "cli_pipelined: keyframes differ")
    _require(out["trajectory"] == sequential["trajectory"],
             "cli_pipelined: trajectory file differs from cli_default's")
    _require(out["metrics"] == sequential["metrics"],
             f"cli_pipelined: metrics {out['metrics']} != {sequential['metrics']}")
    _log(f"cli_pipelined: trajectory file and metrics identical to cli_default's; avg solve "
         f"{out['ms_per_frame']:.3f} ms/frame against {sequential['ms_per_frame']:.3f}")
    return out


def _ply_vertices(path: str) -> int:
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"element vertex"):
                return int(line.split()[-1])
            if line.strip() == b"end_header":
                break
    return 0


def run_cli_loop_close() -> dict:
    """`dvo --frames 30 --loop-close --map-out map.ply`, beside the JAX CLI
    on the CPU (4 closures, ATE 11.51 mm, 15036 map points)."""
    out = run_cli("cli_loop_close", ["--frames", "30", "--loop-close", "--map-out", "{tmp}/map.ply"],
                  0.020, inspect=lambda tmp: {"vertices": _ply_vertices(f"{tmp}/map.ply")})
    n = len(out["summary"]["closures"])
    _log(f"cli_loop_close: {n} closures, ATE {out['ate_mm']:.3f} mm, map {out['vertices']} points "
         f"(JAX CLI on the CPU: 4 closures, 11.51 mm, 15036 points)")
    _require(n >= 1, "cli_loop_close: no closure")
    _require(out["vertices"] > 0 and out["vertices"] == out["summary"]["map_points"],
             "cli_loop_close: empty map")
    return out


def run_cli_weighted_refine() -> dict:
    """`dvo --frames 30 --loop-close --weighted-refine` (JAX CLI on the CPU:
    ATE 5.95 mm)."""
    out = run_cli("cli_weighted_refine", ["--frames", "30", "--loop-close", "--weighted-refine"],
                  0.020)
    _require("(information-weighted odometry edges)" in out["stderr"],
             "cli_weighted_refine: no information-weighted refinement line")
    _log(f"cli_weighted_refine: ATE {out['ate_mm']:.3f} mm (JAX CLI on the CPU: 5.95 mm)")
    return out


def run_cli_refine(loop_close: dict) -> dict:
    """`refine` of cli_loop_close's trajectory with its closures as the
    constraints file, `--robust geman --covariance-out`."""
    import torch

    from rgbd_odometry_tpu_torch import cli
    from rgbd_odometry_tpu_torch.core.geometry import quat_from_rotmat

    summary = loop_close["summary"]
    with tempfile.TemporaryDirectory() as tmp:
        est, lc = os.path.join(tmp, "est.txt"), os.path.join(tmp, "lc.txt")
        with open(est, "w") as fh:
            fh.write(loop_close["trajectory"])
        rows = [[i, j, *t, *quat_from_rotmat(torch.as_tensor(R)).numpy(), 3.0]
                for (i, j, _), (R, t) in zip(summary["closures"], summary["closure_poses"])]
        np.savetxt(lc, np.asarray(rows))
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            cli.main(["refine", est, "--constraints", lc, "--out", os.path.join(tmp, "ref.txt"),
                      "--robust", "geman", "--covariance-out", os.path.join(tmp, "cov.npy")])
        wall = time.perf_counter() - t0
        cov = np.load(os.path.join(tmp, "cov.npy"))
    res = json.loads(stdout.getvalue().strip().splitlines()[-1])
    norms = res["residual_norms"]
    _log(f"cli_refine: {res['nodes']} nodes, {res['loop_closures']} closures, residual norms "
         f"{norms}, closure weights {res.get('closure_robust_weights')}, covariance "
         f"{cov.shape} trace max {res['covariance_trace_max']}, {wall:.2f} s wall")
    # the JSON rounds the norms to 6 decimals
    _require(all(b <= a + 1e-6 for a, b in zip(norms, norms[1:])), "cli_refine: a norm grew")
    _require(cov.shape == (res["nodes"], 6, 6) and np.isfinite(cov).all(), "cli_refine: covariance")
    return {"nodes": res["nodes"], "norms": norms}


def run_multistream(device) -> dict:
    """`MultiStreamOdometry` over 8 of the `multistream` command's rendered
    320x240 streams, 12 frames, at its defaults (hold), then with constant
    velocity; each against 8 `EdgeDvoOdometry` runs with rollback off on
    the same frames: the keyframe schedules must be equal, hold mode's poses
    bitwise equal (every kernel of the path works one image or one pair a
    block), constant velocity's within the JAX test's 1e-2 and bitwise
    unless `cv_extrapolate`, the one batched op of its step outside the
    kernels, itself differs at B = 8 from B = 1, which is checked first.
    Aggregate frames/s of the lockstep loop (host clock, rendering apart,
    ending in a sync)."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig, EdgeDvoOdometry
    from rgbd_odometry_tpu_torch.cli import multistream_config, render_streams
    from rgbd_odometry_tpu_torch.core.geometry import se3_exp
    from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry
    from rgbd_odometry_tpu_torch.pipeline.odometry import cv_extrapolate

    n, frames = MULTI_STREAMS, MULTI_FRAMES
    # the constant-velocity warm start's 3x3 products at B = n against B = 1
    twists = torch.from_numpy(
        (np.random.default_rng(7).uniform(-1, 1, (2 * n, 6)) * 0.05).astype(np.float32)).to(device)
    R, t = se3_exp(twists)
    poses = (R[:n], t[:n], R[n:], t[n:])
    batched = cv_extrapolate(*poses)
    single = [cv_extrapolate(*(x[s:s + 1] for x in poses)) for s in range(n)]
    cv_same = all(_same_bits(batched[i][s:s + 1], single[s][i]) for s in range(n) for i in (0, 1))
    _log(f"multistream: cv_extrapolate on {n} poses {'equals' if cv_same else 'differs from'} "
         f"its {n} one-pose calls bitwise")
    out = {"cv_extrapolate_bitwise": cv_same}

    t0 = time.perf_counter()
    seqs, gts = render_streams(CameraConfig(), n, frames)
    render_s = time.perf_counter() - t0
    for model, bar in (("hold", 0.0), ("constant_velocity", 1e-2)):
        cfg = multistream_config(CameraConfig(), motion_model=model)
        multi = MultiStreamOdometry(n, cfg, device=device)
        multi.prepare()  # the frame step's capture, outside the timed loop
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(frames):
            multi.process_batch(np.stack([sq[f][0] for sq in seqs]),
                                np.stack([sq[f][1] for sq in seqs]), timestamp=f / 30.0)
        torch.cuda.synchronize()
        fps = n * frames / (time.perf_counter() - t0)
        worst, bitwise = 0.0, True
        for s in range(n):
            single = EdgeDvoOdometry(cfg, device=device)
            for f, (g, d) in enumerate(seqs[s]):
                single.process_frame(g, d, timestamp=f / 30.0)
            Rm, tm, _ = multi.trajectories()[s]
            R1, t1, _ = single.trajectory()
            _require(multi.gops[s].keyframe_indices() == single.gop.keyframe_indices(),
                     f"multistream {model}: stream {s} keyframes "
                     f"{multi.gops[s].keyframe_indices()} != single {single.gop.keyframe_indices()}")
            worst = max(worst, float(np.abs(Rm - R1).max()), float(np.abs(tm - t1).max()))
            bitwise &= bool(np.array_equal(Rm, R1) and np.array_equal(tm, t1))
        ate = max(float(np.sqrt(((multi.trajectories()[s][1] - gts[s]) ** 2).sum(-1).mean()))
                  for s in range(n))
        _log(f"multistream {model}: {n} streams x {frames} frames 320x240, keyframes "
             f"{multi.gops[0].keyframe_indices()} (all streams equal to their single runs), "
             f"largest pose difference to the single-stream runs {worst:.3e} "
             f"({'bitwise equal' if bitwise else 'not bitwise'}), ATE max {ate * 1000:.3f} mm, "
             f"{fps:.1f} frames/s aggregate (rendering {render_s:.1f} s apart)")
        _require(worst <= bar, f"multistream {model}: pose difference {worst:.3e} > {bar}")
        if model == "hold":
            _require(bitwise, "multistream hold: lockstep poses are not bitwise the single runs'")
        else:
            _require(bitwise or not cv_same,
                     "multistream constant_velocity: poses differ from the single runs although "
                     "cv_extrapolate is bitwise across batch sizes")
        _require(not multi.diverged_frames,
                 f"multistream {model}: diverged {multi.diverged_frames}")
        out[model] = {"max_pose_diff": worst, "bitwise": bitwise, "frames_per_s": fps}
    return out


def run_cli_multistream() -> dict:
    """`multistream --streams 16 --frames 12 --quality-triggers` as a user
    runs it: every stream within 2 cm (ATE), the aggregate frames/s the
    command prints and the kernels' C calls per lockstep step."""
    from rgbd_odometry_tpu_torch import cli

    counters = _launch_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    stdout, stderr = io.StringIO(), io.StringIO()
    argv = ["multistream", "--streams", "16", "--frames", "12", "--quality-triggers"]
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        summary = cli.main(argv)
    calls = {k: fn.launches - before[k] for k, fn in counters.items()}
    res = json.loads(stdout.getvalue().strip().splitlines()[-1])
    steps = res["frames"]
    per_step = {k: v / steps for k, v in calls.items() if v}
    refreshes = sum(len(k) - 1 for k in summary["keyframes"])
    _log(f"cli_multistream: {' '.join(argv)}: {stderr.getvalue().strip()}; "
         f"{res['aggregate_frames_per_s']} frames/s aggregate ({summary['wall_s']:.3f} s for "
         f"{steps} steps), ATE max {res['ate_rmse_max'] * 1000:.3f} mm, {refreshes} stream "
         f"refreshes; kernel calls per step {per_step} ({sum(per_step.values()):.2f} in all)")
    _require(res["streams"] == 16 and res["devices"] == 1, f"cli_multistream: {res}")
    _require(res["ate_rmse_max"] < 0.02, f"cli_multistream: ATE {res['ate_rmse_max']} >= 20 mm")
    return {"frames_per_s": res["aggregate_frames_per_s"], "ate_max": res["ate_rmse_max"],
            "calls_per_step": per_step}


def run_align_sequence(device) -> dict:
    """`align_sequence` over the stream phase's 30 rendered frames under
    production_320, keyframe-anchored every 5 frames: the last frame within
    tests/test_sharding.py's bar (half the motion, at least 2 cm) and every
    frame within 2 cm; ms for the whole sequence (host clock, one call
    after a warm-up, ending in its one device-to-host copy)."""
    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.parallel.sequence import align_sequence

    prof = profiles.production_320()
    frames, poses = stream_frames()
    args = ([g for g, _ in frames], [d for _, d in frames], Intrinsics.from_config(prof.camera),
            prof.solver, prof.max_points, prof.num_levels, 5)
    align_sequence(*args, device=device)
    t0 = time.perf_counter()
    R, t, rel_R, _ = align_sequence(*args, device=device)
    ms = (time.perf_counter() - t0) * 1000.0
    gt = np.stack([p[1] for p in poses])
    err = np.linalg.norm(t - gt, axis=-1)
    bar = max(0.5 * float(np.linalg.norm(gt[-1])), 0.02)
    _log(f"align_sequence: {len(frames)} frames 320x240 keyframe_every=5, {len(rel_R)} pairs in "
         f"one batch, |t-t_gt| last {err[-1] * 1000:.3f} mm (bar {bar * 1000:.1f} mm), max "
         f"{err.max() * 1000:.3f} mm, {ms:.3f} ms for the sequence")
    _require(np.isfinite(t).all() and err[-1] < bar, f"align_sequence: last frame off {err[-1]}")
    _require(bool((err < 0.02).all()), f"align_sequence: a frame off by {err.max():.4f} m")
    return {"last_mm": float(err[-1]) * 1000.0, "ms": ms}


# ---------------------------------------------------------------------------
# multigpu: the pair batch, the lockstep streams and the sequence over ranks
# ---------------------------------------------------------------------------

MULTIGPU_STREAMS, MULTIGPU_FRAMES = 16, 12  # the multistream command's production cell
MULTIGPU_JOIN_S = 300  # every rank is joined by this deadline
FPS_RUNS = 3  # the timed lockstep loops a world size (the median is kept)
# the kernels every rank of the path must launch
RANK_KERNELS = ("canny_pyramid", "dt_pyramid", "level_lm", "extract")
# the per-iteration and step-by-step kernels no job of the path may launch
RANK_IDLE = ("gn", "sg", "residual", "pnp")


@contextlib.contextmanager
def _job(name: str, jobs: dict, solves: dict):
    """One job of the path, counted on its own: every launch counter and
    the solve counts are set to 0 just before it and read just after into
    `jobs[name]`; afterwards the counters hold what they held before plus
    the job's, so that an enclosing count goes on."""
    counters = _launch_counters()
    saved = {k: fn.launches for k, fn in counters.items()}
    saved_solves = dict(solves)
    for fn in counters.values():
        fn.launches = 0
    for k in solves:
        solves[k] = 0
    yield
    jobs[name] = {"launches": {k: fn.launches for k, fn in counters.items()},
                  "solves": dict(solves)}
    for k, fn in counters.items():
        fn.launches += saved[k]
    for k in solves:
        solves[k] += saved_solves[k]


def _check_job(what: str, job: dict) -> None:
    """A job of the path launched each of its kernels (`RANK_KERNELS`),
    one `dt_pyramid` launch a target preparation, one `level_lm` launch a
    Gauss-Newton solve, and none of `RANK_IDLE`."""
    n, ns = job["launches"], job["solves"]
    _require(all(n[k] > 0 for k in RANK_KERNELS),
             f"{what}: a kernel of the path was not launched: {n}")
    targets = ns[("targets", "gauss_newton")] + ns[("targets", "subgradient")]
    _require(n["dt_pyramid"] == targets, f"{what}: dt_pyramid launched {n['dt_pyramid']} times "
             f"for {targets} target preparations")
    want = ns[("pyramid", "gauss_newton")] + ns[("level", "gauss_newton")]
    _require(n["level_lm"] == want, f"{what}: level_lm launched {n['level_lm']} times for "
             f"{want} solves")
    _require(all(n[k] == 0 for k in RANK_IDLE), f"{what}: launched one of {RANK_IDLE}: {n}")


@contextlib.contextmanager
def _uncounted(solves: dict):
    """The launches and solves inside do not count: the one-process
    references the ranks are held against."""
    counters = _launch_counters()
    saved = {k: fn.launches for k, fn in counters.items()}
    saved_solves = dict(solves)
    yield
    for k, fn in counters.items():
        fn.launches = saved[k]
    solves.update(saved_solves)


def _lockstep_run(multi, gray, depth) -> float:
    """Drive `multi` over frames (N, F, H, W); the loop's wall seconds,
    ending in a sync of its device."""
    import torch

    torch.cuda.synchronize(multi.device)
    t0 = time.perf_counter()
    for f in range(gray.shape[1]):
        multi.process_batch(gray[:, f], depth[:, f], timestamp=f / 30.0)
    torch.cuda.synchronize(multi.device)
    return time.perf_counter() - t0


def _gops_out(gops) -> dict:
    return {"R": np.stack([g.poses()[0] for g in gops]),
            "t": np.stack([g.poses()[1] for g in gops]),
            "keyframes": [g.keyframe_indices() for g in gops]}


def _multigpu_rank(rank: int, world: int, address: str, backend: str, device, inputs: str,
                   out_dir: str, jobs: tuple, cli_address) -> None:
    """A spawned rank of the multigpu phase, on `device` (None: card
    `rank % cards`): its share of each job in `jobs`, each job's launches
    and solves counted on their own (`_job`), written beside the other
    ranks' results. The jobs: "batch" the sharded aligner ("align") and
    train step ("step") over the batch phase's 64 pairs, "lockstep" the 16
    streams in both motion models (the collectives of their steps
    counted), "fps" the timed lockstep loops, "sequence" `align_sequence`;
    with `cli_address`, then the `multistream` command ("cli") as one of
    `world` processes."""
    import torch
    import torch.distributed as dist

    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.cli import multistream_config
    from rgbd_odometry_tpu_torch.config import CameraConfig
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.kernels import build
    from rgbd_odometry_tpu_torch.parallel import launch
    from rgbd_odometry_tpu_torch.parallel import mesh as pmesh
    from rgbd_odometry_tpu_torch.parallel import multihost
    from rgbd_odometry_tpu_torch.parallel.sequence import align_sequence
    from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry

    build.load_all(KERNELS)
    out = {"built": [n for n in KERNELS if build.build_record(n)["built"]], "jobs": {}}
    solves = _count_solves()
    multihost.initialize(address, world, rank, backend=backend, timeout_s=MULTIGPU_JOIN_S)
    mesh = multihost.global_mesh(device)
    out["device"] = str(mesh.device)
    data = np.load(inputs)
    prof = profiles.production_320()
    intr = Intrinsics.from_config(prof.camera)
    if "batch" in jobs:
        rg, rd, ng, nd = pmesh.shard_batch(mesh, tuple(data[k] for k in ("rg", "rd", "ng", "nd")))
        ref, now = build_pyramid(rg, rd, prof.num_levels), build_pyramid(ng, nd, prof.num_levels)
        counts: dict = {}
        with _job("align", out["jobs"], solves), launch.counted_collectives(counts):
            R, t = pmesh.build_sharded_aligner(mesh, intr, prof.solver, prof.max_points)(
                ref.gray, ref.depth, now.gray)
        out["align"] = {"R": R.numpy(), "t": t.numpy(), "collectives": counts}
        counts = {}
        with _job("step", out["jobs"], solves), launch.counted_collectives(counts):
            (R, t), stats = pmesh.build_sharded_train_step(
                mesh, intr, prof.solver, prof.max_points)(ref.gray, ref.depth, now.gray)
        out["step"] = {"R": R.cpu().numpy(), "t": t.cpu().numpy(), "collectives": counts,
                       **{k: v.item() for k, v in stats.items()}}
    for model in ("hold", "constant_velocity") if "lockstep" in jobs else ():
        with _job(model, out["jobs"], solves):
            multi = MultiStreamOdometry(MULTIGPU_STREAMS, multistream_config(
                CameraConfig(), motion_model=model), mesh=mesh)
            counts = {}
            with launch.counted_collectives(counts):
                _lockstep_run(multi, data["gray"], data["depth"])
            gops = multi.all_gops()
        out[model] = {**_gops_out(gops), "collectives": counts,
                      "streams": (multi.lo, multi.hi), "diverged": multi.diverged_frames}
    if "fps" in jobs:
        # the hold loop after a warm-up run, FPS_RUNS times, started together on every rank
        walls = []
        with _job("fps", out["jobs"], solves):
            for run in range(FPS_RUNS + 1):
                multi = MultiStreamOdometry(MULTIGPU_STREAMS, multistream_config(CameraConfig()),
                                            mesh=mesh)
                multi.prepare()  # the frame step's capture, outside the timed loop
                dist.barrier()
                slowest = torch.tensor([_lockstep_run(multi, data["gray"], data["depth"])],
                                       dtype=torch.float64)
                dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
                walls += [float(slowest[0])] if run else []
        out["fps"] = MULTIGPU_STREAMS * MULTIGPU_FRAMES / float(np.median(walls))
    if "sequence" in jobs:
        with _job("sequence", out["jobs"], solves):
            R, t, rel_R, rel_t = align_sequence(
                list(data["seq_gray"]), list(data["seq_depth"]), intr, prof.solver,
                prof.max_points, prof.num_levels, 5, mesh=mesh)
        out["sequence"] = {"R": R, "t": t, "rel_R": rel_R, "rel_t": rel_t}
    multihost.shutdown()
    if cli_address:
        from rgbd_odometry_tpu_torch import cli

        stdout = io.StringIO()
        with _job("cli", out["jobs"], solves), contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(io.StringIO()):
            summary = cli.main(["multistream", "--streams", str(world), "--frames",
                                str(MULTIGPU_FRAMES), "--world-size", str(world), "--rank",
                                str(rank), "--dist-address", cli_address,
                                "--device", device or "cuda"])
        out["cli"] = {"stdout": stdout.getvalue(), "ate": summary["ate_rmse_per_stream"],
                      "devices": summary["devices"]}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _spawn_ranks(world: int, backend: str, device, inputs: str, jobs: tuple, cli: bool,
                 solves: dict) -> list:
    """`world` ranks of `_multigpu_rank` on `device` (None: a card a
    rank), started with the `spawn` method (this process holds a CUDA
    context) and joined by a deadline (`parallel/launch.Ranks`): a rank
    that fails or hangs fails the phase. Every job of every rank must pass
    `_check_job`; the ranks' launches and solves are added to this
    process's counts, which the phase's checks read. Their results, in
    rank order."""
    from rgbd_odometry_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory() as out_dir:
        args = (f"127.0.0.1:{launch.free_port()}", backend, device, inputs, out_dir, jobs,
                f"127.0.0.1:{launch.free_port()}" if cli else None)
        try:
            launch.Ranks(_multigpu_rank, world, args, out_dir, MULTIGPU_JOIN_S).join()
        except RuntimeError as e:
            _require(False, f"multigpu ({backend}): {e}")
        res = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    counters = _launch_counters()
    for r, out in enumerate(res):
        _require(not out["built"], f"multigpu: rank {r} built {out['built']} (the parent builds)")
        for name, job in out["jobs"].items():
            _check_job(f"multigpu: rank {r} of {world} ({backend}), job {name}", job)
            for k, fn in counters.items():
                fn.launches += job["launches"][k]
            for k in solves:
                solves[k] += job["solves"][k]
    return res


def _check_ranks(what: str, res: list, ref: dict, cv_bitwise: bool) -> dict:
    """Hold the ranks' results against the one-process references `ref`:
    the aligner's and the train step's poses bitwise, the stats within
    1e-6 (total points exact), one gather a call and one `all_reduce` a
    step; lockstep's keyframes equal and no collective inside a step, hold
    bitwise, constant velocity within 1e-2 and bitwise where `cv_bitwise`;
    the sequence bitwise."""
    out = {}
    world = len(res)
    if "align" in res[0]:
        for r, o in enumerate(res):
            _require(o["align"]["collectives"] == {"all_gather": 1},
                     f"{what}: the aligner's collectives {o['align']['collectives']}")
            _require(np.array_equal(o["align"]["R"], ref["align"][0]) and
                     np.array_equal(o["align"]["t"], ref["align"][1]),
                     f"{what}: rank {r}'s gathered aligner poses are not the one-process call's")
            _require(o["step"]["collectives"] == {"all_reduce": 1},
                     f"{what}: the train step's collectives {o['step']['collectives']}")
            _require(o["step"]["total_points"] == ref["step"]["total_points"],
                     f"{what}: total points {o['step']['total_points']}")
            for k in ("mean_energy", "mean_visible_ratio"):
                rel = abs(o["step"][k] / ref["step"][k] - 1.0)
                _require(rel <= 1e-6, f"{what}: rank {r} {k} {o['step'][k]} vs {ref['step'][k]}")
        R = np.concatenate([o["step"]["R"] for o in res])
        t = np.concatenate([o["step"]["t"] for o in res])
        _require(np.array_equal(R, ref["step"]["R"]) and np.array_equal(t, ref["step"]["t"]),
                 f"{what}: the train step's poses are not build_batch_step's")
        out["stats"] = {k: res[0]["step"][k] for k in ("mean_energy", "mean_visible_ratio",
                                                       "total_points")}
    for model in ("hold", "constant_velocity") if "hold" in res[0] else ():
        o = res[0][model]
        _require(o["keyframes"] == ref[model]["keyframes"],
                 f"{what} {model}: keyframes {o['keyframes']} != {ref[model]['keyframes']}")
        worst = max(float(np.abs(o["R"] - ref[model]["R"]).max()),
                    float(np.abs(o["t"] - ref[model]["t"]).max()))
        bitwise = bool(np.array_equal(o["R"], ref[model]["R"])
                       and np.array_equal(o["t"], ref[model]["t"]))
        for r, orank in enumerate(res):
            _require(orank[model]["collectives"] == {},
                     f"{what} {model}: rank {r} ran collectives in its steps: "
                     f"{orank[model]['collectives']}")
            _require(not orank[model]["diverged"], f"{what} {model}: diverged")
        if model == "hold":
            _require(bitwise, f"{what}: lockstep hold is not bitwise the one-process run "
                     f"({worst:.3e})")
        else:
            _require(worst <= 1e-2 and (bitwise or not cv_bitwise),
                     f"{what}: constant velocity {worst:.3e} from the one-process run, "
                     f"although cv_extrapolate is bitwise across batch sizes")
        out[model] = {"max_pose_diff": worst, "bitwise": bitwise}
    if "sequence" in res[0]:
        for r, o in enumerate(res):
            _require(all(np.array_equal(o["sequence"][k], ref["sequence"][k])
                         for k in ("R", "t", "rel_R", "rel_t")),
                     f"{what}: rank {r}'s align_sequence is not the one-process call's")
    _log(f"{what}: {world} ranks on {sorted({o['device'] for o in res})}, every result held; "
         f"{out}")
    _log_jobs(what, res)
    return out


def _log_jobs(what: str, res: list) -> None:
    """Each job's launches of the path's kernels, rank by rank."""
    for name in res[0]["jobs"]:
        _log(f"{what}: job {name}: launches a rank (" + ", ".join(RANK_KERNELS) + "): "
             + "; ".join("/".join(str(o["jobs"][name]["launches"][k]) for k in RANK_KERNELS)
                         for o in res))


def _check_cli(what: str, res: list) -> None:
    """`multistream --world-size W` run by the W ranks: only rank 0 prints,
    `"devices"` is W, every stream's ATE < 20 mm."""
    world = len(res)
    for r, o in enumerate(res):
        _require(o["cli"]["devices"] == world and max(o["cli"]["ate"]) < 0.02,
                 f"{what}: multistream --world-size {world}, rank {r}: {o['cli']}")
        _require(bool(o["cli"]["stdout"]) == (r == 0),
                 f"{what}: rank {r} printed {o['cli']['stdout']!r}")
    line = json.loads(res[0]["cli"]["stdout"].strip().splitlines()[-1])
    _log(f"{what}: multistream --streams {world} --world-size {world} as {world} processes: "
         f"{line}")


def run_multigpu(device, solves: dict) -> dict:
    """The port's multi-GPU path (`parallel/` over `torch.distributed`).
    Every kernel is already built here, so the spawned ranks load them.
    (a) NCCL at world 1 on the card: the sharded train step over the batch
    phase's 64 pairs, its poses bitwise `build_batch_step`'s and its stats
    within 1e-6 (`initialize` is a no-op for one process, so the phase
    opens the group itself). (b) 4 ranks sharing the card over gloo: the
    sharded aligner and train step over the 64 pairs, lockstep over the
    `multistream` command's configuration, 16 streams x 12 frames, and
    `align_sequence` over the stream phase's 30 frames, each held against
    the one-process call (`_check_ranks`); then `multistream --streams 4`
    as 4 processes, every ATE < 20 mm; and lockstep frames/s at W = 1, 2
    and 4 ranks on the card (the hold loop after a warm-up, started
    together, over the slowest rank's wall, the median of `FPS_RUNS`).
    (c) where there are two cards or more: W = min(count, 4) ranks, one a
    card, over NCCL, held as (b). Each job of the path, in this process
    and in every rank, is counted on its own and must launch the path's
    kernels (`_check_job`); the phase's launches are those jobs' (the
    one-process references are not counted, `_uncounted`)."""
    import torch
    import torch.distributed as dist

    from rgbd_odometry_tpu_torch import profiles
    from rgbd_odometry_tpu_torch.cli import multistream_config, render_streams
    from rgbd_odometry_tpu_torch.config import CameraConfig
    from rgbd_odometry_tpu_torch.core.camera import Intrinsics
    from rgbd_odometry_tpu_torch.core.geometry import se3_exp
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.parallel import launch
    from rgbd_odometry_tpu_torch.parallel import mesh as pmesh
    from rgbd_odometry_tpu_torch.parallel import multihost
    from rgbd_odometry_tpu_torch.parallel.sequence import align_sequence
    from rgbd_odometry_tpu_torch.parallel.streams import MultiStreamOdometry
    from rgbd_odometry_tpu_torch.pipeline.odometry import cv_extrapolate
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    prof = profiles.production_320()
    intr = Intrinsics.from_config(prof.camera)
    rg, rd, ng, nd, _ = render_batch(prof.camera, BATCH)
    seqs, _ = render_streams(CameraConfig(), MULTIGPU_STREAMS, MULTIGPU_FRAMES)
    gray = np.stack([[f[0] for f in sq] for sq in seqs])
    depth = np.stack([[f[1] for f in sq] for sq in seqs])
    frames, _ = stream_frames()

    # the one-process references (their launches are not the path's)
    with _uncounted(solves):
        f = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        ref = build_pyramid(f(rg), f(rd), prof.num_levels)
        now = build_pyramid(f(ng), f(nd), prof.num_levels)
        R, t, _ = edge_dvo.align_pair(ref.gray, ref.depth, now.gray, intr, prof.solver,
                                      prof.max_points)
        refs = {"align": (R.cpu().numpy(), t.cpu().numpy())}
        (R, t), stats = pmesh.build_batch_step(intr, prof.solver, prof.max_points)(
            ref.gray, ref.depth, now.gray)
        refs["step"] = {"R": R.cpu().numpy(), "t": t.cpu().numpy(),
                        **{k: v.item() for k, v in stats.items()}}
        fps = {}
        for model in ("hold", "constant_velocity"):
            multi = MultiStreamOdometry(MULTIGPU_STREAMS, multistream_config(
                CameraConfig(), motion_model=model), device=device)
            _lockstep_run(multi, gray, depth)
            refs[model] = _gops_out(multi.gops)
        walls = [_lockstep_run(MultiStreamOdometry(MULTIGPU_STREAMS, multistream_config(
            CameraConfig()), device=device), gray, depth) for _ in range(FPS_RUNS)]
        fps[1] = MULTIGPU_STREAMS * MULTIGPU_FRAMES / float(np.median(walls))
        R, t, rel_R, rel_t = align_sequence([g for g, _ in frames], [d for _, d in frames], intr,
                                            prof.solver, prof.max_points, prof.num_levels, 5,
                                            device=device)
        refs["sequence"] = {"R": R, "t": t, "rel_R": rel_R, "rel_t": rel_t}
    # cv_extrapolate at a rank's batch against the whole batch's
    twists = torch.from_numpy((np.random.default_rng(7).uniform(-1, 1, (
        2 * MULTIGPU_STREAMS, 6)) * 0.05).astype(np.float32)).to(device)
    Rt, tt = se3_exp(twists)
    poses = (Rt[:MULTIGPU_STREAMS], tt[:MULTIGPU_STREAMS], Rt[MULTIGPU_STREAMS:],
             tt[MULTIGPU_STREAMS:])
    whole = cv_extrapolate(*poses)
    cv_bitwise = {}
    for world in (2, 4):
        b = MULTIGPU_STREAMS // world
        parts = [cv_extrapolate(*(x[i:i + b] for x in poses))
                 for i in range(0, MULTIGPU_STREAMS, b)]
        cv_bitwise[world] = all(_same_bits(torch.cat([p[i] for p in parts]), whole[i])
                                for i in (0, 1))
    _log(f"multigpu: cv_extrapolate at B = 8 / 4 {'equals' if cv_bitwise[2] else 'differs from'}"
         f" / {'equals' if cv_bitwise[4] else 'differs from'} B = 16 bitwise")

    out = {}
    # (a) NCCL at world 1 on the card
    dist.init_process_group(multihost.NCCL,
                            init_method=f"tcp://127.0.0.1:{launch.free_port()}",
                            world_size=1, rank=0)
    jobs: dict = {}
    try:
        mesh = multihost.global_mesh(device)
        counts: dict = {}
        with _job("step", jobs, solves), launch.counted_collectives(counts):
            (R, t), stats = pmesh.build_sharded_train_step(mesh, intr, prof.solver,
                                                           prof.max_points)(
                ref.gray, ref.depth, now.gray)
        torch.cuda.synchronize()
    finally:
        multihost.shutdown()
    _check_job("multigpu (a): the NCCL train step", jobs["step"])
    _require(counts == {"all_reduce": 1}, f"multigpu (a): collectives {counts}")
    _require(_same_bits(R.cpu(), torch.from_numpy(refs["step"]["R"])) and
             _same_bits(t.cpu(), torch.from_numpy(refs["step"]["t"])),
             "multigpu (a): the NCCL train step's poses are not build_batch_step's")
    for k in ("mean_energy", "mean_visible_ratio"):
        _require(abs(stats[k].item() / refs["step"][k] - 1.0) <= 1e-6,
                 f"multigpu (a): {k} {stats[k].item()} vs {refs['step'][k]}")
    _require(stats["total_points"].item() == refs["step"]["total_points"],
             "multigpu (a): total points")
    _log(f"multigpu (a): NCCL at world 1 on {torch.cuda.get_device_name(0)}: the train step "
         f"over {BATCH} pairs bitwise build_batch_step's, stats "
         f"{ {k: v.item() for k, v in stats.items()} } (one all_reduce); launches ("
         + ", ".join(RANK_KERNELS) + "): "
         + "/".join(str(jobs["step"]["launches"][k]) for k in RANK_KERNELS))

    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, rg=rg, rd=rd, ng=ng, nd=nd, gray=gray, depth=depth,
                 seq_gray=np.stack([g for g, _ in frames]),
                 seq_depth=np.stack([d for _, d in frames]))
        # (b) 4 ranks sharing the card over gloo
        t0 = time.perf_counter()
        res = _spawn_ranks(4, multihost.GLOO, str(device), inputs,
                           ("batch", "lockstep", "fps", "sequence"), True, solves)
        out["gloo_4"] = _check_ranks("multigpu (b) gloo x4", res, refs, cv_bitwise[4])
        fps[4] = res[0]["fps"]
        _check_cli("multigpu (b)", res)
        _log(f"multigpu (b): {time.perf_counter() - t0:.1f} s")
        res = _spawn_ranks(2, multihost.GLOO, str(device), inputs, ("fps",), False, solves)
        fps[2] = res[0]["fps"]
        _log_jobs("multigpu (b) gloo x2", res)
        # (c) NCCL across cards, one rank a card
        cards = torch.cuda.device_count()
        if cards >= 2:
            world = min(cards, 4)
            cv_world = cv_bitwise.get(world, False)
            res = _spawn_ranks(world, multihost.NCCL, None, inputs,
                               ("batch", "lockstep", "fps", "sequence"), True, solves)
            out["nccl_cards"] = _check_ranks(f"multigpu (c) NCCL x{world} cards", res, refs,
                                             cv_world)
            _check_cli("multigpu (c)", res)
            out["nccl_cards"]["fps"] = res[0]["fps"]
            _log(f"multigpu (c): lockstep frames/s over {world} cards (NCCL, a rank a card): "
                 f"{res[0]['fps']:.1f}")
        else:
            _log(f"multigpu (c): not run: {cards} CUDA device (NCCL across cards needs two or "
                 f"more; run on a host with several cards)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={device.index or 0}"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _log(f"multigpu: lockstep frames/s on one card, {MULTIGPU_STREAMS} streams x "
         f"{MULTIGPU_FRAMES} frames (hold, after a warm-up, the slowest rank's loop, the median "
         f"of {FPS_RUNS}): "
         + ", ".join(f"W = {w}: {v:.1f}" for w, v in sorted(fps.items())) + f" ({smi})")
    out["frames_per_s"] = fps
    return out


def run_cli_cam_scale(scale: int, frames: int) -> dict:
    """`dvo --cam-scale <scale> --frames <frames>`: level 0 at 960x720 (3) or
    1280x960 (4, where Canny's hysteresis and extraction run level 0 on a
    cluster of blocks); ATE < 20 mm, the cli_default bar."""
    name = f"cli_cam_scale_{scale}"
    out = run_cli(name, ["--cam-scale", str(scale), "--frames", str(frames)], 0.020)
    _log(f"{name}: {320 * scale}x{240 * scale}, ATE {out['ate_mm']:.3f} mm, "
         f"{out['ms_per_frame']:.3f} ms/frame solve")
    return out


_CKPT_FLAGS = ["--loop-close", "--refine-every", "2", "--relocalize"]


def _resume_same(name: str, extra) -> dict:
    """30 frames in one run against 15, a checkpoint, and a resume for the
    rest: the trajectory file, the closures, the keyframes and the
    relocalizer's counters identical."""
    with tempfile.TemporaryDirectory() as tmp:
        c = os.path.join(tmp, "c.npz")
        full = run_cli(f"{name}_full", [*_CKPT_FLAGS, *extra, "--frames", "30"], 0.020)
        run_cli(f"{name}_first15", [*_CKPT_FLAGS, *extra, "--frames", "15", "--checkpoint", c],
                0.020)
        resumed = run_cli(f"{name}_resumed", [*_CKPT_FLAGS, *extra, "--frames", "30",
                                              "--resume", c], 0.020)
    s, r = full["summary"], resumed["summary"]
    _require(resumed["trajectory"] == full["trajectory"],
             f"{name}: the resumed trajectory file differs from the uninterrupted run's")
    _require(r["closures"] == s["closures"] and r["keyframes"] == s["keyframes"],
             f"{name}: closures or keyframes differ")
    _require((r["recoveries"], r["reloc_attempts"]) == (s["recoveries"], s["reloc_attempts"]),
             f"{name}: relocalizer counters differ")
    _require(resumed["metrics"] == full["metrics"], f"{name}: metrics differ")
    _log(f"{name}: 15 + checkpoint + resume 15 = 30 frames in one run: trajectory file, "
         f"{len(s['closures'])} closures, keyframes, relocalizer {s['recoveries']}/"
         f"{s['reloc_attempts']} identical; ATE {full['ate_mm']:.3f} mm")
    return full


def time_checkpoint(device) -> dict:
    """Save and load (`save_odometry`; `read_checkpoint`, then
    `load_odometry` and `load_loop_closer` from it, as `dvo --resume` does)
    of a `dvo --loop-close --relocalize` state with 8, 128 and 256
    keyframes in each store, the load timed as the best of 5 rounds over
    the three files (the host's drift spread over all three). The load
    reads each array of the file once (counted), and its cost per keyframe
    from 128 to 256 keyframes is at most twice that from 8 to 128: a restore
    that read an array per keyframe would grow with the square of the
    store."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig, PipelineConfig, RelocalizeConfig
    from rgbd_odometry_tpu_torch.io.stream import SyntheticCamera
    from rgbd_odometry_tpu_torch.pipeline.loop_closure import KeyframeRecord, LoopCloser
    from rgbd_odometry_tpu_torch.pipeline.odometry import EdgeDvoOdometry
    from rgbd_odometry_tpu_torch.utils import checkpoint as ckpt

    frames = list(SyntheticCamera(CameraConfig(), num_frames=2).frames())
    odo = EdgeDvoOdometry(PipelineConfig(relocalize=RelocalizeConfig(enabled=True)),
                          device=device)
    for g, d, ts in frames:
        odo.process_frame(g, d, ts)
    closer = LoopCloser(odo.intr, device=device)
    g, d, _ = frames[-1]
    sk_r, sk_l = odo._reloc.matcher.describe(g, d), closer.matcher.describe(g, d)
    reads: dict = {}
    real = np.lib.npyio.NpzFile.__getitem__

    def counting(npz, key):
        reads[key] = reads.get(key, 0) + 1
        return real(npz, key)

    def load(path):
        t0 = time.perf_counter()
        snap = ckpt.read_checkpoint(path)
        back = ckpt.load_odometry(snap, device=device)
        lc = ckpt.load_loop_closer(snap, back.intr, device=device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000.0, back, lc

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in (8, 128, 256):
            while len(odo._reloc) < n:
                odo._reloc.matcher.store(sk_r)
                odo._reloc.poses.append((np.eye(3), np.zeros(3)))
                odo._reloc.nodes.append(len(odo._reloc.nodes))
            while len(closer.keyframes) < n:
                closer.matcher.store(sk_l)
                closer.keyframes.append(KeyframeRecord(len(closer.keyframes), sk_l.pts3d,
                                                       sk_l.pts_valid))
            path = os.path.join(tmp, f"c{n}.npz")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save_odometry(odo, path, closer=closer, raw_rels=[], refine_state={
                "kf": 0, "closures": 0})
            save_ms = (time.perf_counter() - t0) * 1000.0
            reads.clear()
            np.lib.npyio.NpzFile.__getitem__ = counting
            try:
                _, back, lc = load(path)
            finally:
                np.lib.npyio.NpzFile.__getitem__ = real
            _require(max(reads.values()) == 1, f"checkpoint: {n} keyframes: an array was read "
                     f"{max(reads.values())} times")
            _require(len(back._reloc) == n and len(lc.keyframes) == n,
                     f"checkpoint: {n} keyframes did not come back")
            _require(torch.equal(lc.matcher._slots.desc, closer.matcher._slots.desc),
                     "checkpoint: the loop closer's slot buffer differs")
            out[n] = {"save_ms": save_ms, "load_ms": float("inf"), "bytes": os.path.getsize(path),
                      "arrays": len(reads)}
        for _ in range(5):
            for n, o in out.items():
                o["load_ms"] = min(o["load_ms"], load(os.path.join(tmp, f"c{n}.npz"))[0])
    for n, o in out.items():
        _log(f"checkpoint with {n} keyframes in each store: save {o['save_ms']:.1f} ms, load "
             f"{o['load_ms']:.1f} ms (best of 5; each of {o['arrays']} arrays read once), "
             f"{o['bytes'] / 1e6:.2f} MB")
    low = (out[128]["load_ms"] - out[8]["load_ms"]) / 120
    high = (out[256]["load_ms"] - out[128]["load_ms"]) / 128
    _log(f"checkpoint load per keyframe: {low:.3f} ms from 8 to 128, {high:.3f} ms from 128 "
         f"to 256")
    _require(high <= 2 * low, "checkpoint: the restore's cost per keyframe grows with the store")
    return {**out, "load_ms_per_keyframe": {"8-128": low, "128-256": high}}


def run_cli_checkpoint(device) -> dict:
    """cli_checkpoint: `dvo --loop-close --refine-every 2 --relocalize`, hold
    and constant velocity, each bitwise across a checkpoint (`_resume_same`),
    and the save and load times at 8, 128 and 256 keyframes
    (`time_checkpoint`)."""
    hold = _resume_same("cli_checkpoint", [])
    _resume_same("cli_checkpoint_cv", ["--motion-model", "constant_velocity"])
    return {**hold, "save_load": time_checkpoint(device)}


_VIZ_SHAPES = {"overlay": (240, 320, 3), "residue": (240, 320, 3), "energy": (200, 400, 3),
               "histogram": (250, 520, 3), "trajectory.png": (400, 400, 3),
               "reprojection": (240, 644)}


def _viz_files(tmp: str) -> dict:
    from rgbd_odometry_tpu_torch.viz.png import read_png

    d = os.path.join(tmp, "viz")
    return {"viz": {n: read_png(os.path.join(d, n)).shape for n in sorted(os.listdir(d))}}


def run_cli_viz(cli_default: dict) -> dict:
    """`dvo --frames 30 --viz-dir`: the JAX sink's file set (overlay, energy,
    residue and histogram images of frames 5, 10, ..., 25, the trajectory
    and the reprojection composite), each decoded by the port's PNG reader
    to its shape, and the trajectory file of cli_default."""
    out = run_cli("cli_viz", ["--frames", "30", "--viz-dir", "{tmp}/viz"], 0.020,
                  inspect=_viz_files)
    want = {f"{k}_{n:04d}.png" for k in ("overlay", "energy", "residue", "histogram")
            for n in range(5, 30, 5)} | {"trajectory.png", "reprojection_debug.png"}
    _require(set(out["viz"]) == want, f"cli_viz: files {sorted(out['viz'])}")
    for name, shape in out["viz"].items():
        _require(shape == _VIZ_SHAPES[name.split("_")[0]], f"cli_viz: {name} is {shape}")
    _require(out["trajectory"] == cli_default["trajectory"],
             "cli_viz: the trajectory differs from cli_default's")
    _log(f"cli_viz: {len(want)} PNGs decoded to their shapes; trajectory file identical to "
         f"cli_default's")
    return out


_TRACED = ("canny_pyramid", "dt_pyramid", "level_lm", "extract_pyramid")
# the host ranges of a traced `dvo` run: a solved frame's targets and solve
# are one frame step replay (its kernels run inside the graph), a keyframe
# one extraction call
_TRACED_HOST = ("frame_step", "extract_pyramid")


def _trace_names(tmp: str) -> dict:
    import glob

    files = glob.glob(os.path.join(tmp, "trace", "*.pt.trace.json"))
    _require(len(files) == 1, f"cli_trace: {len(files)} trace files")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    host, device = {}, {}
    for e in events:
        name, cat = str(e.get("name", "")), str(e.get("cat", ""))
        if cat == "user_annotation" and name in _TRACED + _TRACED_HOST:
            host[name] = host.get(name, 0) + 1
        elif cat == "kernel":
            device[name] = device.get(name, 0) + 1
    return {"host": host, "device": device, "trace_bytes": os.path.getsize(files[0])}


def run_cli_trace(cli_default: dict) -> dict:
    """`dvo --frames 30 --trace-dir`: a Chrome trace whose host ranges name
    every frame step replay (`frame_step`: the frame's `canny_pyramid`,
    `dt_pyramid` and `level_lm` launches are inside its graph, captured
    before the trace starts) and `extract_pyramid` call, and whose device
    events hold the four kernels (`canny_pyramid_*`, `dt_pyramid_kernel`,
    `level_lm`, `extract_pyramid_kernel`); the trajectory file of cli_default."""
    out = run_cli("cli_trace", ["--frames", "30", "--trace-dir", "{tmp}/trace"], 0.020,
                  inspect=_trace_names)
    _require(all(out["host"].get(k, 0) > 0 for k in _TRACED_HOST),
             f"cli_trace: host ranges {out['host']}")
    dev = out["device"]
    kernels = {k: sum(v for n, v in dev.items() if key in n)
               for k, key in zip(_TRACED, ("canny_pyramid", "dt_pyramid", "level_lm",
                                           "extract_pyramid"))}
    _require(all(v > 0 for v in kernels.values()), f"cli_trace: device kernels {kernels} "
             f"(of {sum(dev.values())} kernel events)")
    _require(out["trajectory"] == cli_default["trajectory"],
             "cli_trace: the trajectory differs from cli_default's")
    _log(f"cli_trace: host ranges {out['host']}, device kernels {kernels}, "
         f"{out['trace_bytes'] / 1e6:.1f} MB trace; trajectory file identical to cli_default's")
    return out


def run_cli_xml(device) -> dict:
    """`dump --frames 15 --levels 4` on the card, every dumped level read
    back bitwise as the pyramid built from the same frames (rounded to
    8 and 16 bits), then `dvo --source xml:<dir>`: ATE < 20 mm against the
    synthetic ground truth (the cli_default bar)."""
    import torch

    from rgbd_odometry_tpu_torch import CameraConfig, cli
    from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid
    from rgbd_odometry_tpu_torch.eval.ate import ate_rmse
    from rgbd_odometry_tpu_torch.io.stream import SyntheticCamera
    from rgbd_odometry_tpu_torch.io.tum import read_trajectory
    from rgbd_odometry_tpu_torch.io.xml_dump import frame_path, read_frame_dump

    synth = SyntheticCamera(CameraConfig(), num_frames=15)
    with tempfile.TemporaryDirectory() as tmp:
        d, est = os.path.join(tmp, "dumps"), os.path.join(tmp, "est.txt")
        with contextlib.redirect_stdout(io.StringIO()):
            res = cli.main(["dump", "--frames", "15", "--levels", "4", "--out-dir", d])
        _require(res["frames_written"] == 15, f"cli_xml: dump wrote {res}")
        for i, (g, dep, _) in enumerate(synth.frames()):
            f32 = dict(dtype=torch.float32, device=device)
            pyr = build_pyramid(torch.as_tensor(g, **f32)[None], torch.as_tensor(dep, **f32)[None], 4)
            gray, depth = read_frame_dump(frame_path(d, i))
            for lvl in range(4):
                for x, y, hi in ((gray[lvl], pyr.gray[lvl], 255), (depth[lvl], pyr.depth[lvl], 65535)):
                    want = np.clip(np.round(y[0].cpu().numpy().astype(np.float64)), 0, hi)
                    _require(np.array_equal(x, want.astype(np.float32)),
                             f"cli_xml: frame {i} level {lvl} does not read back")
        stderr = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(stderr):
            summary = cli.main(["dvo", "--source", f"xml:{d}", "--out", est])
        _, t, _ = read_trajectory(est)
    ate = ate_rmse(t, synth.ground_truth()[1][: len(t)], align=False)
    _log(f"cli_xml: 15 frames x 4 levels dumped and read back bitwise; dvo --source xml: "
         f"{summary['frames']} frames, ATE {ate * 1000:.3f} mm, {summary['avg_solve_ms']:.3f} "
         f"ms/frame solve")
    _require(summary["frames"] == 15 and ate < 0.020, f"cli_xml: ATE {ate * 1000:.3f} mm")
    return {"ate_mm": ate * 1000.0}


def run_probe() -> dict:
    """`probe --method subgradient` and `--method gauss_newton` at level 0,
    100 iterations, on the card, held to the level kernels' bars against the
    plain version of its level on the same card inputs (the probe's own
    features and targets). Gauss-Newton: `_check_level_curves` against
    `level_lm_plain`. Sub-gradient: the probe's launch again with its
    trace, every step on its own (`_check_sg_steps`), then
    `_check_sg_curves` against `level_sg_plain`. Two free-running descents
    may part for good at one floor decision (check_level_sg sees 0-5 of 64
    pairs part at 50 iterations and holds half of them to never part), so
    the probe's one pair may part, within the bar."""
    from types import SimpleNamespace

    import torch

    from rgbd_odometry_tpu_torch import cli
    from rgbd_odometry_tpu_torch.kernels import level_lm, level_sg, sg_terms
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    out = {}
    for method in ("subgradient", "gauss_newton"):
        with contextlib.redirect_stdout(io.StringIO()):
            r = cli.main(["probe", "--method", method, "--level", "0", "--iterations", "100"])
        d, ref, now, cfg, li = r["diag"], r["ref"], r["now"], r["cfg"], r["intr"]
        ker = SimpleNamespace(energy=d.energy, best_iter=d.best_iter,
                              visible_ratio=d.visible_ratio, R=r["R"], t=r["t"])
        R0 = torch.eye(3, device=ref.pts3d.device)[None]
        t0 = torch.zeros((1, 3), device=R0.device)
        what = f"probe {method} level 0, 100 iterations"
        if method == "subgradient":
            args = (R0, t0, ref.pts3d, ref.valid, ref.count, now.dt, *li, cfg, 100)
            trace = torch.zeros((1, 100, 18), device=R0.device)
            # the check's launches are not the path's: their counts are put back
            counted = (level_sg.level_sg_pyramid, sg_terms.subgradient_terms)
            before = [fn.launches for fn in counted]
            again = level_sg.level_sg(*args, trace=trace)
            _require(_same_bits(again.energy, d.energy),
                     f"{what}: the traced launch differs from the probe's")
            _check_sg_steps(what, cfg, args, again, trace)
            for fn, n in zip(counted, before):
                fn.launches = n
            pl = level_sg.level_sg_plain(*args)
            torch.cuda.synchronize()
            _, err, _ = _check_sg_curves(what, ker, pl)
        else:
            jstride, stride = edge_dvo.level_strides(cfg, ref.pts3d.shape[1])
            pl = level_lm.level_lm_plain(R0, t0, ref.pts3d, ref.valid, ref.count,
                                         now.chans[:, 0], now.scale, *li, cfg, 100, jstride,
                                         stride)
            torch.cuda.synchronize()
            err = _check_level_curves(what, cfg, ker, pl)
        _log(f"{what}: within the level kernel's bars against its plain version; best "
             f"iteration {int(ker.best_iter[0])} / {int(pl.best_iter[0])}, energy "
             f"{r['best_energy']}, pose err {err:.2e}")
        out[method] = {"best_iter": int(ker.best_iter[0]), "pose_err": err,
                       "best_energy": r["best_energy"]}
    return out


def _quiet(fn, *a, **k):
    """fn(*a, **k) with its stdout and stderr captured: (result, stdout,
    stderr, wall seconds)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        r = fn(*a, **k)
    return r, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def run_cli_photometric() -> dict:
    """`photometric --frames 30 --cam-scale 2 --huber` (640x480: the
    reference's levels 3 and 2 are 80x60 and 160x120 of its VGA pyramid): 30
    trajectory rows, one `level_photo` launch for each of the 29 solved
    frames, and the trajectory within 1e-4 (m, and of the rotations) of the
    plain route's: the same command over the same frames with `level_photo`
    replaced by its plain version on the card."""
    from rgbd_odometry_tpu_torch import cli
    from rgbd_odometry_tpu_torch.kernels import level_photo as klp

    argv = ["photometric", "--frames", "30", "--cam-scale", "2", "--huber"]
    make, cache = cli._make_source, []

    def recording(args):
        frames, cam, gt = make(args)
        cache.append((list(frames), cam, gt))
        return iter(cache[0][0]), cam, gt

    n0 = klp.level_photo.launches
    with _patched(cli, _make_source=recording):
        got, _, err, wall = _quiet(cli.main, argv)
    launched = klp.level_photo.launches - n0
    frames, cam, gt = cache[0]
    with _patched(cli, _make_source=lambda args: (iter(frames), cam, gt)), \
            _patched(klp, level_photo=klp.level_photo_plain):
        plain, _, _, plain_wall = _quiet(cli.main, argv)
    err_t = float(np.abs(got["t"] - plain["t"]).max())
    err_R = float(np.abs(got["R"] - plain["R"]).max())
    lines = [ln for ln in err.splitlines() if ln.startswith("frame ")]
    ate = float(np.sqrt(np.mean(np.sum((got["t"] - gt[1][:30]) ** 2, -1))))
    _log(f"cli_photometric: photometric {' '.join(argv[1:])}: {got['frames']} rows, "
         f"{launched} level_photo launches for {len(lines)} solved frames, last |eps| "
         f"{got['eps'][-1]:.1f}, ATE {ate * 1000:.3f} mm; against the plain route t "
         f"{err_t:.2e}, R {err_R:.2e}; {wall:.1f} s wall (plain route {plain_wall:.1f} s)")
    _require(got["frames"] == 30 and got["t"].shape == (30, 3) and len(lines) == 29,
             "cli_photometric: not 30 rows and 29 solved frames")
    _require(launched == 29, f"cli_photometric: {launched} level_photo launches for 29 frames")
    _require(err_t <= 1e-4 and err_R <= 1e-4,
             f"cli_photometric: {err_t:.2e} m / {err_R:.2e} from the plain route")
    return {"frames": got["frames"], "launches_per_frame": launched / 29, "ate_mm": ate * 1000.0,
            "plain_route_err": max(err_t, err_R)}


def run_cli_fused() -> dict:
    """`fused --frames 30 --imu-refine --imu-noise 0.01` at the command's
    defaults otherwise (320x240): unaligned ATE < 20 mm and the refined
    trajectory no worse than the visual one (+1e-4); a line a frame. The
    wall time of the refinement (the pose graph's first jacfwd set-up)."""
    from rgbd_odometry_tpu_torch import cli
    from rgbd_odometry_tpu_torch.pipeline import fused

    refine, took = fused.refine_trajectory_with_imu, []

    def timed(*a, **k):
        t0 = time.perf_counter()
        r = refine(*a, **k)
        took.append(time.perf_counter() - t0)
        return r

    with tempfile.TemporaryDirectory() as tmp:
        est = os.path.join(tmp, "fused.txt")
        with _patched(fused, refine_trajectory_with_imu=timed):
            got, out, err, wall = _quiet(cli.main, ["fused", "--frames", "30", "--imu-refine",
                                                    "--imu-noise", "0.01", "--out", est])
        rows = np.loadtxt(est, comments="#", ndmin=2)
    summary = json.loads(out.strip().splitlines()[-1])
    lines = [ln for ln in err.splitlines() if ln.startswith("frame ")]
    _log(f"cli_fused: fused --frames 30 --imu-refine --imu-noise 0.01: ATE "
         f"{summary['ate_rmse'] * 1000:.3f} mm refined, {summary['ate_rmse_unrefined'] * 1000:.3f}"
         f" mm unrefined, fallback frames {summary['fallback_frames']}; refinement "
         f"{took[0]:.2f} s, {wall:.1f} s wall incl. rendering")
    _require(summary["frames"] == 30 and rows.shape == (30, 8) and len(lines) == 30,
             "cli_fused: not 30 frames")
    _require(summary["ate_rmse"] < 0.020, f"cli_fused: ATE {summary['ate_rmse'] * 1000:.3f} mm")
    _require(summary["ate_rmse"] <= summary["ate_rmse_unrefined"] + 1e-4,
             "cli_fused: the refinement made the trajectory worse")
    return {"ate_mm": summary["ate_rmse"] * 1000.0,
            "ate_unrefined_mm": summary["ate_rmse_unrefined"] * 1000.0,
            "fallback_frames": summary["fallback_frames"], "refine_s": took[0]}


def run_fused_fallback(device) -> dict:
    """`FusedOdometry` as JAX's `test_fused_fallback_fires` sets it up (b-hat
    threshold 0, min_pnp_matches 5, its 4-frame trajectory, 3 levels
    2048/1024/512, 50/8/5 iterations) at 320x240: at least one fallback
    frame, the last frame within 0.12 m of ground truth."""
    from rgbd_odometry_tpu_torch import config as pc
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence
    from rgbd_odometry_tpu_torch.pipeline.fused import FusedConfig, FusedOdometry

    cam = pc.CameraConfig()
    frames, poses = render_sequence(cam, _trajectory(4, 0.004), seed=0)
    cfg = pc.PipelineConfig(
        camera=cam, pyramid=pc.PyramidConfig(num_levels=3, max_points=(2048, 1024, 512)),
        solver=pc.SolverConfig(method="gauss_newton", iterations=(50, 8, 5)),
        keyframe=pc.KeyframeConfig())
    fo = FusedOdometry(cfg, FusedConfig(laplacian_b_thresh=0.0, min_pnp_matches=5),
                       device=device)
    for i, (g, d) in enumerate(frames):
        fo.process_frame(g, d, float(i))
    _, t, _ = fo.trajectory()
    err = float(np.linalg.norm(t[-1] - poses[-1][1]))
    _log(f"fused_fallback: 4 frames 320x240, fallback frames {fo.fallback_frames}, last frame "
         f"{err * 1000:.3f} mm from ground truth")
    _require(len(fo.fallback_frames) >= 1, "fused_fallback: the fallback never fired")
    _require(err < 0.12, f"fused_fallback: last frame {err:.3f} m off")
    return {"fallback_frames": fo.fallback_frames, "err_mm": err * 1000.0}


def run_cli_feature_vo() -> dict:
    """`feature-vo --frames 30` (320x240, --min-matches 40): 30 trajectory
    rows and a line a frame. The JAX package's own feature VO loses this
    synthetic track: every frame through 15 within JAX's
    `test_feature_vo_tracks` bar of 0.1 m, frame 16 metres off, NaN later
    (tests/test_torch_feature_vo.py: the port on the CPU loses it at the
    same frames, with JAX's counts and keyframes). So the card's run holds
    the good-match counts a frame (which fix every keyframe switch) to
    JAX's, every frame before FEATURE_VO_LOST_FROM to 0.1 m and finite, and
    the loss to the same frame; where NaN starts is logged."""
    from rgbd_odometry_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        est = os.path.join(tmp, "fv.txt")
        got, _, err, wall = _quiet(cli.main, ["feature-vo", "--frames", "30", "--out", est])
        rows = np.loadtxt(est, comments="#", ndmin=2)
    gt_t = got["gt"][1]
    errs = np.linalg.norm(got["t"] - gt_t[:30], axis=-1)
    lost = [i for i, e in enumerate(errs) if not e < 0.1]
    nan = [i for i, e in enumerate(errs) if not np.isfinite(e)]
    tracked = errs[:FEATURE_VO_LOST_FROM]
    _log(f"cli_feature_vo: feature-vo --frames 30: {rows.shape[0]} rows, good matches "
         f"{got['match_counts']}, frames 0-{FEATURE_VO_LOST_FROM - 1} at most "
         f"{tracked.max() * 1000:.3f} mm from ground truth (frame 9 {errs[9] * 1000:.3f}), "
         f"frames past 0.1 m or NaN {lost}, NaN from {nan[0] if nan else None}, {wall:.1f} s "
         "wall incl. rendering")
    _require(rows.shape == (30, 8) and err.count("good matches") == 30,
             "cli_feature_vo: not 30 frames")
    _require(tuple(got["match_counts"]) == FEATURE_VO_COUNTS,
             f"cli_feature_vo: good matches {got['match_counts']}, the JAX package's "
             f"{list(FEATURE_VO_COUNTS)}")
    _require(bool(np.all(tracked < 0.1)),
             f"cli_feature_vo: frames before {FEATURE_VO_LOST_FROM} up to {tracked.max():.3f} m "
             "off")
    _require(lost[:1] == [FEATURE_VO_LOST_FROM],
             f"cli_feature_vo: the track lost from frame {lost[:1]}, the JAX package's from "
             f"{FEATURE_VO_LOST_FROM}")
    return {"tracked_max_mm": float(tracked.max()) * 1000.0, "frame9_mm": float(errs[9]) * 1000.0,
            "lost_from": lost[0], "nan_from": nan[0] if nan else None}


def run_cli_imu() -> dict:
    """`imu --steps 400` on the card and with `--device cpu` (the plain
    route): the JSON within 1e-6."""
    from rgbd_odometry_tpu_torch import cli

    got, _, _, _ = _quiet(cli.main, ["imu", "--steps", "400"])
    plain, _, _, _ = _quiet(cli.main, ["imu", "--steps", "400", "--device", "cpu"])
    err = max(float(np.abs(np.subtract(got[k], plain[k])).max()) for k in ("final_p", "final_q"))
    _log(f"cli_imu: imu --steps 400: final p {got['final_p']}, q {got['final_q']}; against the "
         f"plain route {err:.2e}")
    _require(got["steps"] == 400 and err <= 1e-6, f"cli_imu: {err:.2e} from the plain route")
    return {"plain_route_err": err}


# aten operations that put no work on the device: allocations left
# unfilled, and views
_NO_DEVICE_WORK = {"empty", "empty_strided", "select", "unsqueeze", "squeeze", "view", "alias",
                   "slice", "expand", "as_strided", "detach", "t", "transpose", "permute"}


def run_cli_pnp() -> dict:
    """`pnp`: the chessboard pose to t_err < 1e-4; its `gn_pnp` call is one
    `pnp_gn` launch (the wrapper's count) and no other device work: every
    aten operation the call dispatches is an unfilled allocation or a view
    (a dispatch mode records them; the profiler's device records, which a
    long process can lose, are not relied on)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from rgbd_odometry_tpu_torch import cli
    from rgbd_odometry_tpu_torch.kernels import pnp_gn
    from rgbd_odometry_tpu_torch.solvers import pnp

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    calls = []

    def recorded(*a, **k):
        before = pnp_gn.pnp_gn.launches
        with Ops() as ops:
            out = gn_pnp(*a, **k)
        calls.append((pnp_gn.pnp_gn.launches - before, ops.names))
        return out

    gn_pnp = pnp.gn_pnp
    with _patched(pnp, gn_pnp=recorded):
        got, _, _, _ = _quiet(cli.main, ["pnp"])
    _log(f"cli_pnp: pnp: residual norms {got['residual_norms_raw'].tolist()}, t_err "
         f"{got['t_err']!r}; its gn_pnp call: {calls[0][0] if calls else 0} pnp_gn launch, aten "
         f"operations {calls[0][1] if calls else []}")
    _require(got["t_err"] < 1e-4, f"cli_pnp: t_err {got['t_err']:.3e}")
    _require(len(calls) == 1 and calls[0][0] == 1,
             f"cli_pnp: gn_pnp calls and their pnp_gn launches {calls}, not one launch")
    work = [n for n in calls[0][1] if n not in _NO_DEVICE_WORK]
    _require(not work, f"cli_pnp: gn_pnp ran aten operations that use the device: {work}")
    return {"t_err": got["t_err"], "residual_norms": got["residual_norms_raw"].tolist()}


def _count_solves() -> dict:
    """Counts, by solver method, of `edge_dvo.solve_pyramid` calls (and the
    levels they solve), of single-level `edge_dvo.run_level` calls and of
    `edge_dvo.prepare_now_targets` calls ("targets") on CUDA tensors (a CPU
    solve, parity_batch's reference run, launches nothing), and of
    `edge_dvo.run_level_loop` calls on any device ("loop", which no route
    reaches) from here on (the path's modules call them through the
    module)."""
    from rgbd_odometry_tpu_torch.solvers import edge_dvo

    counts = {(what, m): 0 for what in ("pyramid", "levels", "level", "loop", "targets")
              for m in ("gauss_newton", "subgradient")}
    solve, run, loop = edge_dvo.solve_pyramid, edge_dvo.run_level, edge_dvo.run_level_loop
    targets = edge_dvo.prepare_now_targets

    def prepare_now_targets(gray_pyr, cfg, *a, **k):
        if gray_pyr[0].is_cuda:
            counts[("targets", cfg.method)] += 1
        return targets(gray_pyr, cfg, *a, **k)

    def solve_pyramid(ref_levels, now_levels, intr, cfg, *a, **k):
        if ref_levels[0].pts3d.is_cuda:
            counts[("pyramid", cfg.method)] += 1
            counts[("levels", cfg.method)] += sum(
                1 for lv in range(len(ref_levels))
                if (cfg.iterations[lv] if lv < len(cfg.iterations) else cfg.iterations[-1]) > 0)
        return solve(ref_levels, now_levels, intr, cfg, *a, **k)

    def run_level(ref, now, intr_level, R0, t0, cfg, *a, **k):
        if ref.pts3d.is_cuda:
            counts[("level", cfg.method)] += 1
        return run(ref, now, intr_level, R0, t0, cfg, *a, **k)

    def run_level_loop(ref, now, intr_level, R0, t0, cfg, *a, **k):
        counts[("loop", cfg.method)] += 1
        return loop(ref, now, intr_level, R0, t0, cfg, *a, **k)

    edge_dvo.solve_pyramid, edge_dvo.run_level = solve_pyramid, run_level
    edge_dvo.run_level_loop = run_level_loop
    edge_dvo.prepare_now_targets = prepare_now_targets
    # a frame step's capture calls solve_pyramid once and a replay not at
    # all: it puts these counts back after the capture and adds its delta
    # at every replay, as it does the kernels' launch counters
    from rgbd_odometry_tpu_torch.pipeline import step

    step.COUNTED[:] = [_Tally(counts, k) for k in counts]
    return counts


class _Tally:
    """One entry of a counts dict as a launch counter (`step.COUNTED`)."""

    def __init__(self, counts: dict, key):
        self.counts, self.key = counts, key

    @property
    def launches(self) -> int:
        return self.counts[self.key]

    @launches.setter
    def launches(self, n: int) -> None:
        self.counts[self.key] = n


def _launch_counters():
    from rgbd_odometry_tpu_torch.kernels import (
        canny, edt, epipolar, extract, features, fused_iter, imu, level_lm, level_photo, level_sg,
        match, pnp_gn, residual, sg_terms,
    )

    return {"edt": edt.edt_squared, "canny_pyramid": canny.canny_pyramid,
            "dt_pyramid": edt.dt_pyramid,
            "gn": fused_iter.fused_gn_terms,
            "residual": residual.residual_pass, "sg": sg_terms.subgradient_terms,
            "match": match.match_mutual, "pnp": pnp_gn.pnp_gn, "ransac": pnp_gn.ransac_pnp,
            "level_lm": level_lm.level_lm_pyramid, "level_sg": level_sg.level_sg_pyramid,
            "extract": extract.extract_pyramid, "imu": imu.imu_scan,
            "level_photo": level_photo.level_photo, "detect": features.detect_describe,
            "epipolar": epipolar.fundamental_ransac}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from rgbd_odometry_tpu_torch.device import resolve_device
    from rgbd_odometry_tpu_torch.kernels import build
    from rgbd_odometry_tpu_torch.pipeline import feature_vo, kf_matcher

    t_start = time.perf_counter()
    device = resolve_device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    _log(smi.stdout.strip())
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load_all(KERNELS)
    _log(f"built {len(KERNELS)} sources in {time.perf_counter() - t0:.2f} s (one nvcc each, in parallel)")
    for name in KERNELS:
        rec = build.build_record(name)
        regs = [ln.strip() for ln in rec["ptxas"].splitlines() if "registers" in ln]
        _log(f"build {name}: {'compiled' if rec['built'] else 'cached'} "
             f"(nvcc {rec['seconds']:.2f} s) {regs}")

    rendered = _render_once()
    rng = np.random.default_rng(0)
    res = {
        "edt": check_edt(device, rng),
        "canny_pyramid": check_canny_pyramid(device, rng),
        "dt_pyramid": check_dt_pyramid(device, rng),
        "gn": check_fused_gn(device, rng),
        "residual": check_residual(device, rng),
        "sg": check_sg_terms(device, rng),
        "match": check_match(device, rng),
        "pnp": check_pnp(device, rng),
        "ransac": check_ransac(device, rng),
        "detect": check_detect(device, rng),
        "epipolar": check_epipolar(device, rng),
        "level_lm": check_level_lm(device, rng),
        "level_sg": check_level_sg(device, rng),
        "extract": check_extract(device, rng),
        "imu": check_imu(device, rng),
        "level_photo": check_level_photo(device, rng),
        "level_traj": check_level_traj(device),
    }
    res["level_lm"]["trajectory"] = {k: v for k, v in res["level_traj"].items()
                                     if k.startswith("level_lm")}
    res["level_sg"]["trajectory"] = {k: v for k, v in res["level_traj"].items()
                                     if k.startswith("level_sg")}

    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    solves = _count_solves()
    phases = (
        ("stream", lambda: run_stream(device)),
        ("stream_vga", lambda: run_stream_vga(device, results["stream"])),
        ("batch", lambda: run_batch(device)),
        ("batch_vga", lambda: run_batch_vga(device, results["batch"])),
        ("cli_default", lambda: run_cli("cli_default", ["--frames", "30"], 0.020)),
        ("cli_default_no_feeder", lambda: run_cli_no_feeder(results["cli_default"])),
        ("cli_pipelined", lambda: run_cli_pipelined(results["cli_default"])),
        ("cli_subgradient", lambda: run_cli(
            "cli_subgradient",
            ["--method", "subgradient", "--iterations", "50,50,50,50", "--frames", "10"], 0.025)),
        ("loop_closure", lambda: run_loop_closure(device)),
        ("relocalize", lambda: run_relocalize(device)),
        ("stream_pipelined", lambda: run_stream_pipelined(device)),
        ("stream_vga_ingest", lambda: run_stream_vga_ingest(device)),
        ("cli_loop_close", run_cli_loop_close),
        ("cli_weighted_refine", run_cli_weighted_refine),
        ("cli_refine", lambda: run_cli_refine(results["cli_loop_close"])),
        ("multistream", lambda: run_multistream(device)),
        ("cli_multistream", run_cli_multistream),
        ("align_sequence", lambda: run_align_sequence(device)),
        ("multigpu", lambda: run_multigpu(device, solves)),
        ("cli_checkpoint", lambda: run_cli_checkpoint(device)),
        ("cli_viz", lambda: run_cli_viz(results["cli_default"])),
        ("cli_trace", lambda: run_cli_trace(results["cli_default"])),
        ("cli_xml", lambda: run_cli_xml(device)),
        ("probe", run_probe),
        ("parity_batch", lambda: run_parity_batch(device)),
        ("parity_stream", lambda: run_parity_stream(device)),
        ("uncaptured", lambda: run_uncaptured(device)),
        ("cli_cam_scale_3", lambda: run_cli_cam_scale(3, 4)),
        ("cli_cam_scale_4", lambda: run_cli_cam_scale(4, 6)),
        ("cli_photometric", run_cli_photometric),
        ("cli_fused", run_cli_fused),
        ("fused_fallback", lambda: run_fused_fallback(device)),
        ("cli_feature_vo", run_cli_feature_vo),
        ("cli_imu", run_cli_imu),
        ("cli_pnp", run_cli_pnp),
    )
    results, per_phase = {}, {}
    for name, phase in phases:
        before = {k: fn.launches for k, fn in counters.items()}
        solves_before = dict(solves)
        t0 = time.perf_counter()
        tally: list = []
        if name in ("loop_closure", "relocalize"):
            filters: list = []
            with _ransac_against_steps(tally), _epipolar_against_twin(filters, kf_matcher):
                results[name] = phase()
            _log(f"{name}: {len(tally)} verifications, each bitwise the step-by-step route "
                 f"(inliers {tally}); {len(filters)} epipolar filters, each bitwise the twin "
                 f"on the CPU (inliers {filters})")
        elif name == "cli_feature_vo":
            filters = []
            with _epipolar_against_twin(filters, feature_vo):
                results[name] = phase()
            launched = counters["epipolar"].launches - before["epipolar"]
            _require(len(filters) == launched > 0,
                     f"{name}: {len(filters)} epipolar filters recorded, {launched} launched")
            _log(f"{name}: {len(filters)} epipolar filters (K={FEATURE_VO_K}), each bitwise the "
                 f"twin on the CPU (inliers {filters})")
        else:
            results[name] = phase()
        torch.cuda.synchronize()
        n = {k: fn.launches - before[k] for k, fn in counters.items()}
        per_phase[name] = n
        ns = {k: solves[k] - solves_before[k] for k in solves}
        _log(f"launches in {name}: " + ", ".join(f"{k} {v}" for k, v in n.items())
             + f" ({time.perf_counter() - t0:.1f} s)")
        for method in ("gauss_newton", "subgradient"):
            _require(ns[("loop", method)] == 0,
                     f"{name}: {ns[('loop', method)]} {method} solves on run_level_loop")
        # a pyramid solve is one launch of its level kernel, every level in it
        for key, method in (("level_lm", "gauss_newton"), ("level_sg", "subgradient")):
            want = ns[("pyramid", method)] + ns[("level", method)]
            if want or n[key]:
                _log(f"  {name}: {key} {n[key]} launches for {ns[('pyramid', method)]} pyramid "
                     f"solves ({ns[('levels', method)]} levels) and {ns[('level', method)]} "
                     f"single levels: {n[key] / max(want, 1):.3f} a solve")
            _require(n[key] == want, f"{name}: {key} launched {n[key]} times for {want} solves")
        if name in MAP_PHASES:
            _require(all(n[k] > 0 for k in MAP_KERNELS),
                     f"{name}: the detection, matching, epipolar or PnP kernel was not launched")
        if name in MAP_PHASES or name == "cli_feature_vo":
            # every PnP verification follows one epipolar filter
            _require(n["epipolar"] >= n["ransac"],
                     f"{name}: {n['epipolar']} epipolar launches for {n['ransac']} verifications")
        if name in PARITY_PHASES:
            _require(n["level_lm"] + n["level_sg"] > 0,
                     f"{name}: no level kernel was launched for the parity configurations")
        if name in GN_PHASES or name in ("cli_subgradient",) + PARITY_PHASES:
            _require(all(n[k] > 0 for k in TARGET_KERNELS),
                     f"{name}: the canny_pyramid or dt_pyramid kernel was not launched")
            targets = ns[("targets", "gauss_newton")] + ns[("targets", "subgradient")]
            _log(f"  {name}: dt_pyramid {n['dt_pyramid']} launches for {targets} target "
                 f"preparations")
            _require(n["dt_pyramid"] == targets, f"{name}: dt_pyramid launched "
                     f"{n['dt_pyramid']} times for {targets} target preparations (one a "
                     f"preparation: no call a level)")
        if name in GN_PHASES:
            _require(n["level_lm"] > 0, f"{name}: the level_lm kernel was not launched")
        if name in ("cli_subgradient", "probe"):
            _require(n["level_sg"] > 0, f"{name}: the level_sg kernel was not launched")
        if name in EXTRACT_PHASES:
            _require(n["extract"] > 0, f"{name}: the extract_pyramid kernel was not launched")
        _require(n["gn"] == 0, f"{name}: the per-iteration fused_gn_terms kernel was launched")
        _require(n["sg"] == 0, f"{name}: the per-iteration subgradient_terms kernel was launched")
        _require(n["residual"] == 0, f"{name}: the residual_pass kernel was launched")
        if name != "cli_pnp":
            _require(n["pnp"] == 0, f"{name}: the step-by-step pnp_gn kernel was launched")
        for key, need in PHASE_KERNELS.get(name, ()):
            _require(n[key] > 0 if need else n[key] == 0,
                     f"{name}: the {key} kernel was {'not ' if need else ''}launched")
        if name == "cli_photometric":
            _require(n["level_photo"] == 29, f"{name}: {n['level_photo']} level_photo launches")
    launches = {k: fn.launches for k, fn in counters.items()}
    _log(f"launches on the main paths: {launches}")
    for key in ("canny_pyramid", "dt_pyramid", "level_lm", "extract"):
        res[key]["vga"]["launches"] = sum(per_phase[p][key] for p in VGA_PHASES)
    for key in ("dt_pyramid", "extract"):
        res[key]["cam_scale_3"]["launches"] = per_phase["cli_cam_scale_3"][key]
    for key in ("canny_pyramid", "dt_pyramid", "extract"):
        res[key]["cam_scale_4"]["launches"] = per_phase["cli_cam_scale_4"][key]
    _require(all(n > 0 for k, n in launches.items() if k not in OFF_PATH),
             "a kernel was not launched on the main paths")

    src = "rgbd_odometry_tpu_torch/csrc/"
    kernels = [
        {"name": "edt_squared", "route": "cuda", "source": src + "edt.cu",
         "replaces": "rgbd_odometry_tpu/pallas/edt.py:58", "launches": launches["edt"],
         **res["edt"]},
        {"name": "dt_pyramid", "route": "cuda", "source": src + "edt.cu",
         "replaces": "rgbd_odometry_tpu/pallas/edt.py:58 + solvers/edge_dvo.py:183 "
                     "prepare_now_level over prepare_now_targets :941 (XLA: sqrt, "
                     "normalization :206, central_gradient, channels) over every level in one "
                     "launch; dt_channels is a pyramid of one level",
         "launches": launches["dt_pyramid"], **res["dt_pyramid"]},
        {"name": "canny_pyramid", "route": "cuda", "source": src + "canny.cu",
         "replaces": "rgbd_odometry_tpu/solvers/edge_dvo.py:933 _pyramid_edges (XLA, no Pallas "
                     "kernel: ops/canny.py:182 canny_multi, :234 canny, the lax.while_loop :148)",
         "launches": launches["canny_pyramid"], **res["canny_pyramid"]},
        {"name": "fused_gn_terms", "route": "cuda", "source": src + "fused_gn.cu",
         "replaces": "rgbd_odometry_tpu/pallas/fused_iter.py:159", "launches": launches["gn"],
         **res["gn"]},
        {"name": "residual_pass", "route": "cuda", "source": src + "residual.cu",
         "replaces": "rgbd_odometry_tpu/solvers/edge_dvo.py:261 (XLA, no Pallas kernel)",
         "launches": launches["residual"], **res["residual"]},
        {"name": "subgradient_terms", "route": "cuda", "source": src + "sg_terms.cu",
         "replaces": "rgbd_odometry_tpu/solvers/edge_dvo.py:293 (XLA, no Pallas kernel)",
         "launches": launches["sg"], **res["sg"]},
        {"name": "match_mutual", "route": "cuda", "source": src + "match.cu",
         "replaces": "rgbd_odometry_tpu/pipeline/kf_matcher.py:103 (XLA, no Pallas kernel)",
         "launches": launches["match"], **res["match"]},
        {"name": "pnp_gn", "route": "cuda", "source": src + "pnp_gn.cu",
         "replaces": "rgbd_odometry_tpu/solvers/pnp.py:46 gn_pnp (XLA, no Pallas kernel; "
                     "vmapped over the hypotheses :152)",
         "launches": launches["pnp"], **res["pnp"]},
        {"name": "ransac_pnp", "route": "cuda", "source": src + "pnp_gn.cu",
         "replaces": "rgbd_odometry_tpu/solvers/pnp.py:116 ransac_pnp (XLA, no Pallas kernel: "
                     "top_k :144, vmap(gn_pnp) :46-97, the scores, argmax :153, the refine)",
         "launches": launches["ransac"], **res["ransac"]},
        {"name": "level_lm", "route": "cuda", "source": src + "level_lm.cu",
         "replaces": "rgbd_odometry_tpu/pallas/fused_iter.py:159 + solvers/edge_dvo.py:261 "
                     "(the lax.scan level loops :586, :754, the all-point diagnostics "
                     ":593-609, :758-771; the parity branches _sample_dt :241-259, "
                     "_jacobian_residual :293-398, rotationize :518, :592, :715, :757)",
         "launches": launches["level_lm"], **res["level_lm"]},
        {"name": "level_sg", "route": "cuda", "source": src + "level_sg.cu",
         "replaces": "rgbd_odometry_tpu/solvers/edge_dvo.py:586 (XLA, no Pallas kernel: the "
                     "lax.scan level loop's sub-gradient branch :493-622 with :775 and "
                     "core/geometry.py:169; the parity branches :241-259, :293-398, "
                     "rotationize_svd core/geometry.py:209 at :518, :592)",
         "launches": launches["level_sg"], **res["level_sg"]},
        {"name": "extract_pyramid", "route": "cuda", "source": src + "extract.cu",
         "replaces": "rgbd_odometry_tpu/solvers/edge_dvo.py:100 extract_ref_level over every "
                     "level, via extract_ref_features :910 (XLA, no Pallas kernel: top_k :145, "
                     ":147, :156, the back-projection :165-179)",
         "launches": launches["extract"], **res["extract"]},
        {"name": "imu_scan", "route": "cuda", "source": src + "imu.cu",
         "replaces": "rgbd_odometry_tpu/solvers/imu.py:116 propagate_batch and :194 preintegrate "
                     "(XLA lax.scan loops, no Pallas kernel; vmap at pipeline/fused.py:276)",
         "launches": launches["imu"], **res["imu"]},
        {"name": "level_photo", "route": "cuda", "source": src + "level_photo.cu",
         "replaces": "rgbd_odometry_tpu/solvers/photometric.py:226 solve_pyramid (XLA, no Pallas "
                     "kernel: solve_level's lax.scan :213 over photometric_residual :147)",
         "launches": launches["level_photo"], **res["level_photo"]},
        {"name": "detect_describe", "route": "cuda", "source": src + "features.cu",
         "replaces": "rgbd_odometry_tpu/ops/features.py:69 detect_and_describe (XLA, no Pallas "
                     "kernel: top_k :91, the one-hot MXU gather :106) and "
                     "pipeline/kf_matcher.py:123 _detect_backproject",
         "launches": launches["detect"], **res["detect"]},
        {"name": "fundamental_ransac", "route": "cuda", "source": src + "epipolar.cu",
         "replaces": "rgbd_odometry_tpu/ops/epipolar.py:91 ransac_fundamental_filter (XLA, no "
                     "Pallas kernel: vmap :134, top_k :126, eigh :62, svd :69)",
         "launches": launches["epipolar"], **res["epipolar"]},
    ]
    _log(f"synthetic frames: {rendered['rendered']} rendered, {rendered['reused']} reused")
    _log(f"chip_smoke: every check and phase passed, {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
