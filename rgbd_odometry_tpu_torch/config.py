"""Typed configuration for the whole framework: the port's own copy of
`rgbd_odometry_tpu/config.py` (tests/test_torch_config.py holds the two
equal field for field).

Replaces the reference's three config mechanisms — ~25 compile-time #define
plugs (reference include/SolveDVO.h:61-131), constructor-hardcoded
constants (reference src/SolveDVO.cpp:20-34), and OpenCV-XML calibration
files chosen in main() (reference src/dvo.cpp:13-15) — with one
serializable dataclass tree.

All numeric defaults reproduce the reference exactly; see per-field citations.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + plumb-bob distortion at the *base* solver resolution.

    The reference loads these from OpenCV XML calib files
    (reference src/SolveDVO.cpp:88, src/camTopic2PublisherPyD.cpp:434-455).
    Defaults are the TUM Freiburg-1 ROS-default calibration at 320x240
    (the auto-written ``Freiburg_ROS_default_320x240.xml``: fr1 VGA intrinsics
    halved, matching src/camTopic2PublisherPyD.cpp:443-451 / src/dvo.cpp:15).
    """

    width: int = 320
    height: int = 240
    fx: float = 525.0 / 2.0
    fy: float = 525.0 / 2.0
    cx: float = 319.5 / 2.0
    cy: float = 239.5 / 2.0
    # plumb-bob (k1, k2, p1, p2, k3); zeros = ROS-default (rectified) stream
    distortion: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)

    def scaled(self, factor: float) -> "CameraConfig":
        """Intrinsics at a different resolution (factor<1 shrinks)."""
        return dataclasses.replace(
            self,
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=self.cx * factor,
            cy=self.cy * factor,
        )


@dataclass(frozen=True)
class PyramidConfig:
    """Image-pyramid layout.

    The reference publishes 4 levels at 1/2..1/16 of VGA with INTER_NEAREST
    (reference src/camTopic2PublisherPyD.cpp:339-345); level 0 of the
    solver is 320x240 (VGA intentionally skipped, ibid:341).

    ``max_points`` fixes the edge-point tensor size per level (TPU static
    shapes): the reference keeps ragged per-level point lists
    (reference src/SolveDVO.cpp:269-303); we keep top-K with a validity
    mask instead.
    """

    num_levels: int = 4
    # fixed edge-point capacity per level, fine -> coarse
    max_points: Tuple[int, ...] = (8192, 4096, 2048, 1024)
    # interpolation used when building the pyramid ("nearest" matches reference)
    resize_mode: str = "nearest"

    def level_scale(self, level: int) -> float:
        """Scale of `level` relative to level 0 (reference: pow(2,-level),
        reference src/SolveDVO.cpp:231)."""
        return 2.0 ** (-level)


@dataclass(frozen=True)
class SolverConfig:
    """Edge-DVO optimizer constants.

    Every default mirrors the reference's hardcoded values
    (reference src/SolveDVO.cpp:20-34 and runIterations :619-1017).
    """

    # iterations per level, index = level (reference: iterationsConfig
    # 50/50/50/50, src/SolveDVO.cpp:29-34)
    iterations: Tuple[int, ...] = (50, 50, 50, 50)
    # sub-gradient schedule: step = step_a / max(itr-step_b, 1) for itr>5
    # (reference: 9.0e-2 / ((itr>5)?(itr-4):1), src/SolveDVO.cpp:772-773)
    step_length: float = 9.0e-2
    # momentum on the descent direction (BETA, src/SolveDVO.cpp:653)
    momentum: float = 0.5
    # diagonal preconditioner: rotation block scaled by this
    # (PFactor, src/SolveDVO.cpp:723-730)
    precondition_rot: float = 0.5
    # L2 regularization on normalized log-pose
    # (regularizationLambda, src/SolveDVO.cpp:742; plug SolveDVO.h:112)
    l2_lambda: float = 0.05
    enable_l2_regularization: bool = True
    # trust-region hyper-sphere radius on psi (src/SolveDVO.cpp:25,830-839)
    trust_region_radius: float = 0.003
    # early-termination threshold on |psi| (src/SolveDVO.cpp:24,872-878)
    psi_norm_termination: float = 1.0e-7
    # Huber-style weight w(r) = 6/(6 + r^2/weight_sigma2)
    # (getWeightOf, src/SolveDVO.cpp:1047-1053) — r in (normalized) DT units,
    # used by the reference-parity subgradient mode
    weight_sigma2: float = 0.25
    # gauss_newton mode: same weight shape but with the residual measured in
    # pixels (resolution/normalization independent); sigma^2 in px^2
    gn_weight_sigma2_px: float = 1.0
    # re-orthonormalize R each iteration (__ENABLE_ROTATIONIZE__, SolveDVO.h:117)
    rotationize: bool = True
    # "svd" = exact polar projection via SVD (reference, src/SolveDVO.cpp:1269-1282)
    # "newton" = Newton-Schulz polar iteration (TPU-fast, equivalent for
    # near-orthogonal R)
    rotationize_method: str = "newton"
    # min-max normalize the distance transform to 0..255
    # (__SCALE_NORMALIZE_DISTANCE_TRANFROM, SolveDVO.h:103, active)
    normalize_dt: bool = True
    # bilinear(ish) DT sampling (__INTERPOLATE_DISTANCE_TRANSFORM, SolveDVO.h:98,
    # inactive in the reference -> floor lookup, src/SolveDVO.cpp:446)
    interpolate_dt: bool = False
    # Canny thresholds/aperture (cv::Canny(150,100,3,L2), src/SolveDVO.cpp:1705)
    canny_high: float = 150.0
    canny_low: float = 100.0
    # run ONE stacked NMS + hysteresis fixpoint for all pyramid levels
    # (ops/canny.canny_multi — bit-identical to per-level Canny). Measured
    # SLOWER on v5e at batch 64 (targets 8.09 vs 7.30 ms, extract 12.91 vs
    # 12.21): the coarse levels' fixpoints converge early and cheap, while
    # the stack pays level-0's ~40 passes over a width-padded buffer with
    # 42% more pixels. Kept as the documented A/B; default off.
    fuse_level_canny: bool = False
    # min depth (mm) for a usable edge point (src/SolveDVO.cpp:1251)
    min_depth_mm: float = 100.0
    # optimizer family: "subgradient" (reference parity) or "gauss_newton"
    # (6x6 normal-equation solve — the TPU fast path)
    method: str = "subgradient"
    # Levenberg damping for the gauss_newton method
    lm_damping: float = 1.0e-4
    # trust radius for the gauss_newton method: larger than the sub-gradient
    # radius (0.003) because adaptive lambda already rejects bad steps
    lm_trust_region: float = 0.01
    # LM accept/reject evaluates the proposed pose on every Nth point only
    # (the decision is a statistical comparison; the strided residual pass
    # costs 1/N of the full gather). 1 = evaluate on all points.
    lm_proposal_stride: int = 4
    # gauss_newton gradient source: "interpolant" derives d/du, d/dv of the
    # bilinearly-sampled DT from its own corner rows (2 one-hot matmuls, the
    # exact gradient of the sampled residual); "channels" gathers the
    # precomputed central-difference gradient images (3 matmuls, smoothed
    # approximation). Only consulted when method == "gauss_newton" and
    # gather_mode == "mxu".
    gn_gradient_mode: str = "interpolant"
    # gauss_newton normal equations (J^T W J, J^T W eps) are accumulated from
    # every Nth point: a 6x6 sufficient statistic needs far fewer than
    # max_points samples, and the per-iteration gather cost scales 1/N.
    # Point order is pseudo-randomized at extraction, so a stride is a
    # uniform subsample. Diagnostics (energy, visibility, residuals) are
    # always evaluated on ALL points at the level's best pose afterwards.
    # 1 = use all points (exact). Default 4: measured 2.7x faster level
    # solves at equal pose accuracy (tools/profile_variants.py, TPU v5e:
    # 24.7 -> 9.1 ms for 18 level-0 iterations at batch 64, t_err stable).
    lm_jacobian_stride: int = 4
    # deferred-accept LM: instead of a separate residual pass per proposal,
    # the NEXT iteration's own Jacobian pass doubles as the accept check —
    # on reject the pose reverts and the step recomputes from the carried
    # previous (J, eps) with raised lambda (no extra gather). Every
    # iteration costs exactly one gather pass (2 row-matmul units) instead
    # of jac (2) + accept (1). Lambda adaptation runs one iteration late.
    lm_deferred_accept: bool = False
    # image sampling backend: "mxu" = separable one-hot matmul gathers (TPU
    # point-gathers serialize per element; the MXU formulation is ~100x
    # faster), "take" = jnp.take_along_axis (exact reference semantics,
    # fine on CPU)
    gather_mode: str = "mxu"
    # dtype of the stacked DT/gradient channels fed to the MXU gather in
    # gauss_newton mode: "bfloat16" doubles MXU throughput at ~0.04px residual
    # rounding (DT spans 0-255); subgradient parity mode always uses float32
    gather_dtype: str = "bfloat16"
    # distance-transform min-plus backend: "xla" (fused broadcast+reduce) or
    # "pallas" (explicit VMEM-staged kernel, rgbd_odometry_tpu.pallas.edt)
    edt_backend: str = "xla"
    # >0 restricts the EDT row-phase to a +-N-column window: exact for all
    # distances <= N, overestimates beyond (ops/distance_transform.py).
    # ~5x cheaper at 320x240 with N=32. Use with normalize_dt=False (the
    # window changes the image max, hence the normalization scale); the
    # gauss_newton weights are normalization-independent (pixel units).
    # 0 = full exact transform (reference parity).
    edt_window: int = 0
    # edge-point selection at extraction: "exact" = one lax.top_k over all
    # pixels (keeps EVERY edge point whenever count <= capacity — reference
    # semantics; the parity mode requires this). "segmented" = two-stage
    # top-k (per-256-pixel-segment top-32, then top-k over the candidates):
    # ~3x faster on v5e at 320x240/batch 256 (36.4 -> 12.4 ms) at the cost
    # of thinning segments with >32 edge pixels (~0.3-1% of points dropped
    # on typical scenes, lowest pseudo-random priority first — the same
    # spatially-uniform thinning the capacity cap already applies on busy
    # frames). Falls back to exact on levels too small to split.
    extract_selection: str = "exact"
    # Jacobian flavour: "reference" reproduces the dehomogenized-coordinate
    # quirk of reference src/SolveDVO.cpp:340-401 (translation block
    # scaled by each point's depth — fine for a sub-gradient direction);
    # "true" is the textbook SE(3) image Jacobian (required for
    # Gauss-Newton). "auto" picks by method.
    jacobian_mode: str = "auto"

    def __post_init__(self):
        if self.edt_window > 0 and self.normalize_dt:
            raise ValueError(
                "edt_window > 0 requires normalize_dt=False: the windowed "
                "transform's max overestimates far-from-edge distances, so "
                "min-max normalization would silently mis-scale the "
                "pixel-unit robust weights (gn_weight_sigma2_px)"
            )
        if self.extract_selection not in ("exact", "segmented"):
            raise ValueError(
                f"extract_selection must be 'exact' or 'segmented', got "
                f"{self.extract_selection!r}"
            )
        if self.extract_selection == "segmented" and self.method == "subgradient":
            raise ValueError(
                "the reference-parity subgradient mode requires "
                "extract_selection='exact' (its semantics keep EVERY edge "
                "point below capacity; segmented selection may thin dense "
                "segments)"
            )


@dataclass(frozen=True)
class PhotometricConfig:
    """Legacy dense photometric DVO (`RGBDOdometry`) constants.

    Defaults mirror reference src/RGBDOdometry.cpp:32-34 and the event
    loop's schedule (:162-164): gradient threshold 5, 3 GN iterations per
    level, coarse levels (3, 2) only, early exit at ||eps|| < 200.
    """

    gradient_threshold: float = 5.0
    iterations_per_level: int = 3
    levels: Tuple[int, ...] = (3, 2)
    eps_norm_exit: float = 200.0
    min_depth_mm: float = 100.0
    max_points: Tuple[int, ...] = (8192, 4096, 2048, 1024)
    gather_mode: str = "mxu"  # "mxu" | "take"
    # optional Huber robust weighting (BASELINE.json config 3)
    use_huber: bool = False
    huber_delta: float = 20.0
    # trust clamp on each GN step: inverse-compositional GN with the normal
    # matrix frozen at the keyframe overshoots on low-texture coarse levels
    max_step: float = 0.02
    # recompute A = J^T W J with the current robust weights every iteration
    # (free on the MXU; False freezes A at the keyframe like the reference —
    # and measures slightly better on the synthetic suite)
    reweight_normal_matrix: bool = False
    # bilinear intensity sampling (False = reference floor semantics, which
    # also measures better against the forward-difference ref gradients)
    bilinear: bool = False
    # refresh reference keyframe every N frames (the reference's modulo knob,
    # RGBDOdometry.cpp:146 — set to 10000 there, effectively first-frame-only)
    ref_refresh_every: int = 10000


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe / reference-frame refresh policy.

    Reference: forced refresh every 5 frames (src/SolveDVO.cpp:2155-2160);
    quality triggers exist but are commented out in loop() (:2129-2152) while
    active in loopFromFile (:2563-2574). We keep all of them switchable.
    """

    force_every: int = 5
    # quality triggers (reference constants, src/SolveDVO.cpp:21-23)
    enable_quality_triggers: bool = False
    laplacian_b_thresh: float = 3.0
    min_visible_ratio: float = 0.8
    min_reprojected_pts: int = 50
    # __NEW__REF_UPDATE rollback re-solve (SolveDVO.h:92, src/SolveDVO.cpp:2194-2233)
    rollback_resolve: bool = True


@dataclass(frozen=True)
class RelocalizeConfig:
    """Relocalization after tracking loss (pipeline/relocalize.py).

    Beyond the reference: `loop()` has no recovery path — its quality
    triggers keep re-seating the reference keyframe on degraded frames
    (reference src/SolveDVO.cpp:2122-2160) while the pose integrates
    junk. When enabled, healthy tracking keyframes are registered (with
    their global poses) in a device-resident appearance database; after
    `trigger_consecutive` lost frames the driver matches the current frame
    against the whole database in one batched dispatch and re-anchors the
    trajectory at the best geometrically-verified pose.
    """

    enabled: bool = False
    # tracking-loss detector: a frame is lost when the solve's visibility or
    # reprojected-point count collapses (read every frame, independent of
    # KeyframeConfig.enable_quality_triggers) or the estimate is non-finite
    trigger_consecutive: int = 3
    lost_visible_ratio: float = 0.5
    lost_min_points: int = 40
    # Laplacian b-hat above this is a lost frame. Visibility alone misses
    # occlusion/blackout (stale ref points still project in-bounds — into
    # garbage); the residual magnitude is the reliable signal there. Units
    # follow the solver's residual units (normalized DT 0..255 by default;
    # pixels when normalize_dt=False) — same units as
    # KeyframeConfig.laplacian_b_thresh, deliberately far above it
    lost_b_cap: float = 10.0
    # appearance matching + geometric verification (pipeline/kf_matcher.py)
    max_keypoints: int = 384
    min_matches: int = 30  # descriptor matches to consider a candidate
    min_inliers: int = 20  # PnP inliers to accept a recovery
    max_candidates: int = 4  # verification rounds per attempt (top-N by matches)
    ransac_hypotheses: int = 64
    epipolar_threshold_px: float = 3.0
    # absolute floor on the descriptor-match distance gate: recovery queries
    # are often near-duplicates of a stored keyframe, where the reference's
    # relative 3*min_d gate degenerates (ops/features.match docstring)
    dist_gate_floor: float = 0.2
    min_depth_mm: float = 100.0
    slot_capacity: int = 64  # initial database capacity (doubles when full)
    # hard cap on stored keyframes (device memory + match cost bound for
    # endurance runs). When full, a new keyframe EVICTS the stored entry
    # whose anchor pose is spatially closest to it — coverage of the whole
    # trajectory is what recovery needs, and the nearest neighbour is the
    # most redundant entry. 0 = unbounded (the pre-r5 behavior)
    max_keyframes: int = 1024

    def __post_init__(self):
        if self.trigger_consecutive < 1:
            raise ValueError("trigger_consecutive must be >= 1")


@dataclass(frozen=True)
class PipelineConfig:
    """Whole-pipeline configuration bundle."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    pyramid: PyramidConfig = field(default_factory=PyramidConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    relocalize: RelocalizeConfig = field(default_factory=RelocalizeConfig)
    # streaming warm-start motion model: "hold" re-uses the previous relative
    # pose (the reference's implicit behavior, reference src/SolveDVO.cpp
    # :2117-2120 — cR/cT persist across loop() iterations); "constant_velocity"
    # extrapolates it by the last inter-frame motion, composed ON DEVICE so the
    # steady-state loop still pays zero extra host<->device transfers
    motion_model: str = "hold"
    # per-frame FrameMetrics records retained (ring buffer); 0 = unbounded.
    # Default mirrors the reference's 100k-pose reserve
    # (reference src/GOP.cpp:125): ~an hour of 30 Hz streaming stays
    # inspectable while endurance runs hold flat host memory
    metrics_max: int = 100_000

    def __post_init__(self):
        if self.motion_model not in ("hold", "constant_velocity"):
            raise ValueError(
                f"motion_model must be 'hold' or 'constant_velocity', got "
                f"{self.motion_model!r}"
            )

    # ---- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "PipelineConfig":
        d = json.loads(s)

        def _tup(x):
            return tuple(x) if isinstance(x, list) else x

        cam = d.get("camera", {})
        cam["distortion"] = _tup(cam.get("distortion", (0.0,) * 5))
        pyr = d.get("pyramid", {})
        pyr["max_points"] = _tup(pyr.get("max_points", (8192, 4096, 2048, 1024)))
        sol = d.get("solver", {})
        sol["iterations"] = _tup(sol.get("iterations", (50, 50, 50, 50)))
        return PipelineConfig(
            camera=CameraConfig(**cam),
            pyramid=PyramidConfig(**pyr),
            solver=SolverConfig(**sol),
            keyframe=KeyframeConfig(**d.get("keyframe", {})),
            relocalize=RelocalizeConfig(**d.get("relocalize", {})),
            # "dtype" was a reserved no-op knob (since removed); old config
            # files / checkpoints that still carry it load fine — the only
            # real reduced-precision switch is SolverConfig.gather_dtype
            motion_model=d.get("motion_model", "hold"),
            metrics_max=d.get("metrics_max", 100_000),
        )
