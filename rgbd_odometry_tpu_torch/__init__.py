"""rgbd_odometry_tpu_torch — the PyTorch + CUDA port of `rgbd_odometry_tpu`.

Runs the edge-DVO odometry on one NVIDIA H100 (Hopper, sm_90a) with no JAX
at run time: `profiles.production_320` (deferred-accept LM), the `dvo`
command at its own defaults (`cli.py`: standard LM on the 0-255 normalized
DT, the frame feeder), the reference's sub-gradient solver, and the map
backend (loop closure, pose-graph refinement, relocalization, the `refine`
command), and N camera streams in lockstep or a whole sequence's pairs in
one batch (`parallel/`, the `multistream` command); checkpoint and resume
(`utils/checkpoint.py`), a `torch.profiler` trace (`utils/tracing.py`), the
live debug PNGs (`viz/live.py`) and the reference's XML pyramid dumps
(`io/xml_dump.py`). The layout mirrors the JAX package so every module's counterpart
is easy to find (`core/`, `ops/`, `solvers/`, `pipeline/`, `parallel/`,
`io/`, `viz/`, `cli.py`), plus `kernels/` + `csrc/` for the hand-written CUDA kernels
(shared device code in `csrc/project.cuh` and `csrc/se3.cuh`; the plain
counterparts in `ops/project.py` and `kernels/se3_plain.py`):

* `kernels/canny.py` + `csrc/canny.cu` — Canny with the hysteresis
  fixpoint on the device (XLA in the JAX package);
* `kernels/edt.py` + `csrc/edt.cu` — the squared-L2 distance transform
  (replaces `rgbd_odometry_tpu/pallas/edt.py`), full or +-R windowed, and
  `dt_channels`, the rest of a now-frame target on the same phases;
* `kernels/fused_iter.py` + `csrc/fused_gn.cu` — one Gauss-Newton
  iteration's J^T W J, J^T W eps, energy and visible count (replaces
  `rgbd_odometry_tpu/pallas/fused_iter.py`), with a per-pair DT scale;
* `kernels/residual.py` + `csrc/residual.cu` — the residual pass (energy,
  visible count, per-point residuals) of the LM accept test and the
  all-point diagnostics (XLA in the JAX package);
* `kernels/level_lm.py` + `csrc/level_lm.cu` — a whole Levenberg-Marquardt
  pyramid level in one launch (the `lax.scan` level loops over the fused
  iteration);
* `kernels/sg_terms.py` + `csrc/sg_terms.cu` — one sub-gradient
  iteration's J^T W eps with floor gathers (XLA in the JAX package);
* `kernels/level_sg.py` + `csrc/level_sg.cu` — a whole sub-gradient
  pyramid level in one launch (the `lax.scan` level loop's sub-gradient
  branch with `se3_log`);
* `kernels/match.py` + `csrc/match.cu` — mutual-nearest descriptor matching
  of a query against every stored keyframe (XLA in the JAX package);
* `kernels/pnp_gn.py` + `csrc/pnp_gn.cu` — batched Gauss-Newton PnP with
  inlier scoring, both RANSAC phases (XLA in the JAX package);
* `kernels/extract.py` + `csrc/extract.cu` — keyframe edge-point selection
  and back-projection over every level of a pyramid in one launch (XLA in
  the JAX package).

Idiom: plain functions on tensors with a leading batch dimension (in place
of `vmap`) and an explicit device. The configuration dataclasses and
profiles (`config.py`, `profiles.py`) are the port's own copies of the JAX
package's: the port imports nothing of `rgbd_odometry_tpu`.
"""

from rgbd_odometry_tpu_torch import profiles  # noqa: F401
from rgbd_odometry_tpu_torch.config import (  # noqa: F401
    CameraConfig,
    KeyframeConfig,
    PipelineConfig,
    PyramidConfig,
    RelocalizeConfig,
    SolverConfig,
)

__version__ = "0.1.0"

_LAZY = {
    "align_pair": ("rgbd_odometry_tpu_torch.solvers.edge_dvo", "align_pair"),
    "EdgeDvoOdometry": ("rgbd_odometry_tpu_torch.pipeline.odometry", "EdgeDvoOdometry"),
    "MultiStreamOdometry": ("rgbd_odometry_tpu_torch.parallel.streams", "MultiStreamOdometry"),
    "align_sequence": ("rgbd_odometry_tpu_torch.parallel.sequence", "align_sequence"),
    "LoopCloser": ("rgbd_odometry_tpu_torch.pipeline.loop_closure", "LoopCloser"),
    "Relocalizer": ("rgbd_odometry_tpu_torch.pipeline.relocalize", "Relocalizer"),
    "refine_pose_graph": ("rgbd_odometry_tpu_torch.solvers.pose_graph", "refine_pose_graph"),
    "information_sqrt": ("rgbd_odometry_tpu_torch.solvers.pose_graph", "information_sqrt"),
    "marginal_covariance": ("rgbd_odometry_tpu_torch.solvers.pose_graph", "marginal_covariance"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'rgbd_odometry_tpu_torch' has no attribute {name!r}")


__all__ = [
    "CameraConfig",
    "KeyframeConfig",
    "PipelineConfig",
    "PyramidConfig",
    "RelocalizeConfig",
    "SolverConfig",
    "profiles",
    "__version__",
    *sorted(_LAZY),
]
