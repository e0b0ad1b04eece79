"""The JAX package's ATE on `chip_smoke.py`'s parity_stream phase, on the CPU.

The phase runs the PyTorch port's `EdgeDvoOdometry` over the stream phase's
30 rendered 320x240 frames under `profiles.parity_320` with the reference's
own switches, `interpolate_dt=True` and `rotationize_method="svd"` (keyframe
every 5 with rollback). Its bar is cli_subgradient's 25 mm unless the JAX
package's own run of the same frames and configuration misses it; this
script prints that run's unaligned ATE RMSE (and the production sub-gradient's
beside it) as one JSON line.

Run: JAX_PLATFORMS=cpu python tools/parity_stream_jax_ate.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = 30


def _trajectory(n: int, step: float = 0.002):
    """The stream phase's twists (`chip_smoke._trajectory`)."""
    ts = np.arange(n)
    return np.stack([0.8 * step * ts, -0.5 * step * ts, 0.3 * step * ts,
                     0.15 * step * ts, -0.2 * step * ts, 0.1 * step * ts],
                    axis=-1).astype(np.float32)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from rgbd_odometry_tpu import profiles
    from rgbd_odometry_tpu.config import KeyframeConfig, PipelineConfig, PyramidConfig
    from rgbd_odometry_tpu.pipeline.odometry import EdgeDvoOdometry
    from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

    prof = profiles.parity_320()
    frames, poses = render_sequence(prof.camera, _trajectory(FRAMES), seed=0)
    gt = np.stack([p[1] for p in poses])
    out = {}
    for name, solver in (
        ("parity_320+interpolate_dt+svd",
         dataclasses.replace(prof.solver, interpolate_dt=True, rotationize_method="svd")),
        ("parity_320", prof.solver),
    ):
        cfg = PipelineConfig(
            camera=prof.camera,
            pyramid=PyramidConfig(num_levels=prof.num_levels, max_points=prof.max_points),
            solver=solver, keyframe=KeyframeConfig(force_every=5, rollback_resolve=True))
        odo = EdgeDvoOdometry(cfg)
        for i, (g, d) in enumerate(frames):
            odo.process_frame(g, d, timestamp=float(i))
        t_est = odo.trajectory()[1]
        out[name] = {"ate_mm": float(np.sqrt(((t_est - gt) ** 2).sum(-1).mean())) * 1000.0,
                     "keyframes": odo.gop.keyframe_indices()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
