"""Live-run visualization sink: the port's copy of
`rgbd_odometry_tpu/viz/live.py`, writing its PNGs through `viz.png` (no
OpenCV).

The reference shows overlays, residue heat maps and energy plots during its
loop and a dense full-frame reprojection composite (`MentisVisualHandle::
debug`); without a display they are image files: `cli dvo --viz-dir <dir>`
attaches a `LiveViz` to the streaming driver.

Per sampled frame (every `every` frames):
  overlay_NNNN.png   ref edge points reprojected onto the now frame
  residue_NNNN.png   per-point residual heat map
  energy_NNNN.png    energy-per-iteration curve
  histogram_NNNN.png residue histogram + Laplacian fit
At the end (`finalize`):
  trajectory.png           top-down path with reason-coloured keyframes
  reprojection_debug.png   dense ref->now warp composite
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from rgbd_odometry_tpu_torch.viz.overlay import (
    energy_plot,
    overlay_points,
    residual_histogram_plot,
    residue_heatmap,
    trajectory_plot,
)
from rgbd_odometry_tpu_torch.viz.png import write_png


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reproject_ref_points(odo) -> tuple[np.ndarray, np.ndarray]:
    """Reproject the level-0 reference edge points under the current relative
    pose (host float64, as the JAX sink does)."""
    ref = odo._ref_feats[0]
    pts = _np(ref.pts3d[0]).astype(np.float64)
    valid = _np(ref.valid[0])
    R = np.asarray(odo._R, np.float64)
    t = np.asarray(odo._t, np.float64)
    xp = (pts - t) @ R  # R^T (X - t) row-wise
    z = np.where(np.abs(xp[:, 2]) < 1e-12, 1e-12, xp[:, 2])
    intr = odo.intr
    u = float(intr.fx) * xp[:, 0] / z + float(intr.cx)
    v = float(intr.fy) * xp[:, 1] / z + float(intr.cy)
    w, h = odo.cfg.camera.width, odo.cfg.camera.height
    vis = valid & (u >= 0) & (u <= w) & (v >= 0) & (v <= h) & (xp[:, 2] > 0)
    return np.stack([u, v], -1), vis


class LiveViz:
    """Attach to an EdgeDvoOdometry run; writes debug PNGs as frames pass."""

    def __init__(self, out_dir: str, every: int = 5):
        self.out_dir = out_dir
        self.every = max(1, every)
        os.makedirs(out_dir, exist_ok=True)
        self._last_frame: Optional[tuple[np.ndarray, np.ndarray]] = None
        self.written: list[str] = []

    def _put(self, name: str, img: np.ndarray):
        path = os.path.join(self.out_dir, name)
        write_png(path, img)
        self.written.append(path)

    def on_frame(self, odo, gray, depth_mm):
        """Call right after odo.process_frame(gray, depth_mm, ...) (numpy
        arrays or tensors, level 0)."""
        gray, depth_mm = _np(gray), _np(depth_mm)
        self._last_frame = (gray, depth_mm)
        m = odo.metrics[-1]
        n = m.frame_num
        if n == 0 or (n % self.every) != 0:
            return
        uv, vis = _reproject_ref_points(odo)
        self._put(f"overlay_{n:04d}.png", overlay_points(gray, uv, vis))
        if m.energy_curve is not None:
            self._put(f"energy_{n:04d}.png", energy_plot(np.asarray(m.energy_curve),
                                                         best_iter=m.best_iter))
        if m.final_epsilons is not None and m.final_valid is not None:
            from rgbd_odometry_tpu_torch.pipeline.odometry import residual_histogram

            eps, val = np.asarray(m.final_epsilons), np.asarray(m.final_valid)
            self._put(f"residue_{n:04d}.png", residue_heatmap(gray, uv, eps, val))
            self._put(f"histogram_{n:04d}.png",
                      residual_histogram_plot(residual_histogram(eps, val), m.b_cap))

    def finalize(self, odo, gt_t: Optional[np.ndarray] = None):
        R, t, ts = odo.trajectory()
        kfs = odo.gop.keyframe_indices()
        reasons = [odo.gop.elements[i].reason for i in kfs]
        self._put("trajectory.png", trajectory_plot(t, gt_t, keyframes=kfs, reasons=reasons))
        if self._last_frame is not None and odo._prev_pyr is not None:
            # the previous frame's level 0 warped into the current frame under
            # the final relative pose, beside the actual frame: a qualitative
            # alignment check (the stored features keep no image)
            from rgbd_odometry_tpu_torch.solvers.photometric import warp_image

            gray, _ = self._last_frame
            f32 = dict(dtype=torch.float32, device=odo.device)
            warped = _np(warp_image(odo._prev_pyr.gray[0][0], odo._prev_pyr.depth[0][0], odo.intr,
                                    torch.as_tensor(odo._R, **f32),
                                    torch.as_tensor(odo._t, **f32)))
            comp = np.concatenate([warped, np.full((warped.shape[0], 4), 255.0), gray], axis=1)
            self._put("reprojection_debug.png", np.clip(comp, 0, 255).astype(np.uint8))
        return self.written
