"""Frame sources and stream manipulation: port of
`rgbd_odometry_tpu/io/stream.py` (`SyntheticCamera`, `TumSource`,
`skip_frames`, `preprocess_vga`).

A source yields (gray level-0 float32 0..255, depth level-0 float32 mm,
timestamp s) as numpy arrays; the driver or `pipeline/feeder.FrameFeeder`
moves them to the device. The synthetic camera renders with the port's
`se3_exp` (`io/synthetic.py`); TUM replay decodes PNGs with the native
loader (`io/native_loader.py`, a C++ worker pool off the GIL) when it
builds, else with cv2.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import CameraConfig


@dataclass
class SyntheticCamera:
    """Deterministic synthetic RGB-D stream along a smooth trajectory (the
    JAX `SyntheticCamera`). `degrade` is an `io.synthetic.Degradations`."""

    camera: CameraConfig
    num_frames: int = 30
    fps: float = 30.0
    seed: int = 0
    step: float = 0.003
    degrade: object = None

    def _twists(self) -> np.ndarray:
        ts = np.arange(self.num_frames)
        s = self.step
        return np.stack(
            [0.8 * s * ts, -0.5 * s * ts, 0.3 * s * ts, 0.15 * s * ts, -0.2 * s * ts,
             0.1 * s * ts],
            axis=-1,
        ).astype(np.float32)

    def frames(self):
        from rgbd_odometry_tpu_torch.io.synthetic import render_sequence

        frames, _ = render_sequence(self.camera, self._twists(), seed=self.seed,
                                    degrade=self.degrade)
        for i, (gray, depth) in enumerate(frames):
            yield gray, depth, i / self.fps

    def ground_truth(self):
        """(R (T,3,3), t (T,3)) float64 camera poses of the frames."""
        from rgbd_odometry_tpu_torch.core.geometry import se3_exp

        R, t = se3_exp(torch.from_numpy(self._twists()))
        return R.numpy().astype(np.float64), t.numpy().astype(np.float64)


@dataclass
class TumSource:
    """Replay a TUM RGB-D sequence directory. With `native=True` (default)
    PNG decode runs in the C++ worker pool when it builds; otherwise (or
    when it does not) cv2 decodes."""

    root: str
    half_res: bool = True
    start: int = 0
    end: Optional[int] = None
    native: bool = True
    vga_size: Tuple[int, int] = (640, 480)

    def frames(self):
        import os

        from rgbd_odometry_tpu_torch.io.tum import open_sequence

        seq = open_sequence(self.root)
        end = len(seq) if self.end is None else min(self.end, len(seq))
        if self.native:
            from rgbd_odometry_tpu_torch.io import native_loader as nl

            if nl.available():
                entries = [
                    (float(seq.timestamps[i]), os.path.join(self.root, seq.rgb_files[i]),
                     os.path.join(self.root, seq.depth_files[i]))
                    for i in range(self.start, end)
                ]
                w, h = self.vga_size
                loader = nl.NativeTumLoader(entries, w, h)
                try:
                    for gray, depth, ts in loader.frames():
                        if self.half_res:
                            gray, depth = gray[::2, ::2], depth[::2, ::2]
                        yield gray, depth, ts
                finally:
                    loader.close()
                return
        for i in range(self.start, end):
            gray, depth = seq.load_frame(i, half_res=self.half_res)
            yield gray, depth, float(seq.timestamps[i])


def skip_frames(source_iter, skip: int = 5):
    """Keep every `skip`-th frame (the bagManip robustness fixture)."""
    for i, item in enumerate(source_iter):
        if i % skip == 0:
            yield item


@functools.lru_cache(maxsize=8)
def _undistort_grid(cam: CameraConfig, device: torch.device) -> torch.Tensor:
    """`undistort_map` of a camera, made once per (camera, device)."""
    from rgbd_odometry_tpu_torch.core.camera import undistort_map

    return undistort_map(cam, device)


def preprocess_vga(rgb_vga, depth_vga_m, cam_vga: CameraConfig, device=None):
    """The converter node's preprocessing of one VGA RGB-D frame, on
    `device` (the card unless the caller asks for the CPU): float metres
    depth -> millimetres with 0 -> 1, the plumb-bob undistortion when the
    camera has distortion (bilinear, gray and depth alike), gray conversion,
    the half-resolution base level. `rgb_vga` (H, W, 3) 0..255, or (H, W)
    gray; `depth_vga_m` (H, W), 0 where invalid. Returns (gray0, depth0_mm),
    (H/2, W/2) float32 tensors on the device, which `EdgeDvoOdometry.
    process_frame` takes."""
    from rgbd_odometry_tpu_torch.core.camera import remap_bilinear
    from rgbd_odometry_tpu_torch.core.pyramid import downsample_nearest, rgb_to_gray, sanitize_depth
    from rgbd_odometry_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    depth_m = torch.as_tensor(np.asarray(depth_vga_m)).to(dev)
    # the product in the depth's own dtype, as numpy takes it
    depth_mm = torch.where(depth_m > 0, depth_m * 1000.0, 0.0).to(torch.float32)
    rgb = torch.as_tensor(np.asarray(rgb_vga, np.float32)).to(dev)
    gray = rgb_to_gray(rgb) if rgb.dim() == 3 else rgb
    depth = sanitize_depth(depth_mm)
    if any(abs(d) > 0 for d in cam_vga.distortion):
        grid = _undistort_grid(cam_vga, dev)
        gray = remap_bilinear(gray, grid)
        depth = remap_bilinear(depth, grid)
    return downsample_nearest(gray, 2), downsample_nearest(depth, 2)
