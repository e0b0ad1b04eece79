"""Frame sources and stream manipulation: port of
`rgbd_odometry_tpu/io/stream.py` (`SyntheticCamera`, `TumSource`,
`skip_frames`).

A source yields (gray level-0 float32 0..255, depth level-0 float32 mm,
timestamp s) as numpy arrays; the driver or `pipeline/feeder.FrameFeeder`
moves them to the device. The synthetic camera renders with the port's
`se3_exp` (`io/synthetic.py`); TUM replay decodes PNGs with the native
loader (`io/native_loader.py`, a C++ worker pool off the GIL) when it
builds, else with cv2.
"""

from __future__ import annotations

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
