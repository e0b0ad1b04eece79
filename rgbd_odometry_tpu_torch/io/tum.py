"""TUM RGB-D dataset ingestion and trajectory files: port of
`rgbd_odometry_tpu/io/tum.py`, with the port's quaternions (the JAX
package's module imports its JAX geometry).

Trajectory files are TUM format `timestamp tx ty tz qx qy qz qw`; depth PNGs
are uint16 at 5000 units per metre, converted to millimetres with 0 -> 1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from rgbd_odometry_tpu_torch.core import geometry as geo
from rgbd_odometry_tpu_torch.eval.ate import rebase_to_first


def write_trajectory(path: str, R: np.ndarray, t: np.ndarray, timestamps: np.ndarray):
    """Write TUM-format `timestamp tx ty tz qx qy qz qw`."""
    q = geo.quat_from_rotmat(torch.as_tensor(np.asarray(R), dtype=torch.float32)).numpy()
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(len(t)):
            f.write(
                f"{timestamps[i]:.6f} {t[i,0]:.6f} {t[i,1]:.6f} {t[i,2]:.6f} "
                f"{q[i,0]:.6f} {q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f}\n"
            )


def read_trajectory(
    path: str, skip_lines: int = 0, rebase: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a TUM trajectory -> (R (T,3,3), t (T,3), timestamps (T,)),
    skipping `skip_lines` data lines (loadGTPath's LINES_TO_SKIP) and, with
    `rebase`, re-expressing every pose relative to the first kept one."""
    ts_list, t_list, q_list = [], [], []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if skipped < skip_lines:
                skipped += 1
                continue
            vals = line.split()
            if len(vals) < 8:
                continue
            ts_list.append(float(vals[0]))
            t_list.append([float(v) for v in vals[1:4]])
            q_list.append([float(v) for v in vals[4:8]])
    ts = np.asarray(ts_list)
    t = np.asarray(t_list)
    q = torch.as_tensor(np.asarray(q_list, np.float32).reshape(-1, 4))
    R = geo.rotmat_from_quat(q).numpy().astype(np.float64)
    if rebase and len(t):
        R, t = rebase_to_first(R, t)
    return R, t, ts


@dataclass
class TumSequence:
    """An associated TUM RGB-D sequence on disk."""

    root: str
    rgb_files: List[str]
    depth_files: List[str]
    timestamps: np.ndarray

    def __len__(self):
        return len(self.rgb_files)

    def load_frame(self, i: int, half_res: bool = True):
        """Frame i -> (gray float32 0..255, depth_mm float32), at the
        reference's half-VGA working resolution when `half_res`."""
        import cv2

        rgb = cv2.imread(os.path.join(self.root, self.rgb_files[i]), cv2.IMREAD_GRAYSCALE)
        depth_raw = cv2.imread(os.path.join(self.root, self.depth_files[i]), cv2.IMREAD_UNCHANGED)
        depth_mm = depth_raw.astype(np.float32) / 5.0
        depth_mm = np.where(depth_mm == 0, 1.0, depth_mm)
        gray = rgb.astype(np.float32)
        if half_res:
            gray = gray[::2, ::2]
            depth_mm = depth_mm[::2, ::2]
        return gray, depth_mm


def _read_file_list(path: str) -> Tuple[np.ndarray, List[str]]:
    ts, files = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            ts.append(float(vals[0]))
            files.append(vals[1])
    return np.asarray(ts), files


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py semantics)."""
    pairs = []
    used_b: set = set()
    for i, ta in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, ta))
        best = None
        for k in (j - 1, j, j + 1):
            if 0 <= k < len(ts_b) and k not in used_b:
                dt = abs(ts_b[k] - ta)
                if dt <= max_dt and (best is None or dt < best[1]):
                    best = (k, dt)
        if best is not None:
            pairs.append((i, best[0]))
            used_b.add(best[0])
    return pairs


def open_sequence(root: str, max_dt: float = 0.02) -> TumSequence:
    """Associate rgb.txt and depth.txt of a TUM sequence directory."""
    ts_rgb, rgb_files = _read_file_list(os.path.join(root, "rgb.txt"))
    ts_depth, depth_files = _read_file_list(os.path.join(root, "depth.txt"))
    pairs = associate(ts_rgb, ts_depth, max_dt)
    return TumSequence(
        root=root,
        rgb_files=[rgb_files[i] for i, _ in pairs],
        depth_files=[depth_files[j] for _, j in pairs],
        timestamps=np.asarray([ts_rgb[i] for i, _ in pairs]),
    )
