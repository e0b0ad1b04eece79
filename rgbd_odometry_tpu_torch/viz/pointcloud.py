"""Point-cloud export — `publishCurrentPointCloud`'s role without RViz: the
port's own copy of `rgbd_odometry_tpu/viz/pointcloud.py`, numpy only.

The reference publishes the current frame's back-projected cloud to RViz
(reference src/MentisVisualHandle.cpp:101-144; the accumulated
full-cloud variant is commented out :392-476). Here: back-project a frame
(optionally transformed by a global pose), and write standard ASCII PLY for
any viewer.
"""

from __future__ import annotations

import numpy as np


def frame_to_cloud(
    gray: np.ndarray,
    depth_mm: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    R: np.ndarray | None = None,
    t: np.ndarray | None = None,
    stride: int = 1,
    min_depth_mm: float = 100.0,
    max_depth_mm: float = 10000.0,
):
    """(points (N,3) metres in the world frame, intensities (N,))."""
    g = np.asarray(gray)[::stride, ::stride]
    d = np.asarray(depth_mm)[::stride, ::stride]
    h, w = d.shape
    ys, xs = np.meshgrid(np.arange(h) * stride, np.arange(w) * stride, indexing="ij")
    valid = (d > min_depth_mm) & (d < max_depth_mm)
    z = d[valid] / 1000.0
    x = z * (xs[valid] - cx) / fx
    y = z * (ys[valid] - cy) / fy
    pts = np.stack([x, y, z], -1)
    if R is not None:
        pts = pts @ np.asarray(R).T + (np.zeros(3) if t is None else np.asarray(t))
    return pts, g[valid]


def compose_map(
    clouds: list[tuple[np.ndarray, int]],
    R_traj: np.ndarray,
    t_traj: np.ndarray,
):
    """Fuse per-keyframe camera-frame clouds into one world-frame map.

    ``clouds``: [(points (M_k, 3) metres in keyframe k's camera frame,
    trajectory node index of keyframe k)] — the semi-dense edge clouds the
    solver already extracts per keyframe (EdgeDvoOdometry.keyframe_cloud).
    ``R_traj``/``t_traj``: (T,3,3)/(T,3) global trajectory — pass the
    loop-refined poses to get the drift-corrected map.

    This is the accumulated full-cloud map the reference sketched and
    commented out (reference src/MentisVisualHandle.cpp:392-476),
    built from edge points (the system's actual measurement support) instead
    of full depth images. Returns (points (N,3) world, node_ids (N,)).
    """
    pts_all, ids = [], []
    for pts, node in clouds:
        if len(pts) == 0:
            continue
        R = np.asarray(R_traj[node], np.float64)
        t = np.asarray(t_traj[node], np.float64)
        pts_all.append(np.asarray(pts, np.float64) @ R.T + t)
        ids.append(np.full(len(pts), node, np.int32))
    if not pts_all:
        return np.zeros((0, 3)), np.zeros((0,), np.int32)
    return np.concatenate(pts_all), np.concatenate(ids)


def map_consistency_error(
    clouds: list[tuple[np.ndarray, int]],
    R_est: np.ndarray,
    t_est: np.ndarray,
    R_gt: np.ndarray,
    t_gt: np.ndarray,
) -> float:
    """Mean metre displacement of every map point between its estimated and
    ground-truth placement. The per-keyframe clouds are exact geometry in
    keyframe coordinates (they come straight from the keyframe's depth map),
    so ALL map error is pose error — this isolates exactly what a trajectory
    refinement changes about the map."""
    a, _ = compose_map(clouds, R_est, t_est)
    b, _ = compose_map(clouds, R_gt, t_gt)
    if len(a) == 0:
        return 0.0
    return float(np.linalg.norm(a - b, axis=-1).mean())


def write_ply(path: str, points: np.ndarray, intensities: np.ndarray | None = None):
    """ASCII PLY writer (positions + optional gray color)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if intensities is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if intensities is not None:
            c = np.clip(np.asarray(intensities), 0, 255).astype(int)
            for p, ci in zip(points, c):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {ci} {ci} {ci}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
