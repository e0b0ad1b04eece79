"""Synthetic RGB-D renders with the port's `se3_exp`.

Twins of `rgbd_odometry_tpu.io.synthetic.render_pair` / `render_sequence`,
whose pose step calls JAX. The scene itself is the JAX package's numpy
`SyntheticScene` (jax-free), so the images are the same renderer's.
"""

from __future__ import annotations

import numpy as np
import torch

from rgbd_odometry_tpu.config import CameraConfig
from rgbd_odometry_tpu.io.synthetic import Degradations, SyntheticScene, degrade_frame
from rgbd_odometry_tpu_torch.core.geometry import se3_exp


def pose_from_twist(psi) -> tuple:
    """float32 se3_exp of a twist (6,), returned as float64 numpy (R, t)."""
    R, t = se3_exp(torch.as_tensor(np.asarray(psi, np.float32)))
    return R.numpy().astype(np.float64), t.numpy().astype(np.float64)


def render_pair(
    cam: CameraConfig,
    psi: np.ndarray,
    seed: int = 0,
    supersample: int = 3,
    degrade: Degradations | None = None,
):
    """(ref, now) frame pair, the now camera at se3_exp(psi) in the ref
    frame: returns ((ref_gray, ref_depth), (now_gray, now_depth), (R, t))."""
    scene = SyntheticScene(seed=seed, texture_amp=degrade.texture_amp if degrade else 0.0)
    R_gt, t_gt = pose_from_twist(psi)
    ref_gray, ref_depth = scene.render(cam, np.eye(3), np.zeros(3), supersample)
    now_gray, now_depth = scene.render(cam, R_gt, t_gt, supersample)
    if degrade is not None:
        ref_gray, ref_depth = degrade_frame(ref_gray, ref_depth, 0, degrade)
        now_gray, now_depth = degrade_frame(now_gray, now_depth, 1, degrade)
    return (ref_gray, ref_depth), (now_gray, now_depth), (R_gt, t_gt)


def render_sequence(
    cam: CameraConfig,
    psis: np.ndarray,
    seed: int = 0,
    supersample: int = 3,
    degrade: Degradations | None = None,
):
    """Frames along absolute camera twists psis (T, 6): returns a list of
    (gray, depth_mm) and a list of ground-truth (R, t)."""
    scene = SyntheticScene(seed=seed, texture_amp=degrade.texture_amp if degrade else 0.0)
    frames, poses = [], []
    for i, psi in enumerate(np.asarray(psis)):
        R, t = pose_from_twist(psi)
        gray, depth = scene.render(cam, R, t, supersample)
        if degrade is not None:
            gray, depth = degrade_frame(gray, depth, i, degrade)
        frames.append((gray, depth))
        poses.append((R, t))
    return frames, poses
