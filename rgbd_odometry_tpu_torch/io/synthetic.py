"""Synthetic RGB-D renders: the analytic scene and the pose step, in numpy
and the port's `se3_exp`.

A copy of the jax-free parts of `rgbd_odometry_tpu/io/synthetic.py` (the
`Degradations` of the sensor, `degrade_frame` and the numpy ray-cast
`SyntheticScene`), so that the images are the same renderer's, plus twins of
its `render_pair` / `render_sequence`, whose pose step there calls JAX.
A textured background plane with painted rotated rectangles and floating
billboards at nearer depths, rendered with supersampling (anti-aliased,
rotated edges vary in sub-pixel phase): exact ground-truth poses with the
sharp intensity edges and parallax that edge-DVO needs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rgbd_odometry_tpu_torch.config import CameraConfig
from rgbd_odometry_tpu_torch.core.geometry import se3_exp


@dataclass(frozen=True)
class Degradations:
    """Scene/sensor degradations for robustness validation — the
    manipulations the reference's stream-manipulator harness envisions
    ("add noise, tinker with illumination etc.",
    reference src/bagManip.cpp:1):

      * `texture_amp` — pose-consistent procedural texture painted on the
        scene surfaces (world-anchored, so it moves correctly with the
        camera and adds genuine extra edges/gradients),
      * `noise_sigma` — per-frame additive Gaussian intensity noise
        (sensor read noise; independent between frames),
      * `depth_noise_mm` — per-frame Gaussian depth noise,
      * `illum_gain_per_frame` / `illum_bias_per_frame` — multiplicative /
        additive illumination drift accumulating over the sequence
        (auto-exposure hunting, lighting changes).
    """

    texture_amp: float = 0.0
    noise_sigma: float = 0.0
    depth_noise_mm: float = 0.0
    illum_gain_per_frame: float = 0.0
    illum_bias_per_frame: float = 0.0
    seed: int = 1000
    # ---- TUM/PrimeSense-shaped sensor modeling ----------------------------
    # quantize depth to the TUM file format: uint16 at 1/5000 m = 0.2 mm
    # steps (the exact representable set of every real TUM depth PNG)
    depth_quantize_tum: bool = False
    # structured-light shadow holes: depth is LOST in a band on the right of
    # every strong horizontal depth discontinuity (the IR projector is
    # baseline-offset from the camera, so foreground objects occlude the
    # pattern on one side). Holes read 0 -> sanitized to 1 mm -> rejected by
    # the >100 mm point gate, the real missing-data path
    depth_shadow_px: int = 0  # band width in pixels (0 = off)
    depth_shadow_thresh_mm: float = 150.0
    # random elliptical dropout blobs per frame (specular/absorbing surfaces)
    depth_dropout_blobs: int = 0
    depth_dropout_radius_px: float = 6.0
    # mild motion blur: gray convolved with a length-L line kernel in a
    # per-frame random direction (handheld shake during exposure)
    motion_blur_px: float = 0.0


def degrade_frame(
    gray: np.ndarray,
    depth_mm: np.ndarray,
    frame_idx: int,
    deg: "Degradations",
):
    """Apply the per-frame (sensor-side) degradations. Texture is scene-side
    and lives in SyntheticScene; this handles noise + illumination drift."""
    g = gray.astype(np.float32)
    if deg.motion_blur_px >= 2.0:
        # length-L line kernel in a per-frame random direction: integer-tap
        # average of shifted copies (cheap, direction varies per frame like
        # real handheld shake)
        rng_b = np.random.default_rng(deg.seed + 7919 * frame_idx + 2)
        ang = rng_b.uniform(0, np.pi)
        L = max(2, int(round(deg.motion_blur_px)))
        acc = np.zeros_like(g)
        for k in range(L):
            s = k - (L - 1) / 2.0
            dy = int(round(s * np.sin(ang)))
            dx = int(round(s * np.cos(ang)))
            acc += np.roll(np.roll(g, dy, axis=0), dx, axis=1)
        g = acc / L
    gain = 1.0 + deg.illum_gain_per_frame * frame_idx
    bias = deg.illum_bias_per_frame * frame_idx
    g = g * gain + bias
    if deg.noise_sigma > 0:
        rng = np.random.default_rng(deg.seed + 7919 * frame_idx)
        g = g + rng.normal(0.0, deg.noise_sigma, g.shape).astype(np.float32)
    d = depth_mm.astype(np.float32)
    if deg.depth_noise_mm > 0:
        rng = np.random.default_rng(deg.seed + 7919 * frame_idx + 1)
        noise = rng.normal(0.0, deg.depth_noise_mm, d.shape).astype(np.float32)
        d = np.where(d > 0, np.maximum(d + noise, 1.0), d)
    if deg.depth_shadow_px > 0:
        # occlusion shadow: kill a band to the RIGHT of strong horizontal
        # depth steps (projector baseline direction)
        dd = np.abs(np.diff(d, axis=1)) > deg.depth_shadow_thresh_mm
        hole = np.zeros(d.shape, bool)
        for k in range(deg.depth_shadow_px):
            hole[:, 1 + k :] |= dd[:, : d.shape[1] - 1 - k]
        d = np.where(hole, 0.0, d)
    if deg.depth_dropout_blobs > 0:
        rng_h = np.random.default_rng(deg.seed + 7919 * frame_idx + 3)
        yy, xx = np.mgrid[0 : d.shape[0], 0 : d.shape[1]]
        for _ in range(deg.depth_dropout_blobs):
            cy = rng_h.uniform(0, d.shape[0])
            cx = rng_h.uniform(0, d.shape[1])
            ry = deg.depth_dropout_radius_px * rng_h.uniform(0.5, 1.5)
            rx = deg.depth_dropout_radius_px * rng_h.uniform(0.5, 1.5)
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            d = np.where(blob, 0.0, d)
    if deg.depth_quantize_tum:
        # TUM PNG format: uint16 at 1/5000 m -> depth_mm in 0.2 mm steps
        d = np.round(d * 5.0) / 5.0
    return np.round(np.clip(g, 0, 255)).astype(np.float32), d


def _in_rot_rect(px, py, x0, y0, w, h, ang):
    """Point-in-rotated-rectangle test (rectangle rotated by `ang` about its
    corner (x0, y0))."""
    ca, sa = np.cos(ang), np.sin(ang)
    lx = (px - x0) * ca + (py - y0) * sa
    ly = -(px - x0) * sa + (py - y0) * ca
    return (lx >= 0) & (lx < w) & (ly >= 0) & (ly < h)


class SyntheticScene:
    """Piecewise-constant-intensity scene: background plane at `z_plane` with
    painted rotated rectangles, plus floating billboards at closer depths."""

    def __init__(
        self,
        seed: int = 0,
        z_plane: float = 2.5,
        n_patches: int = 12,
        n_billboards: int = 5,
        texture_amp: float = 0.0,
    ):
        rng = np.random.default_rng(seed)
        self.z_plane = z_plane
        # world-anchored procedural texture: a few fixed-frequency sinusoids
        # of the world hit-point — moves with the scene under camera motion.
        # Drawn from a SEPARATE rng stream so enabling texture (or adding
        # texture parameters) never changes the patch/billboard layout of
        # existing seeds.
        self.texture_amp = float(texture_amp)
        tex_rng = np.random.default_rng(seed + 977)
        self._tex_waves = [
            (
                tex_rng.uniform(3.0, 9.0),
                tex_rng.uniform(3.0, 9.0),
                tex_rng.uniform(0, 2 * np.pi),
            )
            for _ in range(4)
        ]
        # painted rectangles on the plane: (x0, y0, w, h, angle, intensity)
        self.patches = []
        for _ in range(n_patches):
            self.patches.append(
                (
                    rng.uniform(-1.6, 1.2),
                    rng.uniform(-1.2, 0.9),
                    rng.uniform(0.25, 0.9),
                    rng.uniform(0.25, 0.9),
                    rng.uniform(0, np.pi),
                    rng.uniform(60, 230),
                )
            )
        self.base_intensity = 40.0
        # floating billboards: (x0, y0, w, h, angle, z, intensity)
        self.billboards = []
        for _ in range(n_billboards):
            self.billboards.append(
                (
                    rng.uniform(-0.9, 0.5),
                    rng.uniform(-0.7, 0.4),
                    rng.uniform(0.2, 0.5),
                    rng.uniform(0.2, 0.5),
                    rng.uniform(0, np.pi),
                    rng.uniform(1.1, 1.9),
                    rng.uniform(80, 250),
                )
            )

    def _render_rays(self, d_world: np.ndarray, o: np.ndarray, R: np.ndarray):
        """Shade a grid of world-frame ray directions; returns (gray, depth_m)."""
        shape = d_world.shape[:-1]
        gray = np.full(shape, self.base_intensity, np.float32)
        depth = np.zeros(shape, np.float32)
        dz = d_world[..., 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            s = (self.z_plane - o[2]) / dz
        hit_plane = (s > 0) & np.isfinite(s)
        px = o[0] + s * d_world[..., 0]
        py = o[1] + s * d_world[..., 1]
        inten = np.full(shape, self.base_intensity, np.float32)
        for x0, y0, pw, ph, ang, it in self.patches:
            m = _in_rot_rect(px, py, x0, y0, pw, ph, ang)
            inten = np.where(m, np.float32(it), inten)
        if self.texture_amp > 0:
            tex = np.zeros(shape, np.float32)
            for fx_, fy_, ph_ in self._tex_waves:
                tex += np.sin(fx_ * px + fy_ * py + ph_).astype(np.float32)
            inten = inten + (self.texture_amp / len(self._tex_waves)) * tex
        # depth = camera-frame z of the hit point: X_cam = R^T (X_world - o)
        plane_pt = np.stack([px, py, np.full_like(px, self.z_plane)], -1)
        hit_cam_z = ((plane_pt - o) @ R)[..., 2]
        gray = np.where(hit_plane, inten, gray)
        depth = np.where(hit_plane, hit_cam_z.astype(np.float32), depth)

        for x0, y0, bw, bh, ang, bz, it in sorted(self.billboards, key=lambda b: -b[5]):
            with np.errstate(divide="ignore", invalid="ignore"):
                s = (bz - o[2]) / dz
            hit = (s > 0) & np.isfinite(s)
            bx = o[0] + s * d_world[..., 0]
            by = o[1] + s * d_world[..., 1]
            hit &= _in_rot_rect(bx, by, x0, y0, bw, bh, ang)
            bb_pt = np.stack([bx, by, np.full_like(bx, bz)], -1)
            bz_cam = ((bb_pt - o) @ R)[..., 2].astype(np.float32)
            closer = hit & ((depth == 0) | (bz_cam < depth)) & (bz_cam > 0)
            gray = np.where(closer, np.float32(it), gray)
            depth = np.where(closer, bz_cam, depth)
        return gray, depth

    def render(self, cam: CameraConfig, R: np.ndarray, t: np.ndarray, supersample: int = 3):
        """Render (gray, depth_mm) float32 arrays from camera pose (R, t):
        the camera's pose in the world (= reference-camera) frame, matching
        the solver's (cR, cT) convention X_cam = R^T (X_world - t)
        (reference src/SolveDVO.cpp:330).

        Intensity is supersampled `supersample`x per axis and box-filtered
        (anti-aliasing); depth takes the central sample (depth sensors don't
        anti-alias).
        """
        h, w = cam.height, cam.width
        ss = supersample
        # supersampled pixel grid: sample centres at (i + (k+0.5)/ss - 0.5)
        ys = (np.arange(h * ss) + 0.5) / ss - 0.5
        xs = (np.arange(w * ss) + 0.5) / ss - 0.5
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        d_cam = np.stack(
            [(gx - cam.cx) / cam.fx, (gy - cam.cy) / cam.fy, np.ones_like(gx)], axis=-1
        )
        d_world = d_cam @ R.T
        gray_ss, depth_ss = self._render_rays(d_world, t, R)
        gray = gray_ss.reshape(h, ss, w, ss).mean(axis=(1, 3))
        mid = ss // 2
        depth = depth_ss.reshape(h, ss, w, ss)[:, mid, :, mid]
        gray = np.round(np.clip(gray, 0, 255)).astype(np.float32)
        depth_mm = np.where(depth > 0, depth * 1000.0, 0.0).astype(np.float32)
        return gray, depth_mm



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
