"""Debug overlays, residue heat maps, energy plots — as plain numpy images:
the port's own copy of `rgbd_odometry_tpu/viz/overlay.py`.

Replaces the reference's imshow-based debug visualizations
(reference src/SolveDVO.cpp): `sOverlay` (:1186-1228, colored mask over
gray image), `visualizeResidueHeatMap` (:1485-1526), `visualizeDistanceResidueHeatMap`
(:1528-1583), `visualizeEnergyProgress` (:1585-1629), `visualizeReprojectedDepth`
(:1632-1675), and `MentisVisualHandle`'s path/keyframe rendering
(reference src/MentisVisualHandle.cpp:283-390 with its reason->color map
:327-358). Every function returns an RGB uint8 array; nothing opens windows —
save with `viz.png.write_png` or feed to notebooks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from rgbd_odometry_tpu_torch.viz.colormap import apply_colormap

# keyframe reason -> RGB color (MentisVisualHandle.cpp:327-358 semantics:
# distinct colors per reason code; 1=first frame, 2=laplacian, 3=visibility,
# 4=too few points, 5=periodic)
REASON_COLORS = {
    0: (200, 200, 200),
    1: (255, 255, 255),
    2: (255, 64, 64),
    3: (255, 160, 0),
    4: (255, 0, 255),
    5: (64, 160, 255),
    6: (0, 255, 128),  # relocalized (beyond-reference, pipeline/relocalize.py)
}


def to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], -1)


def overlay_mask(gray: np.ndarray, mask: np.ndarray, color=(0, 255, 0)) -> np.ndarray:
    """`sOverlay`: paint mask pixels in `color` over the gray image
    (reference src/SolveDVO.cpp:1186-1228)."""
    img = to_rgb(gray)
    img[np.asarray(mask) > 0] = color
    return img


def overlay_points(gray: np.ndarray, uv: np.ndarray, valid=None, color=(0, 255, 0)) -> np.ndarray:
    """Paint reprojected points (the per-iteration reprojection overlay,
    SolveDVO.cpp:930-989)."""
    img = to_rgb(gray)
    h, w = img.shape[:2]
    uv = np.asarray(uv)
    if valid is not None:
        uv = uv[np.asarray(valid)]
    xi = np.clip(uv[:, 0].astype(int), 0, w - 1)
    yi = np.clip(uv[:, 1].astype(int), 0, h - 1)
    img[yi, xi] = color
    return img


def residue_heatmap(gray: np.ndarray, uv: np.ndarray, residues: np.ndarray, valid=None, vmax=None) -> np.ndarray:
    """`visualizeResidueHeatMap`: color each reprojected point by |residual|
    (SolveDVO.cpp:1485-1526)."""
    img = to_rgb(gray)
    h, w = img.shape[:2]
    uv = np.asarray(uv)
    r = np.asarray(residues)
    if valid is not None:
        m = np.asarray(valid)
        uv, r = uv[m], r[m]
    if len(r) == 0:
        return img
    colors = apply_colormap(r, 0.0, vmax if vmax is not None else max(float(r.max()), 1e-6))
    xi = np.clip(uv[:, 0].astype(int), 0, w - 1)
    yi = np.clip(uv[:, 1].astype(int), 0, h - 1)
    img[yi, xi] = colors
    return img


def energy_plot(energies: np.ndarray, best_iter: int | None = None, height: int = 200, width: int = 400) -> np.ndarray:
    """`visualizeEnergyProgress` (SolveDVO.cpp:1585-1629): the per-iteration
    energy curve as an image, with the best iterate marked."""
    e = np.asarray(energies, np.float64)
    e = e[e > 0] if (e > 0).any() else e
    img = np.full((height, width, 3), 255, np.uint8)
    if len(e) == 0:
        return img
    emax = max(float(e.max()), 1e-9)
    xs = (np.arange(len(e)) * (width - 1) / max(len(e) - 1, 1)).astype(int)
    ys = (height - 1 - (e / emax) * (height - 20)).astype(int)
    for i in range(len(e) - 1):
        x0, x1 = xs[i], xs[i + 1]
        y0, y1 = ys[i], ys[i + 1]
        n = max(abs(x1 - x0), abs(y1 - y0), 1)
        xi = np.linspace(x0, x1, n + 1).astype(int)
        yi = np.linspace(y0, y1, n + 1).astype(int)
        img[np.clip(yi, 0, height - 1), np.clip(xi, 0, width - 1)] = (200, 40, 40)
    if best_iter is not None and 0 <= best_iter < len(e):
        bx, by = xs[best_iter], ys[best_iter]
        img[max(by - 2, 0) : by + 3, max(bx - 2, 0) : bx + 3] = (40, 40, 220)
    return img


def trajectory_plot(
    t_est: np.ndarray,
    t_gt: np.ndarray | None = None,
    keyframes: Sequence[int] = (),
    reasons: Sequence[int] = (),
    size: int = 400,
    axes=(0, 2),
) -> np.ndarray:
    """Top-down trajectory rendering — the RViz path/keyframe-marker view
    (`publishGOP`/`publishPath`, MentisVisualHandle.cpp:283-390) as an image.
    Keyframes are colored by reason code."""
    img = np.full((size, size, 3), 255, np.uint8)
    pts = [np.asarray(t_est)[:, axes]]
    if t_gt is not None:
        pts.append(np.asarray(t_gt)[:, axes])
    allp = np.concatenate(pts, 0)
    lo = allp.min(0) - 1e-6
    hi = allp.max(0) + 1e-6
    span = np.maximum(hi - lo, 1e-6).max()

    def to_px(p):
        q = (p - lo) / span
        return (q * (size - 40) + 20).astype(int)

    if t_gt is not None:
        for p in to_px(np.asarray(t_gt)[:, axes]):
            img[np.clip(size - 1 - p[1], 0, size - 1), np.clip(p[0], 0, size - 1)] = (150, 150, 150)
    est_px = to_px(np.asarray(t_est)[:, axes])
    for p in est_px:
        img[np.clip(size - 1 - p[1], 0, size - 1), np.clip(p[0], 0, size - 1)] = (200, 40, 40)
    for j, ki in enumerate(keyframes):
        p = est_px[ki]
        c = REASON_COLORS.get(reasons[j] if j < len(reasons) else 0, (0, 0, 0))
        y, x = np.clip(size - 1 - p[1], 2, size - 3), np.clip(p[0], 2, size - 3)
        img[y - 2 : y + 3, x - 2 : x + 3] = c
    return img


def residual_histogram_plot(
    hist: np.ndarray, b_cap: float, height: int = 250, width: int = 520
) -> np.ndarray:
    """`processResidueHistogram`'s plot (reference src/SolveDVO.cpp:
    1398-1483): normalized residue histogram bars with the fitted Laplacian
    pdf 1/(2b) exp(-r/b) overlaid."""
    img = np.full((height, width, 3), 255, np.uint8)
    n = len(hist)
    hmax = max(float(np.max(hist)), 1e-9)
    for i in range(n):
        x = int(i * (width - 1) / max(n - 1, 1))
        y = int((height - 20) * (1.0 - hist[i] / hmax))
        img[max(y, 0) : height - 10, x] = (60, 60, 220)
    if b_cap > 1e-9:
        for i in range(1, n):
            mag = 1.0 / (2.0 * b_cap) * np.exp(-(i - 1) / b_cap)
            x = int(i * (width - 1) / max(n - 1, 1))
            y = int((height - 20) * (1.0 - min(mag / hmax, 1.0)))
            y = np.clip(y, 0, height - 1)
            img[y, max(x - 1, 0) : x + 1] = (220, 160, 0)
    return img


def reprojected_depth_map(gray: np.ndarray, uv: np.ndarray, depths_m: np.ndarray, valid=None, max_depth: float = 5.0) -> np.ndarray:
    """`visualizeReprojectedDepth` (reference src/SolveDVO.cpp:1632-1675):
    reprojected points painted by their camera-frame depth."""
    return residue_heatmap(gray, uv, np.clip(np.asarray(depths_m), 0, max_depth), valid, vmax=max_depth)
