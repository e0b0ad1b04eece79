"""False-color maps for debug visualization: the port's own copy of
`rgbd_odometry_tpu/viz/colormap.py` (numpy only).

Replaces `FColorMap` (reference src/FColorMap.cpp) — a 64-entry
hardcoded BGR jet table (built with undefined behaviour: writes through
operator[] into a reserved-but-empty vector, :12-77). Here the jet map is
computed analytically at any resolution, plus the false-color depth ramp the
converter node uses for its debug view
(reference src/camTopic2PublisherPyD.cpp:187-223).
"""

from __future__ import annotations

import numpy as np


def jet(n: int = 64) -> np.ndarray:
    """(n, 3) RGB jet colormap in 0..255 (the reference's FColorMap role)."""
    x = np.linspace(0.0, 1.0, n)

    def ramp(v):
        return np.clip(1.5 - np.abs(v), 0.0, 1.0)

    r = ramp(4.0 * (x - 0.75))
    g = ramp(4.0 * (x - 0.5))
    b = ramp(4.0 * (x - 0.25))
    return np.stack([r, g, b], -1) * 255.0


def apply_colormap(values: np.ndarray, vmin=None, vmax=None, n: int = 64) -> np.ndarray:
    """Map scalar image (H, W) -> RGB uint8 (H, W, 3) via the jet table,
    indexing exactly like the reference's `FColorMap::at` usage."""
    table = jet(n).astype(np.uint8)
    v = np.asarray(values, np.float64)
    vmin = float(v.min()) if vmin is None else vmin
    vmax = float(v.max()) if vmax is None else vmax
    idx = np.clip(((v - vmin) / max(vmax - vmin, 1e-12) * (n - 1)).astype(np.int32), 0, n - 1)
    return table[idx]


def depth_false_color(depth_mm: np.ndarray, max_mm: float = 5000.0) -> np.ndarray:
    """False-color depth debug image (converter node's debug view)."""
    return apply_colormap(np.clip(depth_mm, 0, max_mm), 0.0, max_mm)
