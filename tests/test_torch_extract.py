"""Reference-keyframe extraction of the PyTorch port against the JAX package
on the CPU: in both the exact and the segmented top-k branch the valid points
are the same set in the same order, pts3d agrees to 1e-6 and `count` is
equal. Invalid slots are compared only on `valid` (zero pads may tie in the
segmented top-k)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JIntrinsics  # noqa: E402
from rgbd_odometry_tpu.profiles import production_320  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(1)

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
# level 0: 19200 px >= 8 * 2048 -> segmented; level 1: 4800 px = 18 full
# 256-px segments + a 192-px padded one, >= 8 * 512 -> segmented; level 2:
# 1200 px >= 8 * 128 -> segmented with a padded tail segment
MAX_POINTS = (2048, 512, 128)


@pytest.fixture(scope="module")
def frames():
    psi = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
    (rg, rd), (ng, nd), _ = render_pair(CAM, psi, seed=0)
    return np.stack([rg, ng]), np.stack([rd, nd])


@pytest.mark.parametrize("selection", ["exact", "segmented"])
def test_extraction_matches_jax(frames, selection):
    grays, depths = frames
    cfg = dataclasses.replace(production_320().solver, extract_selection=selection)
    pyr = build_pyramid(torch.from_numpy(grays), torch.from_numpy(depths), 3)
    got = ted.extract_ref_features(pyr.gray, pyr.depth, Intrinsics.from_config(CAM), cfg, MAX_POINTS)
    jintr = JIntrinsics.from_config(CAM)
    extract = jax.jit(
        lambda g, d: jed.extract_ref_features(g, d, jintr, cfg, MAX_POINTS)
    )
    for b in range(2):
        jg = tuple(jnp.asarray(g[b].numpy()) for g in pyr.gray)
        jd = tuple(jnp.asarray(d[b].numpy()) for d in pyr.depth)
        want = extract(jg, jd)
        for lvl, (w, t) in enumerate(zip(want, got)):
            msg = f"pair {b} level {lvl} ({selection})"
            valid = np.asarray(w.valid)
            assert valid.sum() > 20, msg
            np.testing.assert_array_equal(t.valid[b].numpy(), valid, err_msg=msg)
            assert int(t.count[b]) == int(w.count), msg
            np.testing.assert_array_equal(t.uv[b].numpy()[valid], np.asarray(w.uv)[valid], err_msg=msg)
            np.testing.assert_allclose(
                t.pts3d[b].numpy()[valid], np.asarray(w.pts3d)[valid], rtol=0, atol=1e-6, err_msg=msg
            )
            assert not t.pts3d[b].numpy()[~valid].any(), msg


def test_extraction_from_step_edges_is_identical(frames):
    """A keyframe's own `NowLevel.edges` fed to extraction (Canny skipped)
    gives bit-identical features."""
    grays, depths = frames
    cfg = production_320().solver
    intr = Intrinsics.from_config(CAM)
    pyr = build_pyramid(torch.from_numpy(grays), torch.from_numpy(depths), 3)
    edges = tuple(n.edges for n in ted.prepare_now_targets(pyr.gray, cfg))
    a = ted.extract_ref_features(pyr.gray, pyr.depth, intr, cfg, MAX_POINTS)
    b = ted.extract_ref_features(pyr.gray, pyr.depth, intr, cfg, MAX_POINTS, edges_pyr=edges)
    for la, lb in zip(a, b):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)
