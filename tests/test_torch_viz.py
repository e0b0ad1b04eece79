"""The port's visualization (`rgbd_odometry_tpu_torch.viz`) on the CPU against
the JAX package's: `colormap` and `overlay` and `residual_histogram` bitwise
on seeded inputs, `warp_image` within a stated tolerance, the PNG codec
against cv2, `LiveViz`'s file set decoded by cv2 to the JAX sink's pixels on
the same odometry state, and `dvo --viz-dir`."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig as JaxCameraConfig  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JaxIntrinsics  # noqa: E402
from rgbd_odometry_tpu.pipeline import odometry as jax_odometry  # noqa: E402
from rgbd_odometry_tpu.solvers import photometric as jax_photometric  # noqa: E402
from rgbd_odometry_tpu.viz import colormap as jax_colormap  # noqa: E402
from rgbd_odometry_tpu.viz import live as jax_live  # noqa: E402
from rgbd_odometry_tpu.viz import overlay as jax_overlay  # noqa: E402
from rgbd_odometry_tpu_torch.cli import main  # noqa: E402
from rgbd_odometry_tpu_torch.config import (  # noqa: E402
    CameraConfig, KeyframeConfig, PipelineConfig, PyramidConfig, SolverConfig,
)
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.geometry import se3_exp  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair, render_sequence  # noqa: E402
from rgbd_odometry_tpu_torch.pipeline import odometry  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import photometric  # noqa: E402
from rgbd_odometry_tpu_torch.viz import colormap, live, overlay  # noqa: E402
from rgbd_odometry_tpu_torch.viz.png import encode_png, read_png, write_png  # noqa: E402

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    gray = rng.uniform(0, 255, (30, 40)).astype(np.float32)
    uv = np.stack([rng.uniform(-5, 45, 200), rng.uniform(-5, 35, 200)], -1)
    return rng, gray, uv, rng.random(200) < 0.7, rng.gamma(2.0, 3.0, 200).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_colormap_is_bitwise_jax(seed):
    rng, gray, *_ = _inputs(seed)
    for n in (2, 64, 255):
        assert np.array_equal(colormap.jet(n), jax_colormap.jet(n))
    for lims in ((None, None), (10.0, 200.0), (100.0, 101.0)):
        assert np.array_equal(colormap.apply_colormap(gray, *lims),
                              jax_colormap.apply_colormap(gray, *lims))
    depth = rng.uniform(0, 7000, (12, 17))
    assert np.array_equal(colormap.depth_false_color(depth), jax_colormap.depth_false_color(depth))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlay_functions_are_bitwise_jax(seed):
    rng, gray, uv, valid, res = _inputs(seed)
    pairs = [
        (overlay.to_rgb(gray), jax_overlay.to_rgb(gray)),
        (overlay.overlay_mask(gray, gray > 128), jax_overlay.overlay_mask(gray, gray > 128)),
        (overlay.overlay_points(gray, uv, valid), jax_overlay.overlay_points(gray, uv, valid)),
        (overlay.residue_heatmap(gray, uv, res, valid),
         jax_overlay.residue_heatmap(gray, uv, res, valid)),
        (overlay.residue_heatmap(gray, uv, res, np.zeros(200, bool)),
         jax_overlay.residue_heatmap(gray, uv, res, np.zeros(200, bool))),
        (overlay.reprojected_depth_map(gray, uv, res / 4, valid),
         jax_overlay.reprojected_depth_map(gray, uv, res / 4, valid)),
    ]
    curve = np.concatenate([rng.uniform(50, 100, 9), np.zeros(3)])
    pairs += [(overlay.energy_plot(curve, best_iter=4), jax_overlay.energy_plot(curve, best_iter=4)),
              (overlay.energy_plot(np.zeros(4)), jax_overlay.energy_plot(np.zeros(4)))]
    t = np.cumsum(rng.normal(0, 0.01, (15, 3)), 0)
    kw = dict(keyframes=[0, 5, 10], reasons=[1, 5, 6])
    pairs += [(overlay.trajectory_plot(t, t + 0.002, **kw),
               jax_overlay.trajectory_plot(t, t + 0.002, **kw)),
              (overlay.trajectory_plot(t), jax_overlay.trajectory_plot(t))]
    hist = odometry.residual_histogram(res, valid)
    pairs += [(hist, jax_odometry.residual_histogram(res, valid)),
              (overlay.residual_histogram_plot(hist, 2.5),
               jax_overlay.residual_histogram_plot(hist, 2.5))]
    for a, b in pairs:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_residual_histogram_is_bitwise_jax():
    rng = np.random.default_rng(7)
    eps = np.concatenate([rng.gamma(2.0, 4.0, 500), [0.0, 258.7, 300.0, 1e4]]).astype(np.float32)
    for valid in (rng.random(eps.size) < 0.6, np.zeros(eps.size, bool), np.ones(eps.size, bool)):
        for bins in (260, 32):
            a = odometry.residual_histogram(eps, valid, bins)
            b = jax_odometry.residual_histogram(eps, valid, bins)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_warp_image_matches_jax():
    """The dense warp of a rendered 160x120 frame under a small pose: within
    5e-3 of JAX's on 0-255 intensities. JAX projects with its own float32
    reduction order and samples with a one-hot matmul; the port samples
    the same four taps with the same weights in another summation order, so
    values differ by float32 roundings of 0-255 sums (1.4e-3 at most, on
    2% of the pixels, measured)."""
    psi = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
    (rg, rd), _, _ = render_pair(CAM, psi, seed=0)
    R, t = se3_exp(torch.from_numpy(psi))
    got = photometric.warp_image(torch.from_numpy(rg), torch.from_numpy(rd),
                                 Intrinsics.from_config(CAM), R, t).numpy()
    jcam = JaxCameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    want = np.asarray(jax_photometric.warp_image(jnp.asarray(rg), jnp.asarray(rd),
                                                 JaxIntrinsics.from_config(jcam),
                                                 jnp.asarray(R.numpy()), jnp.asarray(t.numpy())))
    assert got.shape == want.shape == (120, 160)
    assert np.abs(got - want).max() < 5e-3
    assert ((got == 0) == (want == 0)).mean() > 0.999


@pytest.mark.parametrize("shape", [(37, 45), (20, 31, 3), (1, 1)])
def test_png_codec_against_cv2(tmp_path, shape):
    """The port's PNG files decode in cv2 to the image written; cv2's files
    (which use every row filter) decode in the port's reader."""
    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    smooth = np.add.outer(np.arange(shape[0]), np.arange(shape[1])).astype(np.uint8)
    if len(shape) == 3:
        smooth = np.stack([smooth, smooth // 2, 255 - smooth], -1)
    bgr = (lambda a: a[..., ::-1] if a.ndim == 3 else a)  # noqa: E731
    for k, a in enumerate((img, smooth)):
        mine, theirs = str(tmp_path / f"m{k}.png"), str(tmp_path / f"c{k}.png")
        write_png(mine, a)
        assert open(mine, "rb").read() == encode_png(a)
        assert np.array_equal(bgr(cv2.imread(mine, cv2.IMREAD_UNCHANGED)), a)
        cv2.imwrite(theirs, bgr(a))
        assert np.array_equal(read_png(theirs), a)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.float32))


class _JaxView:
    """The port's odometry state in the shapes the JAX sink reads (unbatched
    numpy), so that both sinks draw the same numbers."""

    def __init__(self, odo):
        self.odo = odo

    def __getattr__(self, name):
        odo = self.odo
        if name == "_ref_feats":
            return tuple(SimpleNamespace(pts3d=f.pts3d[0].numpy(), valid=f.valid[0].numpy())
                         for f in odo._ref_feats)
        if name == "_prev_pyr":
            return SimpleNamespace(gray=tuple(g[0].numpy() for g in odo._prev_pyr.gray),
                                   depth=tuple(d[0].numpy() for d in odo._prev_pyr.depth))
        return getattr(odo, name)


def test_live_viz_writes_jax_files_with_jax_pixels(tmp_path):
    """`LiveViz` on a 7-frame run writes the JAX sink's file set, and cv2
    decodes every file to the JAX sink's pixels on the same state; the
    reprojection composite (through `warp_image`) differs by at most one
    intensity level, on at most 1% of its pixels."""
    frames, poses = render_sequence(CAM, np.linspace(0, 0.02, 7)[:, None] * np.array(
        [1.0, -0.5, 0.3, 0.2, -0.2, 0.1], np.float32), seed=0)
    cfg = PipelineConfig(camera=CAM, pyramid=PyramidConfig(num_levels=3,
                                                           max_points=(2048, 1024, 512)),
                         solver=SolverConfig(method="gauss_newton", iterations=(8, 4, 3)),
                         keyframe=KeyframeConfig(force_every=4))
    odo = odometry.EdgeDvoOdometry(cfg, device="cpu")
    odo.keep_residuals = True
    mine, theirs = live.LiveViz(str(tmp_path / "port"), every=2), jax_live.LiveViz(
        str(tmp_path / "jax"), every=2)
    view = _JaxView(odo)
    for i, (g, d) in enumerate(frames):
        odo.process_frame(g, d, timestamp=i / 30.0)
        mine.on_frame(odo, g, d)
        theirs.on_frame(view, g, d)
    gt_t = np.stack([p[1] for p in poses])
    a = sorted(os.path.basename(p) for p in mine.finalize(odo, gt_t))
    b = sorted(os.path.basename(p) for p in theirs.finalize(view, gt_t))
    assert a == b and "reprojection_debug.png" in a and "histogram_0006.png" in a
    assert {n.split("_")[0] for n in a} == {"overlay", "energy", "residue", "histogram",
                                            "trajectory.png", "reprojection"}
    for name in a:
        x = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
        y = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        assert x.shape == y.shape, name
        if name == "reprojection_debug.png":
            diff = np.abs(x.astype(int) - y.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        else:
            assert np.array_equal(x, y), name


def test_cli_viz_dir_keeps_the_trajectory(tmp_path, capsys):
    """`dvo --viz-dir` writes the file set and the same trajectory as the run
    without it."""
    argv = ["dvo", "--device", "cpu", "--cam-scale", "0.5", "--frames", "6", "--iterations",
            "6,3,2,2"]
    main([*argv, "--out", str(tmp_path / "a.txt")])
    summary = main([*argv, "--viz-dir", str(tmp_path / "viz"), "--viz-every", "2",
                    "--out", str(tmp_path / "b.txt")])
    assert "viz: 10 images -> " in capsys.readouterr().err
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    names = sorted(os.listdir(tmp_path / "viz"))
    assert names == sorted(os.path.basename(p) for p in summary["viz"])
    assert read_png(str(tmp_path / "viz" / "trajectory.png")).shape == (400, 400, 3)
    assert read_png(str(tmp_path / "viz" / "overlay_0004.png")).shape == (120, 160, 3)
    assert read_png(str(tmp_path / "viz" / "reprojection_debug.png")).shape == (120, 324)
