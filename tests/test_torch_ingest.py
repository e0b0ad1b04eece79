"""The port's VGA ingest (`core/pyramid.rgb_to_gray`, `pyramid_from_vga`,
`core/camera.undistort_map`, `remap_bilinear`, `io/stream.preprocess_vga`)
against the JAX package's on the CPU, bit for bit: the same seeded numpy
inputs through both, every output compared with `np.array_equal` (tolerance
0). The luma is held on 8-bit inputs, on the pixels whose sum lies on a .5
boundary (where only the exact XLA:CPU evaluation order rounds the same
way), and on non-integral inputs. The one tolerance, 1e-4 px, is the distance of
the distortion-free grid from the pixel centres."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig as JaxCameraConfig  # noqa: E402
from rgbd_odometry_tpu.core import camera as jax_camera  # noqa: E402
from rgbd_odometry_tpu.core import pyramid as jax_pyramid  # noqa: E402
from rgbd_odometry_tpu.io.stream import preprocess_vga as jax_preprocess_vga  # noqa: E402
from rgbd_odometry_tpu_torch.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu_torch.core import camera, pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.stream import preprocess_vga  # noqa: E402

VGA = dict(width=640, height=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5)
DISTORTIONS = {
    "none": (0.0, 0.0, 0.0, 0.0, 0.0),
    "fr1": (0.2624, -0.9531, -0.0054, 0.0026, 1.1633),  # TUM freiburg1's RGB calibration
    "barrel": (-0.28, 0.07, 0.001, -0.0015, 0.0),
}


def _rgb(seed: int, integral: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if integral:
        return rng.integers(0, 256, (480, 640, 3)).astype(np.float32)
    return rng.uniform(0.0, 255.0, (480, 640, 3)).astype(np.float32)


def _depth_m(seed: int, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    d = rng.uniform(0.4, 4.0, (480, 640))
    d[rng.random((480, 640)) < 0.1] = 0.0  # invalid pixels
    return d.astype(dtype)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("integral", [True, False])
def test_rgb_to_gray_bitwise(integral):
    rgb = _rgb(0, integral)
    want = np.asarray(jax_pyramid.rgb_to_gray(jnp.asarray(rgb)))
    got = pyramid.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    assert _same(got, want)
    # the sums on a .5 boundary: round half to even after the same chain
    w = np.asarray(jnp.asarray([0.299, 0.587, 0.114], jnp.float32))
    raw = np.asarray(jnp.einsum("...c,c->...", jnp.asarray(rgb), jnp.asarray(w)))
    half = np.abs(raw - np.floor(raw) - 0.5) == 0
    if integral:
        assert half.sum() > 100  # such pixels occur in the test image
    assert _same(got[half], want[half])


@pytest.mark.parametrize("levels", [4, 5])
def test_pyramid_from_vga_bitwise(levels):
    rgb, depth_mm = _rgb(1), _depth_m(1) * 1000.0
    want = jax_pyramid.pyramid_from_vga(jnp.asarray(rgb), jnp.asarray(depth_mm), levels)
    got = pyramid.pyramid_from_vga(torch.from_numpy(rgb), torch.from_numpy(depth_mm), levels)
    assert len(got.gray) == len(want.gray) == levels
    assert got.gray[0].shape == (240, 320)
    for a, b in zip(got.gray + got.depth, want.gray + want.depth):
        assert _same(a.numpy(), b)
    # an already-gray frame passes through unconverted
    gray = np.array(jax_pyramid.rgb_to_gray(jnp.asarray(rgb)))
    want = jax_pyramid.pyramid_from_vga(jnp.asarray(gray), jnp.asarray(depth_mm), levels)
    got = pyramid.pyramid_from_vga(torch.from_numpy(gray), torch.from_numpy(depth_mm), levels)
    assert all(_same(a.numpy(), b) for a, b in zip(got.gray, want.gray))


@pytest.mark.parametrize("dist", sorted(DISTORTIONS))
def test_undistort_map_and_remap_bitwise(dist):
    cfg, jcfg = (C(**VGA, distortion=DISTORTIONS[dist]) for C in (CameraConfig, JaxCameraConfig))
    want = np.asarray(jax_camera.undistort_map(jcfg))
    got = camera.undistort_map(cfg, device="cpu").numpy()
    assert got.shape == (480, 640, 2) and _same(got, want)
    if dist == "none":
        gy, gx = np.meshgrid(np.arange(480.0), np.arange(640.0), indexing="ij")
        # the identity grid, up to the float32 round trip through (x - cx) / fx
        np.testing.assert_allclose(got, np.stack([gx, gy], -1), rtol=0, atol=1e-4)
    img = _rgb(2, integral=False)[..., 0]
    a = camera.remap_bilinear(torch.from_numpy(img), torch.from_numpy(got)).numpy()
    b = np.asarray(jax_camera.remap_bilinear(jnp.asarray(img), jnp.asarray(want)))
    assert _same(a, b)
    # a batch of images through one grid, and a grid past the borders (clamped)
    imgs = np.stack([img, img[::-1].copy()])
    wide = (want - np.array([320.0, 240.0], np.float32)) * 1.5 + np.array([320.0, 240.0],
                                                                         np.float32)
    a = camera.remap_bilinear(torch.from_numpy(imgs), torch.from_numpy(wide)).numpy()
    b = np.asarray(jax_camera.remap_bilinear(jnp.asarray(imgs), jnp.asarray(wide)))
    assert _same(a, b)


@pytest.mark.parametrize("dist", sorted(DISTORTIONS))
@pytest.mark.parametrize("depth_dtype", [np.float32, np.float64])
def test_preprocess_vga_bitwise(dist, depth_dtype):
    rgb, depth_m = _rgb(3), _depth_m(3, depth_dtype)
    cfg, jcfg = (C(**VGA, distortion=DISTORTIONS[dist]) for C in (CameraConfig, JaxCameraConfig))
    want = jax_preprocess_vga(rgb, depth_m, jcfg)
    got = preprocess_vga(rgb, depth_m, cfg, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.shape == (240, 320)
        assert _same(a.numpy(), b)
    if dist == "none":
        assert float(got[1].min()) == 1.0  # zero depth sanitized to 1 mm
    # a gray frame is taken as it is
    gray = np.array(jax_pyramid.rgb_to_gray(jnp.asarray(rgb)))
    want = jax_preprocess_vga(gray, depth_m, jcfg)
    got = preprocess_vga(gray, depth_m, cfg, device="cpu")
    assert all(_same(a.numpy(), b) for a, b in zip(got, want))
