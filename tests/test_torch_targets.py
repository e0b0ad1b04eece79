"""Now-frame targets of the PyTorch port against the JAX package, on the CPU:
Sobel, central gradients and Canny bit-exact; the plain EDT (kernel 1's
reference) bitwise equal to the XLA and Pallas (interpret mode) versions;
`prepare_now_level` dt exact and its bf16 channels bitwise equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu.ops import canny as jcanny  # noqa: E402
from rgbd_odometry_tpu.ops import distance_transform as jdt  # noqa: E402
from rgbd_odometry_tpu.ops import gradient as jgrad  # noqa: E402
from rgbd_odometry_tpu.pallas.edt import edt_l2_squared_pallas  # noqa: E402
from rgbd_odometry_tpu.profiles import production_320  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels.edt import edt_squared, edt_squared_plain  # noqa: E402
from rgbd_odometry_tpu_torch.ops import canny as tcanny  # noqa: E402
from rgbd_odometry_tpu_torch.ops import gradient as tgrad  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(1)

CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)


def _blocks(rng, h=120, w=160):
    """Piecewise-constant blocks with a soft edge (as tests/test_edges_golden)."""
    img = np.full((h, w), 40.0, np.float32)
    img[20:70, 30:90] = 160
    img[50:100, 80:140] = 90
    yy, xx = np.mgrid[0:h, 0:w]
    img[(yy - 40) ** 2 + (xx - 120) ** 2 < 22**2] = 210
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16
    for ax in (0, 1):
        img = np.apply_along_axis(lambda r: np.convolve(np.pad(r, 2, mode="edge"), k, "valid"), ax, img)
    return np.round(img).astype(np.float32)


def _adversarial(seed):
    """Raw white noise (odd seeds) or noisy step edges (even seeds), as in
    tests/test_edges_golden.test_canny_exact_on_adversarial_imagery."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        return rng.integers(0, 256, (96, 128)).astype(np.float32)
    img = np.full((96, 128), 40, np.uint8)
    img[20:60, 30:80] = 170
    return (img + rng.normal(0, 8, (96, 128))).clip(0, 255).astype(np.uint8).astype(np.float32)


@pytest.fixture(scope="module")
def frame():
    psi = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
    (_, _), (ng, _), _ = render_pair(CAM, psi, seed=0)
    return ng


@pytest.mark.parametrize("kind", ["blocks", "noise"])
def test_sobel_and_central_gradient_bit_exact(kind):
    rng = np.random.default_rng(1)
    img = _blocks(rng) if kind == "blocks" else rng.uniform(0, 255, (64, 80)).astype(np.float32)
    gx_j, gy_j = jgrad.sobel3(jnp.asarray(img), border="replicate")
    gx_t, gy_t = tgrad.sobel3(torch.from_numpy(img)[None])
    np.testing.assert_array_equal(gx_t[0].numpy(), np.asarray(gx_j))
    np.testing.assert_array_equal(gy_t[0].numpy(), np.asarray(gy_j))
    cx_j, cy_j = jgrad.central_gradient(jnp.asarray(img))
    cx_t, cy_t = tgrad.central_gradient(torch.from_numpy(img)[None])
    np.testing.assert_array_equal(cx_t[0].numpy(), np.asarray(cx_j))
    np.testing.assert_array_equal(cy_t[0].numpy(), np.asarray(cy_j))


def test_canny_bit_exact_on_scenes(frame):
    rng = np.random.default_rng(3)
    smooth = np.cumsum(np.cumsum(rng.uniform(-1, 1, (96, 128)), 0), 1)
    smooth = np.round(255 * (smooth - smooth.min()) / np.ptp(smooth)).astype(np.float32)
    for img in (_blocks(rng), frame, smooth):
        want = np.asarray(jcanny.canny(jnp.asarray(img), 100.0, 150.0))
        got = tcanny.canny(torch.from_numpy(img)[None])[0].numpy()
        assert want.sum() > 0
        np.testing.assert_array_equal(got, want)


def test_canny_bit_exact_on_adversarial_imagery_batched():
    """The NMS tie/sector-boundary imagery of the JAX golden test, all eight
    images in one batched call of the port."""
    imgs = np.stack([_adversarial(s) for s in range(8)])
    f = jax.jit(lambda g: jcanny.canny(g, 100.0, 150.0))
    got = tcanny.canny(torch.from_numpy(imgs)).numpy()
    for s in range(8):
        np.testing.assert_array_equal(got[s], np.asarray(f(jnp.asarray(imgs[s]))), err_msg=f"seed {s}")


def _masks():
    rng = np.random.default_rng(7)
    m = rng.uniform(size=(4, 48, 128)) < np.array([0.002, 0.01, 0.05, 0.2])[:, None, None]
    m[:, :, :3] = False  # edge-free border columns: the window's pad candidates win there
    m[:, :, -5:] = False
    m[1, :, 60:70] = False
    m[2] = False  # no edge at all
    m[2, 0, 64] = True  # ... but one
    m[3, 10] = True  # a full edge row
    return m


@pytest.mark.parametrize("radius", [0, 4, 16])
def test_plain_edt_bitwise_equals_jax(radius):
    m = _masks()
    got = edt_squared(torch.from_numpy(m), radius).numpy()  # CPU -> plain version
    np.testing.assert_array_equal(got, edt_squared_plain(torch.from_numpy(m), radius).numpy())
    for i in range(m.shape[0]):
        mi = jnp.asarray(m[i])
        want = jdt.edt_l2_squared_windowed(mi, radius) if radius else jdt.edt_l2_squared(mi)
        np.testing.assert_array_equal(got[i], np.asarray(want), err_msg=f"mask {i}")


def test_plain_edt_bitwise_equals_pallas_interpret():
    m = _masks()
    want = np.asarray(edt_l2_squared_pallas(jnp.asarray(m), interpret=True))
    np.testing.assert_array_equal(edt_squared(torch.from_numpy(m), 0).numpy(), want)


def test_plain_edt_empty_mask():
    empty = torch.zeros((2, 16, 24), dtype=torch.bool)
    d2 = edt_squared(empty, 0)
    assert torch.isfinite(d2).all() and (d2 > 1e6).all()
    np.testing.assert_array_equal(
        d2.numpy(), np.broadcast_to(np.asarray(jdt.edt_l2_squared(jnp.zeros((16, 24), bool))), (2, 16, 24))
    )
    np.testing.assert_array_equal(
        edt_squared(empty, 16).numpy(),
        np.broadcast_to(np.asarray(jdt.edt_l2_squared_windowed(jnp.zeros((16, 24), bool), 16)), (2, 16, 24)),
    )


@pytest.mark.parametrize("window", [16, 0])
def test_prepare_now_level_exact(frame, window):
    cfg = dataclasses.replace(production_320().solver, edt_window=window)
    prep = jax.jit(lambda g: jed.prepare_now_level(g, cfg))
    for level in range(3):
        g = frame[:: 2**level, :: 2**level]
        want = prep(jnp.asarray(g))
        got = ted.prepare_now_level(torch.from_numpy(np.ascontiguousarray(g))[None], cfg)
        np.testing.assert_array_equal(got.edges[0].numpy(), np.asarray(want.edges))
        np.testing.assert_array_equal(got.dt[0].numpy(), np.asarray(want.dt))
        assert got.chans.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.chans[0].view(torch.int16).numpy(), np.asarray(want.chans).view(np.int16)
        )
