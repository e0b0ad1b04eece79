"""Kernel C's entry points on the CPU (`ops/features.detect_and_describe`
and `detect_describe_backproject`: the plain version on CPU tensors) against
the JAX package at 160x120, and numpy models of what the CUDA kernel does
differently from the plain version, held bitwise to it:

- the response tile by tile (32x16 tiles with a one-pixel ring, the image
  and the gradient products read at clamped pixels) against
  `harris_response`;
- the selection: candidate keys (order-preserving score bits, then ~index),
  the radix select of the K-th largest peak key, the sort, and the slots
  past the last peak from a flag a pixel below K and a scan, against the
  stable sort of the plain version, on tied and untied maps, with more and
  fewer peaks than K;
- the fused back-projection against the three callers' former formulas
  (the matcher's `_detect_backproject`, `FeatureVo`'s and `FusedOdometry`'s
  `backproject_points`) and JAX's `_detect_backproject`;
- the wrapper refuses every device but CUDA.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JaxIntrinsics  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu.ops import features as jf  # noqa: E402
from rgbd_odometry_tpu.pipeline.kf_matcher import KeyframeMatcher as JaxMatcher  # noqa: E402
from rgbd_odometry_tpu.pipeline.kf_matcher import MatcherConfig as JaxMatcherConfig  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics, backproject_points  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import features as kfeat  # noqa: E402
from rgbd_odometry_tpu_torch.ops import features as pf  # noqa: E402

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=176.0, fy=176.0, cx=79.5, cy=59.5)


@pytest.fixture(scope="module")
def frames():
    """Rendered 160x120 (gray, depth) frames, one with sensor noise."""
    ts = np.arange(4)
    amp = 0.04
    psis = np.stack([amp * ts / 3, -0.5 * amp * ts / 3, 0.3 * amp * ts / 3,
                     0.2 * amp * ts / 3, -0.2 * amp * ts / 3, 0.1 * amp * ts / 3],
                    -1).astype(np.float32)
    out, _ = render_sequence(CAM, psis, seed=0)
    rng = np.random.default_rng(1)
    g, d = out[0]
    out.append((g + rng.normal(0, 2.0, g.shape).astype(np.float32), d))
    return out


def _image(frames, name: str) -> np.ndarray:
    if name == "flat":
        return np.full((120, 160), 87.0, np.float32)
    if name == "checker":  # many equal responses: the tie order decides
        y, x = np.mgrid[:120, :160]
        return np.where(((y // 6) + (x // 6)) % 2 == 0, 200.0, 40.0).astype(np.float32)
    if name == "ragged":  # 37x45: tiles cut on both axes
        return np.ascontiguousarray(frames[4][0][20:57, 30:75])
    return frames[int(name)][0]


def _same(got, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,k_max", [("0", 16), ("1", 384), ("4", 512), ("2", 1024),
                                        ("flat", 384), ("checker", 512), ("ragged", 384)])
def test_detect_and_describe_on_the_cpu_is_jax(frames, name, k_max):
    """The entry point on CPU tensors: every output bitwise JAX's, the slots
    past the last corner included (-inf, in pixel order)."""
    g = _image(frames, name)
    kj = jf.detect_and_describe(jnp.asarray(g), k_max)
    kp = pf.detect_and_describe(torch.from_numpy(g), k_max)
    for got, want in zip(kp, kj):
        _same(got, want)
    if name == "flat":
        assert int(kp.count) == 0 and torch.isinf(kp.score).all()
        _same(kp.uv[:, 0] + 160 * kp.uv[:, 1], np.arange(k_max, dtype=np.float32))
    if name == "checker":
        assert int(kp.count) > 50


def _harris_tiles(g: np.ndarray) -> np.ndarray:
    """The kernel's response, tile by tile: each 32x16 tile reads the image
    with a 3-pixel halo and computes the gradient products with a 2-pixel
    halo, every value at its clamped pixel (numpy float32, each operation
    rounded once as the kernel's intrinsics round it)."""
    h, w = g.shape
    out = np.zeros((h, w), np.float32)
    f2, k = np.float32(2.0), np.float32(0.04)
    clamp = lambda v, n: min(max(v, 0), n - 1)  # noqa: E731
    for y0 in range(0, h, 16):
        for x0 in range(0, w, 32):
            prod = {}
            for r in range(max(y0 - 2, 0), min(y0 + 18, h)):
                for c in range(max(x0 - 2, 0), min(x0 + 34, w)):
                    rm, rp, cm, cp = clamp(r - 1, h), clamp(r + 1, h), clamp(c - 1, w), clamp(c + 1, w)
                    syp = (g[rm, cp] + f2 * g[r, cp]) + g[rp, cp]
                    sym = (g[rm, cm] + f2 * g[r, cm]) + g[rp, cm]
                    sxp = (g[rp, cm] + f2 * g[rp, c]) + g[rp, cp]
                    sxm = (g[rm, cm] + f2 * g[rm, c]) + g[rm, cp]
                    gx, gy = syp - sym, sxp - sxm
                    prod[r, c] = (gx * gx, gy * gy, gx * gy)
            for y in range(y0, min(y0 + 16, h)):
                for x in range(x0, min(x0 + 32, w)):
                    cells = [(clamp(y + dy, h), clamp(x + dx, w)) for dy in (-1, 0, 1)
                             for dx in (-1, 0, 1)]
                    s = [prod[cells[0]][m] for m in range(3)]
                    for cell in cells[1:]:
                        s = [s[m] + prod[cell][m] for m in range(3)]
                    det = s[0] * s[1] - s[2] * s[2]
                    tr = s[0] + s[1]
                    out[y, x] = det - (k * tr) * tr
    return out


@pytest.mark.parametrize("name", ["4", "ragged", "checker"])
def test_tiled_response_is_the_plain_response(frames, name):
    g = _image(frames, name)
    with np.errstate(over="ignore"):
        got = _harris_tiles(g)
    want = pf.harris_response(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _ordered(f: np.ndarray) -> np.ndarray:
    u = f.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _kernel_selection(score_map: np.ndarray, k: int, rng) -> tuple:
    """Steps 2-3 of `csrc/features.cu` on a (H, W) map of peak scores
    (-inf where no peak): the candidates as 64-bit keys in a shuffled
    (atomic) order, the radix select of the K-th largest with 8-bit digits
    when there are more peaks than K, the chosen keys sorted, the slots past
    the last peak from the flags below K and their scan. (indices (K,),
    scores (K,))."""
    flat = score_map.reshape(-1)
    idx = np.nonzero(np.isfinite(flat))[0]
    keys = (_ordered(flat[idx]) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - idx.astype(np.uint64))
    keys = keys[rng.permutation(len(keys))]
    count = len(keys)
    T = np.uint64(0)
    if count > k:
        prefix, mask, need = np.uint64(0), np.uint64(0), k
        for shift in range(56, -8, -8):
            sh = np.uint64(shift)
            match = keys[(keys & mask) == prefix]
            hist = np.bincount(((match >> sh) & np.uint64(255)).astype(np.int64), minlength=256)
            above = 0
            for d in range(255, -1, -1):
                if above + hist[d] >= need:
                    break
                above += hist[d]
            prefix |= np.uint64(d) << sh
            mask |= np.uint64(255) << sh
            need -= above
        T = prefix
    chosen = np.sort(keys[keys >= T])[::-1]
    assert len(chosen) == min(count, k)
    out_idx = list((np.uint64(0xFFFFFFFF) - (chosen & np.uint64(0xFFFFFFFF))).astype(np.int64))
    out_sc = list((chosen >> np.uint64(32)).astype(np.uint32) & 0x7FFFFFFF)
    out_sc = list(np.array(out_sc, np.uint32).view(np.float32))
    if len(chosen) < k:
        flag = np.zeros(k, bool)
        flag[[i for i in out_idx if i < k]] = True
        free = np.nonzero(~flag)[0][: k - len(chosen)]
        out_idx += list(free)
        out_sc += [-np.inf] * len(free)
    return np.array(out_idx), np.array(out_sc, np.float32)


@pytest.mark.parametrize("name,k_max", [("1", 16), ("1", 384), ("4", 1024), ("checker", 64),
                                        ("checker", 2000), ("flat", 100)])
def test_kernel_selection_is_the_stable_sort(frames, name, k_max):
    """The kernel's selection gives the plain version's slots (the stable
    descending sort of the peak score map), with more and fewer peaks than K
    and on the checkerboard's ties."""
    g = torch.from_numpy(_image(frames, name))
    kp = pf.detect_and_describe(g, k_max)
    resp = pf.harris_response(g)
    h, w = g.shape
    ys, xs = torch.arange(h)[:, None], torch.arange(w)[None, :]
    inside = (ys >= 8) & (ys < h - 8) & (xs >= 8) & (xs < w - 8)
    peak = pf._nms3(resp) & inside & (resp > 1e-4 * resp.amax())
    score_map = torch.where(peak, resp, torch.full_like(resp, float("-inf"))).numpy()
    idx, sc = _kernel_selection(score_map, k_max, np.random.default_rng(k_max))
    np.testing.assert_array_equal(idx % w, kp.uv[:, 0].numpy())
    np.testing.assert_array_equal(idx // w, kp.uv[:, 1].numpy())
    np.testing.assert_array_equal(sc.view(np.int32), kp.score.numpy().view(np.int32))
    # every peak is above 0, as the kernel's candidate test assumes
    assert bool((resp[peak] > 0).all())


def _old_matcher_backproject(kps, depth_mm, intr, min_depth):
    """The matcher's `_detect_backproject` before the fused entry."""
    h, w = depth_mm.shape
    ui = torch.clamp(kps.uv[:, 0].long(), 0, w - 1)
    vi = torch.clamp(kps.uv[:, 1].long(), 0, h - 1)
    z_mm = depth_mm.reshape(-1)[vi * w + ui]
    valid = kps.valid & (z_mm > min_depth)
    z = z_mm / 1000.0
    x = z * (kps.uv[:, 0] - intr.cx) / intr.fx
    y = z * (kps.uv[:, 1] - intr.cy) / intr.fy
    return torch.stack([x, y, z], -1), valid, z_mm


@pytest.mark.parametrize("idx,k_max", [(0, 384), (3, 512), (4, 384)])
def test_fused_backprojection_is_the_former_formulas_and_jax(frames, idx, k_max):
    g, d = frames[idx]
    intr = Intrinsics.from_config(CAM)
    gt, dt = torch.from_numpy(g), torch.from_numpy(d)
    kps, pts, pv = pf.detect_describe_backproject(gt, dt, intr, k_max, 100.0)
    want_kps = pf.detect_and_describe(gt, k_max)
    for a, b in zip(kps, want_kps):
        assert torch.equal(a, b)
    old_pts, old_valid, z_mm = _old_matcher_backproject(want_kps, dt, intr, 100.0)
    assert torch.equal(pts, old_pts) and torch.equal(pv, old_valid)
    # FeatureVo's and FusedOdometry's former back-projection
    assert torch.equal(pts, backproject_points(want_kps.uv, z_mm, intr))
    assert 0 < int(pv.sum()) <= int(kps.count)
    jm = JaxMatcher(JaxIntrinsics.from_config(CAM), JaxMatcherConfig(max_keypoints=k_max))
    jk, jpts, jpv = jm._detect_backproject(jnp.asarray(g), jnp.asarray(d))
    _same(pts, jpts)
    _same(pv, jpv)


def test_cuda_wrapper_refuses_other_devices(frames):
    g = torch.from_numpy(frames[0][0])
    with pytest.raises(ValueError, match="unsupported device"):
        kfeat.detect_describe(g, 384)
    with pytest.raises(ValueError, match="unsupported device"):
        pf.detect_and_describe(g.to("meta"), 384)
    with pytest.raises(ValueError, match="unsupported device"):
        pf.detect_describe_backproject(g.to("meta"), g.to("meta"), Intrinsics.from_config(CAM))
