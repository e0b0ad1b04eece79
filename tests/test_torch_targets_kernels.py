"""The now-frame target kernels of the PyTorch port (`kernels/canny.canny`,
`kernels/edt.dt_channels`) against the JAX package, on the CPU, where their
wrappers run the plain versions:

* `dt_channels` bitwise against JAX's `prepare_now_level` (dt, gradients,
  scale, channels) for the +-16 window and the whole row, with and without
  the 0-255 normalization, bf16 and float32 channels, on a batch that mixes
  an edge-free, an all-edge and a rendered image;
* `canny` bitwise against JAX's `canny` on rendered frames and on
  adversarial imagery (a serpentine weak chain, weak without strong, empty);
* two numpy models of what the CUDA kernels rely on, each held to the JAX
  function: the hysteresis updated in place on bit-packed words in a
  shuffled order, and the segmented column sweep with a 16-bit g;
* the CUDA wrappers' argument checks, which run before anything is built.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig, SolverConfig  # noqa: E402
from rgbd_odometry_tpu.ops import canny as jcanny  # noqa: E402
from rgbd_odometry_tpu.ops import distance_transform as jdt  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import build  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import canny as kcanny  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import edt as kedt  # noqa: E402
from rgbd_odometry_tpu_torch.ops import canny as tcanny  # noqa: E402
from rgbd_odometry_tpu_torch.ops.distance_transform import column_g2  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(1)

SHAPES = ((30, 40), (60, 80), (120, 160))


def _frames(h, w, n=3):
    """n rendered grey frames of one scene at (h, w)."""
    cam = CameraConfig(width=w, height=h, fx=0.8125 * w, fy=0.8125 * w,
                       cx=(w - 1) / 2, cy=(h - 1) / 2)
    out = []
    for i in range(n):
        psi = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32) * (i + 1)
        (_, _), (ng, _), _ = render_pair(cam, psi, seed=i)
        out.append(ng)
    return np.stack(out)


def serpentine_image(h, w, seed=True):
    """A band 3 pixels wide, 30 grey levels over the background (a step of
    30 gives a Sobel magnitude of 120: weak, not strong), that winds through
    the whole image; with `seed`, its first 3 pixels stand 70 over (strong).
    The hysteresis must walk the band's outline: far more than H + W steps."""
    img = np.full((h, w), 40.0, np.float32)
    rows = list(range(3, h - 6, 8))
    for k, y in enumerate(rows):
        img[y:y + 3, 3:w - 3] = 70.0
        if k + 1 < len(rows):
            x = w - 6 if k % 2 == 0 else 3
            img[y:y + 11, x:x + 3] = 70.0
    if seed:
        img[rows[0]:rows[0] + 3, 3:6] = 110.0
    return img


def _weak_strong(img):
    """The port's weak and strong maps of a (H, W) image, as numpy bools."""
    t = torch.from_numpy(img)[None]
    mag, gx, gy, low_t, high_t = tcanny._grad_mag(t, 100.0, 150.0)
    weak = tcanny._nms(mag, gx, gy, low_t)
    return weak[0].numpy(), (weak & (mag > high_t))[0].numpy()


def _jacobi_passes(strong, weak):
    """One-pixel dilation passes until the fixpoint (the JAX loop's count)."""
    e, n = strong & weak, 0
    while True:
        p = np.pad(e, 1)
        new = e.copy()
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                new |= p[dy:dy + e.shape[0], dx:dx + e.shape[1]]
        new &= weak
        if (new == e).all():
            return n
        e, n = new, n + 1


# ---------------------------------------------------------------------------
# dt_channels against JAX's prepare_now_level
# ---------------------------------------------------------------------------


def _jax_cfg(window, normalize, bf16):
    """The JAX solver configuration of one `dt_channels` flag set. The
    configuration itself refuses a window with normalization (the scale
    would mislead the pixel-unit weights); the function computes it all the
    same, and the kernel takes the two flags independently, so the pair is
    held to JAX too, with the check bypassed."""
    cfg = SolverConfig(method="gauss_newton" if bf16 else "subgradient",
                       normalize_dt=normalize and window == 0, edt_window=window)
    if normalize and window > 0:
        object.__setattr__(cfg, "normalize_dt", True)
    return cfg


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "pixels"])
@pytest.mark.parametrize("window", [16, 0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dt_channels_bitwise_equals_jax(shape, window, normalize, bf16):
    h, w = shape
    frame = _frames(h, w, 1)[0]
    edges = np.stack([
        np.zeros((h, w), bool),
        np.ones((h, w), bool),
        np.asarray(jcanny.canny(jnp.asarray(frame), 100.0, 150.0)),
    ])
    assert 0 < edges[2].sum() < h * w
    cfg = _jax_cfg(window, normalize, bf16)
    dt, dgx, dgy, scale, chans = kedt.dt_channels(torch.from_numpy(edges), window, normalize, bf16)
    assert chans.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert chans.shape == (3, 3, h, w) and scale.shape == (3,)
    for i in range(3):
        want = jed.prepare_now_level(jnp.zeros((h, w), jnp.float32), cfg, jnp.asarray(edges[i]))
        for name, got in (("dt", dt), ("dgx", dgx), ("dgy", dgy), ("scale", scale)):
            np.testing.assert_array_equal(
                got[i].numpy().view(np.int32), np.asarray(getattr(want, name)).view(np.int32),
                err_msg=f"{name} of image {i}")
        if bf16:
            np.testing.assert_array_equal(chans[i].view(torch.int16).numpy(),
                                          np.asarray(want.chans).view(np.int16))
        else:
            np.testing.assert_array_equal(chans[i].numpy().view(np.int32),
                                          np.asarray(want.chans).view(np.int32))
    if normalize:  # dmax == dmin on the all-edge image, and without a window (whose
        # 4e9 border candidates differ from 65504^2) on the edge-free one
        assert not dt[1].any() and float(scale[1]) == pytest.approx(2.55e14, rel=1e-6)
        assert window > 0 or (not dt[0].any() and float(scale[0]) == float(scale[1]))
        assert float(dt[2].max()) == 255.0
    else:
        assert torch.equal(scale, torch.ones(3))


def test_prepare_now_level_is_one_canny_and_one_dt_channels_call(monkeypatch):
    frames = torch.from_numpy(_frames(60, 80))
    cfg = SolverConfig(method="gauss_newton")
    calls = []
    real_canny, real_dt = ted.canny, ted.dt_channels
    monkeypatch.setattr(ted, "canny", lambda *a: calls.append("canny") or real_canny(*a))
    monkeypatch.setattr(ted, "dt_channels",
                        lambda *a: calls.append("dt_channels") or real_dt(*a))
    now = ted.prepare_now_level(frames, cfg)
    assert calls == ["canny", "dt_channels"]
    edges = kcanny.canny(frames, cfg.canny_low, cfg.canny_high)
    want = kedt.dt_channels(edges, 0, True, True)
    assert torch.equal(now.edges, edges)
    for got, ref in zip((now.dt, now.dgx, now.dgy, now.scale, now.chans), want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


# ---------------------------------------------------------------------------
# canny against JAX's canny
# ---------------------------------------------------------------------------


def _canny_case(kind):
    if kind == "frames":
        return _frames(120, 160)
    h, w = 60, 80
    if kind == "serpentine":
        img = serpentine_image(h, w)
        weak, strong = _weak_strong(img)
        assert strong.any() and _jacobi_passes(strong, weak) > 3 * (h + w)
        return np.stack([img, img[::-1].copy(), img[:, ::-1].copy()])
    if kind == "weak_only":
        img = serpentine_image(h, w, seed=False)
        weak, strong = _weak_strong(img)
        assert weak.any() and not strong.any()
        return np.stack([img, img[::-1].copy(), img])
    return np.stack([np.zeros((h, w), np.float32), np.full((h, w), 255.0, np.float32),
                     np.full((h, w), 128.0, np.float32)])


@pytest.mark.parametrize("kind", ["frames", "serpentine", "weak_only", "empty"])
def test_canny_wrapper_bitwise_equals_jax(kind):
    imgs = _canny_case(kind)
    got = kcanny.canny(torch.from_numpy(imgs), 100.0, 150.0)
    assert got.dtype == torch.bool and got.shape == imgs.shape
    assert torch.equal(got, kcanny.canny_plain(torch.from_numpy(imgs), 150.0, 100.0))
    for i, img in enumerate(imgs):
        want = np.asarray(jcanny.canny(jnp.asarray(img), 100.0, 150.0))
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=f"image {i}")
    if kind in ("frames", "serpentine"):
        assert got.any(dim=(-2, -1)).all()
    elif kind == "weak_only":
        assert not got[0].any() and not got[2].any()
    else:
        assert not got.any()


# ---------------------------------------------------------------------------
# numpy models of the CUDA kernels' algorithms
# ---------------------------------------------------------------------------


def _pack(mask):
    """(H, W) bool -> (H + 2, ceil(W / 32) + 2) uint32 with a zero guard
    ring: bit i of word k of a row is column 32 k + i."""
    h, w = mask.shape
    words = (w + 31) // 32
    bits = np.zeros((h, words * 32), np.uint64)
    bits[:, :w] = mask
    packed = (bits.reshape(h, words, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    out = np.zeros((h + 2, words + 2), np.uint32)
    out[1:-1, 1:-1] = packed.astype(np.uint32)
    return out


def _unpack(packed, w):
    body = packed[1:-1, 1:-1]
    bits = (body[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(body.shape[0], -1)[:, :w].astype(bool)


def _spread(e, r, c):
    v = int(e[r, c])
    return (v | (v << 1) | (v >> 1) | (int(e[r, c - 1]) >> 31) | (int(e[r, c + 1]) << 31)) \
        & 0xFFFFFFFF


def _hysteresis_in_place(strong, weak, rng):
    """The hysteresis kernel's pass, word by word, in place, in a shuffled
    order: OR of the three rows' spread words masked by weak, run along the
    weak runs inside the word; until a pass changes no word."""
    w = weak.shape[1]
    wk, e = _pack(weak), _pack(strong & weak)
    cells = [(r, c) for r in range(1, wk.shape[0] - 1) for c in range(1, wk.shape[1] - 1)]
    passes = 0
    while True:
        changed = False
        for k in rng.permutation(len(cells)):
            r, c = cells[k]
            m, old = int(wk[r, c]), int(e[r, c])
            if old == m:
                continue
            now = (old | _spread(e, r - 1, c) | _spread(e, r, c) | _spread(e, r + 1, c)) & m
            while True:
                nxt = (now | (now << 1) | (now >> 1)) & m
                if nxt == now:
                    break
                now = nxt
            if now != old:
                e[r, c] = now
                changed = True
        passes += 1
        if not changed:
            return _unpack(e, w), passes


@pytest.mark.parametrize("case", ["random0", "random1", "random2", "serpentine"])
def test_in_place_packed_hysteresis_reaches_jax_fixpoint(case):
    rng = np.random.default_rng(11)
    if case == "serpentine":
        weak, strong = _weak_strong(serpentine_image(60, 80))
    else:
        h, w = ((24, 40), (17, 70), (33, 32))[int(case[-1])]
        weak = rng.random((h, w)) < (0.35, 0.5, 0.6)[int(case[-1])]
        strong = weak & (rng.random((h, w)) < 0.02)
    want = np.asarray(jcanny.hysteresis(jnp.asarray(strong), jnp.asarray(weak)))
    jacobi = _jacobi_passes(strong, weak)
    for _ in range(2):  # two different orders
        got, passes = _hysteresis_in_place(strong, weak, rng)
        np.testing.assert_array_equal(got, want)
        assert passes <= jacobi + 1
    assert want.sum() > strong.sum()


def _segmented_columns(mask, segs):
    """The column phase of the EDT kernel: each column in `segs` row
    segments; per segment the first and last edge row, the nearest edge
    above and below from the other segments' summaries, a forward and a
    backward sweep; g clamped to 65504 and stored in 16 bits."""
    h, w = mask.shape
    length = -(-h // segs)
    bounds = [(min(s * length, h), min(min(s * length, h) + length, h)) for s in range(segs)]
    first = np.full((segs, w), -1)
    last = np.full((segs, w), -1)
    for s, (ya, yb) in enumerate(bounds):
        for c in range(w):
            ys = np.nonzero(mask[ya:yb, c])[0]
            if len(ys):
                first[s, c], last[s, c] = ya + ys[0], ya + ys[-1]
    g = np.zeros((h, w), np.uint16)
    for s, (ya, yb) in enumerate(bounds):
        for c in range(w):
            above = next((last[k, c] for k in range(s - 1, -1, -1) if last[k, c] >= 0), -1)
            below = next((first[k, c] for k in range(s + 1, segs) if first[k, c] >= 0), -1)
            up = np.zeros(yb - ya, np.uint16)
            edge = above
            for y in range(ya, yb):
                if mask[y, c]:
                    edge = y
                up[y - ya] = min(y - edge, 65504) if edge >= 0 else 65504
            edge = below
            for y in range(yb - 1, ya - 1, -1):
                if mask[y, c]:
                    edge = y
                d = int(up[y - ya])
                g[y, c] = min(d, edge - y) if edge >= 0 else d
    return g


@pytest.mark.parametrize("h", [32, 37])
@pytest.mark.parametrize("segs", [1, 4, 8])
def test_segmented_column_sweep_gives_the_clamped_column_distance(segs, h):
    rng = np.random.default_rng(5)
    mask = rng.random((h, 12)) < 0.08
    mask[:, 3] = False  # an edge-free column
    mask[:, 4] = False
    mask[h - 1, 4] = True  # one edge, in the last segment
    mask[:, 5] = True
    g = _segmented_columns(mask, segs)
    assert g.dtype == np.uint16 and g[:, 3].min() == 65504
    want = np.minimum(np.asarray(jdt._column_distance(jnp.asarray(mask))), 65504.0)
    np.testing.assert_array_equal(g.astype(np.float32), want)
    g32 = g.astype(np.float32)
    np.testing.assert_array_equal(g32 * g32, column_g2(torch.from_numpy(mask)).numpy())


# ---------------------------------------------------------------------------
# the wrappers' argument checks
# ---------------------------------------------------------------------------

_WRAPPERS = {
    "canny": (lambda x: kcanny.canny(x, 100.0, 150.0), torch.float32),
    "edt_squared": (lambda x: kedt.edt_squared(x, 16), torch.bool),
    "dt_channels": (lambda x: kedt.dt_channels(x, 16, False, True), torch.bool),
}


@pytest.mark.parametrize("fault", ["rank", "dtype", "strides", "device"])
@pytest.mark.parametrize("name", list(_WRAPPERS))
def test_cuda_wrappers_reject_bad_arguments_before_building(monkeypatch, name, fault):
    """Off the CPU a wrapper checks rank, dtype, contiguity and device
    before it builds or binds anything (meta tensors stand in for a device
    without a kernel)."""
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(build, "bind", no_build)
    monkeypatch.setattr(build, "load", no_build)
    fn, dtype = _WRAPPERS[name]
    good = torch.empty((2, 16, 24), dtype=dtype, device="meta")
    arg, match = {
        "rank": (torch.empty((16, 24), dtype=dtype, device="meta"), r"must be \(B, H, W\)"),
        "dtype": (torch.empty((2, 16, 24), dtype=torch.float64, device="meta"), "must be"),
        "strides": (torch.empty((2, 16, 48), dtype=dtype, device="meta")[:, :, ::2],
                    "must be contiguous"),
        "device": (good, "unsupported device"),
    }[fault]
    before = (kcanny.canny_pyramid.launches, kedt.edt_squared.launches, kedt.dt_channels.launches)
    with pytest.raises(ValueError, match=match):
        fn(arg)
    assert before == (kcanny.canny_pyramid.launches, kedt.edt_squared.launches,
                      kedt.dt_channels.launches)


def test_wrappers_on_cpu_run_the_plain_versions():
    frames = torch.from_numpy(_frames(30, 40))
    edges = kcanny.canny(frames)
    assert torch.equal(edges, tcanny.canny(frames))
    for flags in ((16, False, True), (0, True, False)):
        for a, b in zip(kedt.dt_channels(edges, *flags), kedt.dt_channels_plain(edges, *flags)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert kcanny.canny_pyramid.launches == 0 and kedt.dt_channels.launches == 0


@pytest.mark.parametrize("shape, fits", [((720, 960), True), ((2400, 64), True),
                                          ((2401, 64), False), ((64, 1601), False)])
@pytest.mark.parametrize("name", ["edt_squared", "dt_channels"])
def test_edt_takes_levels_up_to_its_shared_memory(monkeypatch, name, shape, fits):
    """The column phase stages 3 bytes a row of a 32-column strip and opts
    in to more than 48 KB of shared memory past 480 rows: a 960x720 level
    (`dvo --cam-scale 3`) and 2400 rows pass the checks (which then stop at
    the device), taller or wider images are refused before anything is
    built, naming the ROADMAP item that would split a level over blocks."""
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(build, "bind", no_build)
    fn, dtype = _WRAPPERS[name]
    mask = torch.empty((1, *shape), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="unsupported device" if fits else
                       "ROADMAP.md Queue 2 item 7"):
        fn(mask)
