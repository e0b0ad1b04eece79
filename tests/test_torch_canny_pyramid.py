"""The pyramid Canny entry point of the PyTorch port
(`kernels/canny.canny_pyramid`) against the JAX package, on the CPU, where
its wrapper runs the plain version:

* bitwise against JAX's `canny_multi` (the stacked single fixpoint) and
  against JAX's per-level `canny`, on 4-level pyramids of rendered frames,
  of the serpentine image and its flips, of 8-bit noise and of an odd-sized
  base, for B = 1 and B = 3; the port's `_pyramid_edges` against JAX's under
  both `fuse_level_canny` settings;
* a numpy model of the CUDA hysteresis schedule (every level and image side
  by side, one block each, 8-row units swept down and up in place in a
  shuffled order, runs filled by carry chains) reaching JAX's fixpoint,
  with a chain that crosses every unit's boundary;
* a numpy model of the cluster route (bands of rows over 2, 4 or 8 blocks,
  a neighbour's boundary row read old or new) equal to JAX's Canny on a
  rendered 1280x960 frame and on the serpentine image, and the route rule
  (`hysteresis_route`) either side of each boundary;
* the solver's calls: `prepare_now_targets` is one `canny_pyramid` call and
  one `dt_pyramid` call (no `dt_channels` call a level), `extract_ref_features` without edge maps
  one `canny_pyramid` call;
* the CUDA wrapper's argument checks (a forced route, the size limit),
  which run before anything is built.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import SolverConfig  # noqa: E402
from rgbd_odometry_tpu.ops import canny as jcanny  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.config import SolverConfig as TSolverConfig  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import build  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import canny as kcanny  # noqa: E402
from rgbd_odometry_tpu_torch.ops import canny as tcanny  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402
from test_torch_targets_kernels import (  # noqa: E402
    _frames, _jacobi_passes, _pack, _spread, _unpack, _weak_strong, serpentine_image,
)

torch.set_num_threads(1)

LEVELS = 4
# JAX's Canny compiled whole, once per shape (eagerly it dispatches op by op)
_jax_canny = jax.jit(functools.partial(jcanny.canny, low=100.0, high=150.0))
_jax_canny_multi = jax.jit(functools.partial(jcanny.canny_multi, low=100.0, high=150.0))


def _base(kind, b):
    """(b, H, W) float32 level-0 images of one kind."""
    rng = np.random.default_rng(7)
    if kind == "frames":
        return _frames(96, 128, b)
    if kind == "serpentine":
        s = serpentine_image(96, 128)
        return np.stack([s, s[::-1], s[:, ::-1], s[::-1, ::-1]][:b]).copy()
    if kind == "noise":
        return rng.integers(0, 256, (b, 64, 80)).astype(np.float32)
    return _frames(74, 90, b)  # odd: 74x90, 37x45, 18x22 or 19x23, ...


def _pyramid(kind, b):
    base = torch.from_numpy(_base(kind, b))
    return build_pyramid(base, torch.full_like(base, 1000.0), LEVELS).gray


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("kind", ["frames", "serpentine", "noise", "odd"])
def test_canny_pyramid_bitwise_equals_jax(kind, b):
    pyr = _pyramid(kind, b)
    assert len(pyr) == LEVELS and all(g.shape[0] == b for g in pyr)
    got = kcanny.canny_pyramid(pyr, 100.0, 150.0)
    assert len(got) == LEVELS
    fused = _jax_canny_multi(tuple(jnp.asarray(g.numpy()) for g in pyr))
    for lvl, (g, e, f) in enumerate(zip(pyr, got, fused)):
        assert e.dtype == torch.bool and e.shape == g.shape and e.is_contiguous()
        np.testing.assert_array_equal(e.numpy(), np.asarray(f), err_msg=f"level {lvl}")
        want = np.asarray(_jax_canny(jnp.asarray(g.numpy())))
        np.testing.assert_array_equal(e.numpy(), want, err_msg=f"level {lvl}")
    assert got[0].any(dim=(-2, -1)).all()
    assert kcanny.canny_pyramid.launches == 0


@pytest.mark.parametrize("fuse", [False, True], ids=["per_level", "canny_multi"])
def test_pyramid_edges_equals_jax(fuse):
    pyr = _pyramid("frames", 2)
    cfg = SolverConfig(method="gauss_newton", fuse_level_canny=fuse)
    want = jed._pyramid_edges(tuple(jnp.asarray(g.numpy()) for g in pyr), cfg)
    got = ted._pyramid_edges(pyr, TSolverConfig(method="gauss_newton", fuse_level_canny=fuse))
    for e, w in zip(got, want):
        np.testing.assert_array_equal(e.numpy(), np.asarray(w))


def test_wrapper_on_cpu_runs_the_plain_version():
    pyr = _pyramid("noise", 2)
    got = kcanny.canny_pyramid(pyr, 150.0, 100.0)  # the thresholds in either order
    for e, g in zip(got, pyr):
        assert torch.equal(e, tcanny.canny(g, 100.0, 150.0))
    for e, p in zip(got, kcanny.canny_pyramid_plain(pyr)):
        assert torch.equal(e, p)
    assert kcanny.canny_pyramid.launches == 0


# ---------------------------------------------------------------------------
# a numpy model of the CUDA hysteresis schedule
# ---------------------------------------------------------------------------


def _fill_runs(s, m):
    """`fill_runs` of csrc/canny.cu: the bits of m in every run of m that
    holds a bit of s (s a subset of m), by two carry chains."""
    mask = 0xFFFFFFFF
    rev = lambda x: int(f"{x:032b}"[::-1], 2)  # noqa: E731
    up = ((((m + s) & mask) ^ m) & m) | s
    rm, rs = rev(m), rev(s)
    return up | rev(((((rm + rs) & mask) ^ rm) & rm) | rs)


def _fill_runs_loop(s, m):
    """The plain loop along the runs inside a word, a column a step."""
    while True:
        nxt = (s | (s << 1) | (s >> 1)) & m
        if nxt == s:
            return s
        s = nxt


def test_carry_chain_fill_equals_the_run_loop():
    rng = np.random.default_rng(3)
    words = [0, 0xFFFFFFFF, 0x80000001, 0x7FFFFFFE, 0xAAAAAAAA]
    words += [int(x) for x in rng.integers(0, 2 ** 32, 400, dtype=np.uint64)]
    for m in words:
        for s in (m, m & 1, m & 0x80000000, m & int(rng.integers(0, 2 ** 32, dtype=np.uint64)), 0):
            assert _fill_runs(s, m) == _fill_runs_loop(s, m), (hex(m), hex(s))


def _pyramid_hysteresis(masks, rng, chunk=8):
    """The hysteresis launch of `canny_pyramid` on a list of (strong, weak)
    (H, W) masks (the (level, image) blocks of one launch): each mask split
    into units of `chunk` rows of one word column, swept down and up in
    place; in a pass every unit of every mask runs once, in a shuffled
    order, reading the rows beside it as they stand; a pass that changes no
    word anywhere ends the launch. Returns the edge maps and the pass
    count."""
    planes, units = [], []
    for i, (strong, weak) in enumerate(masks):
        wk, e = _pack(weak), _pack(strong & weak)
        planes.append((wk, e))
        h, words = weak.shape[0], wk.shape[1] - 2
        for k in range(0, h, chunk):
            for c in range(1, words + 1):
                units.append((i, k, min(k + chunk, h), c))
    passes = 0
    while True:
        changed = False
        for u in rng.permutation(len(units)):
            i, ra, rb, c = units[u]
            wk, e = planes[i]
            rows = list(range(ra, rb)) + list(range(rb - 2, ra - 1, -1))
            for y in rows:
                r = y + 1  # the packed planes' guard row is row 0
                m, old = int(wk[r, c]), int(e[r, c])
                if old == m:
                    continue
                seed = (old | _spread(e, r - 1, c) | _spread(e, r, c) | _spread(e, r + 1, c)) & m
                now = _fill_runs(seed, m)
                if now != old:
                    e[r, c] = now
                    changed = True
        passes += 1
        if not changed:
            return [_unpack(e, weak.shape[1]) for (_, e), (_, weak) in zip(planes, masks)], passes


def _chain_across_units(h, w):
    """A weak chain that winds down through every 8-row unit: a vertical
    zigzag in the first columns, strong only at its top."""
    weak = np.zeros((h, w), bool)
    for x in range(0, w - 1, 4):
        weak[:, x] = True
        if (x // 4) % 2 == 0:
            weak[h - 1, x:x + 5] = True
        else:
            weak[0, x:x + 5] = True
    strong = np.zeros_like(weak)
    strong[0, 0] = True
    return strong, weak


@pytest.mark.parametrize("seed", [13, 14, 15, 16])
def test_pyramid_hysteresis_reaches_jax_fixpoint(seed):
    """A launch's worth of masks, in shuffled orders drawn from `seed`: a
    random level 37 rows tall (a short last unit), a 7-row one (one short
    unit), the serpentine image's, and a chain that crosses every unit's
    boundary."""
    rng = np.random.default_rng(seed)
    masks = []
    for h, w, dens in ((37, 70, 0.5), (7, 40, 0.6), (24, 33, 0.35)):
        weak = rng.random((h, w)) < dens
        masks.append((weak & (rng.random((h, w)) < 0.03), weak))
    weak, strong = _weak_strong(serpentine_image(60, 80))
    masks.append((strong, weak))
    masks.append(_chain_across_units(40, 64))
    jacobi = max(_jacobi_passes(s, w) for s, w in masks)
    for _ in range(2):  # two different orders
        got, passes = _pyramid_hysteresis(masks, rng)
        for (strong, weak), g in zip(masks, got):
            want = np.asarray(jcanny.hysteresis(jnp.asarray(strong), jnp.asarray(weak)))
            np.testing.assert_array_equal(g, want)
        assert passes <= jacobi + 1
    chain = got[-1]
    assert chain[-1].any() and chain.sum() == masks[-1][1].sum()  # the whole chain, every unit


_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint64)
_M32 = np.uint64(0xFFFFFFFF)


def _brev(x):
    """Bit reversal of 32-bit words held in uint64."""
    return sum(_REV8[(x >> np.uint64(8 * i)) & np.uint64(255)] << np.uint64(24 - 8 * i)
               for i in range(4))


def _fill_runs_vec(s, m):
    """`_fill_runs` on arrays of words."""
    up = ((((m + s) & _M32) ^ m) & m) | s
    rm, rs = _brev(m), _brev(s)
    return up | _brev(((((rm + rs) & _M32) ^ rm) & rm) | rs)


def _spread_rows(rows):
    """`spread` of every word of a (n, words + 2) block of packed rows (the
    guard columns included), for the words 1..words."""
    v = rows[:, 1:-1]
    return (v | ((v << np.uint64(1)) & _M32) | (v >> np.uint64(1)) | (rows[:, :-2] >> np.uint64(31))
            | ((rows[:, 2:] << np.uint64(31)) & _M32))


def _banded_hysteresis(strong, weak, ranks, rng, chunk=8):
    """The cluster route of the hysteresis kernel on one (H, W) image: the
    rows in `ranks` bands of a multiple of `chunk` rows, each band's units
    (`chunk` rows of one word column) swept down and up in place, every
    unit of every band stepping together (one row a step, all columns); a
    row of the neighbouring band is read from that band's memory either as
    it stands or as it stood when the pass began (a read through
    distributed shared memory may see the neighbour's old word), drawn per
    pass and boundary. A pass in which no band changed a word ends it.
    Returns the edge map and the pass count."""
    h, w = weak.shape
    wk, e = _pack(weak).astype(np.uint64), _pack(strong & weak).astype(np.uint64)
    band = -(-(-(-h // ranks)) // chunk) * chunk
    units = [(ra, min(ra + chunk, h, (ra // band + 1) * band)) for ra in range(0, h, chunk)]
    band_of = np.arange(h + 2) - 1  # the packed row's image row, then its band
    band_of = np.where((band_of >= 0) & (band_of < h), band_of // band, -1)
    passes = 0
    while True:
        changed = False
        start = e.copy()
        stale = rng.random(ranks + 1) < 0.5  # per band boundary, this pass
        for step in range(2 * chunk - 1):
            rows = []
            for ra, rb in units:
                n = rb - ra
                if step < 2 * n - 1:
                    rows.append(1 + (ra + step if step < n else 2 * rb - ra - 2 - step))
            r = np.array(rows)
            own = band_of[r]

            def neighbour(rn):
                live, old = e[rn], start[rn]
                other = (band_of[rn] != own) & (band_of[rn] >= 0)
                pick = other & stale[np.maximum(np.minimum(own, band_of[rn]), 0) + 1]
                return np.where(pick[:, None], old, live)

            seed = (e[r, 1:-1] | _spread_rows(neighbour(r - 1)) | _spread_rows(e[r])
                    | _spread_rows(neighbour(r + 1)))
            m = wk[r, 1:-1]
            now = np.where(e[r, 1:-1] == m, e[r, 1:-1], _fill_runs_vec(seed & m, m))
            if (now != e[r, 1:-1]).any():
                changed = True
                e[r, 1:-1] = now
        passes += 1
        if not changed:
            return _unpack(e.astype(np.uint32), w), passes


@functools.lru_cache(maxsize=None)
def _jax_canny_1280x960():
    img = _frames(960, 1280, 1)[0]
    return img, np.asarray(_jax_canny(jnp.asarray(img)))


@pytest.mark.parametrize("ranks", [2, 4, 8])
@pytest.mark.parametrize("kind", ["frame 1280x960", "serpentine 120x160"])
def test_banded_hysteresis_reaches_jax_canny(kind, ranks):
    """The hysteresis over a cluster of 2, 4 or 8 blocks, a band of rows
    each, gives JAX's Canny edge map: on a rendered 1280x960 frame (`dvo
    --cam-scale 4`'s level 0, which one block cannot hold) and on the
    serpentine image, whose chain crosses every band boundary many times."""
    rng = np.random.default_rng(ranks)
    if kind.startswith("frame"):
        img, want = _jax_canny_1280x960()
    else:
        img = serpentine_image(120, 160)
        want = np.asarray(_jax_canny(jnp.asarray(img)))
    weak, strong = _weak_strong(img)
    got, passes = _banded_hysteresis(strong, weak, ranks, rng)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > strong.sum() and passes >= 2


_P320 = [(240, 320), (120, 160), (60, 80), (30, 40)]
_VGA = [(480, 640)] + _P320


@pytest.mark.parametrize("shapes, b, want", [
    # a level whose units (8 rows of a 32-column word) fit a block's 1024
    # threads stays on one block; one more row of units goes to a cluster
    (_P320, 1, ((1, 1, 1, 1), 1)), ([(256, 1024)], 1, ((1,), 1)), ([(264, 1024)], 1, ((8,), 8)),
    # the largest c whose blocks the card holds at once (264), else one block
    (_VGA, 1, ((8, 1, 1, 1, 1), 8)), (_VGA, 16, ((8, 1, 1, 1, 1), 8)),
    (_VGA, 32, ((4, 1, 1, 1, 1), 4)), (_VGA, 44, ((2, 1, 1, 1, 1), 2)),
    (_VGA, 45, ((1, 1, 1, 1, 1), 1)), (_VGA, 64, ((1, 1, 1, 1, 1), 1)),
    # a level one block cannot hold (from 690 rows of 1280) always clusters:
    # where the card cannot hold the wanted clusters, on the smallest c that fits
    ([(689, 1280)], 1, ((8,), 8)), ([(690, 1280)], 64, ((4,), 4)),
    ([(960, 1280), (480, 640), (240, 320), (120, 160)], 64, ((2, 1, 1, 1), 2)),
    ([(960, 1280), (480, 640), (240, 320), (120, 160)], 1, ((8, 8, 1, 1), 8)),
    ([(1600, 2560), (800, 1280), (400, 640)], 1, ((8, 8, 1), 8)),
    ([(1600, 2560)], 64, ((8,), 8)),
])
def test_hysteresis_route_rule(shapes, b, want):
    """`hysteresis_route` over B images: a level one block cannot hold, or
    whose units outnumber a block's threads, runs on the largest cluster
    whose blocks the card holds at once; where none does, only the levels
    one block cannot hold go to the smallest cluster that holds them."""
    assert kcanny.hysteresis_route(shapes, b) == want


@pytest.mark.parametrize("shape, cluster, match", [
    ((240, 320), 3, "one of"), ((960, 1280), 1, "does not fit"),
    ((1600, 2560), 4, "does not fit"), ((240, 320), 8, "unsupported device"),
])
def test_forced_cluster_is_checked_before_building(monkeypatch, shape, cluster, match):
    """A forced route must be a cluster size every level fits; it is checked
    before anything is built (a 240x320 level takes any c)."""
    monkeypatch.setattr(build, "bind", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match=match):
        kcanny.canny_pyramid((_meta(1, *shape),), cluster=cluster)


# ---------------------------------------------------------------------------
# the solver's calls
# ---------------------------------------------------------------------------


def _count_calls(monkeypatch, *names):
    calls = []
    for name in names:
        real = getattr(ted, name)
        monkeypatch.setattr(ted, name, lambda *a, _n=name, _f=real, **k: calls.append(_n)
                            or _f(*a, **k))
    return calls


def test_prepare_now_targets_is_one_canny_pyramid_and_a_dt_channels_call_per_level(monkeypatch):
    pyr = _pyramid("frames", 2)
    cfg = TSolverConfig(method="gauss_newton")
    calls = _count_calls(monkeypatch, "canny", "canny_pyramid", "dt_channels", "dt_pyramid")
    nows = ted.prepare_now_targets(pyr, cfg)
    assert calls == ["canny_pyramid", "dt_pyramid"]
    for g, now in zip(pyr, nows):
        want = ted.prepare_now_level(g, cfg)
        for a, b in zip(now, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_extract_ref_features_without_edges_is_one_canny_pyramid_call(monkeypatch):
    base = torch.from_numpy(_frames(96, 128, 2))
    pyr = build_pyramid(base, torch.full_like(base, 1500.0), LEVELS)
    cfg = TSolverConfig(method="gauss_newton")
    intr = Intrinsics(fx=104.0, fy=104.0, cx=63.5, cy=47.5)
    caps = (1024, 512, 256, 128)
    calls = _count_calls(monkeypatch, "canny", "canny_pyramid")
    feats = ted.extract_ref_features(pyr.gray, pyr.depth, intr, cfg, caps)
    assert calls == ["canny_pyramid"]
    edges = tuple(tcanny.canny(g) for g in pyr.gray)
    want = ted.extract_ref_features(pyr.gray, pyr.depth, intr, cfg, caps, edges_pyr=edges)
    for a, b in zip(feats, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert int(feats[0].count.min()) > 0


# ---------------------------------------------------------------------------
# the wrapper's argument checks
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("fault", ["batch", "dtype", "strides", "rank", "smem", "levels",
                                   "passes", "device"])
def test_cuda_wrapper_rejects_bad_arguments_before_building(monkeypatch, fault):
    """Off the CPU the wrapper checks every level (the same B and device,
    float32, contiguous, (B, H, W), within the kernels' size limit: a
    3000x3000 level is past it), the level count and the pass-count tensor
    before it builds or binds anything (meta tensors stand in for a device
    without a kernel)."""
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(build, "bind", no_build)
    monkeypatch.setattr(build, "load", no_build)
    good = [_meta(2, 48, 64), _meta(2, 24, 32), _meta(2, 12, 16)]
    imgs, kw = list(good), {}
    match = {"batch": "images", "dtype": "float32", "strides": "contiguous", "rank": "(B, H, W)",
             "smem": "too large", "levels": "levels", "passes": "passes",
             "device": "unsupported device"}[fault]
    if fault == "batch":
        imgs[1] = _meta(3, 24, 32)
    elif fault == "dtype":
        imgs[2] = _meta(2, 12, 16, dtype=torch.float64)
    elif fault == "strides":
        imgs[1] = _meta(2, 24, 64)[:, :, ::2]
    elif fault == "rank":
        imgs[0] = _meta(48, 64)
    elif fault == "smem":
        imgs[0] = _meta(2, 3000, 3000)
    elif fault == "levels":
        imgs = good * 3
    elif fault == "passes":
        kw["passes"] = _meta(2, 3, dtype=torch.int32)
    before = kcanny.canny_pyramid.launches
    with pytest.raises(ValueError, match=match):
        kcanny.canny_pyramid(tuple(imgs), 100.0, 150.0, **kw)
    assert kcanny.canny_pyramid.launches == before


@pytest.mark.parametrize("shape, fits", [((480, 640), True), ((2048, 2048), False),
                                          ((3000, 640), False), ((800, 1280), True),
                                          ((960, 1280), True), ((2560, 1600), True),
                                          ((64, 2561), False)])
def test_a_level_fits_one_hysteresis_block_up_to_its_shared_memory(monkeypatch, shape, fits):
    """A level of fewer than 2^22 pixels with both sides at most 2560 passes
    the checks (which then stop at the device): a 640x480 level on one block
    (85 KB, through the opt-in), 1280x800, 1280x960 and 1600x2560 on a
    cluster of blocks, a band of rows each; a 2048x2048 level, a 3000-row
    one and a side of 2561 are refused before anything is built, naming the
    limit."""
    monkeypatch.setattr(build, "bind", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match="unsupported device" if fits else
                       r"fewer than 2\^22 pixels .* at most 2560 a side"):
        kcanny.canny_pyramid((_meta(1, *shape),))
