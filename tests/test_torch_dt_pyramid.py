"""The targets' distance transforms of a whole pyramid in one call
(`kernels/edt.dt_pyramid`, `csrc/edt.cu`'s `dt_pyramid_kernel`) against
the JAX package, on the CPU, where the wrapper runs its plain twin:

* `dt_pyramid` bitwise against JAX's `prepare_now_targets` (dt, gradients,
  scale, channels) under production_320, the `dvo` defaults, parity_320
  (float32 channels) and production_vga's 5 levels, on rendered frames;
* a numpy model of the kernel's row phase, in its own order (the search
  outward from x, four offsets a step, stopping at the first offset whose
  square over the row's least candidate reaches the best so far), bitwise
  against JAX's `edt_l2_squared` and `edt_l2_squared_windowed` on
  edge-free, single-pixel, single-column, dense-noise, all-edge, 37x45 and
  2xW masks, with the work it does;
* a numpy model of the kernel's schedule (bands of rows over 1, 2, 4, 8
  blocks, tiles of rows with halo rows reflected into the neighbouring
  bands, the image's min and max combined over the bands) bitwise against
  JAX's `prepare_now_level`;
* the route rule (`dt_route`) at the main paths' pyramids, B = 1, 8, 64,
  and the per-level route of the largest levels;
* the wrapper's argument checks, which run before anything is built.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu import profiles as jprofiles  # noqa: E402
from rgbd_odometry_tpu.config import SolverConfig  # noqa: E402
from rgbd_odometry_tpu.ops import distance_transform as jdt  # noqa: E402
from rgbd_odometry_tpu.solvers import edge_dvo as jed  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import build  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import canny as kcanny  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import edt as kedt  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402
from test_torch_targets_kernels import _frames, _jax_cfg  # noqa: E402

torch.set_num_threads(1)

F32 = np.float32
PAD = F32(4.0e9)


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# dt_pyramid against JAX's prepare_now_targets
# ---------------------------------------------------------------------------

_CONFIGS = {
    "production_320": lambda: jprofiles.production_320(),
    "dvo_defaults": lambda: jprofiles.Profile(
        name="dvo", camera=jprofiles.production_320().camera,
        solver=SolverConfig(method="gauss_newton"), max_points=(8192, 4096, 2048, 1024)),
    "parity_320": lambda: jprofiles.parity_320(),
    "production_vga": lambda: jprofiles.production_vga(),
}


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_dt_pyramid_bitwise_equals_jax_prepare_now_targets(name):
    prof = _CONFIGS[name]()
    cfg = prof.solver
    cam = prof.camera
    frames = []
    for i in range(2):
        psi = np.array([0.01, -0.006, 0.004, 0.003, -0.004, 0.002], np.float32) * (i + 1)
        (_, _), (ng, nd), _ = render_pair(cam, psi, seed=i, supersample=1)
        frames.append((ng, nd))
    gray = torch.from_numpy(np.stack([g for g, _ in frames]))
    depth = torch.from_numpy(np.stack([d for _, d in frames]))
    pyr = build_pyramid(gray, depth, prof.num_levels).gray
    edges = kcanny.canny_pyramid(pyr, cfg.canny_low, cfg.canny_high)
    flags = ted._dt_flags(cfg)
    assert flags == (cfg.edt_window, cfg.normalize_dt,
                     cfg.method == "gauss_newton" and cfg.gather_dtype == "bfloat16")
    got = kedt.dt_pyramid(edges, *flags)
    assert len(got) == prof.num_levels
    for i in range(2):
        want = jed.prepare_now_targets(tuple(jnp.asarray(g[i].numpy()) for g in pyr), cfg)
        for lvl, (mine, ref) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(edges[lvl][i].numpy(), np.asarray(ref.edges))
            dt, dgx, dgy, scale, chans = mine
            assert chans.shape == (2, 3, *edges[lvl].shape[1:]) and scale.shape == (2,)
            for what, a, b in (("dt", dt[i], ref.dt), ("dgx", dgx[i], ref.dgx),
                               ("dgy", dgy[i], ref.dgy), ("scale", scale[i], ref.scale),
                               ("chans", chans[i], ref.chans)):
                a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)
                np.testing.assert_array_equal(a.numpy(), _bits(b),
                                              err_msg=f"{name} image {i} level {lvl} {what}")


def test_prepare_now_targets_on_cpu_is_dt_pyramid_of_the_edges():
    pyr = build_pyramid(torch.from_numpy(_frames(48, 64, 2)),
                        torch.full((2, 48, 64), 1000.0), 3).gray
    for cfg in (ted.SolverConfig(method="gauss_newton"), ted.SolverConfig(method="subgradient"),
                ted.SolverConfig(method="gauss_newton", edt_window=16, normalize_dt=False)):
        nows = ted.prepare_now_targets(pyr, cfg)
        edges = kcanny.canny_pyramid(pyr, cfg.canny_low, cfg.canny_high)
        for now, e, want in zip(nows, edges, kedt.dt_pyramid(edges, *ted._dt_flags(cfg))):
            assert torch.equal(now.edges, e)
            for a, b in zip((now.dt, now.dgx, now.dgy, now.scale, now.chans), want):
                assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# a numpy model of the row phase, in the kernel's order
# ---------------------------------------------------------------------------


def _column_g2(mask):
    """G^2 of the column phase: g = min(column distance, 65504), squared in
    float32 (JAX's `_column_distance`, which the kernel's sweep matches:
    test_torch_targets_kernels.py holds the sweep to it)."""
    g = np.minimum(np.asarray(jdt._column_distance(jnp.asarray(mask))), 65504.0).astype(F32)
    return g * g


def _model_row(g2row, radius):
    """D^2 of one row as `row_tile` computes it: the row padded with
    radius + 4 candidates of 4e9 a side under a window, its lower bound (min
    G^2, and 4e9 under a window), then the search outward, four offsets a
    step (past the window an offset adds +inf; without one an index past
    the row is clamped to its end): `row_search4` on four pixels at once
    where the width and the pad are multiples of 4, else `row_search` a
    pixel. Returns
    (D^2, the (pixel, offset) pairs examined)."""
    w = g2row.shape[0]
    pad = radius + 4 if radius else 0
    p = np.concatenate([np.full(pad, PAD, F32), g2row, np.full(pad, PAD, F32)])
    lb = F32(min(np.min(g2row), PAD) if radius else np.min(g2row))
    out = np.empty(w, F32)
    steps = 0
    k = 4 if w % 4 == 0 and pad % 4 == 0 else 1
    for x0 in range(0, w, k):
        best = [p[pad + x0 + j] for j in range(k)]
        lim = radius if radius else max(x0 + k - 1, w - 1 - x0)
        e = 1
        while e <= lim:
            if F32(lb + F32(e * e)) >= max(best):
                break
            for o in range(e, e + 4):
                d = F32(o * o) if not radius or o <= radius else F32(np.inf)
                for j in range(k):
                    il, ir = j - o, j + o  # relative to x0
                    if not radius:
                        il, ir = max(il, -x0), min(ir, w - 1 - x0)
                    a, b = p[pad + x0 + il], p[pad + x0 + ir]
                    best[j] = min(best[j], F32(min(a, b) + d))
                    steps += 1
            e += 4
        out[x0:x0 + k] = best
    return out, steps


def _model_d2(mask, radius):
    g2 = _column_g2(mask)
    rows = [_model_row(r, radius) for r in g2]
    return np.stack([r for r, _ in rows]), sum(s for _, s in rows)


def _masks():
    rng = np.random.default_rng(11)
    single = np.zeros((24, 40), bool)
    single[7, 29] = True
    column = np.zeros((24, 40), bool)
    column[:, 3] = True
    odd = rng.random((37, 45)) < 0.04
    odd[:, 40:] = False  # edge-free columns at the border: the 4e9 pads win there
    two = rng.random((2, 57)) < 0.1  # a width no multiple of 4: one pixel a thread
    return {
        "edge-free": np.zeros((24, 40), bool),
        "single-pixel": single,
        "single-column": column,
        "dense-noise": rng.random((24, 40)) < 0.5,
        "all-edge": np.ones((24, 40), bool),
        "37x45": odd,
        "2xW": two,
    }


@pytest.mark.parametrize("radius", [0, 5, 16])
@pytest.mark.parametrize("kind", list(_masks()))
def test_row_search_model_bitwise_equals_jax(kind, radius):
    mask = _masks()[kind]
    got, steps = _model_d2(mask, radius)
    if radius:
        want = np.asarray(jdt.edt_l2_squared_windowed(jnp.asarray(mask), radius))
    else:
        want = np.asarray(jdt.edt_l2_squared(jnp.asarray(mask)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    h, w = mask.shape
    # the work: an all-edge image (best 0) and, without a window, an
    # edge-free one (the row's bound is every candidate) stop at once; a
    # dense one near each pixel's distance, not at the row's end (one edge
    # column far away costs that distance: the search is O(D), not O(1))
    if kind == "all-edge" or (kind == "edge-free" and radius == 0):
        assert steps == 0
    if kind == "dense-noise":
        assert steps <= 4 * h * w


def test_row_search_stops_short_of_the_row():
    """The whole-row search on a wide dense mask examines a small, bounded
    number of offsets a pixel, where the JAX min-plus (and the parent
    kernel) takes all W."""
    rng = np.random.default_rng(3)
    mask = rng.random((4, 320)) < 0.05
    mask[:, 0] = True
    got, steps = _model_d2(mask, 0)
    want = np.asarray(jdt.edt_l2_squared(jnp.asarray(mask)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert steps / mask.size < 40


# ---------------------------------------------------------------------------
# a numpy model of the kernel's schedule: bands, tiles, halo rows, min/max
# ---------------------------------------------------------------------------


def _reflect(y, h):
    if y < 0:
        y = -y
    if y >= h:
        y = 2 * h - 2 - y
    return min(max(y, 0), h - 1)


def _model_targets(mask, radius, normalize, ranks, tile):
    """One image's dt, dgx, dgy, scale as `dt_pyramid_kernel` schedules them
    over `ranks` blocks (bands of ceil(H / ranks) rows) in tiles of at most
    `tile` rows."""
    h, w = mask.shape
    d2, _ = _model_d2(mask, radius)
    raw = np.sqrt(d2)  # float32 sqrt, correctly rounded
    band = -(-h // ranks)
    bands = [(min(r * band, h), min(min(r * band, h) + band, h)) for r in range(ranks)]
    dt = np.full((h, w), np.nan, F32)
    dgx, dgy = dt.copy(), dt.copy()
    if normalize:
        parts = [(raw[r0:r1].min(initial=np.inf), raw[r0:r1].max(initial=0.0))
                 for r0, r1 in bands]
        dmin = F32(min(p[0] for p in parts))
        dmax = F32(max(p[1] for p in parts))
        scale = F32(F32(255.0) / max(F32(dmax - dmin), F32(1e-12)))
        src = lambda y: (raw[y] - dmin) * scale  # noqa: E731
    else:
        scale = F32(1.0)
        src = lambda y: raw[y]  # noqa: E731
    for r0, r1 in bands:
        for y0 in range(r0, r1, tile):
            rows = min(tile, r1 - y0)
            t = np.stack([src(_reflect(y, h)) for y in range(y0 - 1, y0 + rows + 1)])
            for r in range(rows):
                row = t[r + 1]
                xl = np.array([x - 1 if x > 0 else 1 for x in range(w)])
                xr = np.array([x + 1 if x < w - 1 else w - 2 for x in range(w)])
                dt[y0 + r] = row
                dgx[y0 + r] = F32(0.5) * (row[xr] - row[xl])
                dgy[y0 + r] = F32(0.5) * (t[r + 2] - t[r])
    return dt, dgx, dgy, scale


@pytest.mark.parametrize("ranks, tile", [(1, 8), (2, 3), (4, 30), (8, 1), (8, 2)])
@pytest.mark.parametrize("radius, normalize", [(16, False), (0, True), (0, False), (16, True)])
def test_schedule_model_bitwise_equals_jax_prepare_now_level(ranks, tile, radius, normalize):
    frame = _frames(37, 45, 1)[0]
    edges = kcanny.canny(torch.from_numpy(frame[None]))[0].numpy()
    assert 0 < edges.sum() < edges.size
    for mask in (edges, np.zeros_like(edges), np.ones_like(edges)):
        cfg = _jax_cfg(radius, normalize, False)
        want = jed.prepare_now_level(jnp.zeros(mask.shape, jnp.float32), cfg, jnp.asarray(mask))
        got = _model_targets(mask, radius, normalize, ranks, tile)
        for what, a, b in zip(("dt", "dgx", "dgy", "scale"), got,
                              (want.dt, want.dgx, want.dgy, want.scale)):
            np.testing.assert_array_equal(np.asarray(a, F32).view(np.int32), _bits(b),
                                          err_msg=f"{what}, ranks {ranks}, tile {tile}")


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

P320 = ((240, 320), (120, 160), (60, 80), (30, 40))
VGA = ((480, 640),) + P320
CAM3 = ((720, 960), (360, 480), (180, 240), (90, 120))
CAM4 = ((960, 1280), (480, 640), (240, 320), (120, 160))


@pytest.mark.parametrize("shapes, b, sms, want", [
    (P320, 1, 132, ((8, 8, 4, 1), 8)),
    (P320, 8, 132, ((8, 8, 2, 1), 8)),
    (P320, 64, 132, ((4, 1, 1, 1), 4)),
    (P320, 64, 66, ((2, 1, 1, 1), 2)),
    (VGA, 1, 132, ((8, 8, 8, 4, 1), 8)),
    (VGA, 8, 132, ((8, 8, 2, 1, 1), 8)),
    (VGA, 64, 132, ((4, 1, 1, 1, 1), 4)),
    (CAM3, 1, 132, ((8, 8, 8, 4), 8)),
    (CAM3, 8, 132, ((8, 8, 2, 1), 8)),
    (CAM3, 64, 132, ((4, 1, 1, 1), 4)),
    (CAM4, 1, 132, ((0, 8, 8, 4), 8)),
    (CAM4, 1, 16, ((0, 8, 2, 1), 8)),
    (CAM4, 8, 132, ((0, 8, 2, 1), 8)),
    (CAM4, 64, 132, ((0, 1, 1, 1), 1)),
    (((1600, 2560),), 1, 132, ((0,), 1)),
    (((2560, 1600),), 1, 132, ((0,), 1)),
    (((720, 960),), 1, 132, ((8,), 8)),
    (((37, 45),), 3, 132, ((1,), 1)),
])
def test_dt_route_rule(shapes, b, sms, want):
    """A level of 2^20 pixels or more goes to the per-level route (0);
    every other level is halved until its blocks' pixels are no
    more than the launch's share (every level's pixels over B images, over
    two blocks an SM of the card of `sms` SMs, at least 2048), at most 8
    ways; c is the largest count (1 when every level is on the per-level
    route). The H100's 132 SMs are the default."""
    assert kedt.dt_route(shapes, b, sms=sms) == want
    if sms == kedt.H100_SMS:
        assert kedt.dt_route(shapes, b) == want
    ranks, c = want
    share = max(2048, b * sum(h * w for h, w in shapes) / (2 * sms))
    for (h, w), r in zip(shapes, ranks):
        assert (r == 0) == (h * w >= 1 << 20)
        if r:
            assert r == 8 or h * w / r <= share
            assert r == 1 or h * w / (r // 2) > share


def test_dt_route_forced_cluster():
    assert kedt.dt_route(P320, 64, cluster=2) == ((2, 2, 2, 2), 2)
    assert kedt.dt_route(P320, 1, cluster=0) == ((0, 0, 0, 0), 1)
    with pytest.raises(ValueError, match="one of"):
        kedt.dt_route(P320, 1, cluster=3)


# ---------------------------------------------------------------------------
# the wrapper's argument checks, before anything is built
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bool):
    return torch.empty(shape, dtype=dtype, device="meta")


_FAULTS = {
    "no levels": ((), 16, None, "tuple of 1 to 8 levels"),
    "nine levels": (tuple(_meta(1, 8, 8) for _ in range(9)), 16, None, "tuple of 1 to 8"),
    "rank": ((_meta(16, 24),), 16, None, r"must be \(B, H, W\)"),
    "dtype": ((_meta(1, 16, 24, dtype=torch.float32),), 16, None, "bool or uint8"),
    "strides": ((_meta(1, 16, 48)[:, :, ::2],), 16, None, "must be contiguous"),
    "batch": ((_meta(2, 16, 24), _meta(3, 8, 12)), 16, None, "has 3 images"),
    "device": ((_meta(1, 16, 24), torch.zeros((1, 8, 12), dtype=torch.bool)), 16, None,
               "is on cpu"),
    "one row": ((_meta(1, 1, 24),), 16, None, "unsupported shape"),
    "radius": ((_meta(1, 16, 24),), -1, None, "radius must be >= 0"),
    "size": ((_meta(1, 2048, 2048),), 16, None, r"fewer than 2\^22 pixels"),
    "side": ((_meta(1, 2561, 64),), 0, None, "at most 2560 a side"),
    "cluster": ((_meta(1, 16, 24),), 16, 3, "one of"),
    "meta": ((_meta(1, 16, 24), _meta(1, 8, 12)), 16, None, "unsupported device"),
    "meta forced": ((_meta(1, 2560, 1600),), 0, 8, "unsupported device"),
}


@pytest.mark.parametrize("fault", list(_FAULTS))
def test_dt_pyramid_rejects_bad_arguments_before_building(monkeypatch, fault):
    """Off the CPU `dt_pyramid` checks the levels, the radius and a forced
    cluster before it builds or binds anything (meta tensors stand in for a
    device without a kernel; a good pyramid stops at the device)."""
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(build, "bind", no_build)
    monkeypatch.setattr(build, "load", no_build)
    levels, radius, cluster, match = _FAULTS[fault]
    before = kedt.dt_pyramid.launches
    with pytest.raises(ValueError, match=match):
        kedt.dt_pyramid(levels, radius, True, True, cluster=cluster)
    assert kedt.dt_pyramid.launches == before


def test_dt_pyramid_on_cpu_is_the_plain_twin():
    edges = tuple(torch.from_numpy(_masks()[k][None].repeat(2, 0)) for k in
                  ("37x45", "single-column", "2xW"))
    for flags in ((16, False, True), (0, True, False)):
        got = kedt.dt_pyramid(edges, *flags)
        for lvl, (mine, plain) in enumerate(zip(got, kedt.dt_pyramid_plain(edges, *flags))):
            for a, b, c in zip(mine, plain, kedt.dt_channels(edges[lvl], *flags)):
                assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)
    assert kedt.dt_pyramid.launches == 0
