"""Keyframe extraction over a whole pyramid (`kernels/extract.py`,
`csrc/extract.cu`) on the CPU.

The CUDA kernel selects without a sort: a stable partition of the pixels in
descending priority (the host's `order` table), after a per-segment
candidate test from the segment table on the segmented branch (a short
path for segments with at most 32 high pixels). A numpy model of that
algorithm, both segment paths and chunk by chunk as the kernel runs it,
must give
`extract_ref_level`'s selection, order and count exactly: both branches,
padded tail segments, edge-free and all-edge images, depth below
`min_depth_mm` and fewer edges than slots. The wrapper on CPU tensors (the
plain version) is held against the JAX package's `extract_ref_features` to
tests/test_torch_extract.py's bars, and the CUDA wrapper's argument checks
run before anything is built."""

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
from rgbd_odometry_tpu_torch.config import SolverConfig  # noqa: E402
from rgbd_odometry_tpu_torch.core.camera import Intrinsics  # noqa: E402
from rgbd_odometry_tpu_torch.core.pyramid import build_pyramid  # noqa: E402
from rgbd_odometry_tpu_torch.io.synthetic import render_pair  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import build  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import extract as kex  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import edge_dvo as ted  # noqa: E402

torch.set_num_threads(1)

INTR = Intrinsics(fx=130.0, fy=130.0, cx=79.5, cy=59.5)


def kernel_model(mask: np.ndarray, k: int, segmented: bool, chunk: int = 1024 * 16):
    """The kernel's selection on one image: mask (n,) bool -> (idx (k,),
    valid (k,), count), from the wrapper's own tables, streaming `order`
    in chunks of `chunk` entries (csrc/extract.cu: kThreads * ITEMS)."""
    n = mask.size
    order = kex._order_table(n, "cpu").numpy()
    cand = np.ones(n, bool)
    if segmented:
        # a warp per segment, the kernel's two paths: with m <= 32 high
        # pixels every one of them and the first 32 - m lows among the
        # segment's first 32 offsets; else the first 32 high pixels
        seg = kex._segment_table(n, "cpu").numpy().reshape(-1, kex.SEGMENT).astype(np.int64)
        cand[:] = False
        for s, offs in enumerate(seg):
            p = s * kex.SEGMENT + offs
            real = p < n
            high = np.zeros(kex.SEGMENT, bool)
            high[real] = mask[p[real]]
            m = int(high.sum())
            if m <= 32:
                low = (real & ~high)[:32]
                keep = high.copy()
                keep[:32] |= low & (np.cumsum(low) - 1 < 32 - m)
            else:
                keep = high & (np.cumsum(high) - 1 < 32)
            cand[p[keep]] = True
    e = int((cand & mask).sum())
    need_high, need_low = min(e, k), max(k - e, 0)
    idx, valid = np.full(k, -1), np.zeros(k, bool)
    taken_high = taken_low = 0
    for c in range(0, order.size, chunk):
        if taken_high >= need_high and taken_low >= need_low:
            break
        px = order[c:c + chunk]
        p = np.maximum(px, 0)
        cls = (px >= 0) & cand[p]
        high, low = cls & mask[p], cls & ~mask[p]
        for sel, pos, v in ((high, taken_high + np.cumsum(high) - 1, True),
                            (low, e + taken_low + np.cumsum(low) - 1, False)):
            put = sel & (pos < k)
            idx[pos[put]], valid[pos[put]] = px[put], v
        taken_high += int(high.sum())
        taken_low += int(low.sum())
    assert (idx >= 0).all(), "a slot was not written"
    return idx, valid, need_high


def _inputs(kind: str, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(150.0, 4000.0, (1, h, w)).astype(np.float32)
    density = {"sparse": 0.03, "dense": 0.35, "edge-free": 0.0, "all-edge": 1.0,
               "shallow": 0.3, "few": 0.002}[kind]
    edges = rng.random((1, h, w)) < density
    if kind == "shallow":  # most edges at or below min_depth_mm
        depth[rng.random((1, h, w)) < 0.7] = 100.0
        depth[rng.random((1, h, w)) < 0.2] = 40.0
    return torch.from_numpy(edges), torch.from_numpy(depth)


CASES = [
    # (h, w, k, selection): the 4 production_320 levels, both branches; a
    # padded tail segment (37x45 = 6 segments + 129 pixels, 120x160 = 75,
    # 30x40 = 4 + 176); a capacity above the pixel count
    (240, 320, 2048, "segmented"), (240, 320, 8192, "exact"), (120, 160, 1024, "segmented"),
    (60, 80, 512, "segmented"), (30, 40, 512, "exact"), (30, 40, 128, "segmented"),
    (37, 45, 100, "segmented"), (37, 45, 2000, "exact"), (7, 9, 64, "segmented"),
]


@pytest.mark.parametrize("h,w,k,selection", CASES)
@pytest.mark.parametrize("kind", ["sparse", "dense", "edge-free", "all-edge", "shallow", "few"])
def test_kernel_model_equals_extract_ref_level(h, w, k, selection, kind):
    """Every slot (valid or not) holds the same pixel in the same order, and
    `count` is equal."""
    cfg = SolverConfig(method="gauss_newton", extract_selection=selection)
    edges, depth = _inputs(kind, h, w, seed=h * w + k)
    kk = min(k, h * w)
    ref = kex.extract_ref_level(None, depth, INTR, k, cfg, edges=edges)
    mask = (edges & (depth > cfg.min_depth_mm)).reshape(-1).numpy()
    idx, valid, count = kernel_model(mask, kk, kex.is_segmented(cfg, h * w, kk))
    uv = ref.uv[0].numpy().astype(np.int64)
    assert np.array_equal(uv[:, 1] * w + uv[:, 0], idx)
    assert np.array_equal(ref.valid[0].numpy(), valid)
    assert int(ref.count[0]) == count
    if kind == "edge-free":
        assert count == 0
    if kind == "all-edge" and selection == "exact":
        assert count == kk


@pytest.mark.parametrize("h,w,k,selection", [
    (720, 960, 8192, "segmented"), (720, 960, 4096, "exact"), (360, 480, 4096, "segmented"),
    (90, 120, 512, "segmented"), (37, 45, 2000, "exact"),
])
@pytest.mark.parametrize("kind", ["sparse", "dense", "shallow"])
def test_kernel_model_at_the_half_chunk_equals_extract_ref_level(h, w, k, selection, kind):
    """A pyramid whose level 0 is 960x720 (`dvo --cam-scale 3`) leaves too
    little shared memory beside its bitmaps for a chunk of 16384 entries, so
    the kernel streams 8192 at every level of that launch: the selection is
    the same at that chunk (the partition is stable whatever the chunk)."""
    assert kex.chunk_size(960 * 720) == 8192 and kex.chunk_size(640 * 480) == 1024 * 16
    cfg = SolverConfig(method="gauss_newton", extract_selection=selection)
    edges, depth = _inputs(kind, h, w, seed=h * w + k)
    kk = min(k, h * w)
    ref = kex.extract_ref_level(None, depth, INTR, k, cfg, edges=edges)
    mask = (edges & (depth > cfg.min_depth_mm)).reshape(-1).numpy()
    idx, valid, count = kernel_model(mask, kk, kex.is_segmented(cfg, h * w, kk), chunk=8192)
    uv = ref.uv[0].numpy().astype(np.int64)
    assert np.array_equal(uv[:, 1] * w + uv[:, 0], idx)
    assert np.array_equal(ref.valid[0].numpy(), valid)
    assert int(ref.count[0]) == count


@pytest.mark.parametrize("n", [1200, 1665, 19200, 76800])
def test_tables_follow_the_priority(n):
    """`order` lists every pixel once by descending priority, then -1s to a
    multiple of 4; each segment's table lists its pixels by descending
    priority, pads last."""
    pri = kex._priority(n, "cpu").numpy()
    order = kex._order_table(n, "cpu").numpy()
    assert order.size % 4 == 0 and (order[n:] == -1).all()
    assert np.array_equal(np.sort(order[:n]), np.arange(n))
    assert (np.diff(pri[order[:n]]) < 0).all()
    seg = kex._segment_table(n, "cpu").numpy().reshape(-1, kex.SEGMENT).astype(np.int64)
    for s, offs in enumerate(seg):
        p = s * kex.SEGMENT + offs
        real = p[p < n]
        assert np.array_equal(np.sort(offs), np.arange(kex.SEGMENT))
        assert (p[: real.size] == real).all() and (np.diff(pri[real]) < 0).all()


CAM = CameraConfig(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
MAX_POINTS = (2048, 512, 128)


@pytest.mark.parametrize("selection", ["exact", "segmented"])
def test_wrapper_on_cpu_matches_jax(selection):
    """`extract_pyramid` on CPU tensors (the plain version) against JAX's
    `extract_ref_features` on two rendered frames, 3 levels: the same valid
    points in the same order, `count` equal, pts3d to 1e-6, invalid slots
    zero (tests/test_torch_extract.py's bars)."""
    psi = np.array([0.012, -0.008, 0.006, 0.004, -0.005, 0.003], np.float32)
    (rg, rd), (ng, nd), _ = render_pair(CAM, psi, seed=0)
    cfg = dataclasses.replace(production_320().solver, extract_selection=selection)
    pyr = build_pyramid(torch.from_numpy(np.stack([rg, ng])), torch.from_numpy(np.stack([rd, nd])),
                        3)
    edges = ted._pyramid_edges(pyr.gray, cfg)
    got = kex.extract_pyramid(edges, pyr.depth, Intrinsics.from_config(CAM), cfg, MAX_POINTS)
    jintr = JIntrinsics.from_config(CAM)
    extract = jax.jit(lambda g, d: jed.extract_ref_features(g, d, jintr, cfg, MAX_POINTS))
    for b in range(2):
        want = extract(tuple(jnp.asarray(g[b].numpy()) for g in pyr.gray),
                       tuple(jnp.asarray(d[b].numpy()) for d in pyr.depth))
        for lvl, (w, t) in enumerate(zip(want, got)):
            msg = f"pair {b} level {lvl} ({selection})"
            valid = np.asarray(w.valid)
            assert valid.sum() > 20, msg
            np.testing.assert_array_equal(t.valid[b].numpy(), valid, err_msg=msg)
            assert int(t.count[b]) == int(w.count), msg
            np.testing.assert_array_equal(t.uv[b].numpy()[valid], np.asarray(w.uv)[valid],
                                          err_msg=msg)
            np.testing.assert_allclose(t.pts3d[b].numpy()[valid], np.asarray(w.pts3d)[valid],
                                       rtol=0, atol=1e-6, err_msg=msg)
            assert not t.pts3d[b].numpy()[~valid].any(), msg


def test_extract_ref_features_is_one_extract_pyramid_call(monkeypatch):
    """The solver's extraction makes one `extract_pyramid` call for every
    level, equal to `extract_ref_level` level by level."""
    base = torch.from_numpy(np.stack([render_pair(CAM, np.zeros(6, np.float32), seed=s)[0][0]
                                      for s in range(2)]))
    pyr = build_pyramid(base, torch.full_like(base, 1500.0), 3)
    cfg = production_320().solver
    calls = []
    real = ted.extract_pyramid
    monkeypatch.setattr(ted, "extract_pyramid", lambda *a, **k: calls.append(1) or real(*a, **k))
    feats = ted.extract_ref_features(pyr.gray, pyr.depth, INTR, cfg, MAX_POINTS)
    assert len(calls) == 1
    edges = ted._pyramid_edges(pyr.gray, cfg)
    for lvl, f in enumerate(feats):
        want = kex.extract_ref_level(None, pyr.depth[lvl], INTR.at_level(lvl), MAX_POINTS[lvl],
                                     cfg, edges=edges[lvl])
        for x, y in zip(f, want):
            assert torch.equal(x, y)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("fault", ["batch", "dtype", "depth", "strides", "rank", "levels",
                                   "capacity", "size", "device"])
def test_cuda_wrapper_rejects_bad_arguments_before_building(monkeypatch, fault):
    """Off the CPU the wrapper checks every level (bool (B, H, W) edges of
    one batch size, contiguous, a float32 depth of the same shape and
    device, a positive capacity, bitmaps that fit one block) and the level
    count before it builds or binds anything (meta tensors stand in for a
    device without a kernel)."""
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(build, "bind", no_build)
    monkeypatch.setattr(build, "load", no_build)
    shapes = [(2, 48, 64), (2, 24, 32), (2, 12, 16)]
    edges = [_meta(*s, dtype=torch.bool) for s in shapes]
    depth = [_meta(*s) for s in shapes]
    caps = [512, 256, 128]
    match = {"batch": "level 0", "dtype": "bool", "depth": "float32", "strides": "contiguous",
             "rank": "bool", "levels": "levels", "capacity": "capacity", "size": "too large",
             "device": "unsupported device"}[fault]
    if fault == "batch":
        edges[1] = _meta(3, 24, 32, dtype=torch.bool)
    elif fault == "dtype":
        edges[2] = _meta(2, 12, 16, dtype=torch.uint8)
    elif fault == "depth":
        depth[1] = _meta(2, 24, 32, dtype=torch.float64)
    elif fault == "strides":
        edges[1] = _meta(2, 24, 64, dtype=torch.bool)[:, :, ::2]
    elif fault == "rank":
        edges[0] = _meta(48, 64, dtype=torch.bool)
    elif fault == "levels":
        edges, depth, caps = edges * 3, depth * 3, caps * 3
    elif fault == "capacity":
        caps[2] = 0
    elif fault == "size":
        edges[0], depth[0] = _meta(1, 2048, 2048, dtype=torch.bool), _meta(1, 2048, 2048)
        edges[1:], depth[1:] = [], []
    before = kex.extract_pyramid.launches
    with pytest.raises(ValueError, match=match):
        kex.extract_pyramid(tuple(edges), tuple(depth), INTR, SolverConfig(), caps)
    assert kex.extract_pyramid.launches == before


@pytest.mark.parametrize("hw, fits", [((720, 960), True), ((768, 1024), True),
                                       ((720, 1280), False)])
def test_a_level_fits_one_block_up_to_its_shared_memory(monkeypatch, hw, fits):
    """A 960x720 level 0 (`dvo --cam-scale 3`) fits one block with the half
    chunk and passes the checks (which then stop at the device); a 1280x720
    one is refused before anything is built, naming the ROADMAP item that
    would split a level over blocks."""
    monkeypatch.setattr(build, "bind", lambda *a, **k: pytest.fail("built"))
    h, w = hw
    edges = tuple(_meta(1, h >> k, w >> k, dtype=torch.bool) for k in range(4))
    depth = tuple(_meta(1, h >> k, w >> k) for k in range(4))
    with pytest.raises(ValueError, match="unsupported device" if fits else
                       "ROADMAP.md Queue 2 item 7"):
        kex.extract_pyramid(edges, depth, INTR, SolverConfig(), (8192, 4096, 2048, 1024))
