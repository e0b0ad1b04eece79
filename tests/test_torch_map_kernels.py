"""The map backend's two kernels on the CPU: models of what the CUDA kernels
do differently from their plain versions, held bitwise to those plain
versions, and the RANSAC PnP route against the JAX package.

- `match_mutual` (`csrc/match.cu`): a numpy model of the tiled one-pass
  merge (compacted valid keypoints, random tilings of the query rows and the
  slot keypoints, rank splits, merge orders; rows as running (best, index,
  second) summaries, columns as 64-bit (d2 bits, index) keys) against
  `match_mutual_plain` at both gate floors, on descriptors with duplicate
  rows and forced ties.
- `ransac_pnp` (`csrc/pnp_gn.cu`): a model of the 128-virtual-lane warp sum
  (a lane is virtual threads l, l + 32, l + 64, l + 96; the tree's first two
  levels in the lane, the last five a shuffle-down tree) against
  `_block_sum`; the sample's selection against `lax.top_k` on tied scores
  (which `torch.topk` resolves otherwise); the RANSAC route against JAX's
  `ransac_pnp` with fewer than four valid points, none valid and tied best
  counts; the wrappers' argument checks. Past 1024 points: the large
  route's sample rule against the stable sort, and both sum layouts
  against `_block_sum` at any K.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.solvers import pnp as jpnp  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import match as kmatch  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import pnp_gn  # noqa: E402
from rgbd_odometry_tpu_torch.solvers import pnp as ppnp  # noqa: E402

torch.set_num_threads(2)
BIG = np.float32(1e9)
NONE = 2**31 - 1


# ---------------------------------------------------------------------------
# match_mutual: the tiled one-pass merge


def _descriptors(seed: int, s: int, k: int):
    """S slots and a query of K unit descriptors with duplicate rows (equal
    d2 down a column), duplicated slot keypoints (equal d2 along a row), a
    slot holding the query itself, random validity and an empty slot."""
    rng = np.random.default_rng(seed)
    unit = lambda *shape: (lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True))(  # noqa: E731
        rng.normal(size=shape + (64,))).astype(np.float32)
    q = unit(k)
    q[5] = q[2]
    q[9] = q[2]
    slots = unit(s, k)
    slots[0] = q + rng.normal(0, 0.05, q.shape).astype(np.float32)
    slots[0] /= np.linalg.norm(slots[0], axis=-1, keepdims=True)
    slots[1] = q  # the query's own duplicate: true distances are ulps from 0
    slots[2, 7] = slots[2, 3]
    slots[2, 11] = slots[2, 3]
    slots[3, :, :] = slots[3, 0]  # every keypoint alike: every row and column tied
    qv = rng.random(k) < 0.8
    sv = rng.random((s, k)) < 0.7
    sv[1] = True
    sv[-1] = False
    return (torch.from_numpy(slots), torch.from_numpy(sv), torch.from_numpy(q),
            torch.from_numpy(qv))


def _cuts(rng, n: int) -> list:
    """A random split of range(n) into consecutive runs."""
    edges = sorted(set(rng.integers(0, n + 1, rng.integers(0, 4)).tolist()) | {0, n})
    return [range(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _row_merge(a, b):
    """Merge row summary b (best, arg, second) into a, as csrc/match.cu's
    row_merge: the lexicographic minimum of (best, arg), second the least
    of the rest."""
    if b[0] < a[0] or (b[0] == a[0] and b[1] < a[1]):
        return b[0], b[1], min(b[2], a[0])
    return a[0], a[1], min(a[2], b[0])


def _tiled_match(d2, sv, qv, factor, ratio, floor, rng):
    """csrc/match.cu's algorithm on one slot's d2 (Kq, Kr) float32: compacted
    valid rows and columns, `ranks` runs of the query rows, each cut into
    random tiles of rows and of columns visited in random orders."""
    qi, rj = np.nonzero(qv)[0], np.nonzero(sv)[0]
    nq, nr = len(qi), len(rj)
    ranks = int(rng.choice([1, 2, 4, 8]))
    rows = [(BIG, NONE, BIG)] * nq
    keys = np.full((ranks, max(nr, 1)), np.uint64(2**64 - 1), np.uint64)
    for r in range(ranks):
        q0, q1 = nq * r // ranks, nq * (r + 1) // ranks
        for tile in _cuts(rng, q1 - q0):
            xs = [q0 + t for t in tile]
            col_tiles = _cuts(rng, nr)
            parts = {x: [] for x in xs}
            for ct in [col_tiles[i] for i in rng.permutation(len(col_tiles))]:
                for x in xs:  # the running summary over a tile's columns, ascending
                    best, arg, second = BIG, NONE, BIG
                    for jj in ct:
                        v = d2[qi[x], rj[jj]]
                        if v < best:
                            best, arg, second = v, jj, best
                        elif v < second:
                            second = v
                    parts[x].append((best, arg, second))
                for jj in ct:  # each column's (d2, row) over the tile's rows
                    vals = [(d2[qi[x], rj[jj]], x) for x in xs]
                    v, x = min(vals, key=lambda p: (p[0], p[1]))
                    key = np.uint64((int(np.float32(v).view(np.uint32)) << 32) | x)
                    keys[r, jj] = min(keys[r, jj], key)
            for x in xs:
                acc = (BIG, NONE, BIG)
                for i in rng.permutation(len(parts[x])):
                    acc = _row_merge(acc, parts[x][i])
                rows[x] = acc
    k = len(qv)
    ref = np.zeros(k, np.int64)
    dist = np.full(k, np.sqrt(BIG), np.float32)
    good = np.zeros(k, bool)
    bests = np.array([b for b, _, _ in rows], np.float32)
    min_d = np.sqrt(bests).min() if nq else np.float32(np.inf)
    gate = max(np.float32(factor) * min_d, np.float32(floor))
    for x, (best, arg, second) in enumerate(rows):
        i = qi[x]
        dist[i] = np.sqrt(np.float32(best))
        ref[i] = 0 if arg == NONE else rj[arg]
        mutual = arg != NONE and int(keys[:, arg].min() & np.uint64(0xFFFFFFFF)) == x
        good[i] = (mutual and dist[i] <= gate and best <= np.float32(ratio * ratio) * second
                   and best < BIG * np.float32(0.5))
    return ref, dist, good, np.int32(good.sum())


@pytest.mark.parametrize("floor", [1e-3, 0.2])
@pytest.mark.parametrize("seed", [0, 1])
def test_tiled_one_pass_merge_is_the_plain_match(seed, floor):
    sd, sv, qd, qv = _descriptors(seed, 6, 40)
    want = kmatch.match_mutual_plain(sd, sv, qd, qv, 3.0, 0.9, floor)
    d2 = kmatch.pair_d2(sd, sv, qd, qv).numpy()
    assert int(want[3][1]) > 0 and int(want[3][-1]) == 0
    rng = np.random.default_rng(seed + 10)
    for _ in range(3):  # random tilings, rank splits and merge orders
        for s in range(sd.shape[0]):
            ref, dist, good, num = _tiled_match(d2[s], sv[s].numpy(), qv.numpy(), 3.0, 0.9,
                                                floor, rng)
            np.testing.assert_array_equal(ref, want[0][s].numpy())
            np.testing.assert_array_equal(dist.view(np.int32), want[1][s].numpy().view(np.int32))
            np.testing.assert_array_equal(good, want[2][s].numpy())
            assert num == int(want[3][s])


def test_cluster_size_fills_the_card():
    """Blocks a slot: S x blocks on at most the SMs, 1 past them."""
    assert [kmatch.cluster_size(s, 132) for s in (1, 16, 17, 33, 34, 66, 67, 132, 512)] == \
        [8, 8, 4, 4, 2, 2, 1, 1, 1]


def test_match_mutual_checks_its_arguments():
    sd, sv, qd, qv = (x.to("meta") for x in _descriptors(0, 5, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        kmatch.match_mutual(sd, sv, qd, qv)


# ---------------------------------------------------------------------------
# ransac_pnp: the warp sum, the sample, the RANSAC route


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, K, C) masked terms -> (B, C) as csrc/pnp_gn.cu's warp does: lane l
    sums virtual threads l + 32 m (their points v, v + 128, ... from 0.0 in
    order), folds (a0 + a2) + (a1 + a3), then a shuffle-down tree over the
    32 lanes (lane l adds lane l + o at o = 16, 8, 4, 2, 1)."""
    b, k, c = x.shape
    a = torch.zeros((b, 4, 32, c), dtype=torch.float32)
    for m in range(4):
        for lane in range(32):
            v = lane + 32 * m
            acc = torch.zeros((b, c), dtype=torch.float32)
            for i in range(v, k, 128):
                acc = acc + x[:, i]
            a[:, m, lane] = acc
    lanes = (a[:, 0] + a[:, 2]) + (a[:, 1] + a[:, 3])
    o = 16
    while o >= 1:
        lanes = torch.cat([lanes[:, :o] + lanes[:, o : 2 * o], lanes[:, o:]], dim=1)
        o //= 2
    return lanes[:, 0]


@pytest.mark.parametrize("k,points", [(384, 4), (384, 384), (300, 200), (100, 60), (130, 4)])
def test_warp_sum_is_the_block_sum(k, points):
    rng = np.random.default_rng(k + points)
    x = torch.from_numpy(rng.normal(size=(3, k, 27)).astype(np.float32))
    mask = torch.zeros((3, k), dtype=torch.bool)
    for b in range(3):
        mask[b, torch.from_numpy(rng.choice(k, points, replace=False))] = True
    x = torch.where(mask[..., None], x, torch.zeros_like(x))
    got, want = _warp_sum(x), pnp_gn._block_sum(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _warp_tree(lanes: torch.Tensor) -> torch.Tensor:
    """csrc/warp.cuh's warp_tree for N = 27 or 28 sums (P = 32 slots): at
    each offset o = 16, ..., 1 lane l keeps the half of its slots [0, 2o)
    its bit o names and adds the other half of lane l ^ o's. lanes (32, N,
    B) -> (N, B), sum m from lane m's slot 0."""
    n, b = lanes.shape[1:]
    x = torch.zeros((32, 32, b), dtype=torch.float32)
    x[:, :n] = lanes
    lane = torch.arange(32)
    o = 16
    while o >= 1:
        hi = ((lane & o) != 0)[:, None, None]
        keep = torch.where(hi, x[:, o : 2 * o], x[:, :o])
        send = torch.where(hi, x[:, :o], x[:, o : 2 * o])
        x = keep + send[lane ^ o]
        o //= 2
    return x[:n, 0]


def _warp_route_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, K, N) terms, (B, K) mask -> (B, N) as a warp of csrc/pnp_gn.cu
    sums a problem (LaneSums, ransac_pnp_kernel's hypotheses): lane l takes
    its masked points l + 32 q chunk by chunk (q0 = 0, 32, ...; bit b of a
    chunk is q = q0 + b) into virtual thread l + 32 (b % 4)'s running sum,
    folds (v0 + v2) + (v1 + v3), then warp_tree."""
    b, k, n = x.shape
    lanes = torch.zeros((32, n, b), dtype=torch.float32)
    for lane in range(32):
        v = [torch.zeros((n, b), dtype=torch.float32) for _ in range(4)]
        for q0 in range(0, -(-k // 32), 32):
            for bit in range(32):
                i = lane + 32 * (q0 + bit)
                if i < k:
                    m = mask[:, i]
                    v[bit % 4] = torch.where(m, v[bit % 4] + x[:, i].T, v[bit % 4])
        lanes[lane] = (v[0] + v[2]) + (v[1] + v[3])
    return _warp_tree(lanes).T


def _split_route_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, K, N) terms, (B, K) mask -> (B, N) as a block of four warps sums
    a problem (pnp_gn_kernel, ransac_pnp_kernel's refine): thread v takes its masked points v + 128 j in ascending j, warp
    0's lane l folds (red[l] + red[l + 64]) + (red[l + 32] + red[l + 96]) from
    shared memory, then warp_tree."""
    b, k, n = x.shape
    red = torch.zeros((128, n, b), dtype=torch.float32)
    for v in range(128):
        acc = torch.zeros((n, b), dtype=torch.float32)
        for i in range(v, k, 128):
            acc = torch.where(mask[:, i], acc + x[:, i].T, acc)
        red[v] = acc
    return _warp_tree((red[:32] + red[64:96]) + (red[32:64] + red[96:])).T


@pytest.mark.parametrize("route", ["warp", "split"])
@pytest.mark.parametrize("k", [1, 31, 33, 54, 127, 384, 1025, 4097])
def test_pnp_gn_routes_sum_as_the_block_sum(k, route):
    """Both layouts of csrc/pnp_gn.cu's sums, a problem on a warp ("warp":
    ransac_pnp_kernel's hypotheses) and on a block of four warps ("split":
    pnp_gn_kernel and the refine), assign the points to the 128 virtual
    threads and add them up in `_block_sum`'s bits (the plain version's
    order) for 28 sums over masked points at any K: masks from 3% to 100%
    of the points."""
    rng = np.random.default_rng(k)
    b = 3
    x = torch.from_numpy(rng.normal(size=(b, k, 28)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, k)) < np.array([[0.03], [0.5], [1.0]]))
    want = pnp_gn._block_sum(torch.where(mask[..., None], x, torch.zeros_like(x)))
    got = (_warp_route_sum if route == "warp" else _split_route_sum)(x, mask)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _ordered(f: np.ndarray) -> np.ndarray:
    """csrc/pnp_gn.cu's `ordered`: float32 bits as uint32 keys in the
    floats' order."""
    u = f.astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _large_route_sample(u: np.ndarray, valid: np.ndarray, size: int) -> np.ndarray:
    """(S, K) samples as ransac_pnp_kernel's large route (K > 1024) takes
    them, with no word of taken points: a round's open points are those
    after the last one taken in descending (key, -index); lane l takes its
    first largest open score among points l + 32 q, the warp the largest
    key, then the lowest index holding it; the pick is kept if valid."""
    s, k = u.shape
    sel = np.zeros((s, k), bool)
    idx = np.arange(k)
    for h in range(s):
        sc = u[h] + np.where(valid, np.float32(1), np.float32(-1))
        key = _ordered(sc)
        last_key, last_i = 0xFFFFFFFF, -1
        for _ in range(size):
            open_ = (key < last_key) | ((key == last_key) & (idx > last_i))
            best = []  # each lane's (key, index)
            for lane in range(32):
                pts = idx[lane::32][open_[lane::32]]
                if len(pts):
                    i = pts[np.argmax(sc[pts])]  # the first largest
                    best.append((int(key[i]), int(i)))
            top = max(kk for kk, _ in best)
            pick = min(i for kk, i in best if kk == top)
            sel[h, pick] |= bool(valid[pick])
            last_key, last_i = top, pick
    return sel


@pytest.mark.parametrize("k,size", [(1025, 4), (2048, 4), (4097, 37)])
def test_large_route_sample_is_the_stable_sort(k, size):
    """Past 1024 points the fused kernel knows a taken point by its place in
    the order, not by a bit: on heavily tied scores, valid and not, its
    rounds take the sample `select_sample` takes (a stable descending
    sort, `lax.top_k`'s ties to the lower index)."""
    rng = np.random.default_rng(k)
    u = (np.floor(rng.random((8, k)) * 4) / 4).astype(np.float32)
    valid = rng.random(k) < 0.7
    want = pnp_gn.select_sample(torch.from_numpy(u), torch.from_numpy(valid), size).numpy()
    np.testing.assert_array_equal(_large_route_sample(u, valid, size), want)


@pytest.mark.parametrize("k", [7, 24, 384])
def test_sample_takes_ties_as_lax_top_k(k):
    """Tied scores at the sample's boundary: the sample is the one
    `lax.top_k` takes (the lower indices). `torch.topk` does not promise
    that, and at small K takes others: the row [0.5, 0.9, 0.9, 0.1, 0.9,
    0.9, 0.2] gives it points 1, 5 and 4 of the three largest, JAX 1, 2
    and 4."""
    s, size = 16, 3 if k == 7 else 4
    rng = np.random.default_rng(k)
    u = np.floor(rng.random((s, k)) * 4).astype(np.float32) / 4  # many ties
    valid = rng.random(k) < 0.7
    if k == 7:
        u[0] = [0.5, 0.9, 0.9, 0.1, 0.9, 0.9, 0.2]
        valid[:] = True
    scores = u + np.where(valid, 1.0, -1.0).astype(np.float32)
    want = np.zeros((s, k), bool)
    for h in range(s):
        want[h, np.asarray(jax.lax.top_k(jnp.asarray(scores[h]), size)[1])] = True
    want &= valid
    ut, vt = torch.from_numpy(u), torch.from_numpy(valid)
    np.testing.assert_array_equal(pnp_gn.select_sample(ut, vt, size).numpy(), want)
    if k == 7:
        topk = torch.zeros((s, k), dtype=torch.bool).scatter_(
            1, torch.topk(ut + torch.where(vt, 1.0, -1.0), size, dim=-1).indices, True) & vt
        assert not np.array_equal(topk[0].numpy(), want[0])


def _pnp_problem(seed: int, k: int = 384, noise: float = 0.001, outliers: float = 0.15):
    rng = np.random.default_rng(seed)
    obj = np.stack([rng.uniform(-1.2, 1.2, k), rng.uniform(-0.9, 0.9, k),
                    rng.uniform(1.0, 3.0, k)], -1).astype(np.float32)
    R, t = (np.asarray(x, np.float64) for x in jgeo.se3_exp(
        jnp.asarray([0.03, -0.02, 0.01, 0.02, -0.03, 0.01], jnp.float32)))
    pq = (obj - t) @ R
    imn = pq[:, :2] / pq[:, 2:] + rng.normal(0, noise, (k, 2))
    bad = rng.random(k) < outliers
    imn[bad] += rng.uniform(-0.1, 0.1, (int(bad.sum()), 2))
    return obj, imn.astype(np.float32), rng


def _draws(key, s: int, k: int) -> np.ndarray:
    return np.array(jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(jax.random.split(key, s)))


def _both(obj, imn, valid, seed: int):
    key = jax.random.PRNGKey(seed)
    want = jpnp.ransac_pnp(key, jnp.asarray(obj), jnp.asarray(imn), jnp.asarray(valid))
    got = ppnp.ransac_pnp(torch.from_numpy(_draws(key, 64, len(valid))), torch.from_numpy(obj),
                          torch.from_numpy(imn), torch.from_numpy(valid))
    return got, want


@pytest.mark.parametrize("n_valid", [0, 1, 3])
def test_ransac_pnp_with_few_valid_points_matches_jax(n_valid):
    """Fewer than four valid points (every sample is all of them) and none
    (every count 0: hypothesis 0, no inliers, the start pose back)."""
    obj, imn, rng = _pnp_problem(1)
    valid = np.zeros(len(obj), bool)
    valid[rng.choice(len(obj), n_valid, replace=False)] = True
    got, want = _both(obj, imn, valid, 0)
    assert int(got.best_hypothesis) == int(want.best_hypothesis)
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-5)
    if n_valid == 0:
        assert int(got.best_hypothesis) == 0 and int(got.num_inliers) == 0
        assert not got.inliers.any()
        assert torch.equal(got.R, torch.eye(3)) and not got.t.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_pnp_tied_best_counts_take_the_first(seed):
    """Noise-free correspondences without outliers: every hypothesis finds
    every valid point, the counts tie, and the first hypothesis wins, in
    the port as in JAX."""
    obj, imn, rng = _pnp_problem(seed, noise=0.0, outliers=0.0)
    valid = rng.random(len(obj)) < 0.9
    got, want = _both(obj, imn, valid, seed)
    assert int(got.best_hypothesis) == int(want.best_hypothesis) == 0
    assert int(got.num_inliers) == int(want.num_inliers) == int(valid.sum())
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-5)


def test_ransac_pnp_checks_its_arguments():
    obj, imn, _ = _pnp_problem(0, k=16)
    args = [torch.rand((4, 16)), torch.from_numpy(obj), torch.from_numpy(imn),
            torch.ones(16, dtype=torch.bool)]
    with pytest.raises(ValueError, match="unsupported device"):
        pnp_gn.ransac_pnp(*(x.to("meta") for x in args))
    cpu = pnp_gn.ransac_pnp(*args)
    assert cpu.best_hypothesis.dtype == torch.int64 and cpu.num_inliers.dtype == torch.int32
    assert cpu.inliers.shape == (16,) and cpu.R.shape == (3, 3) and cpu.t.shape == (3,)
