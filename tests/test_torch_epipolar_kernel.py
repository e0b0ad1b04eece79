"""Kernel D's twin (`kernels/epipolar.fundamental_ransac_steps`, the CUDA
kernel's arithmetic in PyTorch) and the epipolar filter's sample on the
CPU, with JAX's draws replayed (as tests/test_torch_ransac.py replays them):

- the sample of `ops/epipolar` (plain route) and of the twin takes ties at
  the 8th place to the lower index, as `lax.top_k` does (`torch.topk` does
  not promise it), and a numpy model of the kernel's sample rounds (lane
  scans and two warp reductions) takes the same points in the same order;
- the twin against JAX's `ransac_fundamental_filter`: identical inliers and
  count on rendered near / far matches, seeds 0-2; on a well-posed two-view
  scene identical inliers and F within 1e-3 up to sign and scale; both
  pass-through guards;
- the Jacobi eigensolvers against numpy's `eigh`, the twin's square roots
  correctly rounded on the CPU (as CUDA's are), and the schedule compiled
  into `csrc/epipolar.cu` against the twin's;
- the CUDA wrapper refuses every device but CUDA.
"""

import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rgbd_odometry_tpu.config import CameraConfig  # noqa: E402
from rgbd_odometry_tpu.core import geometry as jgeo  # noqa: E402
from rgbd_odometry_tpu.core.camera import Intrinsics as JaxIntrinsics  # noqa: E402
from rgbd_odometry_tpu.io.synthetic import render_sequence  # noqa: E402
from rgbd_odometry_tpu.ops import epipolar as jepi  # noqa: E402
from rgbd_odometry_tpu.pipeline.kf_matcher import KeyframeMatcher  # noqa: E402
from rgbd_odometry_tpu_torch.kernels import epipolar as kepi  # noqa: E402
from rgbd_odometry_tpu_torch.ops import epipolar as pepi  # noqa: E402

torch.set_num_threads(2)
CAM = CameraConfig(width=160, height=120, fx=176.0, fy=176.0, cx=79.5, cy=59.5)
K = 384


def _draws(key, s: int, k: int) -> torch.Tensor:
    """The uniforms JAX's RANSAC draws from `key`: uniform(k_i, (k,)) for
    k_i in split(key, s)."""
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(jax.random.split(key, s))
    return torch.from_numpy(np.array(u))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _same_up_to_sign_and_scale(Fp, Fj, tol):
    Fp, Fj = Fp / np.linalg.norm(Fp), Fj / np.linalg.norm(Fj)
    return min(np.abs(Fp - Fj).max(), np.abs(Fp + Fj).max()) < tol


@pytest.fixture(scope="module", params=[(0, 2), (0, 5)], ids=["near", "far"])
def corr(request):
    """Matched pixel pairs of rendered frames a (stored) and b (query), as
    tests/test_torch_ransac.py builds them with the JAX matcher."""
    a, b = request.param
    ts = np.arange(6)
    amp = 0.05
    psis = np.stack([amp * ts / 5, -0.5 * amp * ts / 5, 0.3 * amp * ts / 5,
                     0.2 * amp * ts / 5, -0.2 * amp * ts / 5, 0.1 * amp * ts / 5],
                    -1).astype(np.float32)
    frames, _ = render_sequence(CAM, psis, seed=0)
    m = KeyframeMatcher(JaxIntrinsics.from_config(CAM))
    old = m.describe(*frames[a])
    q = m.detect(frames[b][0])
    m.store(old)
    all_m, _ = m.match_all(q)
    mt = jax.tree_util.tree_map(lambda x: x[0], all_m)
    uv_old = jnp.take(old.kps.uv, mt.ref_idx, axis=0)
    valid = mt.good & q.valid & jnp.take(old.kps.valid, mt.ref_idx, axis=0)
    return dict(uv1=q.uv, uv2=uv_old, valid=valid)


def _general_scene(seed: int, n: int = 96):
    """test_torch_ransac.py's well-posed scene: random points at spread
    depths from two poses, a quarter of the pairs corrupted, 6 invalid."""
    rng = np.random.default_rng(seed)
    P = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), rng.uniform(1.5, 5, n)], -1)
    R, t = (np.asarray(x, np.float64) for x in jgeo.se3_exp(
        jnp.asarray([0.12, -0.04, 0.03, 0.02, 0.05, -0.01], jnp.float32)))
    Q = (P - t) @ R

    def proj(X):
        return np.stack([176.0 * X[:, 0] / X[:, 2] + 79.5, 176.0 * X[:, 1] / X[:, 2] + 59.5], -1)

    uv1, uv2 = proj(Q), proj(P)
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)
    bad = rng.random(n) < 0.25
    uv1[bad] += rng.uniform(-25, 25, (int(bad.sum()), 2))
    valid = np.ones(n, bool)
    valid[-6:] = False
    return uv1.astype(np.float32), uv2.astype(np.float32), valid


def _tied_draw(k: int = 24, s: int = 16):
    """Uniforms on a grid of quarters (many ties), valid and not; row 0 has
    four equal scores across the 8th place."""
    rng = np.random.default_rng(k)
    u = (np.floor(rng.random((s, k)) * 4) / 4).astype(np.float32)
    valid = rng.random(k) < 0.7
    valid[:12] = True
    u[0, :12] = [0.75] * 6 + [0.5] * 4 + [0.25, 0.25]  # places 7-10 tie at 0.5
    u[0, 12:] = 0.0
    return u, valid


def _jax_top8(u, valid) -> np.ndarray:
    scores = u + np.where(valid, 1.0, -1.0).astype(np.float32)
    return np.stack([np.asarray(jax.lax.top_k(jnp.asarray(row), 8)[1]) for row in scores])


def _kernel_rounds(u: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The kernel's sample (csrc/epipolar.cu step 2): 8 rounds, each lane
    scanning its points l, l + 32, ... for the first largest score after the
    last point taken in descending (score, -index), then the warp's largest
    key and the lowest index holding it. (S, 8) indices in round order."""
    scores = (u + np.where(valid, 1.0, -1.0).astype(np.float32)).astype(np.float32)
    bits = scores.view(np.uint32).astype(np.int64)
    keys = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    s_n, k = u.shape
    out = np.zeros((s_n, 8), np.int64)
    for h in range(s_n):
        last_key, last_i = 1 << 32, -1
        for r in range(8):
            best = []
            for lane in range(32):
                pts = [i for i in range(lane, k, 32)
                       if keys[h, i] < last_key or (keys[h, i] == last_key and i > last_i)]
                if pts:
                    i = max(pts, key=lambda j: (scores[h, j], -j))
                    best.append((keys[h, i], i))
            top = max(kk for kk, _ in best)
            last_key, last_i = top, min(i for kk, i in best if kk == top)
            out[h, r] = last_i
    return out


def test_sample_takes_ties_as_lax_top_k(monkeypatch):
    """A tie at the 8th place: the plain route's sample (the weights it
    hands `_eight_point`), the twin's sample order and the kernel's rounds
    are all `lax.top_k`'s."""
    u, valid = _tied_draw()
    want = _jax_top8(u, valid)
    np.testing.assert_array_equal(kepi.sample_order(torch.from_numpy(u),
                                                    torch.from_numpy(valid)).numpy(), want)
    np.testing.assert_array_equal(_kernel_rounds(u, valid), want)
    seen = []
    monkeypatch.setattr(pepi, "_eight_point",
                        lambda a, b, w: seen.append(w.clone()) or torch.zeros((w.shape[0], 3, 3)))
    rng = np.random.default_rng(0)
    uv = torch.from_numpy(rng.uniform(0, 100, (u.shape[1], 2)).astype(np.float32))
    pepi.ransac_fundamental_filter(torch.from_numpy(u), uv, uv + 1.0, torch.from_numpy(valid))
    mask = np.zeros(u.shape, bool)
    for h in range(u.shape[0]):
        mask[h, want[h]] = True
    np.testing.assert_array_equal(seen[0].numpy() > 0, mask & valid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_matches_jax_on_rendered_matches(corr, seed):
    key = jax.random.PRNGKey(seed)
    c = corr
    want = jepi.ransac_fundamental_filter(key, c["uv1"], c["uv2"], c["valid"])
    inl, num, F, counts = kepi.fundamental_ransac_steps(_draws(key, 64, K), _t(c["uv1"]),
                                                        _t(c["uv2"]), _t(c["valid"]))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(want.inliers))
    assert int(num) == int(want.num_inliers) > 0
    assert counts.shape == (64,) and int(counts.max()) == int(num)
    d = pepi.sampson_distance(F, _t(c["uv1"]), _t(c["uv2"]))[inl]
    assert float(d.max()) < 9.0


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_jax_on_a_well_posed_scene(seed):
    uv1, uv2, valid = _general_scene(seed)
    key = jax.random.PRNGKey(seed)
    want = jepi.ransac_fundamental_filter(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                          jnp.asarray(valid))
    args = (_draws(key, 64, len(valid)), torch.from_numpy(uv1), torch.from_numpy(uv2),
            torch.from_numpy(valid))
    inl, num, F, counts = kepi.fundamental_ransac_steps(*args)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(want.inliers))
    assert int(num) >= int(0.6 * len(valid))
    assert _same_up_to_sign_and_scale(F.numpy(), np.asarray(want.F), 1e-3)
    assert counts.shape == (64,) and int(counts.max()) == int(num)


def test_twin_pass_through_guards(corr):
    c = corr
    key = jax.random.PRNGKey(3)
    # fewer than 8 match slots: the entry point's static guard, as in JAX
    five = pepi.ransac_fundamental_filter(_draws(key, 64, 5), _t(c["uv1"][:5]),
                                          _t(c["uv2"][:5]), torch.ones(5, dtype=torch.bool))
    assert five.inliers.all() and int(five.num_inliers) == 5 and not five.F.any()
    with pytest.raises(ValueError, match="fewer than"):
        kepi.fundamental_ransac_steps(_draws(key, 64, 5), _t(c["uv1"][:5]), _t(c["uv2"][:5]),
                                      torch.ones(5, dtype=torch.bool))
    # fewer than min_points valid candidates: every candidate passes
    few = np.zeros(K, bool)
    few[np.nonzero(np.asarray(c["valid"]))[0][:6]] = True
    want = jepi.ransac_fundamental_filter(key, c["uv1"], c["uv2"], jnp.asarray(few))
    inl, num, _, _ = kepi.fundamental_ransac_steps(_draws(key, 64, K), _t(c["uv1"]),
                                                   _t(c["uv2"]), torch.from_numpy(few))
    np.testing.assert_array_equal(inl.numpy(), few)
    np.testing.assert_array_equal(np.asarray(want.inliers), few)
    assert int(num) == 6


@pytest.mark.parametrize("n,schedule", [(9, kepi.SCHEDULE9), (3, kepi.SCHEDULE3)])
def test_jacobi_is_an_eigendecomposition(n, schedule):
    """Random symmetric matrices, a rank-deficient normal matrix (8 rows of
    9) among them: eigenvalues within 1e-12 of numpy's (relative to the
    largest), A V = V diag, V orthonormal."""
    rng = np.random.default_rng(n)
    X = rng.normal(size=(6, n, n))
    A = X + X.transpose(0, 2, 1)
    if n == 9:
        R = rng.normal(size=(8, 9))
        A[0] = R.T @ R
    D, V = kepi.jacobi(torch.from_numpy(A), schedule)
    lam = torch.diagonal(D, dim1=1, dim2=2).numpy()
    V = V.numpy()
    for b in range(len(A)):
        scale = np.abs(lam[b]).max()
        np.testing.assert_allclose(np.sort(lam[b]), np.linalg.eigvalsh(A[b]), rtol=0,
                                   atol=1e-12 * scale)
        np.testing.assert_allclose(A[b] @ V[b], V[b] * lam[b], rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(V[b].T @ V[b], np.eye(n), rtol=0, atol=1e-12)


def test_twin_square_roots_are_correctly_rounded():
    """The twin's float64 and float32 square roots on the CPU are the
    correctly rounded ones (Python's `math.sqrt`, and its float64 result
    rounded once), as CUDA's are: 1 + tau^2 of a rendered feature-vo
    filter's first rotation, whose root torch's CPU sqrt takes 1 ulp off,
    among seeded values."""
    rng = np.random.default_rng(0)
    x = np.concatenate([[1.4062854561636497], 1.0 + rng.random(4096) ** 2,
                        10.0 ** rng.uniform(-30, 30, 4096)])
    got = kepi._sqrt64(torch.from_numpy(x)).numpy()
    assert got.tolist() == [math.sqrt(v) for v in x.tolist()]
    x32 = x.astype(np.float32)
    got32 = kepi._sqrt_f32(torch.from_numpy(x32)).numpy()
    assert np.array_equal(got32, np.array([math.sqrt(float(v)) for v in x32], np.float32))
    assert float(kepi._sqrt64(torch.tensor(2.0, dtype=torch.float64))) == math.sqrt(2.0)


def test_kernel_schedule_is_the_twins():
    src = (pathlib.Path(kepi.__file__).parent.parent / "csrc" / "epipolar.cu").read_text()
    for name, schedule in (("kSchedule9", kepi.SCHEDULE9), ("kSchedule3", kepi.SCHEDULE3)):
        body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        pairs = [tuple(map(int, p)) for p in re.findall(r"\{(\d+), (\d+)\}", body)]
        assert pairs == [p for rnd in schedule for p in rnd]
    assert f"kSweeps = {kepi.SWEEPS};" in src and "kTol = 0x1p-40;" in src
    assert kepi.TOL == 2.0 ** -40


def test_cuda_wrapper_refuses_other_devices(corr):
    c = corr
    u = _draws(jax.random.PRNGKey(0), 64, K)
    with pytest.raises(ValueError, match="unsupported device"):
        kepi.fundamental_ransac(u, _t(c["uv1"]), _t(c["uv2"]), _t(c["valid"]))
    meta = [x.to("meta") for x in (u, _t(c["uv1"]), _t(c["uv2"]), _t(c["valid"]))]
    with pytest.raises(ValueError, match="unsupported device"):
        pepi.ransac_fundamental_filter(*meta)
