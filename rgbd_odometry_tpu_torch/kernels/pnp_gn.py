"""Kernel B: RANSAC PnP (`csrc/pnp_gn.cu`), whole in one launch or step by step.

Replaces JAX's `gn_pnp` (`rgbd_odometry_tpu/solvers/pnp.py:46-97`) and
`ransac_pnp` (:116-166; XLA, no Pallas kernel): per hypothesis the
`sample_size` largest uniforms biased to the valid points, a fixed number of
Gauss-Newton iterations of the reference's normalized-plane PnP
(`SolvePnP::PnP`, src/SolvePnP.cpp:148-203) on them, the inlier count; then
the first best hypothesis refined on its inliers. Two entry points:

- `ransac_pnp`: CPU tensors go to the step-by-step route `ransac_pnp_steps`
  over the plain version `pnp_gn_plain`; CUDA tensors to the fused kernel,
  one launch a verification at any K up to `max_points` (192512 on an
  H100; a warp a hypothesis, the argmax across a thread-block cluster, the
  refine in the same launch); anything else raises.
- `pnp_gn`: B independent Gauss-Newton problems over the same K
  correspondences and their inlier counts, which the step-by-step route
  calls twice (the hypotheses at B = 64, the refine at B = 1), and
  `solvers/pnp.gn_pnp` once (B = 1 from the identity, with the residual
  norm before each iteration): CPU tensors go to `pnp_gn_plain`, CUDA
  tensors to its kernel, a block of four warps a problem; `chip_smoke.py`
  holds the fused kernel to the step-by-step route over it bit for bit.

The plain version performs the kernel's operations in the kernel's order:
each per-point term with one rounding per operation, the sums over points
as each of 128 virtual threads' running sum followed by the fixed pairwise
tree (the kernels' lanes and warps take the threads' places, `_block_sum`),
the 6x6 Cholesky and `se3_exp` element by element through the twins of
`csrc/se3.cuh` in `kernels/se3_plain.py` (sin and cos in float64, rounded
once; square roots correctly rounded). Kernel and plain version therefore
agree to the last bit, so that ill-conditioned 4-point hypotheses cannot
amplify a summation-order difference. The fused kernel takes the sample by
`lax.top_k`'s rule (ties to the lower index), which `ransac_pnp_steps`
takes with a stable sort (`torch.topk` does not keep it).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from rgbd_odometry_tpu_torch.kernels import build
from rgbd_odometry_tpu_torch.kernels.se3_plain import chol_solve6, mat3, se3_exp, sqrt

THREADS = 128  # the virtual threads: the partial-sum layout every version shares
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float]
    + [ctypes.c_void_p] * 7
)
_RANSAC_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_void_p] * 6
)


class RansacResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (K,) bool
    num_inliers: torch.Tensor  # () int32
    best_hypothesis: torch.Tensor  # () int64


def point_terms(obj, imn, R, t):
    """Residual (r0, r1) and Jacobian rows (Ju, Jv, six (B,K) tensors each) of
    the normalized-plane residual r = u_norm - dehom(R^T (P - t)) (the JAX
    `gn_pnp_step`'s J, rows for u and v), for obj (K,3), imn (K,2) and B
    poses R (B,3,3), t (B,3); nothing masked."""
    d = [obj[None, :, c] - t[:, c, None] for c in range(3)]
    Rc = [[R[:, i, j, None] for j in range(3)] for i in range(3)]
    pb = [Rc[0][j] * d[0] + Rc[1][j] * d[1] + Rc[2][j] * d[2] for j in range(3)]
    z = pb[2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    r0 = imn[None, :, 0] - pb[0] / zs
    r1 = imn[None, :, 1] - pb[1] / zs
    iz = torch.reciprocal(zs)
    zz = zs * zs
    c0 = -pb[0] / zz
    c1 = -pb[1] / zz
    ju = [Rc[j][0] * iz + Rc[j][2] * c0 for j in range(3)]
    ju += [c0 * pb[1], iz * pb[2] - c0 * pb[0], -(iz * pb[1])]
    jv = [Rc[j][1] * iz + Rc[j][2] * c1 for j in range(3)]
    jv += [c1 * pb[1] - iz * pb[2], -(c1 * pb[0]), iz * pb[0]]
    return r0, r1, ju, jv


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, K, C) -> (B, C): the kernel's reduction over K points (thread k
    % THREADS adds its points in order, then a pairwise tree over threads)."""
    b, k, c = x.shape
    m = -(-k // THREADS)
    x = torch.nn.functional.pad(x, (0, 0, 0, m * THREADS - k)).reshape(b, m, THREADS, c)
    acc = x[:, 0]
    for i in range(1, m):
        acc = acc + x[:, i]
    s = THREADS // 2
    while s >= 1:
        acc = acc[:, :s] + acc[:, s : 2 * s]
        s //= 2
    return acc[:, 0]


_UPPER = [(i, j) for i in range(6) for j in range(i, 6)]


def gn_step_plain(obj, imn, R, t, mask):
    """One Gauss-Newton iteration for B problems: (R (B,3,3), t (B,3)) after
    the right-multiplied update T <- T exp(delta), delta = -(J^T J + 1e-9
    I)^-1 J^T r over the points in mask (B,K)."""
    r0, r1, ju, jv = point_terms(obj, imn, R, t)
    zero = torch.zeros_like(r0)
    r0, r1 = torch.where(mask, r0, zero), torch.where(mask, r1, zero)
    ju = [torch.where(mask, x, zero) for x in ju]
    jv = [torch.where(mask, x, zero) for x in jv]
    terms = [ju[i] * ju[j] + jv[i] * jv[j] for i, j in _UPPER]
    terms += [ju[i] * r0 + jv[i] * r1 for i in range(6)]
    sums = _block_sum(torch.stack(terms, dim=-1))
    H = [[None] * 6 for _ in range(6)]
    for n, (i, j) in enumerate(_UPPER):
        H[i][j] = H[j][i] = sums[:, n]
    for i in range(6):
        H[i][i] = H[i][i] + 1e-9
    x = chol_solve6(H, [sums[:, 21 + i] for i in range(6)])
    xR, xt = se3_exp([-xi for xi in x])
    Rl = [[R[:, i, j] for j in range(3)] for i in range(3)]
    t_new = [t[:, i] + (Rl[i][0] * xt[0] + Rl[i][1] * xt[1] + Rl[i][2] * xt[2]) for i in range(3)]
    R_new = mat3(Rl, xR)
    return (torch.stack([torch.stack(row, -1) for row in R_new], -2),
            torch.stack(t_new, -1))


def score_plain(obj, imn, R, t, score_mask, inlier_thresh):
    """Inliers (B,K): score_mask & |r| < inlier_thresh at poses (R, t)."""
    r0, r1, _, _ = point_terms(obj, imn, R, t)
    err = sqrt(r0 * r0 + r1 * r1)
    return score_mask[None, :] & (err < inlier_thresh)


def residual_norm_plain(obj, imn, R, t, mask):
    """|r| (B,) over the points of mask (B,K) at poses (R, t): the squares
    r0^2 + r1^2 summed in the kernel's order, a correctly rounded root."""
    r0, r1, _, _ = point_terms(obj, imn, R, t)
    sq = torch.where(mask, r0 * r0 + r1 * r1, torch.zeros_like(r0))
    return sqrt(_block_sum(sq[..., None])[:, 0])


def pnp_gn_plain(obj, imn, masks, R0, t0, iters, inlier_thresh, score_mask,
                 write_inliers=False, rnorm_out=None):
    """The plain PyTorch version: (R (B,3,3), t (B,3), counts (B,) int32,
    inliers (B,K) bool | None); fills rnorm_out (B, iters) when given. R0
    and t0 None start every problem at the identity."""
    b = masks.shape[0]
    f32 = dict(dtype=torch.float32, device=obj.device)
    R = torch.eye(3, **f32).expand(b, 3, 3) if R0 is None else R0
    t = torch.zeros((b, 3), **f32) if t0 is None else t0
    for it in range(iters):
        if rnorm_out is not None:
            rnorm_out[:, it] = residual_norm_plain(obj, imn, R, t, masks)
        R, t = gn_step_plain(obj, imn, R, t, masks)
    inl = score_plain(obj, imn, R, t, score_mask, inlier_thresh)
    return R, t, inl.sum(-1, dtype=torch.int32), inl if write_inliers else None


def pnp_gn(obj, imn, masks, R0, t0, iters, inlier_thresh, score_mask, write_inliers=False,
           rnorm_out=None, clocks=None):
    """B Gauss-Newton PnP problems over shared correspondences obj (K,3)
    (metres, the stored keyframe's camera frame) and imn (K,2) (the query's
    normalized image points): problem b starts at (R0[b], t0[b]) (R0 and
    t0 None: the identity) and runs `iters` iterations on the points of
    masks[b] (B,K) bool; then counts the points of score_mask (K,) bool
    with reprojection error < inlier_thresh. Returns (R (B,3,3), t (B,3),
    counts (B,) int32, inliers (B,K) bool when write_inliers, else None), in
    the solver's p_query = R (p - t) convention. `rnorm_out`, a (B, iters)
    float32 tensor, receives the residual norm over each problem's masked
    points before each iteration. On the card `clocks`, an (iters + 1, 4)
    int64 tensor, receives problem 0's clock64() at the start of each
    iteration, after its pass, after the sums and after the step (the last
    row: before and after the score)."""
    if obj.device.type == "cpu":
        return pnp_gn_plain(obj, imn, masks, R0, t0, iters, inlier_thresh, score_mask,
                            write_inliers, rnorm_out)
    if obj.device.type != "cuda":
        raise ValueError(f"pnp_gn: unsupported device {obj.device}")
    dev = obj.device
    if obj.dim() != 2 or masks.dim() != 2:
        raise ValueError("pnp_gn: obj must be (K, 3) and masks (B, K)")
    b, k = masks.shape
    iters = int(iters)
    fn = "pnp_gn"
    build.check_arg(fn, "obj", obj, (k, 3), torch.float32, dev)
    build.check_arg(fn, "imn", imn, (k, 2), torch.float32, dev)
    build.check_arg(fn, "masks", masks, (b, k), torch.bool, dev)
    if R0 is not None:
        build.check_arg(fn, "R0", R0, (b, 3, 3), torch.float32, dev)
    if t0 is not None:
        build.check_arg(fn, "t0", t0, (b, 3), torch.float32, dev)
    build.check_arg(fn, "score_mask", score_mask, (k,), torch.bool, dev)
    if rnorm_out is not None:
        build.check_arg(fn, "rnorm_out", rnorm_out, (b, iters), torch.float32, dev)
    if clocks is not None:
        build.check_arg(fn, "clocks", clocks, (iters + 1, 4), torch.int64, dev)
    R = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((b,), dtype=torch.int32, device=dev)
    inl = torch.empty((b, k), dtype=torch.bool, device=dev) if write_inliers else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = build.bind("pnp_gn", fn, _ARGTYPES)
    with build.traced("pnp_gn"):
        code = lib.pnp_gn(
            dev.index or 0, obj.data_ptr(), imn.data_ptr(), masks.data_ptr(), ptr(R0), ptr(t0),
            score_mask.data_ptr(), b, k, iters, float(inlier_thresh), R.data_ptr(),
            t.data_ptr(), counts.data_ptr(), ptr(inl), ptr(rnorm_out), ptr(clocks),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "pnp_gn launch")
    pnp_gn.launches += 1
    return R, t, counts, inl


pnp_gn.launches = 0


def select_sample(u: torch.Tensor, valid: torch.Tensor, sample_size: int) -> torch.Tensor:
    """(S, K) masks of each hypothesis's sample: the `sample_size` largest u +
    (valid ? 1 : -1), ties to the lower index as `lax.top_k` takes them,
    ANDed with valid."""
    scores = u + torch.where(valid, 1.0, -1.0).to(u.dtype)
    sel = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :sample_size]
    return torch.zeros_like(u, dtype=torch.bool).scatter_(1, sel, True) & valid


def ransac_pnp_steps(u, obj, imn, valid, sample_size=4, inlier_thresh=0.01, hypothesis_iters=4,
                     refine_iters=5, R0=None, t0=None) -> RansacResult:
    """RANSAC PnP step by step: the samples, the hypotheses' `pnp_gn` call,
    the first best count, the refine's `pnp_gn` call. On CPU tensors it is
    the fused kernel's plain version."""
    s, _ = u.shape
    dev = obj.device
    R0 = torch.eye(3, dtype=torch.float32, device=dev) if R0 is None else R0
    t0 = torch.zeros(3, dtype=torch.float32, device=dev) if t0 is None else t0
    sub = select_sample(u, valid, sample_size)
    obj, imn = obj.contiguous(), imn.contiguous()
    Rs, ts, counts, inl = pnp_gn(
        obj, imn, sub, R0.expand(s, 3, 3).contiguous(), t0.expand(s, 3).contiguous(),
        hypothesis_iters, inlier_thresh, valid, write_inliers=True,
    )
    best = torch.argmax(counts)
    inliers = inl[best]
    R_f, t_f, _, _ = pnp_gn(
        obj, imn, inliers[None].contiguous(), Rs[best][None].contiguous(),
        ts[best][None].contiguous(), refine_iters, inlier_thresh, valid,
    )
    return RansacResult(R=R_f[0], t=t_f[0], inliers=inliers, num_inliers=counts[best],
                        best_hypothesis=best)


_MAX_POINTS: dict = {}  # device index -> the fused kernel's largest K


def max_points(dev) -> int:
    """The largest K the fused kernel takes on CUDA device `dev`: the large
    route's words (a lane's sampled points, a refine thread's inliers, one
    bit each) in the dynamic shared memory the card allows."""
    index = torch.device(dev).index or 0
    if index not in _MAX_POINTS:
        lib = build.bind("pnp_gn", "ransac_pnp_max_points",
                         [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)])
        out = ctypes.c_longlong(0)
        build.check(lib, lib.ransac_pnp_max_points(index, ctypes.byref(out)),
                    "ransac_pnp_max_points")
        _MAX_POINTS[index] = int(out.value)
    return _MAX_POINTS[index]


def ransac_pnp(u, obj, imn, valid, sample_size=4, inlier_thresh=0.01, hypothesis_iters=4,
               refine_iters=5, R0=None, t0=None) -> RansacResult:
    """RANSAC PnP over K correspondences obj (K,3) and imn (K,2) with the
    candidate mask valid (K,) bool and S hypotheses drawn from u (S,K)
    uniforms in [0, 1), starting from (R0 (3,3), t0 (3,)) (default the
    identity): on CUDA tensors one launch of the fused kernel, on CPU
    tensors `ransac_pnp_steps`."""
    if obj.device.type == "cpu":
        return ransac_pnp_steps(u, obj, imn, valid, sample_size, inlier_thresh,
                                hypothesis_iters, refine_iters, R0, t0)
    if obj.device.type != "cuda":
        raise ValueError(f"ransac_pnp: unsupported device {obj.device}")
    dev = obj.device
    if u.dim() != 2 or obj.dim() != 2:
        raise ValueError("ransac_pnp: u must be (S, K) and obj (K, 3)")
    s, k = u.shape
    if not 1 <= k <= max_points(dev):
        raise ValueError(f"ransac_pnp: the kernel takes 1 to {max_points(dev)} points on "
                         f"{torch.cuda.get_device_name(dev)} (the large route's sample and "
                         f"inlier words in shared memory), got {k}")
    if s < 1 or not 1 <= sample_size <= k:
        raise ValueError(f"ransac_pnp: {s} hypotheses of {sample_size} points of {k}")
    fn = "ransac_pnp"
    build.check_arg(fn, "u", u, (s, k), torch.float32, dev)
    build.check_arg(fn, "obj", obj, (k, 3), torch.float32, dev)
    build.check_arg(fn, "imn", imn, (k, 2), torch.float32, dev)
    build.check_arg(fn, "valid", valid, (k,), torch.bool, dev)
    if R0 is not None:
        build.check_arg(fn, "R0", R0, (3, 3), torch.float32, dev)
    if t0 is not None:
        build.check_arg(fn, "t0", t0, (3,), torch.float32, dev)
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((3,), dtype=torch.float32, device=dev)
    inliers = torch.empty((k,), dtype=torch.bool, device=dev)
    num = torch.empty((), dtype=torch.int32, device=dev)
    best = torch.empty((), dtype=torch.int64, device=dev)
    lib = build.bind("pnp_gn", fn, _RANSAC_ARGTYPES)
    with build.traced("ransac_pnp"):
        code = lib.ransac_pnp(
            dev.index or 0, u.data_ptr(), obj.data_ptr(), imn.data_ptr(), valid.data_ptr(),
            None if R0 is None else R0.data_ptr(), None if t0 is None else t0.data_ptr(), s, k,
            int(sample_size), int(hypothesis_iters), int(refine_iters), float(inlier_thresh),
            R.data_ptr(), t.data_ptr(), inliers.data_ptr(), num.data_ptr(), best.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "ransac_pnp launch")
    ransac_pnp.launches += 1
    return RansacResult(R=R, t=t, inliers=inliers, num_inliers=num, best_hypothesis=best)


ransac_pnp.launches = 0
