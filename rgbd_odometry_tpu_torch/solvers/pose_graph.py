"""SE(3) pose-graph refinement: port of `rgbd_odometry_tpu/solvers/pose_graph.py`.

Batched Gauss-Newton over keyframe poses with odometry and loop-closure
edges, node 0 anchored (gauge). Every edge residual is evaluated at once; the
per-edge Jacobian blocks (A_e = dr/d delta_i, B_e = dr/d delta_j) come from
`torch.func.jacfwd` over the 12 tangents of each edge under `torch.func.vmap`.
Two solvers share the outer loop: ``dense`` assembles J (6E, 6N) from the
blocks and solves the damped normal equations directly (<= 64 nodes under
``auto``); ``cg`` solves them matrix-free by preconditioned conjugate
gradients, H x applied through `index_select` / `index_add_` over the edge
endpoints, preconditioned by the inverted 6x6 diagonal blocks of H.

The JAX PCG stops on a tolerance inside `lax.while_loop`; here it runs a
fixed `cg_iters` iterations and freezes its state once the tolerance test
passes, which equals the early exit without a host read per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from rgbd_odometry_tpu_torch.core import geometry as geo


class PoseGraphEdges(NamedTuple):
    """Relative-pose constraints pose_j ~= pose_i * (R_rel, t_rel), with an
    optional per-edge whitening factor L (Omega = L L^T) applied as
    r' = L^T (w r)."""

    i: torch.Tensor  # (E,) int64 source node
    j: torch.Tensor  # (E,) int64 target node
    R_rel: torch.Tensor  # (E, 3, 3)
    t_rel: torch.Tensor  # (E, 3)
    weight: torch.Tensor  # (E,) confidence weight (1/sigma)
    sqrt_info: Optional[torch.Tensor] = None  # (E, 6, 6) lower Cholesky factor of Omega


def information_sqrt(info: torch.Tensor, ridge: float = 1e-9) -> torch.Tensor:
    """(E, 6, 6) information matrices -> whitening factors L (Omega = L L^T),
    with a ridge for rank-deficient directions. Twist layout (translation,
    rotation), as the solver's psi and `geo.se3_log`."""
    eye = torch.eye(6, dtype=info.dtype, device=info.device)
    return torch.linalg.cholesky(info + ridge * eye)


def normalized_information_sqrt(info, sigma2=None, ridge: float = 1e-9,
                                block_normalize: bool = False) -> torch.Tensor:
    """`information_sqrt` after dividing the batch by the mean of trace/6
    (or, with `block_normalize`, the translation and rotation blocks by
    separate scales), so that solver information mixes with weight-1
    isotropic edges; `sigma2` (E,) divides each edge's information first
    (see the JAX docstring)."""
    if sigma2 is not None:
        info = info / torch.clamp(sigma2[:, None, None], min=1e-12)
    if block_normalize:
        s_t = torch.diagonal(info[..., :3, :3], dim1=-2, dim2=-1).sum(-1).mean() / 3.0
        s_r = torch.diagonal(info[..., 3:, 3:], dim1=-2, dim2=-1).sum(-1).mean() / 3.0
        d = torch.cat([s_t.expand(3), s_r.expand(3)])
        D = torch.sqrt(torch.clamp(d[:, None] * d[None, :], min=1e-30))
        return information_sqrt(info / D, ridge=ridge)
    scale = torch.diagonal(info, dim1=-2, dim2=-1).sum(-1).mean() / 6.0
    return information_sqrt(info / torch.clamp(scale, min=1e-30), ridge=ridge)


def _rt(R: torch.Tensor) -> torch.Tensor:
    return R.transpose(-1, -2)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def odometry_edges(R: torch.Tensor, t: torch.Tensor, weight: float = 1.0,
                   sqrt_info: Optional[torch.Tensor] = None) -> PoseGraphEdges:
    """Consecutive-frame constraints of an absolute trajectory (N,3,3),
    (N,3); `sqrt_info` optional (N-1, 6, 6) whitening factors."""
    n = R.shape[0]
    i = torch.arange(n - 1, device=R.device)
    return PoseGraphEdges(
        i=i, j=i + 1, R_rel=_rt(R[:-1]) @ R[1:], t_rel=_mv(_rt(R[:-1]), t[1:] - t[:-1]),
        weight=torch.full((n - 1,), weight, dtype=R.dtype, device=R.device), sqrt_info=sqrt_info,
    )


def concat_edges(a: PoseGraphEdges, b: PoseGraphEdges) -> PoseGraphEdges:
    """a then b; identity whitening for the side without `sqrt_info`."""
    si = None
    if a.sqrt_info is not None or b.sqrt_info is not None:
        def _or_eye(e: PoseGraphEdges):
            if e.sqrt_info is not None:
                return e.sqrt_info
            eye = torch.eye(6, dtype=e.R_rel.dtype, device=e.R_rel.device)
            return eye.expand(e.i.shape[0], 6, 6)

        si = torch.cat([_or_eye(a), _or_eye(b)])
    return PoseGraphEdges(
        i=torch.cat([a.i, b.i]), j=torch.cat([a.j, b.j]), R_rel=torch.cat([a.R_rel, b.R_rel]),
        t_rel=torch.cat([a.t_rel, b.t_rel]), weight=torch.cat([a.weight, b.weight]), sqrt_info=si,
    )


def _apply_deltas(R, t, deltas):
    """Right-perturb every pose by its tangent: T_k <- T_k exp(d_k)."""
    dR, dt = geo.se3_exp(deltas)
    return R @ dR, t + _mv(R, dt)


def _residual(Ri, ti, Rj, tj, Rrel, trel, w, L):
    """One edge's (or a batch's) weighted, whitened residual
    w log((R_rel, t_rel)^-1 (T_i^-1 T_j))."""
    R_ij = _rt(Ri) @ Rj
    t_ij = _mv(_rt(Ri), tj - ti)
    r = w[..., None] * geo.se3_log(_rt(Rrel) @ R_ij, _mv(_rt(Rrel), t_ij - trel))
    if L is not None:
        r = _mv(_rt(L), r)
    return r


def _edge_residuals(R, t, edges: PoseGraphEdges) -> torch.Tensor:
    """(E, 6) weighted (and whitened) residuals at poses (R, t)."""
    return _residual(R[edges.i], t[edges.i], R[edges.j], t[edges.j], edges.R_rel, edges.t_rel,
                     edges.weight, edges.sqrt_info)


def _edge_jacobians(R, t, edges: PoseGraphEdges):
    """Exact per-edge Jacobian blocks (A_e, B_e), each (E, 6, 6), for right
    perturbations of node i and node j."""

    def one_edge(d, Ri, ti, Rj, tj, Rrel, trel, w, L):
        # evaluated on leading dims of 1 and 2: forward-mode AD of a 0-dim
        # tensor combined with a Python scalar yields a float64 tangent
        dR, dt = geo.se3_exp(d.reshape(2, 6))
        one = (Ri @ dR[0], ti + _mv(Ri, dt[0]), Rj @ dR[1], tj + _mv(Rj, dt[1]), Rrel, trel, w)
        return _residual(*(x[None] for x in one), None if L is None else L[None])[0]

    zero = torch.zeros(12, dtype=R.dtype, device=R.device)
    args = (R[edges.i], t[edges.i], R[edges.j], t[edges.j], edges.R_rel, edges.t_rel,
            edges.weight)
    if edges.sqrt_info is not None:
        J = vmap(jacfwd(one_edge), in_dims=(None, 0, 0, 0, 0, 0, 0, 0, 0))(
            zero, *args, edges.sqrt_info)
    else:
        J = vmap(jacfwd(lambda d, *a: one_edge(d, *a, None)),
                 in_dims=(None, 0, 0, 0, 0, 0, 0, 0))(zero, *args)
    return J[..., :6], J[..., 6:]


def _robust_sqrt_weights(r: torch.Tensor, robust: str, delta: float) -> torch.Tensor:
    """(E,) IRLS factors sqrt(w(|r_e|)) from the current whitened residuals:
    huber w = min(1, delta/s); geman w = 1/(1 + (s/delta)^2)^2."""
    s = torch.linalg.vector_norm(r, dim=-1)
    if robust == "huber":
        w = torch.clamp(delta / torch.clamp(s, min=1e-12), max=1.0)
    elif robust == "geman":
        w = 1.0 / torch.square(1.0 + torch.square(s / delta))
    else:
        raise ValueError(f"unknown robust kernel {robust!r} (huber|geman)")
    return torch.sqrt(w).to(r.dtype)


def edge_robust_weights(R, t, edges: PoseGraphEdges, robust: str, delta: float) -> torch.Tensor:
    """(E,) effective robust weights w at the given poses."""
    return torch.square(_robust_sqrt_weights(_edge_residuals(R, t, edges), robust, delta))


def _pcg(matvec, apply_minv, b: torch.Tensor, max_iters: int, tol: float) -> torch.Tensor:
    """Preconditioned conjugate gradients for H x = b, b (..., N, 6) a batch
    of right-hand sides: `max_iters` iterations, each right-hand side's
    state frozen from the first iteration at which |r|^2 <= tol^2 |b|^2."""
    dims = (-2, -1)

    def dot(a, c):
        return (a * c).sum(dims)

    def col(v):
        return v[..., None, None]

    x = torch.zeros_like(b)
    r = b
    z = apply_minv(r)
    p = z
    rz = dot(r, z)
    thresh = tol * tol * torch.clamp(dot(b, b), min=1e-30)
    active = torch.ones_like(rz, dtype=torch.bool)
    for _ in range(max_iters):
        active = active & (dot(r, r) > thresh)
        Hp = matvec(p)
        alpha = rz / torch.clamp(dot(p, Hp), min=1e-30)
        x_n = x + col(alpha) * p
        r_n = r - col(alpha) * Hp
        z_n = apply_minv(r_n)
        rz_n = dot(r_n, z_n)
        p_n = z_n + col(rz_n / torch.clamp(rz, min=1e-30)) * p
        a = col(active)
        x, r, p = torch.where(a, x_n, x), torch.where(a, r_n, r), torch.where(a, p_n, p)
        rz = torch.where(active, rz_n, rz)
    return x


def _scatter(idx: torch.Tensor, v: torch.Tensor, n: int, dim: int = -2) -> torch.Tensor:
    """Sum the per-edge entries of v along `dim` (length E) into n node
    entries, edge e into node idx[e]."""
    shape = list(v.shape)
    shape[dim] = n
    return v.new_zeros(shape).index_add_(dim % v.dim(), idx, v)


def _normal_ops(R, t, edges: PoseGraphEdges, damping):
    """Matrix-free damped normal-equation operators at (R, t): the H-apply
    (node 0's rows act as identity, so it stays fixed), the block-Jacobi
    preconditioner and the J^T r assembler."""
    n = R.shape[0]
    A, B = _edge_jacobians(R, t, edges)
    node_mask = (torch.arange(n, device=R.device) > 0).to(R.dtype)[:, None]
    i, j = edges.i, edges.j

    def matvec(x):
        xm = x * node_mask
        xi, xj = xm.index_select(-2, i), xm.index_select(-2, j)
        u = _mv(A, xi) + _mv(B, xj)
        y = _scatter(i, _mv(_rt(A), u), n) + _scatter(j, _mv(_rt(B), u), n)
        return (y + damping * xm) * node_mask + x * (1.0 - node_mask)

    eye = torch.eye(6, dtype=R.dtype, device=R.device)
    D = _scatter(i, _rt(A) @ A, n, dim=-3) + _scatter(j, _rt(B) @ B, n, dim=-3)
    D = D + (damping + 1e-8) * eye
    D = torch.where((torch.arange(n, device=R.device) > 0)[:, None, None], D, eye)
    Dinv = torch.linalg.inv(D)

    def apply_minv(v):
        return _mv(Dinv, v)

    def gather_grad(r):
        g = _scatter(i, _mv(_rt(A), r), n) + _scatter(j, _mv(_rt(B), r), n)
        return g * node_mask

    return matvec, apply_minv, gather_grad


def _dense_jacobian(A, B, edges: PoseGraphEdges, n: int) -> torch.Tensor:
    """J (6E, 6N) with node 0's columns zeroed, from the per-edge blocks."""
    e = A.shape[0]
    J = torch.zeros((e, 6, n, 6), dtype=A.dtype, device=A.device)
    rows = torch.arange(e, device=A.device)
    J[rows, :, edges.i] = A
    J[rows, :, edges.j] += B
    J[:, :, 0] = 0.0
    return J.reshape(e * 6, n * 6)


def _gauge_eye(n: int, damping: float, like: torch.Tensor) -> torch.Tensor:
    """damping I, plus 1 on node 0's diagonal (the gauge rows)."""
    d = torch.full((n * 6,), damping, dtype=like.dtype, device=like.device)
    d[:6] = d[:6] + 1.0
    return torch.diag(d)


def refine_pose_graph(
    R0: torch.Tensor,
    t0: torch.Tensor,
    edges: PoseGraphEdges,
    iterations: int = 10,
    damping: float = 1e-6,
    solver: str = "auto",
    cg_iters: int | None = None,
    cg_tol: float = 1e-6,
    robust: str | None = None,
    robust_delta: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gauss-Newton pose-graph optimization of absolute poses R0 (N,3,3),
    t0 (N,3): (R, t, residual norms (iterations,)), node 0 fixed.
    ``solver`` "dense" | "cg" | "auto" (dense for N <= 64); ``cg_iters``
    defaults to 2N. ``robust`` "huber" | "geman" reweights each edge by its
    whitened residual norm at scale ``robust_delta`` (IRLS, weights frozen
    per iteration); the norms are the unreweighted ones. See the JAX
    docstring for choosing ``robust_delta``."""
    n = R0.shape[0]
    if solver == "auto":
        solver = "dense" if n <= 64 else "cg"
    if cg_iters is None:
        cg_iters = 2 * n

    def reweighted(R, t):
        r0 = _edge_residuals(R, t, edges)
        if robust is None:
            return edges, r0, r0
        sw = _robust_sqrt_weights(r0, robust, robust_delta)
        return edges._replace(weight=edges.weight * sw), r0 * sw[:, None], r0

    R, t = R0, t0
    norms = []
    for _ in range(iterations):
        e2, r, r_raw = reweighted(R, t)
        if solver == "dense":
            A, B = _edge_jacobians(R, t, e2)
            J = _dense_jacobian(A, B, e2, n)
            rf = r.reshape(-1)
            H = _rt(J) @ J + _gauge_eye(n, damping, J)
            delta = -torch.linalg.solve(H, _rt(J) @ rf)
            delta = delta.reshape(n, 6)
            delta[0] = 0.0
        else:
            matvec, apply_minv, gather_grad = _normal_ops(R, t, e2, damping)
            delta = _pcg(matvec, apply_minv, -gather_grad(r), cg_iters, cg_tol)
        R, t = _apply_deltas(R, t, delta)
        R = geo.rotationize_newton(R)
        norms.append(torch.linalg.vector_norm(r_raw))
    return R, t, torch.stack(norms)


def marginal_covariance(
    R: torch.Tensor,
    t: torch.Tensor,
    edges: PoseGraphEdges,
    nodes: torch.Tensor | None = None,
    damping: float = 1e-8,
    solver: str = "auto",
    cg_iters: int | None = None,
    cg_tol: float = 1e-8,
    robust: str | None = None,
    robust_delta: float = 1.0,
) -> torch.Tensor:
    """Per-node 6x6 marginal covariance blocks (diagonal blocks of H^-1, H =
    J^T J at (R, t)) relative to the gauge node 0, which returns zeros;
    twist layout (translation, rotation). ``robust`` freezes the IRLS
    weights of the refinement at (R, t). ``nodes`` (K,) selects blocks
    ((K,6,6); default all N). ``solver`` "auto" is dense for N <= 256; the
    matrix-free path runs 6 PCG solves per requested node, all at once."""
    n = R.shape[0]
    if solver == "auto":
        solver = "dense" if n <= 256 else "cg"
    if cg_iters is None:
        cg_iters = 4 * n
    if robust is not None:
        sw = _robust_sqrt_weights(_edge_residuals(R, t, edges), robust, robust_delta)
        edges = edges._replace(weight=edges.weight * sw)
    node_idx = (torch.arange(n, device=R.device) if nodes is None
                else torch.as_tensor(nodes, device=R.device).long())

    if solver == "dense":
        A, B = _edge_jacobians(R, t, edges)
        J = _dense_jacobian(A, B, edges, n)
        cov = torch.linalg.inv(_rt(J) @ J + _gauge_eye(n, damping, J))
        cov = cov.reshape(n, 6, n, 6)
        cov[0] = 0.0
        cov[:, :, 0] = 0.0
        return cov[node_idx, :, node_idx]

    matvec, apply_minv, _ = _normal_ops(R, t, edges, damping)
    k = node_idx.shape[0]
    rhs = torch.zeros((k, 6, n, 6), dtype=R.dtype, device=R.device)
    cols = torch.arange(6, device=R.device)
    rhs[torch.arange(k, device=R.device)[:, None], cols[None, :], node_idx[:, None], cols[None, :]] = 1.0
    x = _pcg(matvec, apply_minv, rhs.reshape(k * 6, n, 6), cg_iters, cg_tol).reshape(k, 6, n, 6)
    blk = x[torch.arange(k, device=R.device), :, node_idx]  # (K, 6, 6): row a of node k's block
    return blk * (node_idx > 0).to(R.dtype)[:, None, None]
