// The level solvers' serial step on one warp, and the fixed-order sum of a
// pair's per-thread partials over one block or a thread-block cluster
// (level_lm.cu, level_sg.cu, level_photo.cu).
//
// The step's values are those of the plain twins (kernels/se3_plain.py:
// se3_exp, compose, rotationize_newton, se3_log, lm_psi), operation for
// operation: each lane performs with round-to-nearest intrinsics the
// float32 operations the twin performs for the value the lane owns, in the
// same order, so a result is bitwise the twin's (given the same double
// sin, cos and arccos). Who computes what:
//
//   pose layout  lane e < 9 holds R[e] (row-major), lanes 9..11 hold t; a
//                3x3 product is one entry a lane, its operands fetched with
//                shuffles (compose, Newton-Schulz, W^2 of the exponential);
//   Cholesky     the 6x6 factorization and substitutions, chains with a
//                correctly rounded square root, reciprocal or division on
//                every link, are run by every lane alike (warp_lm_psi);
//   sums         the shuffle-down tree of up to 32 sums with a lane keeping
//                half of its values at each offset (warp_tree), the same
//                additions with 31 shuffles for 32 sums, not 160;
//   sin, cos     the exponential's and the log's double-precision sine and
//                cosine of one angle are one `sincos` (one argument
//                reduction): lanes of one warp that call different
//                functions run them one after the other, not together.
//
// Every lane returns the uniform scalars (the step psi, its norm, the
// decisions), so no broadcast through shared memory is needed inside the
// step; the pose goes to shared memory once, for the block's next pass.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "se3.cuh"

namespace rgbd {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPoseLanes = 12;  // R (9) and t (3), one element a lane

// The pose element lane e holds of the identity scaled by d (0 off the
// diagonal and for t).
__device__ __forceinline__ float lane_eye(int e, float d) {
  return (e == 0 || e == 4 || e == 8) ? d : 0.0f;
}

// (A B)[e] (or (A^T B)[e] with kTN) for lane e < 9 of two 3x3 matrices held
// one element a lane: the twins' mat3 / mat3_tn for the lane's entry.
// Lanes 9..31 get a value they must not use.
template <bool kTN>
__device__ __forceinline__ float lane_mat3(float a, float b, int lane) {
  const int e = lane < 9 ? lane : 8;
  const int i = e / 3, j = e - 3 * (e / 3);
  float s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ak = __shfl_sync(kFull, a, kTN ? 3 * k + i : 3 * i + k);
    const float bk = __shfl_sync(kFull, b, 3 * k + j);
    s[k] = fmul(ak, bk);
  }
  return fadd(fadd(s[0], s[1]), s[2]);
}

// compose in the pose layout: (R xR, t + R xt) for the element
// lane e < 12 holds of the pose p and the increment x.
__device__ __forceinline__ float lane_compose(float p, float x, int lane) {
  const int e = lane < kPoseLanes ? lane : kPoseLanes - 1;
  const bool rot = e < 9;
  const int i = rot ? e / 3 : e - 9, j = rot ? e - 3 * (e / 3) : 0;
  float s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ak = __shfl_sync(kFull, p, 3 * i + k);
    const float bk = __shfl_sync(kFull, x, rot ? 3 * k + j : 9 + k);
    s[k] = fmul(ak, bk);
  }
  const float d = fadd(fadd(s[0], s[1]), s[2]);
  return rot ? d : fadd(p, d);
}

// T exp(psi)^-1 in the pose layout (level_photo.cu's update): for the pose
// p = (R, t) and x = exp(psi) = (xR, xt) (lane_se3_exp's layout) the element
// lane e < 12 holds of (R xR^T, t + R xti), xti = -(xR^T xt) formed on lanes
// 9..11 first; each sum in the twin's order (kernels/level_photo._step).
__device__ __forceinline__ float lane_compose_inv(float p, float x, int lane) {
  const int e = lane < kPoseLanes ? lane : kPoseLanes - 1;
  const bool rot = e < 9;
  const int k = rot ? 0 : e - 9;
  float s[3];
#pragma unroll
  for (int m = 0; m < 3; ++m)
    s[m] = fmul(__shfl_sync(kFull, x, 3 * m + k), __shfl_sync(kFull, x, 9 + m));
  const float xti = -fadd(fadd(s[0], s[1]), s[2]);  // lanes 9..11
  const float v = rot ? x : xti;
  const int i = rot ? e / 3 : e - 9, j = rot ? e - 3 * (e / 3) : 0;
#pragma unroll
  for (int m = 0; m < 3; ++m)
    s[m] = fmul(__shfl_sync(kFull, p, 3 * i + m), __shfl_sync(kFull, v, rot ? 3 * j + m : 9 + m));
  const float d = fadd(fadd(s[0], s[1]), s[2]);
  return rot ? d : fadd(p, d);
}

// rotationize_newton in the pose layout: X <- X (1.5 I - 0.5 X^T X), 3
// steps, on R; lanes 9..11 keep t.
__device__ __forceinline__ float lane_rotationize(float x, int lane) {
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const float m = lane_mat3<true>(x, x, lane);
    const float y = fsub(lane_eye(lane, 1.5f), fmul(0.5f, m));
    const float z = lane_mat3<false>(x, y, lane);
    x = lane < 9 ? z : x;
  }
  return x;
}

constexpr int kSvdSweeps = 4;          // kernels/se3_plain.py SVD_SWEEPS
constexpr double kSvdDegenerate = 0x1p-40;  // se3_plain.SVD_DEGENERATE

__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double ddiv(double a, double b) { return __ddiv_rn(a, b); }

// The reference's SVD projection (JAX `rotationize_svd`, core/geometry.py:
// 209: U diag(sign S) V^T, sign(0) = -1) of a 3x3 row-major float32 A, as
// its twin kernels/se3_plain.rotationize_svd takes it, operation for
// operation in double precision (round-to-nearest intrinsics, nothing
// fused), rounded once to float32: the eigenvectors V of M = A^T A by
// kSvdSweeps cyclic Jacobi sweeps over (0,1), (0,2), (1,2) (tan from theta
// = (m_qq - m_pp) / 2 m_pq, no rotation where m_pq is 0), S = sqrt(max(diag
// M, 0)), u_m = A v_m / S_m (v_m where S_m is 0), then sum_m sign(S_m) u_m
// v_m^T; the smallest eigenvalue k at most kSvdDegenerate of a positive
// largest is a zero singular value whose column is the completion -(u_i x
// u_j). A fixed count of steps, no data-dependent loop: every branch is a
// select, so the twin mirrors it. In float32 the product A^T A would round
// away most of a near-rotation's deviation from I.
__device__ inline void rotationize_svd3(const float Af[9], float Q[9]) {
  double A[9], M[3][3], V[3][3];
#pragma unroll
  for (int e = 0; e < 9; ++e) A[e] = (double)Af[e];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      M[i][j] = dadd(dadd(dmul(A[i], A[j]), dmul(A[3 + i], A[3 + j])), dmul(A[6 + i], A[6 + j]));
      V[i][j] = i == j ? 1.0 : 0.0;
    }
#pragma unroll
  for (int sw = 0; sw < kSvdSweeps; ++sw) {
#pragma unroll
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0, q = pq == 0 ? 1 : 2, r = 3 - p - q;
      const double mpq = M[p][q];
      const double th = ddiv(dsub(M[q][q], M[p][p]), dmul(2.0, mpq));
      const double sg = th >= 0.0 ? 1.0 : -1.0;
      double t = ddiv(sg, dadd(fabs(th), __dsqrt_rn(dadd(dmul(th, th), 1.0))));
      t = mpq == 0.0 ? 0.0 : t;
      const double c = ddiv(1.0, __dsqrt_rn(dadd(dmul(t, t), 1.0)));
      const double sn = dmul(t, c);
      const double mpp = M[p][p], mqq = M[q][q], mrp = M[r][p], mrq = M[r][q];
      M[p][p] = dsub(mpp, dmul(t, mpq));
      M[q][q] = dadd(mqq, dmul(t, mpq));
      M[p][q] = M[q][p] = 0.0;
      M[r][p] = M[p][r] = dsub(dmul(c, mrp), dmul(sn, mrq));
      M[r][q] = M[q][r] = dadd(dmul(sn, mrp), dmul(c, mrq));
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const double vp = V[i][p], vq = V[i][q];
        V[i][p] = dsub(dmul(c, vp), dmul(sn, vq));
        V[i][q] = dadd(dmul(sn, vp), dmul(c, vq));
      }
    }
  }
  const double lam[3] = {M[0][0], M[1][1], M[2][2]};
  int k = 0;
  double lmin = lam[0], lmax = lam[0];
#pragma unroll
  for (int m = 1; m < 3; ++m) {
    if (lam[m] < lmin) k = m;
    lmin = fmin(lmin, lam[m]);
    lmax = fmax(lmax, lam[m]);
  }
  const bool deg = lmin <= dmul(lmax, kSvdDegenerate) && lmax > 0.0;
  double u[3][3];
  bool pos[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const double S = __dsqrt_rn(fmax(lam[m], 0.0));
    pos[m] = S > 0.0;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const double av = dadd(dadd(dmul(A[3 * r], V[0][m]), dmul(A[3 * r + 1], V[1][m])),
                             dmul(A[3 * r + 2], V[2][m]));
      u[m][r] = pos[m] ? ddiv(av, S) : V[r][m];
    }
  }
  double su[3][3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int ia = (m + 1) % 3, ib = (m + 2) % 3;
    const double cr[3] = {dsub(dmul(u[ia][1], u[ib][2]), dmul(u[ia][2], u[ib][1])),
                          dsub(dmul(u[ia][2], u[ib][0]), dmul(u[ia][0], u[ib][2])),
                          dsub(dmul(u[ia][0], u[ib][1]), dmul(u[ia][1], u[ib][0]))};
    const bool dk = deg && k == m;
#pragma unroll
    for (int r = 0; r < 3; ++r) su[m][r] = dk ? cr[r] : (pos[m] ? u[m][r] : -u[m][r]);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Q[3 * r + c] = (float)dadd(dadd(dmul(su[0][r], V[c][0]), dmul(su[1][r], V[c][1])),
                                 dmul(su[2][r], V[c][2]));
}

// rotationize_svd3 in the pose layout: R gathered to every lane, the
// projection computed by every lane alike (as warp_lm_psi's Cholesky), lane
// e < 9 keeps Q[e]; lanes 9..11 keep t.
__device__ __forceinline__ float lane_rotationize_svd(float x, int lane) {
  float A[9], Q[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) A[e] = __shfl_sync(kFull, x, e);
  rotationize_svd3(A, Q);
  float out = x;
#pragma unroll
  for (int e = 0; e < 9; ++e)
    if (lane == e) out = Q[e];
  return out;
}

// The pose element a lane holds, re-orthogonalized by `how` (the same on
// every lane): 0 not at all, 1 Newton-Schulz (lane_rotationize), 2 the SVD
// projection (lane_rotationize_svd), compiled in only with kSvd.
template <bool kSvd>
__device__ __forceinline__ float lane_rotationize_by(int how, float x, int lane) {
  if constexpr (kSvd) {
    if (how == 2) return lane_rotationize_svd(x, lane);
  }
  return how ? lane_rotationize(x, lane) : x;
}

// se3_exp (se3.cuh's, in the pose layout): the twist psi (uniform, six
// values on every lane) -> the element lane e < 12 holds of (R, t).
__device__ __forceinline__ float lane_se3_exp(const float psi[6], int lane) {
  const float w0 = psi[3], w1 = psi[4], w2 = psi[5];
  const float theta2 = fadd(fadd(fmul(w0, w0), fmul(w1, w1)), fmul(w2, w2));
  const float theta = __fsqrt_rn(fadd(theta2, 1e-16f));
  const bool small = theta2 < 1e-8f;
  double sd, cd;
  sincos((double)theta, &sd, &cd);
  const float sn = (float)sd, cs = (float)cd;
  const float a = small ? fsub(1.0f, fdiv(theta2, 6.0f)) : fdiv(sn, theta);
  const float b = small ? fsub(0.5f, fdiv(theta2, 24.0f)) : fdiv(fsub(1.0f, cs), theta2);
  const float c = small ? fsub((float)(1.0 / 6.0), fdiv(theta2, 120.0f))
                        : fdiv(fsub(theta, sn), fmul(theta2, theta));
  // W = hat(w) = {0, -w2, w1, w2, 0, -w0, -w1, w0, 0}, one entry a lane
  const int e = lane < 9 ? lane : 8;
  const float W = e == 1 ? -w2 : e == 2 ? w1 : e == 3 ? w2 : e == 5 ? -w0
                : e == 6 ? -w1 : e == 7 ? w0 : 0.0f;
  const float WW = lane_mat3<false>(W, W, lane);
  const float id = lane_eye(e, 1.0f);
  const float R = fadd(fadd(id, fmul(a, W)), fmul(b, WW));
  const float V = fadd(fadd(id, fmul(b, W)), fmul(c, WW));
  // t[i] = V[i] . v on lane 9 + i
  const int ti = lane < 9 ? 0 : (lane < kPoseLanes ? lane - 9 : 2);
  const float v0 = __shfl_sync(kFull, V, 3 * ti), v1 = __shfl_sync(kFull, V, 3 * ti + 1),
              v2 = __shfl_sync(kFull, V, 3 * ti + 2);
  const float t = fadd(fadd(fmul(v0, psi[0]), fmul(v1, psi[1])), fmul(v2, psi[2]));
  return lane < 9 ? R : t;
}

// The Levenberg-Marquardt step of se3.cuh's lm_psi, from H (the row-major
// upper triangle, 21 floats) at Hs and g (6) at gs in shared memory: psi =
// -(H + lam diag(max(diag H, 1e-8)))^-1 g projected onto the trust region.
// Every lane runs the one-thread factorization alike: lanes across the
// rows of each column put a shuffle on every link of the factorization's
// and the substitutions' chains, and measured slower an iteration on an
// H100 (PERF.md).
__device__ __forceinline__ void warp_lm_psi(const float* Hs, const float* gs, float lam,
                                            float radius, float psi[6]) {
  float H[36], g[6];
#pragma unroll
  for (int r = 0, m = 0; r < 6; ++r)
#pragma unroll
    for (int c = r; c < 6; ++c, ++m) H[r * 6 + c] = H[c * 6 + r] = Hs[m];
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = gs[i];
  lm_psi(H, g, lam, radius, psi);
}

// se3_log on the warp (the twin's: so3_log in three branches, Taylor for
// cos theta > 1 - 1e-6, the generic theta / (2 sin theta) vee(R - R^T), and
// for cos theta < -(1 - 5e-7) the axis from the diagonal with the signs
// from the off-diagonals; then V^-1 = I - W/2 + coef W^2), pose (R, t)
// given whole to every lane:
// so3_log's branches are uniform (one cos theta for the warp); the one
// double arccos, then the generic branch's double sine, then se3_log's
// sine and cosine as one sincos; V^-1 t on lanes 0..2. Every lane returns
// the same psi.
__device__ inline void warp_se3_log(const float R[9], const float t[3], int lane, float psi[6]) {
  float w[3];
  const float trace = fadd(fadd(R[0], R[4]), R[8]);
  const float cs = fminf(fmaxf(fmul(fsub(trace, 1.0f), 0.5f), -1.0f), 1.0f);
  const bool small = cs > 0.999999f;
  const bool near_pi = cs < -0.9999995f;
  const float theta = (float)acos((double)(small ? 0.0f : cs));
  if (near_pi) {
    const float denom = fmaxf(fsub(1.0f, cs), 1e-8f);
    float a2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      a2[i] = fmaxf(fdiv(fsub(fmul(0.5f, fadd(R[4 * i], R[4 * i])), cs), denom), 0.0f);
    const float s01 = sign_or_one(fmul(0.5f, fadd(R[1], R[3])));
    const float s02 = sign_or_one(fmul(0.5f, fadd(R[2], R[6])));
    const float s12 = sign_or_one(fmul(0.5f, fadd(R[5], R[7])));
    const int imax = (a2[0] >= a2[1] && a2[0] >= a2[2]) ? 0 : (a2[1] >= a2[2] ? 1 : 2);
    const float sgn[3] = {imax == 0 ? 1.0f : (imax == 1 ? s01 : s02),
                          imax == 1 ? 1.0f : (imax == 0 ? s01 : s12),
                          imax == 2 ? 1.0f : (imax == 0 ? s02 : s12)};
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = fmul(fmul(theta, __fsqrt_rn(a2[i])), sgn[i]);
  } else {
    float k;
    if (small) {
      k = fmul(0.5f, fadd(1.0f, fdiv(fmul(2.0f, fsub(1.0f, cs)), 6.0f)));
    } else {
      const float sn = (float)sin((double)theta);
      k = fdiv(fmul(0.5f, theta), fabsf(sn) < 1e-8f ? 1.0f : sn);
    }
    w[0] = fmul(k, fsub(R[7], R[5]));
    w[1] = fmul(k, fsub(R[2], R[6]));
    w[2] = fmul(k, fsub(R[3], R[1]));
  }
  const float theta2 = fadd(fadd(fmul(w[0], w[0]), fmul(w[1], w[1])), fmul(w[2], w[2]));
  float coef;
  if (theta2 < 1e-3f) {
    coef = fadd((float)(1.0 / 12.0), fdiv(theta2, 720.0f));
  } else {
    const float th = __fsqrt_rn(fadd(theta2, 1e-16f));
    double sd, cd;
    sincos((double)th, &sd, &cd);
    const float a = fdiv((float)sd, th);
    const float b = fdiv(fsub(1.0f, (float)cd), theta2);
    coef = fdiv(fsub(1.0f, fdiv(a, fmul(2.0f, b))), fmaxf(theta2, 1e-16f));
  }
  // row i of V^-1 = I - W/2 + coef W^2 on lane i, then v[i] = V^-1[i] . t
  const int i = lane < 3 ? lane : 2;
  const float W[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
  float V[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // W^2[i][j] as mat3 forms it, W's entries picked with constant indices
    float Wi[3], Wj[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      Wi[k] = i == 0 ? W[k] : i == 1 ? W[3 + k] : W[6 + k];
      Wj[k] = W[3 * k + j];
    }
    const float ww = fadd(fadd(fmul(Wi[0], Wj[0]), fmul(Wi[1], Wj[1])), fmul(Wi[2], Wj[2]));
    V[j] = fadd(fsub(i == j ? 1.0f : 0.0f, fmul(0.5f, Wi[j])), fmul(coef, ww));
  }
  const float v = fadd(fadd(fmul(V[0], t[0]), fmul(V[1], t[1])), fmul(V[2], t[2]));
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    psi[q] = __shfl_sync(kFull, v, q);
    psi[3 + q] = w[q];
  }
}

// Where a block is in its pair's cluster: `ranks` blocks share the pair's
// points (1: the block alone), this block is rank `q` of them, and they are
// ranks base .. base + ranks - 1 of the cluster.
struct Split {
  int ranks, q, base;
};

// The levels of warp_tree below offset O: at each offset o = O, O / 2, ...,
// 1 a lane keeps the half of its x[0 .. 2o) its lane bit o names and adds
// the other half of the lane across. A template parameter a level, so that
// every loop has a constant trip count and x stays in registers (as loops
// over o, nvcc left x in local memory for N = 27).
template <int O, int P>
__device__ __forceinline__ void tree_levels(float (&x)[P], int lane) {
  const bool hi = (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float keep = hi ? x[k + O] : x[k];
    const float send = hi ? x[k] : x[k + O];
    x[k] = keep + __shfl_xor_sync(kFull, send, O);
  }
  if constexpr (O > 1) tree_levels<O / 2, P>(x, lane);
}

// The offsets O, O / 2, ..., P of warp_tree, where every lane adds the
// lane across to each of its P values.
template <int O, int P>
__device__ __forceinline__ void tree_fold(float (&x)[P]) {
  if constexpr (O >= P) {
#pragma unroll
    for (int m = 0; m < P; ++m) x[m] += __shfl_xor_sync(kFull, x[m], O);
    tree_fold<O / 2, P>(x);
  }
}

// The shuffle-down tree of each of N per-lane values over a warp (N <= 32)
// with fewer shuffles. A tree of __shfl_down_sync at offsets 16, 8, 4, 2, 1
// costs 5 shuffles a value; here, at each offset below N, a lane keeps the
// half of its values its lane bit names and trades the other half with the
// lane across (31 shuffles for 32 values, not 160), at the offsets from N
// up it adds the lane across to every value. Every addition has the
// operands the tree's has, and a float addition is commutative, so lane m
// (m < N) returns bitwise the sum a shuffle-down tree of value m leaves in
// lane 0.
template <int N>
__device__ __forceinline__ float warp_tree(const float (&acc)[N], int lane) {
  constexpr int P = N > 16 ? 32 : N > 8 ? 16 : N > 4 ? 8 : N > 2 ? 4 : N > 1 ? 2 : 1;
  float x[P];
#pragma unroll
  for (int m = 0; m < P; ++m) x[m] = m < N ? acc[m] : 0.0f;
  tree_fold<16, P>(x);
  if constexpr (P > 1) tree_levels<P / 2, P>(x, lane);
  return x[0];
}

// The fixed-order sum of N <= 32 per-thread partials over a pair: the
// shuffle-down tree in each warp (warp_tree), the `nwarps` partials of
// warps first .. first + nwarps - 1 added in order by lane m of warp 0
// (warps before `first` contribute nothing), then, over `sp.ranks` > 1
// blocks, each rank's sum written into every rank's slot `par`
// (distributed shared memory) behind one cluster barrier and the ranks'
// sums added in rank order by every rank alike. The result is on lanes
// m < N of warp 0 (other threads: 0). `part` holds kMaxWarps x 32 floats
// and `slot` 2 x kMaxCluster x 32, both in shared memory. Every thread of
// the block, and with ranks > 1 of every block of the cluster, must call;
// a block barrier must separate two calls.
template <int N>
__device__ __forceinline__ float pair_sum(const float (&acc)[N], float* part, float* slot,
                                          int first, int nwarps, const Split& sp, int par,
                                          int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const float v = warp_tree(acc, lane);
  if (lane < N && warp >= first) part[(warp - first) * 32 + lane] = v;
  __syncthreads();
  float s = 0.0f;
  if (warp == 0 && lane < N) {
    s = part[lane];
    for (int q = 1; q < nwarps; ++q) s += part[q * 32 + lane];
  }
  if (sp.ranks > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* mine = slot + (par * kMaxCluster + sp.q) * 32 + lane;
    if (warp == 0 && lane < N)
      for (int d = 0; d < sp.ranks; ++d) *cluster.map_shared_rank(mine, sp.base + d) = s;
    cluster.sync();
    if (warp == 0 && lane < N) {
      const float* row = slot + par * kMaxCluster * 32 + lane;
      s = row[0];
      for (int d = 1; d < sp.ranks; ++d) s += row[d * 32];
    }
  }
  return s;
}

}  // namespace rgbd
