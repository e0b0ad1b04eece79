// The 8-point fundamental-matrix RANSAC filter in one launch, for Hopper.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `ransac_fundamental_filter` (rgbd_odometry_tpu/ops/epipolar.py:91): the
// Hartley normalization (:37), the vmapped hypotheses (:134) with their
// `lax.top_k` samples (:126), the 9x9 `eigh` (:62), the rank-2 `svd`
// (:69), the Sampson scores, `argmax` and the best hypothesis's inliers.
//
// The arithmetic is that of the twin `fundamental_ransac_steps`
// (kernels/epipolar.py, whose docstring lists it step by step), operation
// for operation with round-to-nearest intrinsics (nothing contracted into a
// fused multiply-add; sqrt and division correctly rounded), so the two agree
// to the last bit. The eigenproblems run in float64: the 8-point system's
// normal matrix squares its condition, and near-degenerate samples (points
// on few planes) leave eigenvalue gaps of 1e-8..1e-6 relative, below what a
// float32 solver resolves.
//
// Layout: one cluster of kRanks blocks x kWarps warps, a warp a hypothesis
// (warp g takes hypotheses g, g + 64, ...):
//   1. every block computes both Hartley normalizations itself (warps 0
//      and 1, the same bits on every block): 32 lane sums folded by a
//      shuffle-down tree;
//   2. the sample: 8 rounds of a scan over the lane's points (l, l + 32,
//      ...) and two warp reductions (the largest score, then the lowest
//      index holding it); a point is free while it comes after the last one
//      taken in descending (score, -index), so no mask is kept and any K
//      works;
//   3. the normal matrix, one of its 45 entries a lane;
//   4. the cyclic Jacobi on the warp, the matrix and V in the warp's shared
//      memory: a round's four rotations computed on lanes 0..3, the column
//      pass (A and V, 72 tasks) and the row pass (36 tasks) over the lanes;
//   5. F = T2^T Fn T1 one entry a lane, F^T F, its 3x3 Jacobi, rank 2;
//   6. the Sampson count over the lane's points and a warp sum;
//   7. the first best count: (count, -h) compared in the warp's loop, the
//      block and, through distributed shared memory, the cluster; rank 0
//      then writes the winner's inlier mask (or every valid pair, below
//      min_points) and its count.
// What bounds it on the H100: not the bytes (the S x K uniforms, 98 KB at
// S = 64, K = 384: 0.03 us) nor the operations, but each hypothesis's
// serial chain: 8 sample rounds, then Jacobi rounds of three float64
// divisions and two square roots each (9 rounds a sweep, ~5-8 sweeps),
// then the 3x3 Jacobi; the hypotheses run side by side on 64 warps.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "se3.cuh"
#include "warp.cuh"

namespace {

using rgbd::fadd;
using rgbd::fdiv;
using rgbd::fmul;
using rgbd::fsub;
using rgbd::kFull;

constexpr int kWarps = 8;   // warps a block
constexpr int kRanks = 8;   // blocks a cluster: 64 warps, a hypothesis each
constexpr int kSample = 8;
constexpr int kSweeps = 16;          // kernels/epipolar.py SWEEPS
constexpr double kTol = 0x1p-40;     // kernels/epipolar.py TOL
constexpr int kNone = 0x7fffffff;

// kernels/epipolar.py SCHEDULE9: the 36 pairs of the 9x9 Jacobi, four
// disjoint pairs a round
__constant__ int8_t kSchedule9[9][4][2] = {
    {{1, 8}, {2, 7}, {3, 6}, {4, 5}}, {{0, 8}, {1, 6}, {2, 5}, {3, 4}},
    {{0, 7}, {6, 8}, {1, 4}, {2, 3}}, {{0, 6}, {5, 7}, {4, 8}, {1, 2}},
    {{0, 5}, {4, 6}, {3, 7}, {2, 8}}, {{0, 4}, {3, 5}, {2, 6}, {1, 7}},
    {{0, 3}, {2, 4}, {1, 5}, {7, 8}}, {{0, 2}, {1, 3}, {5, 8}, {6, 7}},
    {{0, 1}, {3, 8}, {4, 7}, {5, 6}},
};
// SCHEDULE3: the 3x3 Jacobi's pairs, one a round
__constant__ int8_t kSchedule3[3][1][2] = {{{0, 1}}, {{0, 2}}, {{1, 2}}};

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double ddiv(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// A float's bits as an unsigned that orders as the float does (for the
// sample scores, which are never 0 or NaN), and above 0.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (count, hypothesis) a is the better: the larger count, then the lower
// index (argmax's first index).
__device__ __forceinline__ bool better(int ca, int ha, int cb, int hb) {
  return ca > cb || (ca == cb && ha < hb);
}

// The shuffle-down tree red[v] += red[v + s], s = 16, ..., 1: lane 0 holds
// the sum.
__device__ __forceinline__ float lane_tree(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fadd(v, __shfl_down_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

// One point set's normalization (s, mu_u, mu_v) and valid count, on one
// warp (every lane returns them).
struct Hartley {
  float s, mu_u, mu_v;
  int n;
};

__device__ Hartley hartley(const float* __restrict__ uv, const uint8_t* __restrict__ valid,
                           int k, int lane) {
  float su = 0.0f, sv = 0.0f;
  int cnt = 0;
  for (int i = lane; i < k; i += 32)
    if (valid[i]) {
      su = fadd(su, uv[2 * i]);
      sv = fadd(sv, uv[2 * i + 1]);
      ++cnt;
    }
  su = __shfl_sync(kFull, lane_tree(su), 0);
  sv = __shfl_sync(kFull, lane_tree(sv), 0);
  const int n = __reduce_add_sync(kFull, cnt);
  const float nf = fmaxf((float)n, 1.0f);
  Hartley h;
  h.mu_u = fdiv(su, nf);
  h.mu_v = fdiv(sv, nf);
  h.n = n;
  float sr = 0.0f;
  for (int i = lane; i < k; i += 32)
    if (valid[i]) {
      const float du = fsub(uv[2 * i], h.mu_u), dv = fsub(uv[2 * i + 1], h.mu_v);
      sr = fadd(sr, fadd(fmul(du, du), fmul(dv, dv)));
    }
  sr = __shfl_sync(kFull, lane_tree(sr), 0);
  const float d = __fsqrt_rn(fdiv(sr, nf));
  h.s = fdiv(static_cast<float>(1.4142135623730951), fmaxf(d, 1e-8f));
  return h;
}

// Component c of a = (u2 u1, u2 v1, u2, v2 u1, v2 v1, v2, u1, v1, 1).
__device__ __forceinline__ float a_comp(int c, float u1, float v1, float u2, float v2) {
  switch (c) {
    case 0: return fmul(u2, u1);
    case 1: return fmul(u2, v1);
    case 2: return u2;
    case 3: return fmul(v2, u1);
    case 4: return fmul(v2, v1);
    case 5: return v2;
    case 6: return u1;
    case 7: return v1;
    default: return 1.0f;
  }
}

// The rotation (c, s, t) zeroing apq; the identity where apq is 0.
__device__ __forceinline__ void rotation(double app, double aqq, double apq, double& c, double& s,
                                         double& t) {
  if (apq == 0.0) {
    c = 1.0;
    s = 0.0;
    t = 0.0;
    return;
  }
  const double tau = ddiv(dsub(aqq, app), dmul(2.0, apq));
  const double den = dadd(fabs(tau), __dsqrt_rn(dadd(1.0, dmul(tau, tau))));
  t = ddiv(tau >= 0.0 ? 1.0 : -1.0, den);
  c = ddiv(1.0, __dsqrt_rn(dadd(1.0, dmul(t, t))));
  s = dmul(t, c);
}

// Cyclic Jacobi of the symmetric N x N matrix A (row-major, the warp's
// shared memory) with V = I on entry: R rounds of P disjoint pairs a sweep
// (`sched`), each round's rotations applied to the columns of A and V,
// then the rows of A, then each pair's 2x2 block set; a sweep starts only
// while max |a_ij| (i != j) > kTol max |a_ii|. `cs` holds 2 P doubles.
template <int N, int R, int P>
__device__ void warp_jacobi(double* A, double* V, const int8_t (*sched)[P][2], double* cs,
                            int lane) {
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    double off = 0.0, dm = 0.0;
    for (int e = lane; e < N * N; e += 32) {
      const double x = fabs(A[e]);
      if (e % (N + 1) == 0) dm = fmax(dm, x);
      else off = fmax(off, x);
    }
    off = warp_max(off);
    dm = warp_max(dm);
    if (off <= dmul(dm, kTol)) break;
    for (int r = 0; r < R; ++r) {
      int p = 0, q = 0;
      double app = 0.0, aqq = 0.0, apq = 0.0, t = 0.0;
      if (lane < P) {
        p = sched[r][lane][0];
        q = sched[r][lane][1];
        app = A[p * N + p];
        aqq = A[q * N + q];
        apq = A[p * N + q];
        double c, s;
        rotation(app, aqq, apq, c, s, t);
        cs[2 * lane] = c;
        cs[2 * lane + 1] = s;
      }
      __syncwarp();
      for (int task = lane; task < 2 * N * P; task += 32) {  // columns of A, then of V
        double* M = task < N * P ? A : V;
        const int rem = task % (N * P), j = rem / N, row = rem % N;
        const int pj = sched[r][j][0], qj = sched[r][j][1];
        const double c = cs[2 * j], s = cs[2 * j + 1];
        const double x = M[row * N + pj], y = M[row * N + qj];
        M[row * N + pj] = dsub(dmul(c, x), dmul(s, y));
        M[row * N + qj] = dadd(dmul(s, x), dmul(c, y));
      }
      __syncwarp();
      for (int task = lane; task < N * P; task += 32) {  // rows of A
        const int j = task / N, col = task % N;
        const int pj = sched[r][j][0], qj = sched[r][j][1];
        const double c = cs[2 * j], s = cs[2 * j + 1];
        const double x = A[pj * N + col], y = A[qj * N + col];
        A[pj * N + col] = dsub(dmul(c, x), dmul(s, y));
        A[qj * N + col] = dadd(dmul(s, x), dmul(c, y));
      }
      __syncwarp();
      if (lane < P) {
        A[p * N + p] = dsub(app, dmul(t, apq));
        A[q * N + q] = dadd(aqq, dmul(t, apq));
        A[p * N + q] = 0.0;
        A[q * N + p] = 0.0;
      }
      __syncwarp();
    }
  }
}

// The column of V at the first smallest diagonal entry of A (N x N).
template <int N>
__device__ __forceinline__ int smallest(const double* A) {
  int j = 0;
#pragma unroll
  for (int e = 1; e < N; ++e)
    if (A[e * (N + 1)] < A[j * (N + 1)]) j = e;
  return j;
}

// Step 6's Sampson distance of pair i under F (row-major float32).
__device__ __forceinline__ float sampson(const float F[9], const float* __restrict__ uv1,
                                         const float* __restrict__ uv2, int i) {
  const float u1 = uv1[2 * i], v1 = uv1[2 * i + 1], u2 = uv2[2 * i], v2 = uv2[2 * i + 1];
  float fx[3], ftx[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) fx[r] = fadd(fadd(fmul(F[r * 3 + 0], u1), fmul(F[r * 3 + 1], v1)), F[r * 3 + 2]);
#pragma unroll
  for (int c = 0; c < 2; ++c) ftx[c] = fadd(fadd(fmul(F[0 * 3 + c], u2), fmul(F[1 * 3 + c], v2)), F[2 * 3 + c]);
  const float e = fadd(fadd(fmul(u2, fx[0]), fmul(v2, fx[1])), fx[2]);
  const float den = fadd(fadd(fadd(fmul(fx[0], fx[0]), fmul(fx[1], fx[1])), fmul(ftx[0], ftx[0])),
                         fmul(ftx[1], ftx[1]));
  return fdiv(fmul(e, e), fmaxf(den, 1e-12f));
}

// One warp's shared memory: the 9x9 (or 3x3) matrix and V, a round's (c,
// s), F in float64 and the hypothesis's float32 F.
struct WarpSmem {
  double A[81], V[81], cs[8], F[9];
  float F32[9];
};

__global__ void __launch_bounds__(kWarps * 32)
fundamental_ransac_kernel(const float* __restrict__ u, const float* __restrict__ uv1,
                          const float* __restrict__ uv2, const uint8_t* __restrict__ valid,
                          int hyps, int k, int min_points, float thr2,
                          uint8_t* __restrict__ inl_out, int* __restrict__ num_out,
                          float* __restrict__ F_out, int* __restrict__ counts_out) {
  namespace cg = cooperative_groups;
  __shared__ WarpSmem ws[kWarps];
  __shared__ float hart[2][3];  // (s, mu_u, mu_v) of uv1, uv2
  __shared__ int n_valid;
  __shared__ float warp_F[kWarps][9];
  __shared__ int warp_count[kWarps], warp_h[kWarps];
  __shared__ int rank_count[kRanks], rank_h[kRanks], rank_w[kRanks];  // rank 0's
  __shared__ float win_F[9];
  __shared__ int total;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  WarpSmem& me = ws[warp];

  // step 1 on warps 0 and 1 of every block
  if (warp < 2) {
    const Hartley h = hartley(warp == 0 ? uv1 : uv2, valid, k, lane);
    if (lane == 0) {
      hart[warp][0] = h.s;
      hart[warp][1] = h.mu_u;
      hart[warp][2] = h.mu_v;
      if (warp == 0) n_valid = h.n;
    }
  }
  if (tid == 0) total = 0;
  __syncthreads();
  const float s1 = hart[0][0], m1u = hart[0][1], m1v = hart[0][2];
  const float s2 = hart[1][0], m2u = hart[1][1], m2v = hart[1][2];

  int best_c = -1, best_h = kNone;
  for (int h = rank * kWarps + warp; h < hyps; h += kRanks * kWarps) {
    const float* U = u + (size_t)h * k;
    // step 2: the sample, in descending (score, -index)
    int pick[kSample];
    unsigned last_key = 0xffffffffu;
    int last_i = -1;
#pragma unroll
    for (int r = 0; r < kSample; ++r) {
      float bs = neg_inf();
      int bi = kNone;
      for (int i = lane; i < k; i += 32) {
        const float sc = fadd(U[i], valid[i] ? 1.0f : -1.0f);
        const unsigned key = ordered(sc);
        const bool open = key < last_key || (key == last_key && i > last_i);
        const bool take = open && (sc > bs || bi == kNone);
        bs = take ? sc : bs;
        bi = take ? i : bi;
      }
      const unsigned key = bi == kNone ? 0u : ordered(bs);
      const unsigned top = __reduce_max_sync(kFull, key);
      const unsigned p = __reduce_min_sync(kFull, key == top && bi != kNone ? (unsigned)bi
                                                                          : 0xffffffffu);
      last_key = top;
      last_i = (int)p;
      pick[r] = (int)p;
    }
    // step 3: N, entry (i, j), i <= j, on lane < 45
    for (int e = lane; e < 45; e += 32) {
      int i = 0, rem = e;
      while (rem >= 9 - i) {
        rem -= 9 - i;
        ++i;
      }
      const int j = i + rem;
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < kSample; ++r) {
        const int pt = pick[r];
        if (!valid[pt]) continue;
        const float a1u = fmul(fsub(uv1[2 * pt], m1u), s1), a1v = fmul(fsub(uv1[2 * pt + 1], m1v), s1);
        const float a2u = fmul(fsub(uv2[2 * pt], m2u), s2), a2v = fmul(fsub(uv2[2 * pt + 1], m2v), s2);
        acc = fadd(acc, fmul(a_comp(i, a1u, a1v, a2u, a2v), a_comp(j, a1u, a1v, a2u, a2v)));
      }
      me.A[i * 9 + j] = (double)acc;
      me.A[j * 9 + i] = (double)acc;
    }
    for (int e = lane; e < 81; e += 32) me.V[e] = e % 10 == 0 ? 1.0 : 0.0;
    __syncwarp();
    // step 4
    warp_jacobi<9, 9, 4>(me.A, me.V, kSchedule9, me.cs, lane);
    const int jf = smallest<9>(me.A);
    // step 5: F = T2^T Fn T1 (lane e = 3 i + j), Fn[a][b] = V[3 a + b][jf]
    double Fe = 0.0;
    if (lane < 9) {
      const int i = lane / 3, j = lane % 3;
      const double t1[3][3] = {{s1, 0.0, -fmul(s1, m1u)}, {0.0, s1, -fmul(s1, m1v)}, {0.0, 0.0, 1.0}};
      const double t2[3][3] = {{s2, 0.0, -fmul(s2, m2u)}, {0.0, s2, -fmul(s2, m2v)}, {0.0, 0.0, 1.0}};
      double M[3];  // (Fn T1)[kk][j]
#pragma unroll
      for (int kk = 0; kk < 3; ++kk)
        M[kk] = dadd(dadd(dmul(me.V[(3 * kk + 0) * 9 + jf], t1[0][j]),
                          dmul(me.V[(3 * kk + 1) * 9 + jf], t1[1][j])),
                     dmul(me.V[(3 * kk + 2) * 9 + jf], t1[2][j]));
      Fe = dadd(dadd(dmul(t2[0][i], M[0]), dmul(t2[1][i], M[1])), dmul(t2[2][i], M[2]));
    }
    __syncwarp();
    if (lane < 9) me.F[lane] = Fe;
    __syncwarp();
    // F^T F into A (3x3), V = I
    if (lane < 9) {
      const int a = lane / 3, b = lane % 3;
      me.A[lane] = dadd(dadd(dmul(me.F[0 * 3 + a], me.F[0 * 3 + b]), dmul(me.F[1 * 3 + a], me.F[1 * 3 + b])),
                        dmul(me.F[2 * 3 + a], me.F[2 * 3 + b]));
      me.V[lane] = lane % 4 == 0 ? 1.0 : 0.0;
    }
    __syncwarp();
    warp_jacobi<3, 3, 1>(me.A, me.V, kSchedule3, me.cs, lane);
    const int jv = smallest<3>(me.A);
    if (lane < 9) {
      const int i = lane / 3, j = lane % 3;
      const double v0 = me.V[0 * 3 + jv], v1 = me.V[1 * 3 + jv], v2 = me.V[2 * 3 + jv];
      const double vj = j == 0 ? v0 : j == 1 ? v1 : v2;
      const double Fv = dadd(dadd(dmul(me.F[i * 3 + 0], v0), dmul(me.F[i * 3 + 1], v1)),
                             dmul(me.F[i * 3 + 2], v2));
      me.F32[lane] = __double2float_rn(dsub(me.F[lane], dmul(Fv, vj)));
    }
    __syncwarp();
    float F[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) F[e] = me.F32[e];
    // step 6
    int c = 0;
    for (int i = lane; i < k; i += 32) c += (valid[i] && sampson(F, uv1, uv2, i) < thr2) ? 1 : 0;
    c = __reduce_add_sync(kFull, c);
    if (lane == 0 && counts_out != nullptr) counts_out[h] = c;
    if (better(c, h, best_c, best_h)) {
      best_c = c;
      best_h = h;
      if (lane < 9) warp_F[warp][lane] = me.F32[lane];
    }
    __syncwarp();
  }

  // step 7: the first best count over the warps, then the ranks
  if (lane == 0) {
    warp_count[warp] = best_c;
    warp_h[warp] = best_h;
  }
  __syncthreads();
  if (tid == 0) {
    int bw = 0;
    for (int w = 1; w < kWarps; ++w)
      if (better(warp_count[w], warp_h[w], warp_count[bw], warp_h[bw])) bw = w;
    *cluster.map_shared_rank(&rank_count[rank], 0) = warp_count[bw];
    *cluster.map_shared_rank(&rank_h[rank], 0) = warp_h[bw];
    *cluster.map_shared_rank(&rank_w[rank], 0) = bw;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    int br = 0;
    for (int r = 1; r < kRanks; ++r)
      if (better(rank_count[r], rank_h[r], rank_count[br], rank_h[br])) br = r;
    const float* src = cluster.map_shared_rank(&warp_F[rank_w[br]][0], br);
    for (int e = 0; e < 9; ++e) win_F[e] = src[e];
  }
  cluster.sync();  // no rank reads another's shared memory past here
  if (rank != 0) return;

  float F[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) F[e] = win_F[e];
  const bool enough = n_valid >= min_points;
  int c = 0;
  for (int i = tid; i < k; i += blockDim.x) {
    const bool v = valid[i] != 0;
    const bool in = enough ? (v && sampson(F, uv1, uv2, i) < thr2) : v;
    inl_out[i] = in ? 1 : 0;
    c += in ? 1 : 0;
  }
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) atomicAdd(&total, c);
  __syncthreads();
  if (tid < 9) F_out[tid] = F[tid];
  if (tid == 0) *num_out = total;
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// u (S,K) uniforms, uv1 and uv2 (K,2) float32, valid (K,) uint8, all
// contiguous; K >= 8, S >= 1. Outputs inliers (K,) uint8, num_inliers ()
// int32, F (3,3) float32 and, when counts_out is not null, each
// hypothesis's inlier count (S,) int32. thr2 is threshold_px^2. One
// cluster launch on `stream`, does not synchronize.
extern "C" int fundamental_ransac(int device, const void* u, const void* uv1, const void* uv2,
                                  const void* valid, int hyps, int k, int min_points, float thr2,
                                  void* inl_out, void* num_out, void* F_out, void* counts_out,
                                  void* stream) {
  if (hyps < 1 || k < kSample) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static rgbd::ClusterLaunch state;
  err = rgbd::launch_cluster(fundamental_ransac_kernel, device, dim3(kRanks), dim3(kWarps * 32), 0,
                             kRanks, (cudaStream_t)stream, &state, (const float*)u,
                             (const float*)uv1, (const float*)uv2, (const uint8_t*)valid, hyps, k,
                             min_points, thr2, (uint8_t*)inl_out, (int*)num_out, (float*)F_out,
                             (int*)counts_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
