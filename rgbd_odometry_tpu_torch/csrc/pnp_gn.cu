// Batched Gauss-Newton PnP with inlier scoring, and the whole RANSAC PnP in
// one launch, for Hopper.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `ransac_pnp` (rgbd_odometry_tpu/solvers/pnp.py:116-166): the selection of
// each hypothesis's points (`lax.top_k` of uniforms, :144), `jax.vmap(gn_pnp)`
// (:46-97), the inlier scoring, the first best count (:153) and the winner's
// refine on its inliers.
//
// Per Gauss-Newton iteration and problem: r = u_norm - dehom(R^T (P - t)),
// its 2x6 Jacobian (the reference's J = -A1 A2, SolvePnP.cpp:252-292), the
// sums J^T J (21 entries) and J^T r (6) over the masked points, then
// (J^T J + 1e-9 I) delta = -J^T r by the 6x6 Cholesky of se3.cuh and the
// right-multiplied update T exp(delta).
//
// The sum order, which both kernels and the plain version
// (kernels/pnp_gn.py `_block_sum`) share: 128 virtual threads, thread v
// adding the terms of its points v, v + 128, ... in order, then the pairwise
// tree red[v] += red[v + s] for s = 64, 32, ..., 1. Every operation is a
// round-to-nearest intrinsic (nothing contracted into a fused
// multiply-add), so the plain version reproduces each value exactly and
// ill-conditioned 4-point hypotheses cannot amplify an order difference.
//
// pnp_gn_kernel: B independent problems, one block of 128 threads each
// (thread v is virtual thread v; the tree in shared memory), `iters`
// iterations each, then each problem's inlier count; on request the
// residual norm before each iteration (a 28th sum, the tree's order). One
// thread takes the step while 127 wait. It serves the step-by-step RANSAC
// route (the hypotheses at B = 64, the refine at B = 1), which the CPU runs
// in its plain version and the card keeps as the check of the fused
// kernel, and the Gauss-Newton PnP of solvers/pnp.gn_pnp (B = 1).
//
// ransac_pnp_kernel: the whole RANSAC PnP with no host sync, one cluster of
// kRanks blocks x kWarps warps, a warp per hypothesis (warp g takes
// hypotheses g, g + 64, ...):
//   1. the sample: the `sample` largest u + (valid ? 1 : -1), ties to the
//      lower index (lax.top_k's rule), by as many rounds of a scan of the
//      lane's points (lane l holds points l + 32 q) and two warp reductions
//      (the largest score, then the lowest index holding it), ANDed with
//      valid;
//   2. Gauss-Newton on the warp: lane l is virtual threads l, l + 32,
//      l + 64, l + 96; it takes its sample points (at most a few) one after
//      another into the four virtual threads' sums while the other lanes
//      take theirs, folds the tree's first two levels in the lane
//      ((v + (v + 64)) + ((v + 32) + (v + 96))), and warp.cuh's warp_tree
//      takes the last five: the very additions of red[v] + red[v + s].
//      Every lane then solves the normal equations with se3.cuh's
//      one-thread Cholesky (the lanes-across-rows one was slower an
//      iteration on an H100, PERF.md) and takes exp and the compose in the
//      pose layout, one element a lane (warp.cuh's lane_se3_exp and
//      lane_compose: se3.cuh's se3_exp and this file's update, operation
//      for operation, with one double sincos for the sin and the cos);
//   3. the score: 12 points a lane at K = 384, an integer warp reduction;
//   4. the first best count: (count, -h) compared lexicographically in the
//      warp, the block and, through distributed shared memory, the cluster,
//      so the result is independent of which warp took which hypothesis;
//   5. the winner's inliers, recomputed at its pose by rank 0 (the
//      function that scored it, so bitwise its count);
//   6. the refine on rank 0's first four warps, thread v virtual thread v,
//      the tree's first two levels through shared memory to warp 0, the
//      step on warp 0.
// What bounds it on the H100: not the arithmetic (~130 float32 operations a
// masked point and iteration, K = 384) but the chain of hypothesis_iters +
// refine_iters serial steps, each a sum tree, a 6x6 Cholesky with correctly
// rounded square roots and divisions, and se3_exp's double sin and cos;
// the launch replaces the ~15 launches of the step-by-step route.

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

constexpr int kThreads = 128;
constexpr int kTerms = 27;  // 21 upper entries of J^T J, 6 of J^T r

struct Point {
  float r0, r1;
  float ju[6], jv[6];
};

__device__ __forceinline__ Point point_terms(const float* __restrict__ P,
                                             const float* __restrict__ u, const float R[9],
                                             const float t[3]) {
  const float d0 = fsub(P[0], t[0]);
  const float d1 = fsub(P[1], t[1]);
  const float d2 = fsub(P[2], t[2]);
  float pb[3];
  for (int j = 0; j < 3; ++j)
    pb[j] = fadd(fadd(fmul(R[0 * 3 + j], d0), fmul(R[1 * 3 + j], d1)), fmul(R[2 * 3 + j], d2));
  const float z = pb[2];
  const float zs = fabsf(z) < 1e-12f ? 1e-12f : z;
  Point p;
  p.r0 = fsub(u[0], fdiv(pb[0], zs));
  p.r1 = fsub(u[1], fdiv(pb[1], zs));
  const float iz = __frcp_rn(zs);
  const float zz = fmul(zs, zs);
  const float c0 = fdiv(-pb[0], zz);
  const float c1 = fdiv(-pb[1], zz);
  for (int j = 0; j < 3; ++j) {
    p.ju[j] = fadd(fmul(R[j * 3 + 0], iz), fmul(R[j * 3 + 2], c0));
    p.jv[j] = fadd(fmul(R[j * 3 + 1], iz), fmul(R[j * 3 + 2], c1));
  }
  p.ju[3] = fmul(c0, pb[1]);
  p.ju[4] = fsub(fmul(iz, pb[2]), fmul(c0, pb[0]));
  p.ju[5] = -fmul(iz, pb[1]);
  p.jv[3] = fsub(fmul(c1, pb[1]), fmul(iz, pb[2]));
  p.jv[4] = -fmul(c1, pb[0]);
  p.jv[5] = fmul(iz, pb[0]);
  return p;
}

__global__ void __launch_bounds__(kThreads)
pnp_gn_kernel(const float* __restrict__ obj, const float* __restrict__ imn,
              const uint8_t* __restrict__ masks, const float* __restrict__ R0,
              const float* __restrict__ t0, const uint8_t* __restrict__ score_mask, int k,
              int iters, float thresh, float* __restrict__ R_out, float* __restrict__ t_out,
              int* __restrict__ count_out, uint8_t* __restrict__ inl_out,
              float* __restrict__ rn_out) {
  __shared__ float red[kTerms + 1][kThreads];
  __shared__ float pose[12];
  __shared__ int cnt[kThreads];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* M = masks + (size_t)b * k;
  if (tid < 9) pose[tid] = R0[(size_t)b * 9 + tid];
  if (tid < 3) pose[9 + tid] = t0[(size_t)b * 3 + tid];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float R[9], t[3];
    for (int i = 0; i < 9; ++i) R[i] = pose[i];
    for (int i = 0; i < 3; ++i) t[i] = pose[9 + i];
    float acc[kTerms + 1];
    for (int n = 0; n <= kTerms; ++n) acc[n] = 0.0f;
    for (int i = tid; i < k; i += kThreads) {
      if (!M[i]) continue;
      const Point p = point_terms(obj + 3 * i, imn + 2 * i, R, t);
      int n = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c, ++n)
          acc[n] = fadd(acc[n], fadd(fmul(p.ju[a], p.ju[c]), fmul(p.jv[a], p.jv[c])));
      for (int a = 0; a < 6; ++a)
        acc[21 + a] = fadd(acc[21 + a], fadd(fmul(p.ju[a], p.r0), fmul(p.jv[a], p.r1)));
      acc[kTerms] = fadd(acc[kTerms], fadd(fmul(p.r0, p.r0), fmul(p.r1, p.r1)));
    }
    // the residual's squared norm is a 28th sum, reduced only when asked for
    const int nterms = rn_out != nullptr ? kTerms + 1 : kTerms;
    for (int n = 0; n <= kTerms; ++n) red[n][tid] = acc[n];
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s)
        for (int n = 0; n < nterms; ++n) red[n][tid] = fadd(red[n][tid], red[n][tid + s]);
      __syncthreads();
    }
    if (tid == 0 && rn_out != nullptr) rn_out[(size_t)b * iters + it] = __fsqrt_rn(red[kTerms][0]);
    if (tid == 0) {
      float H[36], g[6], x[6];
      int n = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c, ++n) H[a * 6 + c] = H[c * 6 + a] = red[n][0];
      for (int a = 0; a < 6; ++a) {
        H[a * 6 + a] = fadd(H[a * 6 + a], 1e-9f);
        g[a] = red[21 + a][0];
      }
      rgbd::chol_solve6(H, g, x);
      float psi[6], xR[9], xt[3], Rn[9];
      for (int a = 0; a < 6; ++a) psi[a] = -x[a];
      rgbd::se3_exp(psi, xR, xt);
      for (int i = 0; i < 3; ++i)
        pose[9 + i] = fadd(t[i], fadd(fadd(fmul(R[i * 3 + 0], xt[0]), fmul(R[i * 3 + 1], xt[1])),
                                      fmul(R[i * 3 + 2], xt[2])));
      rgbd::mat3(R, xR, Rn);
      for (int i = 0; i < 9; ++i) pose[i] = Rn[i];
    }
    __syncthreads();
  }

  float R[9], t[3];
  for (int i = 0; i < 9; ++i) R[i] = pose[i];
  for (int i = 0; i < 3; ++i) t[i] = pose[9 + i];
  int c = 0;
  for (int i = tid; i < k; i += kThreads) {
    const Point p = point_terms(obj + 3 * i, imn + 2 * i, R, t);
    const float err = __fsqrt_rn(fadd(fmul(p.r0, p.r0), fmul(p.r1, p.r1)));
    const bool inl = score_mask[i] && err < thresh;
    c += inl ? 1 : 0;
    if (inl_out != nullptr) inl_out[(size_t)b * k + i] = inl ? 1 : 0;
  }
  cnt[tid] = c;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) cnt[tid] += cnt[tid + s];
    __syncthreads();
  }
  if (tid < 9) R_out[(size_t)b * 9 + tid] = R[tid];
  if (tid < 3) t_out[(size_t)b * 3 + tid] = t[tid];
  if (tid == 0) count_out[b] = cnt[0];
}

// ---------------------------------------------------------------------------
// ransac_pnp_kernel

constexpr int kWarps = 8;            // warps a block
constexpr int kRanks = 8;            // blocks a cluster: 64 warps, a hypothesis each
constexpr int kMaxPoints = 1024;     // K: at most 32 points a lane, one bit each
constexpr int kVirtual = 128;        // the sum order's virtual threads
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// A float's bits as an unsigned that orders as the float does (for the
// scores, which are never 0 or NaN), and above 0.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (count, hypothesis) a is the better: the larger count, then the lower
// index (argmax's first index).
__device__ __forceinline__ bool better(int ca, int ha, int cb, int hb) {
  return ca > cb || (ca == cb && ha < hb);
}

// The 27 terms of one point, as pnp_gn_kernel adds them.
__device__ __forceinline__ void point_sums(const Point& p, float (&x)[kTerms]) {
  int n = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c, ++n) x[n] = fadd(fmul(p.ju[a], p.ju[c]), fmul(p.jv[a], p.jv[c]));
#pragma unroll
  for (int a = 0; a < 6; ++a) x[21 + a] = fadd(fmul(p.ju[a], p.r0), fmul(p.jv[a], p.r1));
}

__device__ __forceinline__ void add_into(float (&acc)[kTerms], const float (&x)[kTerms]) {
#pragma unroll
  for (int n = 0; n < kTerms; ++n) acc[n] = fadd(acc[n], x[n]);
}

// The pose as every lane holds it (R row-major, t) from the lane layout
// (lane e < 12 holds element e).
__device__ __forceinline__ void pose_of(float p, float R[9], float t[3]) {
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = __shfl_sync(rgbd::kFull, p, e);
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = __shfl_sync(rgbd::kFull, p, 9 + e);
}

// The Gauss-Newton step from the 27 sums of the warp's lanes (lane n < 27
// holds sum n): every lane solves (J^T J + 1e-9 I) x = J^T r with the
// one-thread Cholesky, then exp(-x) and the compose in the lane layout
// (warp.cuh's lane_se3_exp and lane_compose, operation for operation
// se3.cuh's se3_exp and pnp_gn_kernel's update). Returns the lane's new
// pose element.
__device__ __forceinline__ float gn_step(float mine, float p, int lane) {
  float H[36], g[6], x[6];
  int n = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c, ++n) H[a * 6 + c] = H[c * 6 + a] = __shfl_sync(rgbd::kFull, mine, n);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    H[a * 6 + a] = fadd(H[a * 6 + a], 1e-9f);
    g[a] = __shfl_sync(rgbd::kFull, mine, 21 + a);
  }
  rgbd::chol_solve6(H, g, x);
  float psi[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) psi[a] = -x[a];
  return rgbd::lane_compose(p, rgbd::lane_se3_exp(psi, lane), lane);
}

// One Gauss-Newton iteration of one problem on a warp. Bit q of `sel` is
// point lane + 32 q, which is virtual thread lane + 32 (q % 4)'s run q / 4:
// the lane takes its points in ascending q (so each virtual thread's in
// ascending order) into four running sums, folds them as the tree's first
// two levels do, and the shuffle-down tree does the rest. A lane's points
// run one after another, the lanes' side by side: a 4-point sample costs
// about one point's latency.
__device__ __forceinline__ float warp_gn_iteration(unsigned sel, const float* obj,
                                                   const float* imn, int lane, float p) {
  float R[9], t[3];
  pose_of(p, R, t);
  float a0[kTerms], a1[kTerms], a2[kTerms], a3[kTerms];
#pragma unroll
  for (int n = 0; n < kTerms; ++n) a0[n] = a1[n] = a2[n] = a3[n] = 0.0f;
  for (unsigned b = sel; b != 0; b &= b - 1) {
    const int q = __ffs(b) - 1;
    const int i = lane + 32 * q;
    float x[kTerms];
    point_sums(point_terms(obj + 3 * i, imn + 2 * i, R, t), x);
    switch (q & 3) {
      case 0: add_into(a0, x); break;
      case 1: add_into(a1, x); break;
      case 2: add_into(a2, x); break;
      default: add_into(a3, x); break;
    }
  }
  float part[kTerms];
#pragma unroll
  for (int n = 0; n < kTerms; ++n) part[n] = fadd(fadd(a0[n], a2[n]), fadd(a1[n], a3[n]));
  return gn_step(rgbd::warp_tree(part, lane), p, lane);
}

// Whether point i is an inlier at (R, t): valid and |r| < thresh, the
// scoring of pnp_gn_kernel.
__device__ __forceinline__ bool inlier(int i, const float* obj, const float* imn,
                                       const uint8_t* valid, const float R[9], const float t[3],
                                       float thresh) {
  const Point p = point_terms(obj + 3 * i, imn + 2 * i, R, t);
  const float err = __fsqrt_rn(fadd(fmul(p.r0, p.r0), fmul(p.r1, p.r1)));
  return valid[i] && err < thresh;
}

__global__ void __launch_bounds__(kWarps * 32)
ransac_pnp_kernel(const float* __restrict__ u, const float* __restrict__ obj_g,
                  const float* __restrict__ imn_g, const uint8_t* __restrict__ valid_g,
                  const float* __restrict__ R0, const float* __restrict__ t0, int hyps, int k,
                  int sample, int hyp_iters, int refine_iters, float thresh,
                  float* __restrict__ R_out, float* __restrict__ t_out,
                  uint8_t* __restrict__ inl_out, int* __restrict__ num_out,
                  long long* __restrict__ best_out) {
  namespace cg = cooperative_groups;
  __shared__ float obj[kMaxPoints * 3];
  __shared__ float imn[kMaxPoints * 2];
  __shared__ uint8_t valid[kMaxPoints];
  __shared__ float warp_pose[kWarps][12];
  __shared__ int warp_count[kWarps], warp_h[kWarps];
  __shared__ int rank_count[kRanks], rank_h[kRanks], rank_w[kRanks];  // rank 0's
  __shared__ float pose[12];
  __shared__ int winner[2];
  __shared__ float red[kTerms][kVirtual];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 3 * k; i += blockDim.x) {
    obj[i] = obj_g[i];
    if (i < 2 * k) imn[i] = imn_g[i];
    if (i < k) valid[i] = valid_g[i];
  }
  // the start pose in the lane layout
  const int e = lane < 12 ? lane : 11;
  const float start = e < 9 ? (R0 ? R0[e] : rgbd::lane_eye(e, 1.0f)) : (t0 ? t0[e - 9] : 0.0f);
  __syncthreads();
  unsigned vbits = 0;  // lane l's valid points l + 32 q
  for (int i = lane; i < k; i += 32)
    if (valid[i]) vbits |= 1u << (i >> 5);

  // steps 1-3, a warp per hypothesis
  int best_c = -1, best_h = kNone;
  float best_p = 0.0f;
  for (int h = rank * kWarps + warp; h < hyps; h += kRanks * kWarps) {
    const float* U = u + (size_t)h * k;
    unsigned taken = 0;
    for (int r = 0; r < sample; ++r) {
      float bs = neg_inf();
      int bi = kNone;
#pragma unroll 4
      for (int i = lane; i < k; i += 32) {
        const int q = i >> 5;
        const float sc = fadd(U[i], ((vbits >> q) & 1u) ? 1.0f : -1.0f);
        const bool take = !((taken >> q) & 1u) && (sc > bs || bi == kNone);
        bs = take ? sc : bs;
        bi = take ? i : bi;
      }
      // the warp's largest score, then the lowest index holding it
      const unsigned key = bi == kNone ? 0u : ordered(bs);
      const unsigned top = __reduce_max_sync(rgbd::kFull, key);
      const unsigned pick = __reduce_min_sync(rgbd::kFull, key == top && bi != kNone ? (unsigned)bi
                                                                                : 0xffffffffu);
      if (pick != 0xffffffffu && (int)(pick & 31) == lane) taken |= 1u << (pick >> 5);
    }
    const unsigned sel = taken & vbits;
    float p = start;
    for (int it = 0; it < hyp_iters; ++it) p = warp_gn_iteration(sel, obj, imn, lane, p);
    float R[9], t[3];
    pose_of(p, R, t);
    int c = 0;
#pragma unroll 4
    for (int i = lane; i < k; i += 32) c += inlier(i, obj, imn, valid, R, t, thresh) ? 1 : 0;
    c = __reduce_add_sync(rgbd::kFull, c);
    if (better(c, h, best_c, best_h)) {
      best_c = c;
      best_h = h;
      best_p = p;
    }
  }

  // step 4: the first best count over the warps, then the ranks
  if (lane < 12) warp_pose[warp][lane] = best_p;
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
    const float* src = cluster.map_shared_rank(&warp_pose[rank_w[br]][0], br);
    for (int x = 0; x < 12; ++x) pose[x] = src[x];
    winner[0] = rank_count[br];
    winner[1] = rank_h[br];
  }
  cluster.sync();  // no rank reads another's shared memory past here
  if (rank != 0) return;

  // steps 5-6 on rank 0: the winner's inliers, then the refine on them,
  // thread v < 128 virtual thread v, the step on warp 0
  float p = pose[e];
  float R[9], t[3];
#pragma unroll
  for (int x = 0; x < 9; ++x) R[x] = pose[x];
#pragma unroll
  for (int x = 0; x < 3; ++x) t[x] = pose[9 + x];
  unsigned mine = 0;  // bit j: point tid + 128 j is an inlier
  if (tid < kVirtual) {
#pragma unroll 4
    for (int j = 0; tid + kVirtual * j < k; ++j) {
      const int i = tid + kVirtual * j;
      const bool in = inlier(i, obj, imn, valid, R, t, thresh);
      inl_out[i] = in ? 1 : 0;
      mine |= (in ? 1u : 0u) << j;
    }
  }
  for (int it = 0; it < refine_iters; ++it) {
    if (tid < kVirtual) {
      float acc[kTerms];
#pragma unroll
      for (int n = 0; n < kTerms; ++n) acc[n] = 0.0f;
      for (unsigned b = mine; b != 0; b &= b - 1) {
        const int i = tid + kVirtual * (__ffs(b) - 1);
        float x[kTerms];
        point_sums(point_terms(obj + 3 * i, imn + 2 * i, R, t), x);
        add_into(acc, x);
      }
#pragma unroll
      for (int n = 0; n < kTerms; ++n) red[n][tid] = acc[n];
    }
    __syncthreads();
    if (warp == 0) {
      float part[kTerms];
#pragma unroll
      for (int n = 0; n < kTerms; ++n)
        part[n] = fadd(fadd(red[n][lane], red[n][lane + 64]),
                       fadd(red[n][lane + 32], red[n][lane + 96]));
      p = gn_step(rgbd::warp_tree(part, lane), p, lane);
      if (lane < 12) pose[lane] = p;
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 9; ++x) R[x] = pose[x];
#pragma unroll
    for (int x = 0; x < 3; ++x) t[x] = pose[9 + x];
  }
  if (tid < 9) R_out[tid] = R[tid];
  if (tid < 3) t_out[tid] = t[tid];
  if (tid == 0) {
    *num_out = winner[0];
    *best_out = winner[1];
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// obj (K,3), imn (K,2), R0 (B,3,3), t0 (B,3) float32; masks (B,K) and
// score_mask (K,) uint8; all contiguous. Outputs R (B,3,3), t (B,3) float32,
// counts (B,) int32, when inl_out is not null inliers (B,K) uint8, and when
// rn_out is not null the residual norm |r| over the masked points before
// each iteration (B,iters) float32.
// Launches on `stream`, does not synchronize.
extern "C" int pnp_gn(int device, const void* obj, const void* imn, const void* masks,
                      const void* R0, const void* t0, const void* score_mask, int batch, int k,
                      int iters, float thresh, void* R_out, void* t_out, void* count_out,
                      void* inl_out, void* rn_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    pnp_gn_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)obj, (const float*)imn, (const uint8_t*)masks, (const float*)R0,
        (const float*)t0, (const uint8_t*)score_mask, k, iters, thresh, (float*)R_out,
        (float*)t_out, (int*)count_out, (uint8_t*)inl_out, (float*)rn_out);
  }
  return (int)cudaGetLastError();
}

// u (S,K) uniforms, obj (K,3), imn (K,2) float32, valid (K,) uint8, R0
// (3,3) and t0 (3,) float32 or null (the identity); all contiguous, K <=
// 1024. Outputs R (3,3), t (3,) float32, inliers (K,) uint8, num_inliers ()
// int32, best_hypothesis () int64. One cluster launch on `stream`, does
// not synchronize.
extern "C" int ransac_pnp(int device, const void* u, const void* obj, const void* imn,
                          const void* valid, const void* R0, const void* t0, int hyps, int k,
                          int sample, int hyp_iters, int refine_iters, float thresh, void* R_out,
                          void* t_out, void* inl_out, void* num_out, void* best_out,
                          void* stream) {
  if (hyps < 1 || k < 1 || k > kMaxPoints || sample < 1 || sample > k)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static rgbd::ClusterLaunch state;
  err = rgbd::launch_cluster(ransac_pnp_kernel, device, dim3(kRanks), dim3(kWarps * 32), 0,
                             kRanks, (cudaStream_t)stream, &state, (const float*)u,
                             (const float*)obj, (const float*)imn, (const uint8_t*)valid,
                             (const float*)R0, (const float*)t0, hyps, k, sample, hyp_iters,
                             refine_iters, thresh, (float*)R_out, (float*)t_out,
                             (uint8_t*)inl_out, (int*)num_out, (long long*)best_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
