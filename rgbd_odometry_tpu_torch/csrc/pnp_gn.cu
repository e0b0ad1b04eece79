// Batched Gauss-Newton PnP with inlier scoring, and the whole RANSAC PnP in
// one launch, for Hopper.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `gn_pnp` (rgbd_odometry_tpu/solvers/pnp.py:46-97) and `ransac_pnp`
// (:116-166): the selection of each hypothesis's points (`lax.top_k` of
// uniforms, :144), `jax.vmap(gn_pnp)`, the inlier scoring, the first best
// count (:153) and the winner's refine on its inliers.
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
// A problem's sums on a warp (LaneSums): lane l is virtual threads l,
// l + 32, l + 64 and l + 96; it takes its points l + 32 q in ascending q
// into the four running sums by q % 4, the lanes side by side, folds the
// tree's first two levels itself ((v + (v + 64)) + ((v + 32) + (v + 96)))
// and warp.cuh's warp_tree takes the last five: the very additions of
// red[v] + red[v + s]. The step (gn_step) runs on every lane of the warp:
// se3.cuh's one-thread Cholesky (the lanes-across-rows one was slower an
// iteration on an H100, PERF.md), then exp and the compose in the pose
// layout, one element a lane (warp.cuh's lane_se3_exp and lane_compose:
// se3.cuh's se3_exp and the update above, operation for operation, with
// one double sincos for the sin and the cos).
//
// pnp_gn_kernel: B independent problems over the same K points, `iters`
// iterations each, then each problem's inlier count; on request the
// residual norm before each iteration (a 28th sum, the same order). It
// serves solvers/pnp.gn_pnp (the `pnp` command: B = 1, 54 points, one
// launch from the identity when R0 and t0 are null) and the step-by-step
// RANSAC route (the hypotheses at B = 64, the refine at B = 1), which the
// CPU runs in its plain version and the card keeps as the check of the
// fused kernel. A block of four warps a problem, thread v virtual thread v
// (its points v + 128 j in ascending j, read from masks[b] for any K), the
// tree's first two levels through shared memory to warp 0, which takes the
// last five (warp_tree) and the step (gn_step) on all its lanes: a
// problem's pass and score spread over 128 threads (the refine, B = 1,
// K = 384, ~300 inliers: 3 points a thread one after another). A warp a
// problem (LaneSums, as ransac_pnp_kernel's hypotheses take it) gives the
// same bits, but measured slower on an H100 at every shape up to B = 528
// problems (PERF.md, Findings: 64 hypotheses of 4 points of K = 384
// 18.6-19.5 us against 14.2-17.3, the refine 47.1-48.3 against 19.9-22.4)
// and no path sends more than 64, so the kernel has this one layout.
// What bounds it on the H100: not the bytes (0.019 us at B = 64, K = 384)
// nor the operations (~130 float32 operations a masked point and
// iteration) but the chain of `iters` serial iterations. Problem 0's
// clock stamps (`clocks`; profile_paths.py --paths secondary, PERF.md,
// Findings) give an iteration ~5000-5400 cycles: the pass ~1050-1100 with
// at most one point a thread (~2500 at the refine's three; the first pass,
// its loads cold in L1, is the longest), the sums ~850-900 (the partials
// through shared memory and a barrier, then warp_tree) and the step
// ~2650-2900 (a 6x6 Cholesky with correctly rounded square roots and
// divisions, then se3_exp's double sincos) on the 32 lanes of one warp
// alike, so no thread waits at a barrier for a one-thread step. The score
// after the last iteration is ~900 cycles at K = 54 and ~2200-3900 at
// K = 384 (three points a thread).
//
// ransac_pnp_kernel: the whole RANSAC PnP with no host sync, one cluster of
// kRanks blocks x kWarps warps, a warp per hypothesis (warp g takes
// hypotheses g, g + 64, ...):
//   1. the sample: the `sample` largest u + (valid ? 1 : -1), ties to the
//      lower index (lax.top_k's rule), by as many rounds of a scan of the
//      lane's points (lane l holds points l + 32 q) and two warp reductions
//      (the largest score, then the lowest index holding it), ANDed with
//      valid;
//   2. Gauss-Newton on the warp (LaneSums, gn_step): a 4-point sample
//      costs about one point's latency, the lanes side by side;
//   3. the score: 12 points a lane at K = 384, an integer warp reduction;
//   4. the first best count: (count, -h) compared lexicographically in the
//      warp, the block and, through distributed shared memory, the cluster,
//      so the result is independent of which warp took which hypothesis;
//   5. the winner's inliers, recomputed at its pose by rank 0 (the
//      function that scored it, so bitwise its count);
//   6. the refine on rank 0's first four warps, thread v virtual thread v,
//      the tree's first two levels through shared memory to warp 0, the
//      step on warp 0.
// Two routes, the same bits: up to kSmallPoints (1024) points the
// correspondences in static shared memory and a lane's points one bit each
// in a register word (the taken and sampled points, the refine's inliers);
// past it (`kLarge`) the words in dynamic shared memory (a lane's sampled
// points ceil(K / 1024) words, a refine thread's inliers ceil(K / 4096)),
// a point taken in an earlier round known by its place in the order
// (a sample takes the points in descending (score, -index), so a point
// is free while it comes after the last one taken), and the
// correspondences staged in dynamic shared memory where they fit beside
// the words (K <= ~10000 on an H100), read through L1 past that. The
// kernel is opted in to all the dynamic shared memory the card allows once
// a device, at its first large launch, never again. K is bounded by the
// words alone (ransac_pnp_max_points: 192512 on an H100).
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
using rgbd::kFull;

constexpr int kTerms = 27;  // 21 upper entries of J^T J, 6 of J^T r
constexpr int kVirtual = 128;  // the sum order's virtual threads
constexpr int kGnWarps = kVirtual / 32;  // pnp_gn_kernel's block: one problem

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

// The N terms of one point: the 21 upper entries of J^T J, the 6 of J^T r
// and, with N = 28, the squared residual.
template <int N>
__device__ __forceinline__ void point_sums(const Point& p, float (&x)[N]) {
  int n = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c, ++n) x[n] = fadd(fmul(p.ju[a], p.ju[c]), fmul(p.jv[a], p.jv[c]));
#pragma unroll
  for (int a = 0; a < 6; ++a) x[21 + a] = fadd(fmul(p.ju[a], p.r0), fmul(p.jv[a], p.r1));
  if constexpr (N > kTerms) x[kTerms] = fadd(fmul(p.r0, p.r0), fmul(p.r1, p.r1));
}

template <int N>
__device__ __forceinline__ void add_into(float (&acc)[N], const float (&x)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = fadd(acc[n], x[n]);
}

// The running sums of a lane's four virtual threads lane, lane + 32,
// lane + 64 and lane + 96 (v[m] is lane + 32 m's).
template <int N>
struct LaneSums {
  float v0[N], v1[N], v2[N], v3[N];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < N; ++n) v0[n] = v1[n] = v2[n] = v3[n] = 0.0f;
  }

  __device__ __forceinline__ void add(int b, const float (&x)[N]) {
    switch (b & 3) {
      case 0: add_into(v0, x); break;
      case 1: add_into(v1, x); break;
      case 2: add_into(v2, x); break;
      default: add_into(v3, x); break;
    }
  }

  // The points of one 32-q chunk at pose (R, t): bit b of `word` is point
  // lane + 32 (q0 + b), q0 a multiple of 32, which is virtual thread
  // lane + 32 (b % 4)'s next point. A lane's points run one after another,
  // the lanes' side by side.
  __device__ __forceinline__ void add_chunk(unsigned word, int q0, const float* obj,
                                            const float* imn, int lane, const float R[9],
                                            const float t[3]) {
    for (unsigned w = word; w != 0; w &= w - 1) {
      const int b = __ffs(w) - 1;
      const int i = lane + 32 * (q0 + b);
      float x[N];
      point_sums(point_terms(obj + 3 * i, imn + 2 * i, R, t), x);
      add(b, x);
    }
  }

  // The tree's first two levels, in the lane.
  __device__ __forceinline__ void fold(float (&part)[N]) const {
#pragma unroll
    for (int n = 0; n < N; ++n) part[n] = fadd(fadd(v0[n], v2[n]), fadd(v1[n], v3[n]));
  }
};

// The tree's first two levels of 128 virtual threads' partials red[n][v]
// in shared memory, for lane `lane` of the warp that takes the step.
template <int N>
__device__ __forceinline__ void fold_shared(const float (*red)[kVirtual], int lane,
                                            float (&part)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    part[n] = fadd(fadd(red[n][lane], red[n][lane + 64]), fadd(red[n][lane + 32], red[n][lane + 96]));
}

// The pose as every lane holds it (R row-major, t) from the lane layout
// (lane e < 12 holds element e).
__device__ __forceinline__ void pose_of(float p, float R[9], float t[3]) {
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = __shfl_sync(kFull, p, e);
#pragma unroll
  for (int e = 0; e < 3; ++e) t[e] = __shfl_sync(kFull, p, 9 + e);
}

// The start pose's element lane e < 12 holds: R0 (row-major) and t0, or
// the identity where they are null.
__device__ __forceinline__ float start_pose(const float* R0, const float* t0, int lane) {
  const int e = lane < rgbd::kPoseLanes ? lane : rgbd::kPoseLanes - 1;
  return e < 9 ? (R0 ? R0[e] : rgbd::lane_eye(e, 1.0f)) : (t0 ? t0[e - 9] : 0.0f);
}

// The Gauss-Newton step from the 27 sums of the warp's lanes (lane n < 27
// holds sum n): every lane solves (J^T J + 1e-9 I) x = J^T r with the
// one-thread Cholesky, then exp(-x) and the compose in the lane layout.
// Returns the lane's new pose element.
__device__ __forceinline__ float gn_step(float mine, float p, int lane) {
  float H[36], g[6], x[6];
  int n = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = a; c < 6; ++c, ++n) H[a * 6 + c] = H[c * 6 + a] = __shfl_sync(kFull, mine, n);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    H[a * 6 + a] = fadd(H[a * 6 + a], 1e-9f);
    g[a] = __shfl_sync(kFull, mine, 21 + a);
  }
  rgbd::chol_solve6(H, g, x);
  float psi[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) psi[a] = -x[a];
  return rgbd::lane_compose(p, rgbd::lane_se3_exp(psi, lane), lane);
}

// Adds to acc, in ascending b, the terms of the points first + stride b
// for the set bits b of `word` at pose (R, t), one after another.
template <int N>
__device__ __forceinline__ void add_points(float (&acc)[N], unsigned word, int first, int stride,
                                           const float* obj, const float* imn, const float R[9],
                                           const float t[3]) {
  for (unsigned w = word; w != 0; w &= w - 1) {
    const int i = first + stride * (__ffs(w) - 1);
    float x[N];
    point_sums(point_terms(obj + 3 * i, imn + 2 * i, R, t), x);
    add_into(acc, x);
  }
}

// Whether point i is an inlier at (R, t): valid and |r| < thresh.
__device__ __forceinline__ bool inlier(int i, const float* obj, const float* imn,
                                       const uint8_t* valid, const float R[9], const float t[3],
                                       float thresh) {
  const Point p = point_terms(obj + 3 * i, imn + 2 * i, R, t);
  const float err = __fsqrt_rn(fadd(fmul(p.r0, p.r0), fmul(p.r1, p.r1)));
  return valid[i] && err < thresh;
}

// ---------------------------------------------------------------------------
// pnp_gn_kernel

// Bits of mask M (one byte a point) for the `stride`-spaced points
// first + stride (j0 + b), b < 32, below k.
__device__ __forceinline__ unsigned mask_word(const uint8_t* M, int first, int stride, int j0,
                                              int k) {
  unsigned w = 0;
#pragma unroll 8
  for (int b = 0; b < 32; ++b) {
    const int i = first + stride * (j0 + b);
    if (i < k && M[i]) w |= 1u << b;
  }
  return w;
}

// Records clock64() at stamp `at` of row `row` for problem 0 (the caller
// is its block's thread 0).
__device__ __forceinline__ void stamp(long long* clocks, int row, int at) {
  if (clocks != nullptr) clocks[row * 4 + at] = clock64();
}

// Block b is problem b, thread v virtual thread v.
template <int N>
__global__ void __launch_bounds__(kVirtual)
pnp_gn_kernel(const float* __restrict__ obj, const float* __restrict__ imn,
              const uint8_t* __restrict__ masks, const float* __restrict__ R0,
              const float* __restrict__ t0, const uint8_t* __restrict__ score_mask, int k,
              int iters, float thresh, float* __restrict__ R_out, float* __restrict__ t_out,
              int* __restrict__ count_out, uint8_t* __restrict__ inl_out,
              float* __restrict__ rn_out, long long* __restrict__ clocks) {
  __shared__ float red[N][kVirtual];
  __shared__ float pose[rgbd::kPoseLanes];
  __shared__ int cnt[kGnWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long* clk = (b == 0 && tid == 0) ? clocks : nullptr;
  const uint8_t* M = masks + (size_t)b * k;
  const unsigned first = mask_word(M, tid, kVirtual, 0, k);  // points tid + 128 j, j < 32
  float p = start_pose(R0 ? R0 + (size_t)b * 9 : nullptr, t0 ? t0 + (size_t)b * 3 : nullptr, lane);
  if (warp == 0 && lane < rgbd::kPoseLanes) pose[lane] = p;
  __syncthreads();
  float R[9], t[3];
  for (int it = 0; it < iters; ++it) {
    stamp(clk, it, 0);
#pragma unroll
    for (int x = 0; x < 9; ++x) R[x] = pose[x];
#pragma unroll
    for (int x = 0; x < 3; ++x) t[x] = pose[9 + x];
    float acc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = 0.0f;
    for (int j0 = 0; tid + kVirtual * j0 < k; j0 += 32) {
      const unsigned word = j0 == 0 ? first : mask_word(M, tid, kVirtual, j0, k);
      add_points(acc, word, tid + kVirtual * j0, kVirtual, obj, imn, R, t);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) red[n][tid] = acc[n];
    __syncthreads();
    stamp(clk, it, 1);
    if (warp == 0) {
      float part[N];
      fold_shared(red, lane, part);
      const float sum = rgbd::warp_tree(part, lane);
      stamp(clk, it, 2);
      if constexpr (N > kTerms)
        if (lane == kTerms) rn_out[(size_t)b * iters + it] = __fsqrt_rn(sum);
      p = gn_step(sum, p, lane);
      if (lane < rgbd::kPoseLanes) pose[lane] = p;
      stamp(clk, it, 3);
    }
    __syncthreads();
  }
  stamp(clk, iters, 0);
#pragma unroll
  for (int x = 0; x < 9; ++x) R[x] = pose[x];
#pragma unroll
  for (int x = 0; x < 3; ++x) t[x] = pose[9 + x];
  int c = 0;
  for (int i = tid; i < k; i += kVirtual) {
    const bool in = inlier(i, obj, imn, score_mask, R, t, thresh);
    c += in ? 1 : 0;
    if (inl_out != nullptr) inl_out[(size_t)b * k + i] = in ? 1 : 0;
  }
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) cnt[warp] = c;
  __syncthreads();
  stamp(clk, iters, 1);
  if (tid < 9) R_out[(size_t)b * 9 + tid] = R[tid];
  else if (tid < rgbd::kPoseLanes) t_out[(size_t)b * 3 + tid - 9] = t[tid - 9];
  if (tid == 0) count_out[b] = (cnt[0] + cnt[1]) + (cnt[2] + cnt[3]);
}

// ---------------------------------------------------------------------------
// ransac_pnp_kernel

constexpr int kWarps = 8;            // warps a block
constexpr int kRanks = 8;            // blocks a cluster: 64 warps, a hypothesis each
constexpr int kSmallPoints = 1024;   // the small route's K: 32 points a lane, one bit each
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

// The large route's dynamic shared memory: the warps' sample words (a
// lane's points l + 32 q, word j its q in [32 j, 32 j + 32), lane-minor),
// the refine threads' inlier words (thread v's points v + 128 j, word m its
// j in [32 m, 32 m + 32), thread-minor), then, where they fit, the
// correspondences (obj 3K floats, imn 2K, valid K bytes).
struct LargeLayout {
  int sel_words, mine_words;  // a lane's, a refine thread's
  long long words_bytes, staged_bytes;

  __host__ __device__ explicit LargeLayout(int k)
      : sel_words((k + 1023) / 1024), mine_words((k + 4095) / 4096),
        words_bytes(4LL * (kWarps * 32LL * sel_words + kVirtual * (long long)mine_words)),
        staged_bytes(21LL * k) {}
};

template <bool kLarge>
__global__ void __launch_bounds__(kWarps * 32)
ransac_pnp_kernel(const float* __restrict__ u, const float* __restrict__ obj_g,
                  const float* __restrict__ imn_g, const uint8_t* __restrict__ valid_g,
                  const float* __restrict__ R0, const float* __restrict__ t0, int hyps, int k,
                  int sample, int hyp_iters, int refine_iters, float thresh,
                  float* __restrict__ R_out, float* __restrict__ t_out,
                  uint8_t* __restrict__ inl_out, int* __restrict__ num_out,
                  long long* __restrict__ best_out, int staged) {
  namespace cg = cooperative_groups;
  constexpr int kStatic = kLarge ? 1 : kSmallPoints;
  __shared__ float obj_s[kStatic * 3];
  __shared__ float imn_s[kStatic * 2];
  __shared__ uint8_t valid_s[kStatic];
  extern __shared__ __align__(16) unsigned dyn[];
  __shared__ float warp_pose[kWarps][12];
  __shared__ int warp_count[kWarps], warp_h[kWarps];
  __shared__ int rank_count[kRanks], rank_h[kRanks], rank_w[kRanks];  // rank 0's
  __shared__ float pose[12];
  __shared__ int winner[2];
  __shared__ float red[kTerms][kVirtual];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const LargeLayout lay(k);
  unsigned* sel_w = dyn + (size_t)warp * lay.sel_words * 32 + lane;  // word j at [32 j]
  unsigned* mine_w = dyn + (size_t)kWarps * lay.sel_words * 32 + tid;  // word m at [128 m]
  const float* obj = obj_s;
  const float* imn = imn_s;
  const uint8_t* valid = valid_s;
  if constexpr (kLarge) {
    if (staged) {
      float* st = (float*)(dyn + lay.words_bytes / 4);
      for (int i = tid; i < 3 * k; i += blockDim.x) st[i] = obj_g[i];
      for (int i = tid; i < 2 * k; i += blockDim.x) st[3 * k + i] = imn_g[i];
      uint8_t* vs = (uint8_t*)(st + 5 * (size_t)k);
      for (int i = tid; i < k; i += blockDim.x) vs[i] = valid_g[i];
      obj = st;
      imn = st + 3 * (size_t)k;
      valid = vs;
    } else {
      obj = obj_g;
      imn = imn_g;
      valid = valid_g;
    }
  } else {
    for (int i = tid; i < 3 * k; i += blockDim.x) {
      obj_s[i] = obj_g[i];
      if (i < 2 * k) imn_s[i] = imn_g[i];
      if (i < k) valid_s[i] = valid_g[i];
    }
  }
  // the start pose in the lane layout
  const int e = lane < 12 ? lane : 11;
  const float start = start_pose(R0, t0, lane);
  __syncthreads();
  unsigned vbits = 0;  // the small route: lane l's valid points l + 32 q
  if constexpr (!kLarge)
    for (int i = lane; i < k; i += 32)
      if (valid[i]) vbits |= 1u << (i >> 5);

  // steps 1-3, a warp per hypothesis
  int best_c = -1, best_h = kNone;
  float best_p = 0.0f;
  for (int h = rank * kWarps + warp; h < hyps; h += kRanks * kWarps) {
    const float* U = u + (size_t)h * k;
    unsigned taken = 0;  // the small route's taken points, one bit a q
    // the large route's last point taken: (key, index); a later round
    // takes from the points after it in descending (key, -index)
    unsigned last_key = 0xffffffffu;
    int last_i = -1;
    if constexpr (kLarge)
      for (int j = 0; j < lay.sel_words; ++j) sel_w[32 * j] = 0u;
    for (int r = 0; r < sample; ++r) {
      float bs = neg_inf();
      int bi = kNone;
#pragma unroll 4
      for (int i = lane; i < k; i += 32) {
        const int q = i >> 5;
        bool open;  // not taken in an earlier round
        float sc;
        if constexpr (kLarge) {
          sc = fadd(U[i], valid[i] ? 1.0f : -1.0f);
          const unsigned key = ordered(sc);
          open = key < last_key || (key == last_key && i > last_i);
        } else {
          sc = fadd(U[i], ((vbits >> q) & 1u) ? 1.0f : -1.0f);
          open = !((taken >> q) & 1u);
        }
        const bool take = open && (sc > bs || bi == kNone);
        bs = take ? sc : bs;
        bi = take ? i : bi;
      }
      // the warp's largest score, then the lowest index holding it
      const unsigned key = bi == kNone ? 0u : ordered(bs);
      const unsigned top = __reduce_max_sync(kFull, key);
      const unsigned pick = __reduce_min_sync(kFull, key == top && bi != kNone ? (unsigned)bi
                                                                             : 0xffffffffu);
      if constexpr (kLarge) {
        if (pick != 0xffffffffu && (int)(pick & 31) == lane && valid[pick]) {
          const int q = (int)(pick >> 5);
          sel_w[32 * (q >> 5)] |= 1u << (q & 31);
        }
        last_key = top;
        last_i = (int)pick;
      } else {
        if (pick != 0xffffffffu && (int)(pick & 31) == lane) taken |= 1u << (pick >> 5);
      }
    }
    const unsigned sel = taken & vbits;
    float p = start;
    for (int it = 0; it < hyp_iters; ++it) {
      float R[9], t[3];
      pose_of(p, R, t);
      LaneSums<kTerms> s;
      s.zero();
      if constexpr (kLarge) {
        for (int j = 0; j < lay.sel_words; ++j) s.add_chunk(sel_w[32 * j], 32 * j, obj, imn, lane, R, t);
      } else {
        s.add_chunk(sel, 0, obj, imn, lane, R, t);
      }
      float part[kTerms];
      s.fold(part);
      p = gn_step(rgbd::warp_tree(part, lane), p, lane);
    }
    float R[9], t[3];
    pose_of(p, R, t);
    int c = 0;
#pragma unroll 4
    for (int i = lane; i < k; i += 32) c += inlier(i, obj, imn, valid, R, t, thresh) ? 1 : 0;
    c = __reduce_add_sync(kFull, c);
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
  unsigned mine = 0;  // the small route: bit j, point tid + 128 j is an inlier
  if (tid < kVirtual) {
    if constexpr (kLarge) {
      for (int m = 0; m < lay.mine_words; ++m) {
        unsigned word = 0;
        for (int b = 0; b < 32 && tid + kVirtual * (32 * m + b) < k; ++b) {
          const int i = tid + kVirtual * (32 * m + b);
          const bool in = inlier(i, obj, imn, valid, R, t, thresh);
          inl_out[i] = in ? 1 : 0;
          word |= (in ? 1u : 0u) << b;
        }
        mine_w[kVirtual * m] = word;
      }
    } else {
#pragma unroll 4
      for (int j = 0; tid + kVirtual * j < k; ++j) {
        const int i = tid + kVirtual * j;
        const bool in = inlier(i, obj, imn, valid, R, t, thresh);
        inl_out[i] = in ? 1 : 0;
        mine |= (in ? 1u : 0u) << j;
      }
    }
  }
  for (int it = 0; it < refine_iters; ++it) {
    if (tid < kVirtual) {
      float acc[kTerms];
#pragma unroll
      for (int n = 0; n < kTerms; ++n) acc[n] = 0.0f;
      const int words = kLarge ? lay.mine_words : 1;
      for (int m = 0; m < words; ++m)
        add_points(acc, kLarge ? mine_w[kVirtual * m] : mine, tid + kVirtual * 32 * m, kVirtual,
                   obj, imn, R, t);
#pragma unroll
      for (int n = 0; n < kTerms; ++n) red[n][tid] = acc[n];
    }
    __syncthreads();
    if (warp == 0) {
      float part[kTerms];
      fold_shared(red, lane, part);
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

// The dynamic shared memory ransac_pnp_kernel<true> may take on `device`
// (the card's opt-in limit less its static shared memory); the kernel is
// opted in to all of it the first time, so no later launch sets an
// attribute. Returns 0 on failure.
long long large_room(int device, rgbd::ClusterLaunch* state) {
  static long long room[rgbd::kMaxDevices] = {};
  if (device < 0 || device >= rgbd::kMaxDevices) return 0;
  if (room[device] > 0) return room[device];
  int optin = 0;
  cudaFuncAttributes fa;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&fa, ransac_pnp_kernel<true>) != cudaSuccess)
    return 0;
  const long long bytes = (long long)optin - (long long)fa.sharedSizeBytes;
  if (bytes <= 0 || rgbd::opt_in_shared(ransac_pnp_kernel<true>, device, bytes, &state->opted) !=
                        cudaSuccess)
    return 0;
  room[device] = bytes;
  return bytes;
}

rgbd::ClusterLaunch large_state;

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// obj (K,3), imn (K,2) float32; masks (B,K) and score_mask (K,) uint8; R0
// (B,3,3) and t0 (B,3) float32 or null (the identity); all contiguous.
// Outputs R (B,3,3), t (B,3) float32, counts (B,) int32, when inl_out is not
// null inliers (B,K) uint8, and when rn_out is not null the residual norm
// |r| over the masked points before each iteration (B,iters) float32.
// clocks (iters + 1, 4) int64 or null: problem 0's clock64() at the start of each
// iteration, after its pass (the first two tree levels included), after
// the sums and after the step; row iters: before and after the score.
// Launches on `stream`, does not synchronize.
extern "C" int pnp_gn(int device, const void* obj, const void* imn, const void* masks,
                      const void* R0, const void* t0, const void* score_mask, int batch, int k,
                      int iters, float thresh, void* R_out, void* t_out, void* count_out,
                      void* inl_out, void* rn_out, void* clocks, void* stream) {
  if (k < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
#define PNP_GN_ARGS                                                                      \
  (const float*)obj, (const float*)imn, (const uint8_t*)masks, (const float*)R0,         \
      (const float*)t0, (const uint8_t*)score_mask, k, iters, thresh, (float*)R_out,     \
      (float*)t_out, (int*)count_out, (uint8_t*)inl_out, (float*)rn_out, (long long*)clocks
    if (rn_out != nullptr) pnp_gn_kernel<kTerms + 1><<<batch, kVirtual, 0, s>>>(PNP_GN_ARGS);
    else pnp_gn_kernel<kTerms><<<batch, kVirtual, 0, s>>>(PNP_GN_ARGS);
#undef PNP_GN_ARGS
  }
  return (int)cudaGetLastError();
}

// The largest K ransac_pnp takes on `device` into *out: the large route's
// words (LargeLayout) in the dynamic shared memory the card allows.
extern "C" int ransac_pnp_max_points(int device, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long room = large_room(device, &large_state);
  if (room <= 0) return (int)cudaErrorInvalidValue;
  long long k = 1024;  // a whole sample word more each step
  while (LargeLayout((int)(k + 1024)).words_bytes <= room) k += 1024;
  *out = k;
  return (int)cudaSuccess;
}

// u (S,K) uniforms, obj (K,3), imn (K,2) float32, valid (K,) uint8, R0
// (3,3) and t0 (3,) float32 or null (the identity); all contiguous, K at
// most ransac_pnp_max_points. Outputs R (3,3), t (3,) float32, inliers (K,)
// uint8, num_inliers () int32, best_hypothesis () int64. One cluster
// launch on `stream`, does not synchronize.
extern "C" int ransac_pnp(int device, const void* u, const void* obj, const void* imn,
                          const void* valid, const void* R0, const void* t0, int hyps, int k,
                          int sample, int hyp_iters, int refine_iters, float thresh, void* R_out,
                          void* t_out, void* inl_out, void* num_out, void* best_out,
                          void* stream) {
  if (hyps < 1 || k < 1 || sample < 1 || sample > k) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k <= kSmallPoints) {
    static rgbd::ClusterLaunch state;
    err = rgbd::launch_cluster(ransac_pnp_kernel<false>, device, dim3(kRanks), dim3(kWarps * 32),
                               0, kRanks, (cudaStream_t)stream, &state, (const float*)u,
                               (const float*)obj, (const float*)imn, (const uint8_t*)valid,
                               (const float*)R0, (const float*)t0, hyps, k, sample, hyp_iters,
                               refine_iters, thresh, (float*)R_out, (float*)t_out,
                               (uint8_t*)inl_out, (int*)num_out, (long long*)best_out, 0);
  } else {
    const long long room = large_room(device, &large_state);
    const LargeLayout lay(k);
    if (room <= 0 || lay.words_bytes > room) return (int)cudaErrorInvalidValue;
    const bool staged = lay.words_bytes + lay.staged_bytes <= room;
    const long long smem = lay.words_bytes + (staged ? lay.staged_bytes : 0);
    err = rgbd::launch_cluster(ransac_pnp_kernel<true>, device, dim3(kRanks), dim3(kWarps * 32),
                               smem, kRanks, (cudaStream_t)stream, &large_state, (const float*)u,
                               (const float*)obj, (const float*)imn, (const uint8_t*)valid,
                               (const float*)R0, (const float*)t0, hyps, k, sample, hyp_iters,
                               refine_iters, thresh, (float*)R_out, (float*)t_out,
                               (uint8_t*)inl_out, (int*)num_out, (long long*)best_out,
                               staged ? 1 : 0);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
