// The photometric DVO pyramid of B frame pairs in one launch, for Hopper.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `solve_pyramid`'s level loop (rgbd_odometry_tpu/solvers/photometric.py:
// 226-247) over `solve_level`'s `lax.scan` (:162-223) of Gauss-Newton
// iterations on `photometric_residual` (:147-159) and `_sample_now`
// (:132-144), the reference's `gaussNewtonIterations` (RGBDOdometry.cpp:
// 514-597).
//
// An iteration at the pose (R, t): every point is moved by R^T (X - t),
// projected, tested for visibility on the unsnapped (u, v), snapped within
// 2e-3 of an integer, sampled from the now image (floor, or bilinear with
// the rows blended first; coordinates clamped to the image), and adds
// eps^2, J_j w eps (6) and, with reweighting, (J_i w) J_j (21) into its
// thread's running sums; then the step: |eps| (the history), the best
// iterate (|eps| <= best), the freeze at |eps| < eps_exit, psi = A^-1 (-J^T
// W eps) by Cholesky (A the cached normal matrix or, reweighted, the sums
// plus 1e-6 max(trace, 1) / 6 on the diagonal), psi clamped to max_step,
// T <- T exp(psi)^-1. Each level starts from the previous level's best
// iterate, which is also the output.
//
// What bounds it on the H100: not the bytes (41 a point once, up to four
// image reads a point and iteration: 0.04 us at K = 2048, B = 1) nor the
// operations, but the latency of the chain of iterations: a pass, a
// block-wide sum and a serial step (a 6x6 solve with correctly rounded
// divisions, a double sincos, the compose), six times. The design shortens
// each link (clock stamps of pair 0, `clocks`, measure them):
//
//   pass      a thread takes up to kUnroll of its points at once (as many as
//             it has left, so a rank of few points does no dead work), in
//             phases: the moved points, their reciprocal depths, the
//             projections and image reads, the weights, then the terms in
//             point order; each phase's work of the points in flight
//             together between the branches of the correctly rounded
//             reciprocal and division. Points and image are read through
//             the read-only path: after the level's first pass they are in
//             L1. Staging them in shared memory (cp.async, or bulk copies of
//             the Tensor Memory Accelerator with the wait deferred past the
//             first step) measured slower on an H100 at every cluster size
//             and batch (PERF.md): the copy competes with the first
//             pass for the SM's bandwidth, and the later passes gain little.
//   sums      warp.cuh pair_sum: each warp's shuffle tree (7 or 28 sums),
//             the 8 warp partials in order, then the ranks' sums in rank
//             order; no block-wide shared-memory tree.
//   step      on warp 0 in warp.cuh's lane layout, every lane alike where
//             a value is scalar: with the cached A the factor is taken once
//             a level (chol_factor6, every level's on its own lane of warp
//             0 before the first pass) and an iteration runs only the two
//             substitutions (chol_subst6: the operations chol_solve6
//             performs on that factor, so the same bits); reweighted, the
//             whole factorization; then the clamp, the exponential
//             (lane_se3_exp, one double sincos) and the compose T
//             exp(psi)^-1 one pose element a lane (lane_compose_inv). A
//             level's last step is not taken (the best iterate replaces
//             it), and a frozen pair repeats its |eps| without a pass.
//   cluster   a pair's level runs on `ranks` blocks (1, 2, 4, 8; a function
//             of K alone, kernels/level_photo.level_ranks, so a pair's bits
//             never depend on B), the ranks of a thread-block cluster;
//             point i belongs to rank (i / 256) % ranks and thread i % 256.
//             The launch's cluster is its largest level's ranks; a level on
//             fewer runs on each group of that many alike (the first
//             writes the outputs). Every rank takes the step alike from the
//             same sums, so no rank waits for a broadcast. A cluster sum
//             costs ~1500 cycles more than a block's, so a level splits
//             only past 2048 points a rank.
//
// Every operation is the plain version's (kernels/level_photo.py), in its
// order, with round-to-nearest intrinsics: a fused multiply-add exactly
// where the plain version takes one (the warp's z, u and v, the bilinear
// blends but that of two columns among the first 8: where XLA:CPU
// contracts them), nothing else contracted; the plain version sums in the
// kernel's layout for the same ranks. So the kernel's pose and history are
// bitwise the plain version's at every cluster size.

#include <cooperative_groups.h>

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "se3.cuh"
#include "warp.cuh"

namespace cg = cooperative_groups;

namespace {

using rgbd::fadd;
using rgbd::fdiv;
using rgbd::fmul;
using rgbd::fsub;
using rgbd::kFull;
using rgbd::kPoseLanes;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kUnroll = 4;  // points of a thread in flight together

struct Level {
  const float* pts;      // (B, K, 3)
  const float* inten;    // (B, K)
  const float* J;        // (B, K, 6)
  const float* A;        // (B, 6, 6)
  const uint8_t* valid;  // (B, K)
  const float* img;      // (B, H, W), rows contiguous, `stride` floats between images
  long long stride;
  int k, h, w;
  int ranks;    // blocks a pair's level runs on (a divisor of the launch's cluster)
  int n_local;  // local point slots of a rank
  float fx, fy, cx, cy;
};

struct Pyramid {
  Level lv[kMaxLevels];
  const float* R0;
  const float* t0;
  float* R_out;
  float* t_out;
  float* hist;
  long long* clocks;  // or null: pair 0's clock64() stamps (level_photo's `clocks`)
  int levels, cluster, iters;
  float eps_exit, delta, max_step;
  int huber, bilinear;
};

struct Shared {
  float pose[kPoseLanes];
  float best[kPoseLanes];
  float L[kMaxLevels][36];  // each level's Cholesky factor of the cached A
  float part[kWarps * 32];
  float slot[2 * rgbd::kMaxCluster * 32];
  int done;
};

__device__ __forceinline__ float ffma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// Pair 0's first rank's thread 0 records clock64() at stamp `at` of row
// `row` (an iteration, or `iters` for the level's own stamps) of level l.
__device__ __forceinline__ void stamp(const Pyramid& P, int l, int row, int at) {
  if (P.clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    P.clocks[((size_t)l * (P.iters + 1) + row) * 4 + at] = clock64();
}

// Level `l` of the table, selected with constant indices only (a dynamic
// index into a kernel parameter would copy the table to local memory).
__device__ __forceinline__ Level level_at(const Pyramid& P, int l) {
  Level L = P.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) L = P.lv[i];
  return L;
}

__device__ __forceinline__ rgbd::Split split_of(const Level& L, int rank) {
  const int q = rank % L.ranks;
  return rgbd::Split{L.ranks, q, rank - q};
}

// The global index of local slot j of rank sp.q: slot c * 256 + t holds
// point (c * ranks + q) * 256 + t.
__device__ __forceinline__ int point_of(int j, const rgbd::Split& sp) {
  return ((j / kThreads) * sp.ranks + sp.q) * kThreads + j % kThreads;
}

__device__ __forceinline__ float snap(float c) {
  const float r = rintf(c);
  return fabsf(fsub(c, r)) < 2e-3f ? r : c;
}

// c clamped to [0, n - 1] (NaN to 0: fmaxf returns the other operand).
__device__ __forceinline__ float clamped(float c, int n) {
  return fminf(fmaxf(c, 0.0f), (float)(n - 1));
}

__device__ __forceinline__ float sample(const float* __restrict__ img, int h, int w, float u,
                                        float v, bool bilinear) {
  const float cu = clamped(u, w), cv = clamped(v, h);
  const float fu0 = floorf(cu), fv0 = floorf(cv);
  const int j0 = (int)fu0, i0 = (int)fv0;
  if (!bilinear) return __ldg(img + (size_t)i0 * w + j0);
  const int j1 = min(j0 + 1, w - 1), i1 = min(i0 + 1, h - 1);
  const float fu = fsub(cu, fu0), fv = fsub(cv, fv0);
  const float gv = fsub(1.0f, fv);
  const float a00 = __ldg(img + (size_t)i0 * w + j0);
  const float a10 = __ldg(img + (size_t)i1 * w + j0);
  const float a01 = __ldg(img + (size_t)i0 * w + j1);
  const float a11 = __ldg(img + (size_t)i1 * w + j1);
  const float row0 = ffma(fv, a10, fmul(gv, a00));
  const float row1 = ffma(fv, a11, fmul(gv, a01));
  // XLA:CPU sums the first 8 column products as a vector, the rest as a
  // fused chain onto that sum
  const float head = fmul(fsub(1.0f, fu), row0);
  return j1 < 8 ? fadd(head, fmul(fu, row1)) : ffma(fu, row1, head);
}

// U (<= kUnroll) of this thread's slots, j0, j0 + 256, ...: each point's
// terms added into acc (N = 7, or 28 when reweighting). In phases over the
// U points, so that each phase's work of all of them (between the branches
// of the correctly rounded reciprocal and division) is in flight together;
// a slot past the level, or an invalid point, adds zeros, which leave a
// running sum as it is.
template <int U, int N>
__device__ __forceinline__ void group(const Level& L, const Pyramid& P, int b,
                                      const rgbd::Split& sp, const float (&pose)[kPoseLanes],
                                      float (&acc)[N], int j0) {
  const float* __restrict__ Pg = L.pts + (size_t)b * L.k * 3;
  const float* __restrict__ Ig = L.inten + (size_t)b * L.k;
  const float* __restrict__ Jg = L.J + (size_t)b * L.k * 6;
  const uint8_t* __restrict__ Vg = L.valid + (size_t)b * L.k;
  const float* __restrict__ img = L.img + (size_t)b * L.stride;
  const float wf = (float)L.w, hf = (float)L.h;
  const float* R = pose;
  const float* t = pose + 9;
  bool ok[U], vis[U];
  int at[U];  // the point read (0 for a slot past the level)
  float zs[U], x0[U], x1[U], inten[U], zinv[U], inow[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + u * kThreads;
    const int i = point_of(j, sp);
    ok[u] = j < L.n_local && i < L.k;
    at[u] = ok[u] ? i : 0;
    const float x = __ldg(Pg + 3 * (size_t)at[u]);
    const float y = __ldg(Pg + 3 * (size_t)at[u] + 1);
    const float zz = __ldg(Pg + 3 * (size_t)at[u] + 2);
    inten[u] = __ldg(Ig + at[u]);
    ok[u] = ok[u] && __ldg(Vg + at[u]) != 0;
    const float d0 = fsub(x, t[0]);
    const float d1 = fsub(y, t[1]);
    const float d2 = fsub(zz, t[2]);
    x0[u] = fadd(fadd(fmul(d0, R[0]), fmul(d1, R[3])), fmul(d2, R[6]));
    x1[u] = fadd(fadd(fmul(d0, R[1]), fmul(d1, R[4])), fmul(d2, R[7]));
    const float z = ffma(R[8], d2, ffma(R[5], d1, fmul(R[2], d0)));
    zs[u] = fabsf(z) < 1e-12f ? 1e-12f : z;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) zinv[u] = __frcp_rn(zs[u]);
  // the projections and the image reads, at coordinates clamped to the
  // image, so in bounds for every slot; an invisible point's value is unused
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float pu = ffma(fmul(L.fx, x0[u]), zinv[u], L.cx);
    const float pv = ffma(fmul(L.fy, x1[u]), zinv[u], L.cy);
    vis[u] = pu >= 0.0f && pu < wf && pv >= 0.0f && pv < hf && ok[u];
    inow[u] = sample(img, L.h, L.w, snap(pu), snap(pv), P.bilinear != 0);
  }
  float eps[U], wgt[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    eps[u] = vis[u] ? fsub(inten[u], inow[u]) : 0.0f;
    wgt[u] = vis[u] ? 1.0f : 0.0f;
  }
  if (P.huber) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float a = fabsf(eps[u]);
      const float q = fdiv(P.delta, fmaxf(a, 1e-9f));
      wgt[u] = vis[u] ? (a <= P.delta ? 1.0f : q) : 0.0f;
    }
  }
  // the terms, in point order
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float e = eps[u];
    const float we = fmul(wgt[u], e);
    float Jr[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) Jr[c] = __ldg(Jg + 6 * (size_t)at[u] + c);
    acc[0] = fadd(acc[0], fmul(e, e));
#pragma unroll
    for (int c = 0; c < 6; ++c) acc[1 + c] = fadd(acc[1 + c], fmul(Jr[c], we));
    if constexpr (N > 7) {
      float jw[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) jw[c] = fmul(Jr[c], wgt[u]);
      int m = 7;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int c = a; c < 6; ++c, ++m) acc[m] = fadd(acc[m], fmul(jw[a], Jr[c]));
    }
  }
}

// One pass of this rank over its points at `pose`: kUnroll slots at a time,
// as many as are left at the end.
template <int N>
__device__ __forceinline__ void pass(const Level& L, const Pyramid& P, int b,
                                     const rgbd::Split& sp, const float (&pose)[kPoseLanes],
                                     float (&acc)[N], int tid) {
  static_assert(kUnroll == 4, "pass dispatches groups of 1..4 slots");
  for (int j0 = tid; j0 < L.n_local; j0 += kUnroll * kThreads) {
    const int live = (L.n_local - j0 + kThreads - 1) / kThreads;
    if (live >= 4) group<4, N>(L, P, b, sp, pose, acc, j0);
    else if (live == 3) group<3, N>(L, P, b, sp, pose, acc, j0);
    else if (live == 2) group<2, N>(L, P, b, sp, pose, acc, j0);
    else group<1, N>(L, P, b, sp, pose, acc, j0);
  }
}

template <bool kReweight>
__global__ void __launch_bounds__(kThreads)
level_photo_kernel(const __grid_constant__ Pyramid P) {
  constexpr int N = kReweight ? 28 : 7;  // |eps|^2, J^T W eps (6), J^T W J (21 upper entries)
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / P.cluster, rank = blockIdx.x - b * P.cluster;
  stamp(P, 0, P.iters, 0);
  if (tid < kPoseLanes)
    sh.pose[tid] = tid < 9 ? P.R0[(size_t)b * 9 + tid] : P.t0[(size_t)b * 3 + tid - 9];
  if constexpr (!kReweight) {
    // the factor of every level's cached A, lane l level l's
    if (warp == 0 && lane < P.levels) {
      const Level L = level_at(P, lane);
      float H[36], F[36];
      const float* A = L.A + (size_t)b * 36;
#pragma unroll
      for (int i = 0; i < 36; ++i) H[i] = A[i];
      rgbd::chol_factor6(H, F);
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int c = 0; c <= r; ++c) sh.L[lane][r * 6 + c] = F[r * 6 + c];
    }
  }
  if (P.cluster > 1) cg::this_cluster().sync();  // every rank has started
  // warp 0's registers: the level's solver state, the same on every lane
  float best_e = 0.0f, last_e = 0.0f;
  bool done = false;
  int par = 0;  // the slot of the next cluster sum

  for (int l = 0; l < P.levels; ++l) {
    const Level L = level_at(P, l);
    const rgbd::Split sp = split_of(L, rank);
    stamp(P, l, P.iters, 1);
    if (warp == 0) {
      best_e = 1e30f;
      done = false;
      if (lane < kPoseLanes) sh.best[lane] = sh.pose[lane];
      if (lane == 0) sh.done = 0;
    }
    __syncthreads();
    stamp(P, l, P.iters, 2);

    for (int it = 0; it < P.iters; ++it) {
      float s = 0.0f;  // on lanes m < N of warp 0: sum m
      stamp(P, l, it, 0);
      if (!sh.done) {
        float pose[kPoseLanes];
#pragma unroll
        for (int i = 0; i < kPoseLanes; ++i) pose[i] = sh.pose[i];
        float acc[N];
#pragma unroll
        for (int m = 0; m < N; ++m) acc[m] = 0.0f;
        pass<N>(L, P, b, sp, pose, acc, tid);
        stamp(P, l, it, 1);
        s = rgbd::pair_sum(acc, sh.part, sh.slot, 0, kWarps, sp, par, tid);
        par ^= sp.ranks > 1 ? 1 : 0;
      }
      stamp(P, l, it, 2);
      if (warp == 0) {
        if (!done) last_e = __fsqrt_rn(__shfl_sync(kFull, s, 0));
        const float e = last_e;  // a frozen pair's pose and |eps| stay
        if (rank == 0 && lane == 0) P.hist[((size_t)b * P.levels + l) * P.iters + it] = e;
        if (e <= best_e) {
          best_e = e;
          if (lane < kPoseLanes) sh.best[lane] = sh.pose[lane];
        }
        const bool newly = e < P.eps_exit;
        if (!done && !newly && it + 1 < P.iters) {
          float g[6], psi[6];
#pragma unroll
          for (int j = 0; j < 6; ++j) g[j] = -__shfl_sync(kFull, s, 1 + j);
          if constexpr (kReweight) {
            float H[36];
            int m = 7;
#pragma unroll
            for (int a = 0; a < 6; ++a)
#pragma unroll
              for (int c = a; c < 6; ++c, ++m) H[a * 6 + c] = H[c * 6 + a] = __shfl_sync(kFull, s, m);
            float tr = H[0];
#pragma unroll
            for (int i = 1; i < 6; ++i) tr = fadd(tr, H[i * 7]);
            const float dmp = fdiv(fmul(1e-6f, fmaxf(tr, 1.0f)), 6.0f);
#pragma unroll
            for (int i = 0; i < 6; ++i) H[i * 7] = fadd(H[i * 7], dmp);
            rgbd::chol_solve6(H, g, psi);
          } else {
            float F[36];
#pragma unroll
            for (int r = 0; r < 6; ++r)
#pragma unroll
              for (int c = 0; c <= r; ++c) F[r * 6 + c] = sh.L[l][r * 6 + c];
            rgbd::chol_subst6(F, g, psi);
          }
          rgbd::trust_region(psi, P.max_step);
          const float x = rgbd::lane_se3_exp(psi, lane);
          const float np =
              rgbd::lane_compose_inv(lane < kPoseLanes ? sh.pose[lane] : 0.0f, x, lane);
          __syncwarp();
          if (lane < kPoseLanes) sh.pose[lane] = np;
        }
        done = done || newly;
        if (lane == 0) sh.done = done ? 1 : 0;
      }
      stamp(P, l, it, 3);
      __syncthreads();
    }
    // the level's result, the best iterate, is the next level's start
    if (warp == 0 && lane < kPoseLanes) sh.pose[lane] = sh.best[lane];
    __syncthreads();
    stamp(P, l, P.iters, 3);
  }
  if (rank == 0 && tid < kPoseLanes) {
    if (tid < 9) P.R_out[(size_t)b * 9 + tid] = sh.pose[tid];
    else P.t_out[(size_t)b * 3 + tid - 9] = sh.pose[tid];
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// `levels` levels of `batch` pairs. ptrs: per level pts, intensity, J, A,
// valid, img (six device pointers); strides: the image batch stride a
// level (floats); ints: per level K, H, W and ranks (1, 2, 4, 8, a divisor
// of `cluster`: the blocks a pair's level runs on, the ranks of a
// thread-block cluster of `cluster` blocks a pair); flts: per level fx, fy,
// cx, cy. R0 (B,3,3), t0 (B,3) float32. Outputs R (B,3,3), t (B,3), hist
// (B, levels, iters) float32; clocks (levels, iters + 1, 4) int64 or null:
// pair 0's clock64() at the start of each iteration, after its pass, after
// its sum and after its step (rows 0 .. iters - 1), and a level's own
// (row iters): the kernel's start (level 0 only), the level's start, after
// its prologue, at its end; left as they were where not run. One launch on
// `stream`, does not synchronize;
// a cluster the card cannot hold is not launched
// (cudaErrorInvalidConfiguration).
extern "C" int level_photo(int device, int levels, int batch, int cluster, const void* R0,
                           const void* t0, const long long* ptrs, const long long* strides,
                           const int* ints, const float* flts, int iters, float eps_exit,
                           int huber, float delta, float max_step, int reweight, int bilinear,
                           void* R_out, void* t_out, void* hist, void* clocks, void* stream) {
  if (levels < 0 || levels > kMaxLevels || batch < 1 || iters < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (long long)batch * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void (*kernel)(const Pyramid) =
      reweight ? level_photo_kernel<true> : level_photo_kernel<false>;
  Pyramid P{};
  P.R0 = (const float*)R0;
  P.t0 = (const float*)t0;
  P.R_out = (float*)R_out;
  P.t_out = (float*)t_out;
  P.hist = (float*)hist;
  P.clocks = (long long*)clocks;
  P.levels = levels;
  P.cluster = cluster;
  P.iters = iters;
  P.eps_exit = eps_exit;
  P.delta = delta;
  P.max_step = max_step;
  P.huber = huber;
  P.bilinear = bilinear;
  for (int l = 0; l < levels; ++l) {
    Level& L = P.lv[l];
    L.pts = (const float*)ptrs[6 * l + 0];
    L.inten = (const float*)ptrs[6 * l + 1];
    L.J = (const float*)ptrs[6 * l + 2];
    L.A = (const float*)ptrs[6 * l + 3];
    L.valid = (const uint8_t*)ptrs[6 * l + 4];
    L.img = (const float*)ptrs[6 * l + 5];
    L.stride = strides[l];
    L.k = ints[4 * l + 0];
    L.h = ints[4 * l + 1];
    L.w = ints[4 * l + 2];
    L.ranks = ints[4 * l + 3];
    L.fx = flts[4 * l + 0];
    L.fy = flts[4 * l + 1];
    L.cx = flts[4 * l + 2];
    L.cy = flts[4 * l + 3];
    const int r = L.ranks;
    if (L.k < 1 || L.h < 1 || L.w < 1 || (r != 1 && r != 2 && r != 4 && r != 8) ||
        cluster % r != 0)
      return (int)cudaErrorInvalidValue;
    const long long chunks = (L.k + (long long)kThreads * r - 1) / ((long long)kThreads * r);
    L.n_local = (int)(chunks * kThreads < L.k ? chunks * kThreads : L.k);
  }
  static rgbd::ClusterLaunch state[2];
  return (int)rgbd::launch_cluster(kernel, device, dim3((unsigned)(batch * cluster)),
                                   dim3(kThreads), 0, cluster, (cudaStream_t)stream,
                                   &state[reweight ? 1 : 0], P);
}
