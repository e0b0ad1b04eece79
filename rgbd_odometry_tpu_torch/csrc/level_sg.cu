// A whole sub-gradient pyramid of the edge-DVO solver in one launch, for
// Hopper: every level of B frame pairs, coarsest first, each level's n_iters
// iterations from the pose the level before returned.
//
// Replaces the per-iteration route of sg_terms.cu + some 230 small PyTorch
// ops around it, i.e. in the JAX package the sub-gradient branch of the
// `lax.scan` level loop (rgbd_odometry_tpu/solvers/edge_dvo.py:493-622, scan
// at :586) with `_subgradient_step` (:775-794) and `geo.se3_log`
// (rgbd_odometry_tpu/core/geometry.py:169), and the level loop of
// `solve_pyramid` (edge_dvo.py:824): XLA code, no Pallas kernel. Per
// pair and iteration itr, as kernels/level_sg.level_sg_plain runs it:
//
//   pass   over every point at the current pose: sg_point of project.cuh (the
//          per-point math of sg_terms.cu) summed into g = J^T W eps (6), e2
//          and the visible count; energy = sqrt(e2);
//   best   energy <= best energy (later ties win) keeps the pose, the
//          iteration and the visible ratio;
//   step   g += l2_lambda log(R, t) / |log(R, t)| (the L2 pull, when
//          enabled; a zero log leaves g), descent = (1 - momentum) g +
//          momentum descent, psi = -step (1, 1, 1, r, r, r) descent with
//          step = step_length / (itr - 4 if itr > 5 else 1), projected onto
//          the trust region;
//   move   (R, t) <- (R, t) exp(psi), re-orthogonalized with `rotationize`;
//          |psi| below the termination norm ends the pair instead: it keeps
//          its pose and the rest of its energy curve is 0.
//
// After the loop the best pose is re-orthogonalized and written with its
// energy, iteration, visible ratio and per-point residuals and visibility.
// Where asked for, the trajectory output (JAX's `collect_trajectory`,
// edge_dvo.py:570) takes the pose after each iteration, stored from shared
// memory by the block's last warp after the barrier that ends the
// iteration (off the step warp's chain), and the frozen pose in every row
// after a pair is done from the tail; it only adds stores, so every other
// output is the same with it or without. A launch with it runs its own
// instantiation of the kernel (`kTraj`); without it, the code is the one
// before the output, whose loop measured 2-3% faster than one that only
// tested a null pointer (profile_paths.py --paths levels, PERF.md PR 18).
// Its pointers sit beside the level table (`Pyramid::traj`) and each block
// selects its rows once a level.
//
// Every configuration runs the same loop over project.cuh's sg_point under
// the launch's `PointSem`: the production semantics folded in at compile
// time, or (`kParity`, an instantiation of its own) a reference-parity
// configuration's from the launch's parameters, uniform over the grid (the
// interpolated DT of either JAX route, the textbook Jacobian, the
// projection with XLA's fused multiply-adds, the weight by divisions);
// and, where asked for, the SVD projection (warp.cuh lane_rotationize_svd)
// takes Newton-Schulz's place after every update and on the returned best;
// the trajectory rows come after it. One instantiation reading the
// semantics at run time for every configuration measured up to 8% slower
// on the production levels (H100, profile_paths.py --paths levels). The
// SVD, twelve double-precision Jacobi rotations with their divisions and
// square roots on every lane of the step warp, takes the step to
// ~11800-12200 cycles against ~2500-2800 with Newton-Schulz; the other
// point terms cost about what the production ones do.
//
// Design. A pair's level runs on `ranks` blocks (1, 2, 4 or 8, a function
// of the level's capacity alone, kernels/level_sg.level_ranks), the ranks
// of a thread-block cluster, each with the level's `threads` working
// threads (512, or 1024 above 4096 points: kernels/level_sg.block_threads);
// the launch's blocks have the most threads and the cluster the most ranks
// any level has, and a level on fewer ranks runs on each group of that
// many alike (the first group writes the outputs). Each rank stages its
// share of the level's points once into shared memory as float4 {x, y, z,
// valid} with cp.async (128 KB at K = 8192 on one rank): point i belongs
// to rank (i / threads) % ranks and thread i % threads, so on one rank the
// map is a block's own. The float32 DT (307 KB at 240x320) stays in L2 and
// is read through the read-only path. The 8 running sums are reduced in a
// fixed order (warp.cuh pair_sum: a warp-shuffle tree, the warp partials in
// order, the ranks' sums in rank order through distributed shared memory
// behind one cluster barrier, added by every rank alike). No atomics: a
// result is the same bit for bit from run to run. Warp 0 goes from the
// last partial sum straight into the step (warp.cuh): the log's branches
// decided once for the warp, its double arccos, sine and one sincos, the
// pull, momentum, preconditioner, step schedule and trust region as
// uniform scalars in warp 0's registers, then the exponential, the compose
// and Newton-Schulz one 3x3 entry a lane, each value bitwise se3.cuh's.
// The current and next pose are two shared-memory slots swapped by index;
// one block barrier hands the next pose to the passes; a done pair's
// blocks leave the loop together.
//
// The best iterate's per-point values. Whether an iterate is the best is
// known only after its reduction, but a point's residual and visibility are
// a function of the pose alone, computed by once-rounded operations in a
// fixed order. So no pass stores them: after the loop one more pass at the
// best pose (as it was evaluated, before the final re-orthogonalization)
// reproduces them bit for bit and writes them once, each rank its own
// points. The best pose, re-orthogonalized, stays in shared memory as the
// next level's start.
//
// What bounds it on the H100: per iteration a pair does ~60 float32
// operations and five 4-byte L2 reads per visible point and the serial
// step (two double-precision arccos/sin/cos groups, a 3x3 product chain);
// a level moves under 10 MB and does ~1.5 GFLOP at B = 64. It is bound by
// latency (the barriers and the serial step of every iteration) and by the
// issue rate of the blocks a pair has, not by bytes or operations.

#include <cooperative_groups.h>

#include "launch.cuh"
#include "project.cuh"
#include "se3.cuh"
#include "warp.cuh"

namespace cg = cooperative_groups;

namespace {

using rgbd::kFull;
using rgbd::kPoseLanes;
constexpr int kMaxThreads = 1024;
constexpr int kSmallBlock = 512 + 32;  // 512 working threads and the step warp
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kTerms = rgbd::kSgTerms;
constexpr int kTrace = 18;  // a trace row: the pose entering an iteration (R 9, t 3) and its g (6)
constexpr int kMaxLevels = 8;
constexpr int kLevelPtrs = 15, kLevelInts = 6, kLevelFloats = 4;  // the host's table rows
constexpr int kStamps = 8;  // iteration start, pass, sum, step, barrier (5 of 8 used)

// One level of the table, in solve order (coarsest first).
struct Level {
  const float* pts;      // (B, K, 3)
  const uint8_t* valid;  // (B, K)
  const int* count;      // (B,)
  const float* dt;       // (B, H, W), rows contiguous
  long long dt_batch_stride;
  int k, n_iters, h, w;
  int ranks;    // blocks a pair's level runs on (a divisor of the launch's cluster)
  int threads;  // working threads of each of them (a multiple of 32)
  int n_local;  // points one rank stages, at most
  float fx, fy, cx, cy;
  float* R_out;
  float* t_out;
  float* energy_out;
  int* best_iter_out;
  float* best_energy_out;
  float* eps_out;
  uint8_t* vis_out;
  float* vis_ratio_out;
  float* trace_out;  // or null
  long long* clocks;  // or null: pair 0's clock64() at kStamps points of its first 64 iterations
};

struct Pyramid {
  Level lv[kMaxLevels];
  float* traj[kMaxLevels];  // each level's (B, n_iters, 12) trajectory output, or null
  const float* R0;
  const float* t0;
  int levels, cluster;
  float inv_sigma2, l2_lambda, one_minus_momentum, momentum, step_length, precond_rot, radius,
      psi_term;
  int l2, rotationize;  // rotationize: 0 none, 1 Newton-Schulz, 2 the SVD
  rgbd::PointSem sem;   // the point terms of a kParity launch
  float sigma2;         // weight_sigma2, for the weight by divisions
};

// A block's shared state besides the staged points.
struct Shared {
  float pose[2][kPoseLanes];  // the pose the next pass evaluates, and the next one
  float best[kPoseLanes];     // the best iterate
  float part[kMaxWarps * 32];
  float slot[2 * rgbd::kMaxCluster * 32];
  int cur, done, any;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ rgbd::Pose pose_of(const float* p) {
  return rgbd::Pose{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11]};
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

// Pair b's rows of level l's trajectory output (n iterations) where this
// block writes the outputs, else null; selected with constant indices, as
// `level_at` selects the level.
__device__ __forceinline__ float* traj_rows(const Pyramid& P, int l, int b, int n, bool writer) {
  float* t = P.traj[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) t = P.traj[i];
  return writer && t != nullptr ? t + (size_t)b * n * kPoseLanes : nullptr;
}

// Pair 0's first rank's thread 0 records the clock at stamp `at` of
// iteration itr < 64, where the caller asked for it (L.clocks).
__device__ __forceinline__ void stamp(const Level& L, int itr, int at) {
  if (L.clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && itr < 64)
    L.clocks[itr * kStamps + at] = clock64();
}

__device__ __forceinline__ rgbd::Split split_of(const Level& L, int rank) {
  const int q = rank % L.ranks;
  return rgbd::Split{L.ranks, q, rank - q};
}

// The level's first pass warp: 1 where the block has a warp beyond the
// level's working threads (warp 0 then takes the step alone), else 0.
__device__ __forceinline__ int first_warp(const Level& L) {
  return (int)blockDim.x >= L.threads + 32 ? 1 : 0;
}

// Stage this rank's share of pair b's points: x, y, z by cp.async, the
// valid flag into w. Local slot j * T + t holds point (j * ranks + q) * T +
// t, T the level's threads; pass thread p (the block's thread p + 32
// first_warp) takes slot p, p + T, ...
__device__ __forceinline__ void stage(const Level& L, int b, const rgbd::Split& sp,
                                      float4* spts, int tid) {
  const int p = tid - 32 * first_warp(L);
  if (p < 0 || p >= L.threads) return;
  const float* P = L.pts + (size_t)b * L.k * 3;
  const uint8_t* V = L.valid + (size_t)b * L.k;
  for (int j = p, i = sp.q * L.threads + p; i < L.k;
       j += L.threads, i += L.threads * sp.ranks) {
    float* dst = reinterpret_cast<float*>(&spts[j]);
    cp_async4(dst, P + 3 * (size_t)i);
    cp_async4(dst + 1, P + 3 * (size_t)i + 1);
    cp_async4(dst + 2, P + 3 * (size_t)i + 2);
    dst[3] = V[i] ? 1.0f : 0.0f;
  }
}

// The L2 pull's direction: se3_log of the pose (R, t, 12 floats in shared
// memory) over its norm (a zero log stays zero), on the warp.
__device__ __forceinline__ void pull_direction(const float* pose, int lane, float cpsi[6]) {
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = pose[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = pose[9 + i];
  rgbd::warp_se3_log(R, t, lane, cpsi);
  const float nrm = rgbd::norm6(cpsi);
  if (nrm > 0.0f) {
    const float d = fmaxf(nrm, 1e-30f);
#pragma unroll
    for (int i = 0; i < 6; ++i) cpsi[i] = rgbd::fdiv(cpsi[i], d);
  }
}

// The launch's point semantics: the production ones, constants the
// compiler folds, or (kParity) those of the launch's parameters.
template <bool kParity>
__device__ __forceinline__ rgbd::PointSem sem_of(const Pyramid& P) {
  if constexpr (kParity) return P.sem;
  return rgbd::sg_production();
}

// kMaxT: the most threads a launch's blocks have (544: up to 512 working
// threads and the step warp, with 120 registers a thread; 1024: 64).
// kTraj: a launch with a trajectory output (an instantiation of its own, so
// that the loop without it is the code it was before the output).
// kParity: the semantics and the SVD of a reference-parity configuration
// (the trajectory output is then read from its pointer).
template <int kMaxT, bool kTraj, bool kParity>
__global__ void __launch_bounds__(kMaxT) level_sg_kernel(const __grid_constant__ Pyramid P) {
  constexpr bool kRows = kTraj || kParity;
  const rgbd::PointSem sem = sem_of<kParity>(P);
  extern __shared__ float4 spts[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / P.cluster, rank = blockIdx.x - b * P.cluster;
  // warp 0's registers: the pair's solver state, the same on every lane
  float best_e = 0.0f, best_vis = 0.0f;
  float descent[6];
  int best_iter = -1, cur = 0;
  int par = 0;  // the slot of the next cluster sum

  if (tid < kPoseLanes)
    sh.pose[0][tid] = tid < 9 ? P.R0[(size_t)b * 9 + tid] : P.t0[(size_t)b * 3 + tid - 9];
  stage(level_at(P, 0), b, split_of(level_at(P, 0), rank), spts, tid);
  if (P.cluster > 1) cg::this_cluster().sync();  // every rank has started
  cp_async_wait_all();
  __syncthreads();

  for (int l = 0; l < P.levels; ++l) {
    const Level L = level_at(P, l);
    const rgbd::Split sp = split_of(L, rank);
    const bool writer = rank < L.ranks;  // the first group writes the outputs
    const int n = L.n_iters, T = L.threads;
    const int first = first_warp(L), p = tid - 32 * first;  // this thread's pass index
    const bool passer = p >= 0 && p < T;
    const size_t ob = (size_t)b * L.k;
    const float* D = L.dt + (size_t)b * L.dt_batch_stride;
    float* const trow = kRows ? traj_rows(P, l, b, n, writer) : nullptr;
    if (warp == 0) {
      best_e = 1.0e10f;
      best_vis = 1.0f;
      best_iter = -1;
      cur = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) descent[i] = 0.0f;
      if (lane < kPoseLanes) sh.best[lane] = rgbd::lane_eye(lane, 1.0f);
      if (lane == 0) {
        sh.cur = 0;
        sh.done = 0;
      }
    }
    __syncthreads();

    int itr = 0;
    for (; itr < n; ++itr) {
      // ---- the pass over every point at the current pose; a step warp of
      // its own meanwhile takes the pull's direction, which needs the pose
      // alone
      stamp(L, itr, 0);
      float s;  // on lanes m < 8 of warp 0: sum m
      float pull[6];
      if (first && warp == 0 && P.l2) pull_direction(sh.pose[cur], lane, pull);
      {
        const rgbd::Pose pose = pose_of(sh.pose[sh.cur]);
        float acc[kTerms];
#pragma unroll
        for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
        if (passer) {
#pragma unroll 4
          for (int j = p, i = sp.q * T + p; i < L.k; j += T, i += T * sp.ranks) {
            const float4 q = spts[j];
            float eps;
            bool vis;
            rgbd::sg_point(pose, q.x, q.y, q.z, q.w != 0.0f, D, L.h, L.w, L.fx, L.fy, L.cx, L.cy,
                           P.inv_sigma2, P.sigma2, sem, acc, &eps, &vis);
          }
        }
        stamp(L, itr, 1);
        s = rgbd::pair_sum(acc, sh.part, sh.slot, first, T / 32, sp, par, tid);
        par ^= sp.ranks > 1 ? 1 : 0;
      }
      stamp(L, itr, 2);
      if (warp == 0) {
        float g[6], psi[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) g[i] = __shfl_sync(kFull, s, i);
        const float e = __fsqrt_rn(__shfl_sync(kFull, s, 6));
        const float n_vis = __shfl_sync(kFull, s, 7);
        const float pe = lane < kPoseLanes ? sh.pose[cur][lane] : 0.0f;
        if (writer && L.trace_out != nullptr) {
          const float gv = __shfl_sync(kFull, s, lane >= 12 && lane < 18 ? lane - 12 : 0);
          float* tr = L.trace_out + ((size_t)b * n + itr) * kTrace;
          if (lane < kPoseLanes) tr[lane] = pe;
          else if (lane < kTrace) tr[lane] = gv;
        }
        if (writer && lane == 0) L.energy_out[(size_t)b * n + itr] = e;
        if (e <= best_e) {
          best_e = e;
          best_iter = itr;
          best_vis = __fdiv_rn(n_vis, (float)max(L.count[b], 1));
          if (lane < kPoseLanes) sh.best[lane] = pe;
        }
        // the damped, projected sub-gradient step of iteration itr
        if (P.l2) {
          if (!first) pull_direction(sh.pose[cur], lane, pull);
#pragma unroll
          for (int i = 0; i < 6; ++i) g[i] = rgbd::fadd(g[i], rgbd::fmul(P.l2_lambda, pull[i]));
        }
        const float step = rgbd::fdiv(P.step_length, (float)(itr > 5 ? itr - 4 : 1));
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          descent[i] = rgbd::fadd(rgbd::fmul(P.one_minus_momentum, g[i]),
                                  rgbd::fmul(P.momentum, descent[i]));
          psi[i] = rgbd::fmul(rgbd::fmul(-step, i < 3 ? 1.0f : P.precond_rot), descent[i]);
        }
        rgbd::trust_region(psi, P.radius);
        const bool done = rgbd::norm6(psi) < P.psi_term;
        if (!done) {
          const float x = rgbd::lane_se3_exp(psi, lane);
          const float np = rgbd::lane_rotationize_by<kParity>(
              P.rotationize, rgbd::lane_compose(pe, x, lane), lane);
          if (lane < kPoseLanes) sh.pose[1 - cur][lane] = np;
          cur = 1 - cur;
        }
        if (lane == 0) {
          sh.cur = cur;
          sh.done = done ? 1 : 0;
        }
      }
      stamp(L, itr, 3);
      __syncthreads();
      stamp(L, itr, 4);
      // the pose after this iteration, by the last warp from shared memory,
      // off the step warp's chain (the next step writes the other slot)
      if (kRows && trow != nullptr && warp == (int)(blockDim.x >> 5) - 1 && lane < kPoseLanes)
        trow[itr * kPoseLanes + lane] = sh.pose[sh.cur][lane];
      if (sh.done) break;
    }

    // ---- the best iterate's per-point values: one more pass at its pose,
    // each rank its own points
    if (warp == 0) {
      if (writer)
        for (int i = itr + 1 + lane; i < n; i += 32) L.energy_out[(size_t)b * n + i] = 0.0f;
      // a pair done early: its frozen pose in the trajectory's remaining rows
      if (kRows && trow != nullptr)
        for (int x = lane; x < (n - itr - 1) * kPoseLanes; x += 32)
          trow[(itr + 1) * kPoseLanes + x] = sh.pose[cur][x % kPoseLanes];
      if (lane == 0) sh.any = best_iter >= 0 ? 1 : 0;
    }
    __syncthreads();
    if (writer && passer) {
      const bool any = sh.any != 0;
      const rgbd::Pose pose = pose_of(sh.best);
      float acc[kTerms];
#pragma unroll
      for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
      for (int j = p, i = sp.q * T + p; i < L.k; j += T, i += T * sp.ranks) {
        const float4 q = spts[j];
        float eps;
        bool vis;
        rgbd::sg_point(pose, q.x, q.y, q.z, any && q.w != 0.0f, D, L.h, L.w, L.fx, L.fy, L.cx,
                       L.cy, P.inv_sigma2, P.sigma2, sem, acc, &eps, &vis);
        L.eps_out[ob + i] = eps;
        L.vis_out[ob + i] = vis ? 1 : 0;
      }
    }
    // the result, re-orthogonalized, is the next level's start
    if (warp == 0) {
      const float be = rgbd::lane_rotationize_by<kParity>(
          P.rotationize, lane < kPoseLanes ? sh.best[lane] : 0.0f, lane);
      if (lane < kPoseLanes) {
        sh.pose[0][lane] = be;
        if (writer) {
          if (lane < 9) L.R_out[(size_t)b * 9 + lane] = be;
          else L.t_out[(size_t)b * 3 + lane - 9] = be;
        }
      }
      if (writer && lane == 0) {
        L.best_iter_out[b] = best_iter;
        L.best_energy_out[b] = best_e;
        L.vis_ratio_out[b] = best_vis;
      }
    }
    __syncthreads();
    if (l + 1 < P.levels) {
      const Level N = level_at(P, l + 1);
      stage(N, b, split_of(N, rank), spts, tid);
      cp_async_wait_all();
      __syncthreads();
    }
  }
}

// The device function se3_log on n poses, one warp each (warp.cuh's
// warp_se3_log, the step's own): psi_out (n, 6).
__global__ void se3_log_kernel(const float* __restrict__ R, const float* __restrict__ t, int n,
                               float* __restrict__ psi_out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warps leave together
  float Ri[9], ti[3], psi[6];
#pragma unroll
  for (int q = 0; q < 9; ++q) Ri[q] = R[(size_t)i * 9 + q];
#pragma unroll
  for (int q = 0; q < 3; ++q) ti[q] = t[(size_t)i * 3 + q];
  rgbd::warp_se3_log(Ri, ti, lane, psi);
  if (lane < 6) {
#pragma unroll
    for (int q = 0; q < 6; ++q)
      if (q == lane) psi_out[(size_t)i * 6 + q] = psi[q];
  }
}

// The device function lane_rotationize_svd on n 3x3 matrices, one warp
// each: Q_out (n, 9).
__global__ void rotationize_svd_kernel(const float* __restrict__ A, int n,
                                       float* __restrict__ Q_out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warps leave together
  const float x = A[(size_t)i * 9 + (lane < 9 ? lane : 0)];
  const float q = rgbd::lane_rotationize_svd(x, lane);
  if (lane < 9) Q_out[(size_t)i * 9 + lane] = q;
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every level of a sub-gradient pyramid for `batch` pairs in one launch,
// levels in solve order (coarsest first), each starting from the pose the
// one before returned; the first from R0 (B,3,3), t0 (B,3) float32
// contiguous. Level l's row of each host table:
//   ptrs   (15)  pts (B,K,3) float32, valid (B,K) uint8, count (B,) int32,
//                dt (B,H,W) float32 (rows contiguous); the outputs R_out
//                (B,3,3), t_out (B,3), energy_out (B,n_iters), best_iter_out
//                (B,) int32, best_energy_out (B,), eps_out (B,K) float32,
//                vis_out (B,K) uint8, vis_ratio_out (B,); trace_out
//                (B,n_iters,18) or null: per iteration run, the pose entering
//                it (R, t) and its J^T W eps (rows after a pair is done are
//                left as they were); clocks (64, 8) int64 or null: pair 0's
//                clock64() at the start of each of its first 64 iterations,
//                after its pass, its sum, its step and the barrier after it;
//                traj_out (B,n_iters,12) or null: the pose after each
//                iteration (R, t), the frozen pose once a pair is done;
//   strides (1)  dt's batch stride in elements;
//   ints   (6)   k, n_iters (>= 1), h, w, ranks, threads;
//   floats (4)   fx, fy, cx, cy.
// rotationize: 0 none, 1 Newton-Schulz, 2 the SVD. The point terms follow
// `sem` (5 ints: sampler, reference, fma_uv, fma_z, div_weight;
// kernels/point_sem.py), with `sigma2` (weight_sigma2) for the weight by
// divisions; any semantics but the production ones, or the SVD, run the
// reference-parity instantiation.
// A level runs on `ranks` blocks a pair (1, 2, 4, 8), a divisor of
// `cluster`, with `threads` working threads each (a multiple of 32 up to
// 1024); the blocks have the most threads any level has. Launches on
// `stream`, does not synchronize; a cluster the card cannot hold is not
// launched (cudaErrorInvalidConfiguration).
extern "C" int level_sg_pyramid(int device, int levels, int batch, int cluster, const void* R0,
                                const void* t0, const long long* ptrs, const long long* strides,
                                const int* ints, const float* floats, float inv_sigma2,
                                float l2_lambda, float one_minus_momentum, float momentum,
                                float step_length, float precond_rot, float radius,
                                float psi_term, int l2, int rotationize, const int* sem,
                                float sigma2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > kMaxLevels || batch < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (long long)batch * cluster > 0x7fffffffLL || rotationize < 0 || rotationize > 2 ||
      sem[0] < rgbd::kSgFloor || sem[0] > rgbd::kSgSqrtTake)
    return (int)cudaErrorInvalidValue;
  Pyramid P{};
  P.sem = rgbd::PointSem{sem[0], sem[1], sem[2], sem[3], sem[4]};
  const bool parity = !rgbd::same_sem(P.sem, rgbd::sg_production()) || rotationize == 2;
  P.sigma2 = sigma2;
  P.R0 = (const float*)R0;
  P.t0 = (const float*)t0;
  P.levels = levels;
  P.cluster = cluster;
  P.inv_sigma2 = inv_sigma2;
  P.l2_lambda = l2_lambda;
  P.one_minus_momentum = one_minus_momentum;
  P.momentum = momentum;
  P.step_length = step_length;
  P.precond_rot = precond_rot;
  P.radius = radius;
  P.psi_term = psi_term;
  P.l2 = l2;
  P.rotationize = rotationize;
  long long smem = 0;
  int threads = 32;  // each level's working threads, and the step warp beside them where it fits
  for (int l = 0; l < levels; ++l) {
    const long long* q = ptrs + kLevelPtrs * l;
    const int* n = ints + kLevelInts * l;
    const float* f = floats + kLevelFloats * l;
    Level& L = P.lv[l];
    L.pts = (const float*)q[0];
    L.valid = (const uint8_t*)q[1];
    L.count = (const int*)q[2];
    L.dt = (const float*)q[3];
    L.R_out = (float*)q[4];
    L.t_out = (float*)q[5];
    L.energy_out = (float*)q[6];
    L.best_iter_out = (int*)q[7];
    L.best_energy_out = (float*)q[8];
    L.eps_out = (float*)q[9];
    L.vis_out = (uint8_t*)q[10];
    L.vis_ratio_out = (float*)q[11];
    L.trace_out = (float*)q[12];
    L.clocks = (long long*)q[13];
    P.traj[l] = (float*)q[14];
    L.dt_batch_stride = strides[l];
    L.k = n[0];
    L.n_iters = n[1];
    L.h = n[2];
    L.w = n[3];
    L.ranks = n[4];
    L.threads = n[5];
    L.fx = f[0];
    L.fy = f[1];
    L.cx = f[2];
    L.cy = f[3];
    const int r = L.ranks, T = L.threads;
    if (L.k < 1 || L.n_iters < 1 || (r != 1 && r != 2 && r != 4 && r != 8) ||
        cluster % r != 0 || T < 32 || T > kMaxThreads || T % 32 != 0)
      return (int)cudaErrorInvalidValue;
    const long long chunks = (L.k + (long long)T * r - 1) / ((long long)T * r);
    L.n_local = (int)(chunks * T < L.k ? chunks * T : L.k);
    const long long need = (long long)L.n_local * 16;
    smem = need > smem ? need : smem;
    const int need_t = T + 32 <= kMaxThreads ? T + 32 : T;
    threads = need_t > threads ? need_t : threads;
  }
  bool traj = false;
  for (int l = 0; l < levels; ++l) traj = traj || P.traj[l] != nullptr;
  const dim3 grid((unsigned)(batch * cluster));
  cudaStream_t s = (cudaStream_t)stream;
  if (parity) {
    if (threads <= kSmallBlock) {
      static rgbd::ClusterLaunch small_parity;
      return (int)rgbd::launch_cluster(level_sg_kernel<kSmallBlock, false, true>, device, grid,
                                       dim3(threads), smem, cluster, s, &small_parity, P);
    }
    static rgbd::ClusterLaunch large_parity;
    return (int)rgbd::launch_cluster(level_sg_kernel<kMaxThreads, false, true>, device, grid,
                                     dim3(threads), smem, cluster, s, &large_parity, P);
  }
  if (threads <= kSmallBlock) {
    if (traj) {
      static rgbd::ClusterLaunch small_traj;
      return (int)rgbd::launch_cluster(level_sg_kernel<kSmallBlock, true, false>, device, grid,
                                       dim3(threads), smem, cluster, s, &small_traj, P);
    }
    static rgbd::ClusterLaunch small;
    return (int)rgbd::launch_cluster(level_sg_kernel<kSmallBlock, false, false>, device, grid,
                                     dim3(threads), smem, cluster, s, &small, P);
  }
  if (traj) {
    static rgbd::ClusterLaunch large_traj;
    return (int)rgbd::launch_cluster(level_sg_kernel<kMaxThreads, true, false>, device, grid,
                                     dim3(threads), smem, cluster, s, &large_traj, P);
  }
  static rgbd::ClusterLaunch large;
  return (int)rgbd::launch_cluster(level_sg_kernel<kMaxThreads, false, false>, device, grid,
                                   dim3(threads), smem, cluster, s, &large, P);
}

// R (n,3,3), t (n,3) float32 contiguous -> psi_out (n,6): warp_se3_log of
// every pose, one warp each. Launches on `stream`, does not synchronize.
extern "C" int se3_log_batch(int device, const void* R, const void* t, int n, void* psi_out,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  se3_log_kernel<<<(n + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, n, (float*)psi_out);
  return (int)cudaGetLastError();
}

// A (n,3,3) float32 contiguous -> Q_out (n,3,3): lane_rotationize_svd of
// every matrix, one warp each. Launches on `stream`, does not synchronize.
extern "C" int rotationize_svd_batch(int device, const void* A, int n, void* Q_out,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rotationize_svd_kernel<<<(n + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const float*)A, n, (float*)Q_out);
  return (int)cudaGetLastError();
}
