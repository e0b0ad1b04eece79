// A whole Levenberg-Marquardt pyramid of the edge-DVO solver in one launch,
// for Hopper: every level of B frame pairs, coarsest first, each level's
// n_iters iterations from the pose the level before returned.
//
// Replaces the per-iteration route of fused_gn.cu + residual.cu + some 200
// small PyTorch ops between them, i.e. on the TPU the Pallas kernel
// `fused_gn_terms` (rgbd_odometry_tpu/pallas/fused_iter.py:159) with the
// XLA residual pass `_project_and_sample` (rgbd_odometry_tpu/solvers/
// edge_dvo.py:261) inside the `lax.scan` level loops (edge_dvo.py:586, the
// standard LM of :493-622, and :754, the deferred accept of :625-772), and
// the level loop of `solve_pyramid` (edge_dvo.py:824). Two loops, as
// kernels/level_lm.level_lm_plain runs them:
//
//   deferred  one Gauss-Newton pass per iteration on the Jacobian subset at
//             the current pose; its energy is the verdict on the pending
//             proposal. On reject the pose reverts to the backup and the
//             step is recomputed from the backup's carried (H, g, energy)
//             with lambda x4 (max 1e6); on accept lambda /3 (min 1e-8). A
//             pair is done when an accepted step has |psi| below the
//             termination norm (production_320);
//   standard  the Gauss-Newton pass at the current pose, then the residual
//             pass at the proposal on the proposal subset (and, when that
//             subset's stride is > 1, at the current pose in the same
//             pass); a decrease accepts and lowers lambda, an exact tie
//             neither moves nor raises it, an increase raises it; a
//             rejected step never terminates (the `dvo` command).
//
// Both keep the best iterate over the evaluated poses (<=, later ties win)
// and write the energy curve with zeros after a pair is done. The level's
// diagnostics (per-point residuals and visibility, energy, visible ratio):
// with `track` (standard, Jacobian stride 1) the best iterate's, from the
// Gauss-Newton pass itself; otherwise (deferred, or a Jacobian stride > 1)
// an all-point tail after the loop, at the returned pose (the best iterate,
// re-orthogonalized), replaces the JAX package's `_project_and_sample` over
// every point (edge_dvo.py:593-609, :758-771) and the residual.cu launch
// that took its place before: it reads every point from global memory and
// forms e2 and the count with residual.cu's thread-to-point map,
// multiply-add and tree, so its outputs are bitwise that pass's.
//
// Design. A pair's level runs on `ranks` blocks of 256 threads (1, 2, 4 or
// 8, a function of the level's shape alone, kernels/level_lm.level_ranks:
// one for every level of the profiles, where a split measured slower), the
// ranks of a thread-block cluster; the launch's cluster has as many blocks
// as its largest level's ranks, and a level on fewer ranks runs on each
// group of that many alike (the groups compute the same bits; the first
// writes the outputs). The level table comes by value. Each rank stages its
// share of the level's strided point set (the Jacobian subset; the
// proposal subset is every stride-th of its points, stride > 1 only on one
// rank) into shared memory once, as float4 {x, y, z, valid} with cp.async:
// Jacobian point i belongs to rank (i / 256) % ranks and thread i % 256, so
// the map is a block's own at ranks = 1. Every pass reads points from
// shared memory and the bf16 DT through the read-only path (a 240x320 level
// is 150 KB and stays in L2). The running sums (gn_point of project.cuh:
// 29) are reduced in a fixed order (warp.cuh pair_sum): the shuffle-down
// tree in each warp (31 shuffles for the 29 sums), the 8 warp partials in
// order, then each rank's sum written into every rank's shared memory
// behind one cluster barrier and the ranks' sums added in rank order by
// every rank alike, so no rank waits for a broadcast and no atomic makes a
// run differ from the next; on one rank the sums are those of the kernel
// before the cluster split, bit for bit. Warp 0 goes from the last partial
// sum straight into the step (warp.cuh): the damped Cholesky on every lane
// alike, the exponential with one double sincos, the compose and
// Newton-Schulz one 3x3 entry a lane, each value bitwise its plain twin's;
// the solver's scalars stay in warp 0's registers, and the current, backup
// (deferred) or proposal (standard) pose and the carried (H, g) are two
// shared-memory slots each, swapped by index. One block barrier hands the
// next pose to the passes; a done pair's blocks leave the loop together.
// The e2 of the Gauss-Newton pass and of the residual pass are formed by
// the same per-thread fused multiply-adds over the same thread-to-point map
// and the same tree, so at an unchanged pose the two energies are bitwise
// equal and the accept test sees an exact tie as a tie. Per-point values
// keep project.cuh's once-rounded operations: a one-ulp move of u or v can
// cross a pixel. Between levels the best pose, re-orthogonalized, stays in
// shared memory as the next level's start, and the next level's points are
// staged with cp.async while this level's tail runs. The tail's per-point
// work is split over the level's ranks; with ranks > 1 the first rank then
// sums e2 and the count from the written residuals in residual.cu's map
// and tree, so the tail stays bitwise residual_pass at the returned pose.
//
// What bounds it on the H100: per iteration a pair does ~150 float32
// operations and four 2-byte L2 reads per point (a few hundred points) and
// the serial step; a pyramid moves under 1 MB and does a few MFLOP at B =
// 64. It is bound by latency: the chain of barriers and the serial step
// of every iteration, not by bytes or operations. The tail adds one pass
// over K points (12-byte point, 1-byte flag, four 2-byte L2 reads).

#include <cooperative_groups.h>

#include "launch.cuh"
#include "project.cuh"
#include "se3.cuh"
#include "warp.cuh"

namespace cg = cooperative_groups;

namespace {

using rgbd::kFull;
using rgbd::kPoseLanes;
using rgbd::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = rgbd::kGnTerms;
constexpr int kMaxLevels = 8;
constexpr int kLevelPtrs = 15, kLevelInts = 8, kLevelFloats = 4;  // the host's table rows
constexpr int kStamps = 8;  // iteration start, pass, sum, step, barrier; standard: pass, step, barrier

// One level of the table, in solve order (coarsest first).
struct Level {
  const float* pts;          // (B, K, 3)
  const uint8_t* valid;      // (B, K)
  const int* count;          // (B,)
  const __nv_bfloat16* img;  // (B, H, W), rows contiguous
  long long img_batch_stride;
  const float* scale;        // (B,) DT units per pixel
  int k, k_jac, jstride, stride, n_iters, h, w;
  int ranks;    // blocks a pair's level runs on (a divisor of the launch's cluster)
  int n_local;  // Jacobian points one rank stages, at most
  int track;    // standard LM at Jacobian stride 1: the best iterate's diagnostics
  float fx, fy, cx, cy;
  float* R_out;
  float* t_out;
  float* energy_out;
  int* best_iter_out;
  float* best_energy_out;
  float* final_energy_out;
  float* eps_out;
  uint8_t* vis_out;
  float* vis_ratio_out;
  long long* clocks;  // or null: pair 0's clock64() at kStamps points of its first 64 iterations
};

struct Pyramid {
  Level lv[kMaxLevels];
  const float* R0;
  const float* t0;
  int levels, cluster;
  float inv_sigma2, lam0, radius, psi_term;
  int deferred, rotationize;
};

// A block's shared state besides the staged points.
struct Shared {
  float pose[2][kPoseLanes];  // current and backup (deferred) or proposal (standard)
  float best[kPoseLanes];     // the best iterate
  float Hg[2][32];            // deferred: the fresh and the carried (H 21, g 6)
  float sums[32];             // standard: this iteration's (H 21, g 6)
  float part[kWarps * 32];
  float slot[2 * rgbd::kMaxCluster * 32];
  float red[2][kThreads];
  int cur, done, better;
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

// Pair 0's first rank's thread 0 records the clock at stamp `at` of
// iteration itr < 64, where the caller asked for it (L.clocks).
__device__ __forceinline__ void stamp(const Level& L, int itr, int at) {
  if (L.clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && itr < 64)
    L.clocks[itr * kStamps + at] = clock64();
}

// Where this block is among the level's ranks.
__device__ __forceinline__ rgbd::Split split_of(const Level& L, int rank) {
  const int q = rank % L.ranks;
  return rgbd::Split{L.ranks, q, rank - q};
}

// Stage this rank's share of pair b's Jacobian subset: x, y, z by
// cp.async, the valid flag into w. Local slot j * 256 + t holds point
// (j * ranks + q) * 256 + t of the subset.
__device__ __forceinline__ void stage(const Level& L, int b, const rgbd::Split& sp,
                                      float4* spts, int tid) {
  const float* P = L.pts + (size_t)b * L.k * 3;
  const uint8_t* V = L.valid + (size_t)b * L.k;
  for (int j = tid, i = sp.q * kThreads + tid; i < L.k_jac;
       j += kThreads, i += kThreads * sp.ranks) {
    const size_t g = (size_t)i * L.jstride;
    float* dst = reinterpret_cast<float*>(&spts[j]);
    cp_async4(dst, P + 3 * g);
    cp_async4(dst + 1, P + 3 * g + 1);
    cp_async4(dst + 2, P + 3 * g + 2);
    dst[3] = V[g] ? 1.0f : 0.0f;
  }
}

// The squared residual of one point of the proposal subset at a pose,
// added to *e2 exactly as gn_point adds it.
__device__ __forceinline__ void add_e2(const rgbd::Pose& pose, const float4& q,
                                       const __nv_bfloat16* __restrict__ I, const Level& L,
                                       float* e2) {
  if (q.w != 0.0f) {
    const rgbd::Projected p = rgbd::project_xyz(pose, q.x, q.y, q.z, L.fx, L.fy, L.cx, L.cy);
    if (rgbd::in_image(p.u, p.v, L.h, L.w)) {
      float eps, gu, gv;
      rgbd::sample_bilinear(I, L.h, L.w, p.u, p.v, &eps, &gu, &gv);
      *e2 = __fmaf_rn(eps, eps, *e2);
    }
  }
}

// One point of the all-point tail: residual.cu's bilinear per-point pass.
__device__ __forceinline__ void tail_point(const rgbd::Pose& pose, const Level& L,
                                           const float* P, const uint8_t* V,
                                           const __nv_bfloat16* I, int i, float* eps_o,
                                           bool* vis_o) {
  float eps = 0.0f;
  bool vis = false;
  if (V[i]) {
    const rgbd::Projected q = rgbd::project<false>(pose, P + 3 * i, L.fx, L.fy, L.cx, L.cy);
    vis = rgbd::in_image(q.u, q.v, L.h, L.w);
    if (vis) {
      float gu, gv;
      rgbd::sample_bilinear(I, L.h, L.w, q.u, q.v, &eps, &gu, &gv);
    }
  }
  *eps_o = eps;
  *vis_o = vis;
}

__global__ void __launch_bounds__(kThreads) level_lm_kernel(const __grid_constant__ Pyramid P) {
  extern __shared__ float4 spts[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / P.cluster, rank = blockIdx.x - b * P.cluster;
  // warp 0's registers: the pair's solver state, the same on every lane
  float lam = 0.0f, eb = 0.0f, best_e = 0.0f, best_vis = 0.0f, e = 0.0f, psi_norm = 0.0f;
  int best_iter = -1, pending = 0, carry = 0, cur = 0;
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
    const int n = L.n_iters;
    const size_t ob = (size_t)b * L.k;  // this pair's per-point outputs
    float* seps = reinterpret_cast<float*>(spts + L.n_local);
    uint8_t* svis = reinterpret_cast<uint8_t*>(seps + L.n_local);
    const __nv_bfloat16* I = L.img + (size_t)b * L.img_batch_stride;
    const float* Pb = L.pts + (size_t)b * L.k * 3;
    const uint8_t* Vb = L.valid + (size_t)b * L.k;
    const float sc = L.scale[b];
    if (L.track && writer) {  // the best iterate's values, 0 until one is evaluated
      for (int i = sp.q * kThreads + tid; i < L.k; i += kThreads * sp.ranks) {
        L.eps_out[ob + i] = 0.0f;
        L.vis_out[ob + i] = 0;
      }
    }
    if (warp == 0) {
      lam = P.lam0;
      eb = __int_as_float(0x7f800000);  // +inf
      best_e = 1.0e10f;
      best_vis = 1.0f;
      best_iter = -1;
      pending = 0;
      carry = 0;
      cur = 0;
      if (lane < kPoseLanes) sh.best[lane] = P.deferred ? sh.pose[0][lane] : rgbd::lane_eye(lane, 1.0f);
      if (lane == 0) {
        sh.cur = 0;
        sh.done = 0;
      }
    }
    __syncthreads();

    int itr = 0;
    for (; itr < n; ++itr) {
      stamp(L, itr, 0);
      // ---- the Gauss-Newton pass at the current pose
      float s;  // on lanes m < 29 of warp 0: sum m
      {
        const rgbd::Pose pose = pose_of(sh.pose[sh.cur]);
        float acc[kTerms];
#pragma unroll
        for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
#pragma unroll 2
        for (int j = tid, i = sp.q * kThreads + tid; i < L.k_jac;
             j += kThreads, i += kThreads * sp.ranks) {
          const float4 q = spts[j];
          float eps;
          bool vis;
          rgbd::gn_point(pose, q.x, q.y, q.z, q.w != 0.0f, I, L.h, L.w, L.fx, L.fy, L.cx, L.cy,
                         sc, P.inv_sigma2, acc, &eps, &vis);
          if (L.track) {
            seps[j] = eps;
            svis[j] = vis ? 1 : 0;
          }
        }
        stamp(L, itr, 1);
        s = rgbd::pair_sum(acc, sh.part, sh.slot, 0, kWarps, sp, par, tid);
        par ^= sp.ranks > 1 ? 1 : 0;
      }
      stamp(L, itr, 2);
      if (warp == 0) {
        e = __fsqrt_rn(__shfl_sync(kFull, s, 27));
        const float n_vis = __shfl_sync(kFull, s, 28);
        float psi[6];
        if (P.deferred) {
          const int fresh = 1 - carry;
          if (lane < 27) sh.Hg[fresh][lane] = s;
          __syncwarp();
          const bool accept = !pending || e < eb;
          const bool worse = pending && e > eb;
          if (pending && accept) lam = fmaxf(__fdiv_rn(lam, 3.0f), 1e-8f);
          else if (worse) lam = fminf(__fmul_rn(lam, 4.0f), 1e6f);
          const int from = accept ? cur : 1 - cur;  // the pose the step starts from
          const int hu = accept ? fresh : carry;    // and its normal equations
          const float eu = accept ? e : eb;
          if (e <= best_e) {
            best_e = e;
            best_iter = itr;
            if (lane < kPoseLanes) sh.best[lane] = sh.pose[cur][lane];
          }
          rgbd::warp_lm_psi(sh.Hg[hu], sh.Hg[hu] + 21, lam, P.radius, psi);
          const bool newly_done = accept && pending && rgbd::norm6(psi) < P.psi_term;
          if (writer && lane == 0) L.energy_out[(size_t)b * n + itr] = e;
          if (!newly_done) {
            const float x = rgbd::lane_se3_exp(psi, lane);
            float np = rgbd::lane_compose(lane < kPoseLanes ? sh.pose[from][lane] : 0.0f, x, lane);
            if (P.rotationize) np = rgbd::lane_rotationize(np, lane);
            if (lane < kPoseLanes) sh.pose[1 - from][lane] = np;
            cur = 1 - from;  // the proposal; the backup is `from`
            carry = hu;
            eb = eu;
            pending = 1;
          } else {
            cur = from;
            pending = 0;
          }
          if (lane == 0) {
            sh.cur = cur;
            sh.done = newly_done ? 1 : 0;
          }
        } else {
          const bool better = e <= best_e;
          if (better) {
            best_e = e;
            best_iter = itr;
            if (lane < kPoseLanes) sh.best[lane] = sh.pose[cur][lane];
            if (L.track) best_vis = __fdiv_rn(n_vis, (float)max(L.count[b], 1));
          }
          if (lane < 27) sh.sums[lane] = s;
          __syncwarp();
          rgbd::warp_lm_psi(sh.sums, sh.sums + 21, lam, P.radius, psi);
          psi_norm = rgbd::norm6(psi);
          const float x = rgbd::lane_se3_exp(psi, lane);
          float np = rgbd::lane_compose(lane < kPoseLanes ? sh.pose[cur][lane] : 0.0f, x, lane);
          if (P.rotationize) np = rgbd::lane_rotationize(np, lane);
          if (lane < kPoseLanes) sh.pose[1 - cur][lane] = np;  // the proposal
          if (lane == 0) sh.better = better ? 1 : 0;
        }
      }
      stamp(L, itr, 3);
      __syncthreads();
      stamp(L, itr, 4);
      if (!P.deferred) {
        // the best iterate's per-point values: each thread copies the points
        // it wrote itself
        if (L.track && sh.better && writer) {
          for (int j = tid, i = sp.q * kThreads + tid; i < L.k_jac;
               j += kThreads, i += kThreads * sp.ranks) {
            L.eps_out[ob + i] = seps[j];
            L.vis_out[ob + i] = svis[j];
          }
        }
        // ---- the residual pass at the proposal (and at the current pose on
        // a strided proposal subset), e2 formed as the Gauss-Newton pass forms it
        const rgbd::Pose pn = pose_of(sh.pose[1 - sh.cur]);
        float acc[2] = {0.0f, 0.0f};
        if (L.stride == 1) {
          for (int j = tid, i = sp.q * kThreads + tid; i < L.k_jac;
               j += kThreads, i += kThreads * sp.ranks)
            add_e2(pn, spts[j], I, L, &acc[0]);
        } else {  // one rank
          const rgbd::Pose pc = pose_of(sh.pose[sh.cur]);
          const int k_sub = (L.k_jac + L.stride - 1) / L.stride;
          for (int j = tid; j < k_sub; j += kThreads) {
            const float4 q = spts[j * L.stride];
            add_e2(pn, q, I, L, &acc[0]);
            add_e2(pc, q, I, L, &acc[1]);
          }
        }
        s = rgbd::pair_sum(acc, sh.part, sh.slot, 0, kWarps, sp, par, tid);
        par ^= sp.ranks > 1 ? 1 : 0;
        stamp(L, itr, 5);
        if (warp == 0) {
          const float e_new = __fsqrt_rn(__shfl_sync(kFull, s, 0));
          const float e_alt = __fsqrt_rn(__shfl_sync(kFull, s, 1));
          const float e_cur = L.stride == 1 ? e : e_alt;
          const bool accept = e_new < e_cur;
          const bool worse = e_new > e_cur;
          if (accept) lam = fmaxf(__fdiv_rn(lam, 3.0f), 1e-8f);
          else if (worse) lam = fminf(__fmul_rn(lam, 4.0f), 1e6f);
          const bool newly_done = accept && psi_norm < P.psi_term;
          if (writer && lane == 0) L.energy_out[(size_t)b * n + itr] = e;
          if (accept && !newly_done) cur = 1 - cur;
          if (lane == 0) {
            sh.cur = cur;
            sh.done = newly_done ? 1 : 0;
          }
        }
        stamp(L, itr, 6);
        __syncthreads();
        stamp(L, itr, 7);
      }
      if (sh.done) break;
    }

    // ---- the level's result: the best iterate, re-orthogonalized, is the
    // next level's start
    if (warp == 0) {
      if (writer)
        for (int i = itr + 1 + lane; i < n; i += 32) L.energy_out[(size_t)b * n + i] = 0.0f;
      float be = lane < kPoseLanes ? sh.best[lane] : 0.0f;
      if (P.rotationize) be = rgbd::lane_rotationize(be, lane);
      if (lane < kPoseLanes) {
        sh.best[lane] = be;
        sh.pose[0][lane] = be;
        if (writer) {
          if (lane < 9) L.R_out[(size_t)b * 9 + lane] = be;
          else L.t_out[(size_t)b * 3 + lane - 9] = be;
        }
      }
      if (writer && lane == 0) {
        L.best_iter_out[b] = best_iter;
        L.best_energy_out[b] = best_e;
        if (L.track) {
          L.final_energy_out[b] = best_e;
          L.vis_ratio_out[b] = best_vis;
        }
      }
    }
    __syncthreads();
    if (l + 1 < P.levels) {  // the next level's points, while the tail runs
      const Level N = level_at(P, l + 1);
      stage(N, b, split_of(N, rank), spts, tid);
    }

    // ---- the all-point tail: the level's diagnostics at the returned pose,
    // every point read from global memory, bitwise residual.cu's bilinear
    // pass (its thread-to-point map, multiply-add and tree)
    if (!L.track) {
      const rgbd::Pose pose = pose_of(sh.best);
      if (sp.ranks == 1) {
        if (writer) {
          float acc[2] = {0.0f, 0.0f};  // e2, count
          for (int i = tid; i < L.k; i += kThreads) {
            float eps;
            bool vis;
            tail_point(pose, L, Pb, Vb, I, i, &eps, &vis);
            if (vis) {
              acc[0] = __fmaf_rn(eps, eps, acc[0]);
              acc[1] += 1.0f;
            }
            L.eps_out[ob + i] = eps;
            L.vis_out[ob + i] = vis ? 1 : 0;
          }
          rgbd::block_reduce(acc, sh.red, tid);
          if (tid == 0) {
            L.final_energy_out[b] = __fsqrt_rn(sh.red[0][0]);
            L.vis_ratio_out[b] = __fdiv_rn(sh.red[1][0], (float)max(L.count[b], 1));
          }
        }
      } else {
        // each rank its share of the points, then the first rank sums the
        // written residuals in residual.cu's map
        if (writer) {
          for (int i = sp.q * kThreads + tid; i < L.k; i += kThreads * sp.ranks) {
            float eps;
            bool vis;
            tail_point(pose, L, Pb, Vb, I, i, &eps, &vis);
            L.eps_out[ob + i] = eps;
            L.vis_out[ob + i] = vis ? 1 : 0;
          }
          __threadfence();
        }
        cg::this_cluster().sync();
        if (rank == 0) {
          float acc[2] = {0.0f, 0.0f};
          for (int i = tid; i < L.k; i += kThreads) {
            if (__ldcg(L.vis_out + ob + i)) {
              const float eps = __ldcg(L.eps_out + ob + i);
              acc[0] = __fmaf_rn(eps, eps, acc[0]);
              acc[1] += 1.0f;
            }
          }
          rgbd::block_reduce(acc, sh.red, tid);
          if (tid == 0) {
            L.final_energy_out[b] = __fsqrt_rn(sh.red[0][0]);
            L.vis_ratio_out[b] = __fdiv_rn(sh.red[1][0], (float)max(L.count[b], 1));
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every level of an LM pyramid for `batch` pairs in one launch, levels in
// solve order (coarsest first), each starting from the pose the one before
// returned; the first from R0 (B,3,3), t0 (B,3) float32 contiguous. Level
// l's row of each host table:
//   ptrs   (15)  pts (B,K,3) float32, valid (B,K) uint8, count (B,) int32,
//                img (B,H,W) bf16 (rows contiguous), scale (B,) float32; the
//                outputs R_out (B,3,3), t_out (B,3), energy_out (B,n_iters),
//                best_iter_out (B,) int32, best_energy_out (B,),
//                final_energy_out (B,), eps_out (B,K) float32, vis_out (B,K)
//                uint8, vis_ratio_out (B,), each written in full; clocks
//                (64, 8) int64 or null: pair 0's clock64() at the start of
//                each of its first 64 iterations, after its Gauss-Newton
//                pass, its sum, its step and the barrier after it, and
//                (standard LM) after the residual pass's sum, the decision
//                and the barrier after it (left as they were where not run);
//   strides (1)  img's batch stride in elements;
//   ints   (8)   k, k_jac, jstride, stride, n_iters (>= 1), h, w, ranks;
//   floats (4)   fx, fy, cx, cy.
// The Jacobian subset is points 0, jstride, 2 jstride, ... (k_jac of them);
// the proposal subset every stride-th of those (standard LM; stride 1 = the
// same set; stride > 1 only on one rank). A level runs on `ranks` blocks a
// pair (1, 2, 4, 8), a divisor of `cluster`, the blocks of a cluster a
// pair. The diagnostics: with track (standard LM, jstride 1) the best
// iterate's (0 where no iterate was evaluated), else the all-point tail's
// at the returned pose. Launches on `stream`, does not synchronize; a
// cluster the card cannot hold is not launched (cudaErrorInvalidConfiguration).
extern "C" int level_lm_pyramid(int device, int levels, int batch, int cluster, const void* R0,
                                const void* t0, const long long* ptrs, const long long* strides,
                                const int* ints, const float* floats, float inv_sigma2,
                                float lam0, float radius, float psi_term, int deferred,
                                int rotationize, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > kMaxLevels || batch < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (long long)batch * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Pyramid P{};
  P.R0 = (const float*)R0;
  P.t0 = (const float*)t0;
  P.levels = levels;
  P.cluster = cluster;
  P.inv_sigma2 = inv_sigma2;
  P.lam0 = lam0;
  P.radius = radius;
  P.psi_term = psi_term;
  P.deferred = deferred;
  P.rotationize = rotationize;
  long long smem = 0;
  for (int l = 0; l < levels; ++l) {
    const long long* q = ptrs + kLevelPtrs * l;
    const int* n = ints + kLevelInts * l;
    const float* f = floats + kLevelFloats * l;
    Level& L = P.lv[l];
    L.pts = (const float*)q[0];
    L.valid = (const uint8_t*)q[1];
    L.count = (const int*)q[2];
    L.img = (const __nv_bfloat16*)q[3];
    L.scale = (const float*)q[4];
    L.R_out = (float*)q[5];
    L.t_out = (float*)q[6];
    L.energy_out = (float*)q[7];
    L.best_iter_out = (int*)q[8];
    L.best_energy_out = (float*)q[9];
    L.final_energy_out = (float*)q[10];
    L.eps_out = (float*)q[11];
    L.vis_out = (uint8_t*)q[12];
    L.vis_ratio_out = (float*)q[13];
    L.clocks = (long long*)q[14];
    L.img_batch_stride = strides[l];
    L.k = n[0];
    L.k_jac = n[1];
    L.jstride = n[2];
    L.stride = n[3];
    L.n_iters = n[4];
    L.h = n[5];
    L.w = n[6];
    L.ranks = n[7];
    L.fx = f[0];
    L.fy = f[1];
    L.cx = f[2];
    L.cy = f[3];
    L.track = !deferred && L.jstride == 1;
    const int r = L.ranks;
    if (L.k < 1 || L.k_jac < 1 || L.jstride < 1 || L.stride < 1 || L.n_iters < 1 ||
        (r != 1 && r != 2 && r != 4 && r != 8) || cluster % r != 0 || (L.stride > 1 && r > 1))
      return (int)cudaErrorInvalidValue;
    const long long chunks = (L.k_jac + (long long)kThreads * r - 1) / ((long long)kThreads * r);
    L.n_local = (int)(chunks * kThreads < L.k_jac ? chunks * kThreads : L.k_jac);
    const long long need = (long long)L.n_local * (16 + (L.track ? 5 : 0));
    smem = need > smem ? need : smem;
  }
  static rgbd::ClusterLaunch state;
  return (int)rgbd::launch_cluster(level_lm_kernel, device, dim3((unsigned)(batch * cluster)),
                                   dim3(kThreads), smem, cluster, (cudaStream_t)stream, &state,
                                   P);
}
