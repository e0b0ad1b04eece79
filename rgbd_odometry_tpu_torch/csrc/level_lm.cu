// A whole Levenberg-Marquardt pyramid level of the edge-DVO solver in one
// launch, for Hopper: the n_iters iterations of one level for B frame pairs.
//
// Replaces the per-iteration route of fused_gn.cu + residual.cu + some 200
// small PyTorch ops between them, i.e. on the TPU the Pallas kernel
// `fused_gn_terms` (rgbd_odometry_tpu/pallas/fused_iter.py:159) with the
// XLA residual pass `_project_and_sample` (rgbd_odometry_tpu/solvers/
// edge_dvo.py:261) inside the `lax.scan` level loops (edge_dvo.py:586, the
// standard LM of :493-622, and :754, the deferred accept of :625-772). Two
// loops, as kernels/level_lm.level_lm_plain runs them:
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
// and write the energy curve with zeros after a pair is done. With `track`
// (standard, Jacobian stride 1) the best iterate's per-point residuals and
// visibility come from the Gauss-Newton pass itself.
//
// Design. One block of 256 threads owns one pair for the whole level. The
// level's strided point set (the Jacobian subset; the proposal subset is
// every stride-th of its points) is staged once into shared memory as
// float4 {x, y, z, valid} with cp.async, overlapped with thread 0 loading
// the start pose. Every pass then reads points from shared memory and the
// bf16 DT through the read-only path (a 240x320 level is 150 KB, so it stays
// in L2). The 29 running sums (gn_point of project.cuh, the per-point math
// of fused_gn.cu) are reduced in a fixed order: a warp-shuffle tree, then
// the 8 warp partials summed in order by one lane per sum. There are no
// atomics, so a result is the same bit for bit from run to run. Thread 0
// then solves the damped 6x6 system, takes the decisions, runs se3_exp,
// the compose and Newton-Schulz (se3.cuh) and broadcasts the next pose
// through shared memory; a done pair's block leaves the loop. The e2 of the
// Gauss-Newton pass and of the residual pass are formed by the same
// per-thread fused multiply-adds over the same thread-to-point map and the
// same tree, so at an unchanged pose the two energies are bitwise equal and
// the accept test sees an exact tie as a tie. Per-point values keep
// project.cuh's once-rounded operations: a one-ulp move of u or v can
// cross a pixel.
//
// What bounds it on the H100: per iteration a pair does ~100 float32
// operations and four 2-byte L2 reads per point (a few hundred points) and
// one thread's serial 6x6 solve, exponential and 3 Newton-Schulz steps; a
// level moves under 1 MB and does a few MFLOP at B = 64. It is bound by
// latency: the per-iteration chain of block reductions and thread 0's
// serial step, not by bytes or operations. A B = 1 pair occupies one SM of
// 132; splitting it over a thread-block cluster is the next step.

#include "launch.cuh"
#include "project.cuh"
#include "se3.cuh"

namespace {

using rgbd::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = rgbd::kGnTerms;

struct Params {
  const float* R0;
  const float* t0;
  const float* pts;
  const uint8_t* valid;
  const int* count;
  const __nv_bfloat16* img;
  long long img_batch_stride;
  const float* scale;
  int k, k_jac, jstride, stride, n_iters, h, w;
  float fx, fy, cx, cy, inv_sigma2, lam0, radius, psi_term;
  int deferred, rotationize, track;
  float* R_out;
  float* t_out;
  float* energy_out;
  int* best_iter_out;
  float* best_energy_out;
  float* eps_out;
  uint8_t* vis_out;
  float* vis_ratio_out;
};

// Per-pair solver state, written by thread 0 only.
struct State {
  float R[9], t[3];      // the pose the next Gauss-Newton pass evaluates
  float Rn[9], tn[3];    // standard: the proposal
  float Rb[9], tb[3];    // deferred: the backup pose
  float Hb[36], gb[6];   // deferred: its carried normal equations
  float eb;              // deferred: its energy
  float bR[9], bt[3];    // the best iterate
  float best_e, best_vis, lam, e, psi_norm;
  int best_iter, pending, done, better;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Sum N per-thread partials over the block: a warp-shuffle tree, then lane
// m of warp 0 adds the 8 warp partials of sum m in order into out[m]. On
// return thread 0 (and only warp 0) may read out[]; every thread must call.
template <int N>
__device__ __forceinline__ void block_sum(float (&acc)[N], float (*part)[kTerms], float* out,
                                          int tid) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    float v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][m] = v;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < N) {
      float s = part[0][lane];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) s += part[q][lane];
      out[lane] = s;
    }
    __syncwarp();
  }
}

__device__ __forceinline__ rgbd::Pose pose_of(const float* R, const float* t) {
  return rgbd::Pose{R[0], R[1], R[2], R[3], R[4], R[5], R[6], R[7], R[8], t[0], t[1], t[2]};
}

// The squared residual of one point of the proposal subset at a pose,
// added to *e2 exactly as gn_point adds it.
__device__ __forceinline__ void add_e2(const rgbd::Pose& pose, const float4& q,
                                       const __nv_bfloat16* __restrict__ I, int h, int w,
                                       float fx, float fy, float cx, float cy, float* e2) {
  if (q.w != 0.0f) {
    const rgbd::Projected p = rgbd::project_xyz(pose, q.x, q.y, q.z, fx, fy, cx, cy);
    if (rgbd::in_image(p.u, p.v, h, w)) {
      float eps, gu, gv;
      rgbd::sample_bilinear(I, h, w, p.u, p.v, &eps, &gu, &gv);
      *e2 = __fmaf_rn(eps, eps, *e2);
    }
  }
}

__device__ __forceinline__ void copy(float* dst, const float* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads) level_lm(const Params p) {
  extern __shared__ float4 spts[];
  __shared__ float part[kWarps][kTerms];
  __shared__ float sums[kTerms];
  __shared__ State st;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float* seps = reinterpret_cast<float*>(spts + p.k_jac);
  uint8_t* svis = reinterpret_cast<uint8_t*>(seps + p.k_jac);
  const __nv_bfloat16* I = p.img + (size_t)b * p.img_batch_stride;

  // stage the Jacobian subset: x, y, z by cp.async, the valid flag into w
  const float* P = p.pts + (size_t)b * p.k * 3;
  const uint8_t* V = p.valid + (size_t)b * p.k;
  for (int i = tid; i < p.k_jac; i += kThreads) {
    const size_t g = (size_t)i * p.jstride;
    float* dst = reinterpret_cast<float*>(&spts[i]);
    cp_async4(dst, P + 3 * g);
    cp_async4(dst + 1, P + 3 * g + 1);
    cp_async4(dst + 2, P + 3 * g + 2);
    dst[3] = V[g] ? 1.0f : 0.0f;
  }
  if (tid == 0) {
    copy(st.R, p.R0 + (size_t)b * 9, 9);
    copy(st.t, p.t0 + (size_t)b * 3, 3);
    if (p.deferred) {
      copy(st.bR, st.R, 9);
      copy(st.bt, st.t, 3);
      copy(st.Rb, st.R, 9);
      copy(st.tb, st.t, 3);
      for (int i = 0; i < 36; ++i) st.Hb[i] = 0.0f;
      for (int i = 0; i < 6; ++i) st.gb[i] = 0.0f;
    } else {
      for (int i = 0; i < 9; ++i) st.bR[i] = (i % 4 == 0) ? 1.0f : 0.0f;
      for (int i = 0; i < 3; ++i) st.bt[i] = 0.0f;
    }
    st.eb = __int_as_float(0x7f800000);  // +inf
    st.best_e = 1.0e10f;
    st.best_vis = 1.0f;
    st.best_iter = -1;
    st.lam = p.lam0;
    st.pending = 0;
    st.done = 0;
  }
  cp_async_wait_all();
  __syncthreads();
  const float sc = p.scale[b];
  const int k_sub = (p.k_jac + p.stride - 1) / p.stride;

  int itr = 0;
  for (; itr < p.n_iters; ++itr) {
    // ---- the Gauss-Newton pass at the current pose
    {
      const rgbd::Pose pose = pose_of(st.R, st.t);
      float acc[kTerms];
#pragma unroll
      for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
      for (int i = tid; i < p.k_jac; i += kThreads) {
        const float4 q = spts[i];
        float eps;
        bool vis;
        rgbd::gn_point(pose, q.x, q.y, q.z, q.w != 0.0f, I, p.h, p.w, p.fx, p.fy, p.cx, p.cy, sc,
                       p.inv_sigma2, acc, &eps, &vis);
        if (p.track) {
          seps[i] = eps;
          svis[i] = vis ? 1 : 0;
        }
      }
      block_sum(acc, part, sums, tid);
    }
    if (tid == 0) {
      float H[36], g[6], psi[6];
      for (int r = 0, m = 0; r < 6; ++r)
        for (int c = r; c < 6; ++c, ++m) H[r * 6 + c] = H[c * 6 + r] = sums[m];
      for (int r = 0; r < 6; ++r) g[r] = sums[21 + r];
      const float e = __fsqrt_rn(sums[27]);
      if (p.deferred) {
        const bool accept = !st.pending || e < st.eb;
        const bool worse = st.pending && e > st.eb;
        if (st.pending && accept) st.lam = fmaxf(__fdiv_rn(st.lam, 3.0f), 1e-8f);
        else if (worse) st.lam = fminf(__fmul_rn(st.lam, 4.0f), 1e6f);
        float Rc[9], tc[3], Hu[36], gu[6];
        copy(Rc, accept ? st.R : st.Rb, 9);
        copy(tc, accept ? st.t : st.tb, 3);
        copy(Hu, accept ? H : st.Hb, 36);
        copy(gu, accept ? g : st.gb, 6);
        const float eu = accept ? e : st.eb;
        if (e <= st.best_e) {
          st.best_e = e;
          copy(st.bR, st.R, 9);
          copy(st.bt, st.t, 3);
          st.best_iter = itr;
        }
        rgbd::lm_psi(Hu, gu, st.lam, p.radius, psi);
        const bool newly_done = accept && st.pending && rgbd::norm6(psi) < p.psi_term;
        p.energy_out[(size_t)b * p.n_iters + itr] = e;
        if (!newly_done) {
          float xR[9], xt[3];
          rgbd::se3_exp(psi, xR, xt);
          rgbd::compose(Rc, tc, xR, xt, st.R, st.t);
          if (p.rotationize) rgbd::rotationize_newton(st.R);
          copy(st.Rb, Rc, 9);
          copy(st.tb, tc, 3);
          copy(st.Hb, Hu, 36);
          copy(st.gb, gu, 6);
          st.eb = eu;
          st.pending = 1;
        } else {
          copy(st.R, Rc, 9);
          copy(st.t, tc, 3);
          st.pending = 0;
          st.done = 1;
        }
      } else {
        st.better = e <= st.best_e;
        if (st.better) {
          st.best_e = e;
          copy(st.bR, st.R, 9);
          copy(st.bt, st.t, 3);
          st.best_iter = itr;
          if (p.track)
            st.best_vis = __fdiv_rn(sums[28], (float)max(p.count[b], 1));
        }
        rgbd::lm_psi(H, g, st.lam, p.radius, psi);
        st.psi_norm = rgbd::norm6(psi);
        st.e = e;
        float xR[9], xt[3];
        rgbd::se3_exp(psi, xR, xt);
        rgbd::compose(st.R, st.t, xR, xt, st.Rn, st.tn);
        if (p.rotationize) rgbd::rotationize_newton(st.Rn);
      }
    }
    __syncthreads();
    if (!p.deferred) {
      // the best iterate's per-point values: each thread copies the points
      // it wrote itself
      if (p.track && st.better) {
        for (int i = tid; i < p.k_jac; i += kThreads) {
          p.eps_out[(size_t)b * p.k + i] = seps[i];
          p.vis_out[(size_t)b * p.k + i] = svis[i];
        }
      }
      // ---- the residual pass at the proposal (and at the current pose on
      // a strided proposal subset), e2 formed as the Gauss-Newton pass forms it
      const rgbd::Pose pn = pose_of(st.Rn, st.tn);
      const rgbd::Pose pc = pose_of(st.R, st.t);
      float acc[2] = {0.0f, 0.0f};
      for (int j = tid; j < k_sub; j += kThreads) {
        const float4 q = spts[j * p.stride];
        add_e2(pn, q, I, p.h, p.w, p.fx, p.fy, p.cx, p.cy, &acc[0]);
        if (p.stride > 1) add_e2(pc, q, I, p.h, p.w, p.fx, p.fy, p.cx, p.cy, &acc[1]);
      }
      block_sum(acc, part, sums, tid);
      if (tid == 0) {
        const float e_new = __fsqrt_rn(sums[0]);
        const float e_cur = p.stride == 1 ? st.e : __fsqrt_rn(sums[1]);
        const bool accept = e_new < e_cur;
        const bool worse = e_new > e_cur;
        if (accept) st.lam = fmaxf(__fdiv_rn(st.lam, 3.0f), 1e-8f);
        else if (worse) st.lam = fminf(__fmul_rn(st.lam, 4.0f), 1e6f);
        const bool newly_done = accept && st.psi_norm < p.psi_term;
        p.energy_out[(size_t)b * p.n_iters + itr] = st.e;
        if (accept && !newly_done) {
          copy(st.R, st.Rn, 9);
          copy(st.t, st.tn, 3);
        }
        st.done = newly_done;
      }
      __syncthreads();
    }
    if (st.done) break;
  }

  if (tid == 0) {
    for (int i = itr + 1; i < p.n_iters; ++i) p.energy_out[(size_t)b * p.n_iters + i] = 0.0f;
    if (p.rotationize) rgbd::rotationize_newton(st.bR);
    copy(p.R_out + (size_t)b * 9, st.bR, 9);
    copy(p.t_out + (size_t)b * 3, st.bt, 3);
    p.best_iter_out[b] = st.best_iter;
    p.best_energy_out[b] = st.best_e;
    if (p.track) p.vis_ratio_out[b] = st.best_vis;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}


// R0 (B,3,3), t0 (B,3), pts (B,K,3) float32, valid (B,K) uint8, count (B,)
// int32, scale (B,) float32, all contiguous; img (B,H,W) bf16 with rows
// contiguous and batch stride `img_batch_stride` elements. The Jacobian
// subset is points 0, jstride, 2 jstride, ... (k_jac of them); the proposal
// subset every stride-th of those (standard LM; stride 1 = the same set).
// Outputs contiguous: R_out (B,3,3), t_out (B,3), energy_out (B,n_iters),
// best_iter_out (B,) int32, best_energy_out (B,); with track, eps_out (B,K)
// float32 and vis_out (B,K) uint8 (zero-filled by the caller) and
// vis_ratio_out (B,), else null. Launches on `stream`, does not synchronize.
extern "C" int level_lm_solve(int device, const void* R0, const void* t0, const void* pts,
                              const void* valid, const void* count, const void* img,
                              long long img_batch_stride, const void* scale, int batch, int k,
                              int k_jac, int jstride, int stride, int n_iters, int h, int w,
                              float fx, float fy, float cx, float cy, float inv_sigma2,
                              float lam0, float radius, float psi_term, int deferred,
                              int rotationize, int track, void* R_out, void* t_out,
                              void* energy_out, void* best_iter_out, void* best_energy_out,
                              void* eps_out, void* vis_out, void* vis_ratio_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // k_jac staged points, and with track their residuals and visibility
  const long long smem = (long long)k_jac * 16 + (track ? (long long)k_jac * 5 : 0);
  static rgbd::SharedOptIn opted;
  err = rgbd::opt_in_shared(level_lm, device, smem, &opted);
  if (err != cudaSuccess) return (int)err;
  Params p{(const float*)R0, (const float*)t0, (const float*)pts, (const uint8_t*)valid,
           (const int*)count, (const __nv_bfloat16*)img, img_batch_stride, (const float*)scale,
           k, k_jac, jstride, stride, n_iters, h, w, fx, fy, cx, cy, inv_sigma2, lam0, radius,
           psi_term, deferred, rotationize, track, (float*)R_out, (float*)t_out,
           (float*)energy_out, (int*)best_iter_out, (float*)best_energy_out, (float*)eps_out,
           (uint8_t*)vis_out, (float*)vis_ratio_out};
  level_lm<<<batch, kThreads, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
