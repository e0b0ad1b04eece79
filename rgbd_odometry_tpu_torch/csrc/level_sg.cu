// A whole sub-gradient pyramid level of the edge-DVO solver in one launch,
// for Hopper: the n_iters iterations of one level for B frame pairs.
//
// Replaces the per-iteration route of sg_terms.cu + some 230 small PyTorch
// ops around it, i.e. in the JAX package the sub-gradient branch of the
// `lax.scan` level loop (rgbd_odometry_tpu/solvers/edge_dvo.py:493-622, scan
// at :586) with `_subgradient_step` (:775-794) and `geo.se3_log`
// (rgbd_odometry_tpu/core/geometry.py:169): XLA code, no Pallas kernel. Per
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
//
// Design. One block owns one pair for the whole level (512 threads, or 1024
// above 4096 points: 8 points a thread at K = 8192; chosen by the wrapper). The level's
// points are staged once into shared memory as float4 {x, y, z, valid} with
// cp.async (128 KB at K = 8192, inside the 227 KB opt-in), overlapped with
// thread 0 loading the start pose, so the 50 passes read no point from
// device memory. The float32 DT (307 KB at 240x320) stays in L2 and is read
// through the read-only path. The 8 running sums are reduced in a fixed
// order: a warp-shuffle tree, then the warp partials summed in order by one
// lane per sum. No atomics: a result is the same bit for bit from run to
// run. Thread 0 then takes the decisions and the step (se3_log, se3_exp,
// compose and Newton-Schulz from se3.cuh) and broadcasts the next pose
// through shared memory; a done pair's block leaves the loop.
//
// The best iterate's per-point values. Whether an iterate is the best is
// known only after its reduction, but a point's residual and visibility are
// a function of the pose alone, computed by once-rounded operations in a
// fixed order. So no pass stores them: after the loop one more pass at the
// best pose (as it was evaluated, before the final re-orthogonalization)
// reproduces them bit for bit and writes them once. Against buffering every
// pass's values in shared memory and flushing them on each improvement
// (most iterations of a descent improve), this costs one pass in n_iters + 1,
// stores 5 bytes a point once instead of up to n_iters times, and leaves
// the shared memory to the points (K up to 14000).
//
// What bounds it on the H100: per iteration a pair does ~60 float32
// operations and five 4-byte L2 reads per visible point and one thread's
// serial step (two double-precision arccos/sin/cos groups, a 3x3 product
// chain); a level moves under 10 MB and does ~1.5 GFLOP at B = 64. It is
// bound by latency and by the issue rate of its one SM per pair, not by
// bytes or operations. Splitting a pair over a thread-block cluster is the
// next step.

#include "launch.cuh"
#include "project.cuh"
#include "se3.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr int kTerms = rgbd::kSgTerms;
constexpr int kTrace = 18;  // a trace row: the pose entering an iteration (R 9, t 3) and its g (6)

struct Params {
  const float* R0;
  const float* t0;
  const float* pts;
  const uint8_t* valid;
  const int* count;
  const float* dt;
  long long dt_batch_stride;
  int k, n_iters, h, w;
  float fx, fy, cx, cy, inv_sigma2;
  float l2_lambda, one_minus_momentum, momentum, step_length, precond_rot, radius, psi_term;
  int l2, rotationize;
  float* R_out;
  float* t_out;
  float* energy_out;
  int* best_iter_out;
  float* best_energy_out;
  float* eps_out;
  uint8_t* vis_out;
  float* vis_ratio_out;
  float* trace_out;
};

// Per-pair solver state, written by thread 0 only.
struct State {
  float R[9], t[3];    // the pose the next pass evaluates
  float bR[9], bt[3];  // the best iterate
  float descent[6];
  float best_e, best_vis;
  int best_iter, done;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ rgbd::Pose pose_of(const float* R, const float* t) {
  return rgbd::Pose{R[0], R[1], R[2], R[3], R[4], R[5], R[6], R[7], R[8], t[0], t[1], t[2]};
}

__device__ __forceinline__ void copy(float* dst, const float* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}

// The damped, projected sub-gradient step of iteration itr at pose (R, t):
// g (J^T W eps, overwritten) and the momentum buffer `descent` (updated) ->
// psi; returns |psi|.
__device__ inline float subgradient_step(const Params& p, const float* R, const float* t,
                                         float g[6], float descent[6], int itr, float psi[6]) {
  using namespace rgbd;
  if (p.l2) {
    float cpsi[6];
    se3_log(R, t, cpsi);
    const float n = norm6(cpsi);
    if (n > 0.0f) {
      const float d = fmaxf(n, 1e-30f);
      for (int i = 0; i < 6; ++i) cpsi[i] = fdiv(cpsi[i], d);
    }
    for (int i = 0; i < 6; ++i) g[i] = fadd(g[i], fmul(p.l2_lambda, cpsi[i]));
  }
  const float step = fdiv(p.step_length, (float)(itr > 5 ? itr - 4 : 1));
  for (int i = 0; i < 6; ++i) {
    descent[i] = fadd(fmul(p.one_minus_momentum, g[i]), fmul(p.momentum, descent[i]));
    psi[i] = fmul(fmul(-step, i < 3 ? 1.0f : p.precond_rot), descent[i]);
  }
  trust_region(psi, p.radius);
  return norm6(psi);
}

__global__ void __launch_bounds__(1024) level_sg(const Params p) {
  extern __shared__ float4 spts[];
  __shared__ float part[kMaxWarps][kTerms];
  __shared__ float sums[kTerms];
  __shared__ State st;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const float* D = p.dt + (size_t)b * p.dt_batch_stride;

  // stage the points: x, y, z by cp.async, the valid flag into w
  const float* P = p.pts + (size_t)b * p.k * 3;
  const uint8_t* V = p.valid + (size_t)b * p.k;
  for (int i = tid; i < p.k; i += nthreads) {
    float* dst = reinterpret_cast<float*>(&spts[i]);
    cp_async4(dst, P + 3 * (size_t)i);
    cp_async4(dst + 1, P + 3 * (size_t)i + 1);
    cp_async4(dst + 2, P + 3 * (size_t)i + 2);
    dst[3] = V[i] ? 1.0f : 0.0f;
  }
  if (tid == 0) {
    copy(st.R, p.R0 + (size_t)b * 9, 9);
    copy(st.t, p.t0 + (size_t)b * 3, 3);
    for (int i = 0; i < 9; ++i) st.bR[i] = (i % 4 == 0) ? 1.0f : 0.0f;
    for (int i = 0; i < 3; ++i) st.bt[i] = 0.0f;
    for (int i = 0; i < 6; ++i) st.descent[i] = 0.0f;
    st.best_e = 1.0e10f;
    st.best_vis = 1.0f;
    st.best_iter = -1;
    st.done = 0;
  }
  cp_async_wait_all();
  __syncthreads();

  int itr = 0;
  for (; itr < p.n_iters; ++itr) {
    // ---- the pass over every point at the current pose
    {
      const rgbd::Pose pose = pose_of(st.R, st.t);
      float acc[kTerms];
#pragma unroll
      for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
#pragma unroll 4
      for (int i = tid; i < p.k; i += nthreads) {
        const float4 q = spts[i];
        float eps;
        bool vis;
        rgbd::sg_point(pose, q.x, q.y, q.z, q.w != 0.0f, D, p.h, p.w, p.fx, p.fy, p.cx, p.cy,
                       p.inv_sigma2, acc, &eps, &vis);
      }
      // the fixed-order sum: a shuffle tree in each warp, then lane m of
      // warp 0 adds the warp partials of sum m in order
#pragma unroll
      for (int m = 0; m < kTerms; ++m) {
        float v = acc[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) part[warp][m] = v;
      }
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < kTerms) {
        float s = part[0][lane];
        for (int q = 1; q < nwarps; ++q) s += part[q][lane];
        sums[lane] = s;
      }
      __syncwarp();
      if (lane == 0) {
        float g[6], psi[6];
        copy(g, sums, 6);
        if (p.trace_out != nullptr) {
          float* tr = p.trace_out + ((size_t)b * p.n_iters + itr) * kTrace;
          copy(tr, st.R, 9);
          copy(tr + 9, st.t, 3);
          copy(tr + 12, g, 6);
        }
        const float e = __fsqrt_rn(sums[6]);
        p.energy_out[(size_t)b * p.n_iters + itr] = e;
        if (e <= st.best_e) {
          st.best_e = e;
          copy(st.bR, st.R, 9);
          copy(st.bt, st.t, 3);
          st.best_iter = itr;
          st.best_vis = __fdiv_rn(sums[7], (float)max(p.count[b], 1));
        }
        const float psi_norm = subgradient_step(p, st.R, st.t, g, st.descent, itr, psi);
        if (psi_norm < p.psi_term) {
          st.done = 1;
        } else {
          float xR[9], xt[3], Rn[9], tn[3];
          rgbd::se3_exp(psi, xR, xt);
          rgbd::compose(st.R, st.t, xR, xt, Rn, tn);
          if (p.rotationize) rgbd::rotationize_newton(Rn);
          copy(st.R, Rn, 9);
          copy(st.t, tn, 3);
        }
      }
    }
    __syncthreads();
    if (st.done) break;
  }

  // ---- the best iterate's per-point values: one more pass at its pose
  {
    const bool any = st.best_iter >= 0;
    const rgbd::Pose pose = pose_of(st.bR, st.bt);
    float acc[kTerms];
#pragma unroll
    for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
    for (int i = tid; i < p.k; i += nthreads) {
      const float4 q = spts[i];
      float eps;
      bool vis;
      rgbd::sg_point(pose, q.x, q.y, q.z, any && q.w != 0.0f, D, p.h, p.w, p.fx, p.fy, p.cx,
                     p.cy, p.inv_sigma2, acc, &eps, &vis);
      p.eps_out[(size_t)b * p.k + i] = eps;
      p.vis_out[(size_t)b * p.k + i] = vis ? 1 : 0;
    }
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = itr + 1; i < p.n_iters; ++i) p.energy_out[(size_t)b * p.n_iters + i] = 0.0f;
    if (p.rotationize) rgbd::rotationize_newton(st.bR);
    copy(p.R_out + (size_t)b * 9, st.bR, 9);
    copy(p.t_out + (size_t)b * 3, st.bt, 3);
    p.best_iter_out[b] = st.best_iter;
    p.best_energy_out[b] = st.best_e;
    p.vis_ratio_out[b] = st.best_vis;
  }
}

// The device function se3_log on n poses, one thread each: psi_out (n, 6).
__global__ void se3_log_kernel(const float* __restrict__ R, const float* __restrict__ t, int n,
                               float* __restrict__ psi_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float Ri[9], ti[3], psi[6];
  copy(Ri, R + (size_t)i * 9, 9);
  copy(ti, t + (size_t)i * 3, 3);
  rgbd::se3_log(Ri, ti, psi);
  copy(psi_out + (size_t)i * 6, psi, 6);
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// R0 (B,3,3), t0 (B,3), pts (B,K,3) float32, valid (B,K) uint8, count (B,)
// int32, all contiguous; dt (B,H,W) float32 with rows contiguous and batch
// stride `dt_batch_stride` elements. `threads` is the block size, a multiple
// of 32 up to 1024. Outputs contiguous: R_out (B,3,3), t_out (B,3),
// energy_out (B,n_iters), best_iter_out (B,) int32, best_energy_out (B,),
// eps_out (B,K) float32, vis_out (B,K) uint8, vis_ratio_out (B,); trace_out
// (B,n_iters,18) or null: per iteration run, the pose entering it (R, t) and
// its J^T W eps (rows after a pair is done are left as they were). Launches
// on `stream`, does not synchronize.
extern "C" int level_sg_solve(int device, const void* R0, const void* t0, const void* pts,
                              const void* valid, const void* count, const void* dt,
                              long long dt_batch_stride, int batch, int k, int n_iters, int h,
                              int w, int threads, float fx, float fy, float cx, float cy,
                              float inv_sigma2, float l2_lambda, float one_minus_momentum,
                              float momentum, float step_length, float precond_rot, float radius,
                              float psi_term, int l2, int rotationize, void* R_out, void* t_out,
                              void* energy_out, void* best_iter_out, void* best_energy_out,
                              void* eps_out, void* vis_out, void* vis_ratio_out, void* trace_out,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static rgbd::SharedOptIn opted;
  const long long smem = (long long)k * 16;  // the staged points
  err = rgbd::opt_in_shared(level_sg, device, smem, &opted);
  if (err != cudaSuccess) return (int)err;
  Params p{(const float*)R0, (const float*)t0, (const float*)pts, (const uint8_t*)valid,
           (const int*)count, (const float*)dt, dt_batch_stride, k, n_iters, h, w, fx, fy, cx,
           cy, inv_sigma2, l2_lambda, one_minus_momentum, momentum, step_length, precond_rot,
           radius, psi_term, l2, rotationize, (float*)R_out, (float*)t_out, (float*)energy_out,
           (int*)best_iter_out, (float*)best_energy_out, (float*)eps_out, (uint8_t*)vis_out,
           (float*)vis_ratio_out, (float*)trace_out};
  level_sg<<<batch, threads, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// R (n,3,3), t (n,3) float32 contiguous -> psi_out (n,6): rgbd::se3_log of
// every pose. Launches on `stream`, does not synchronize.
extern "C" int se3_log_batch(int device, const void* R, const void* t, int n, void* psi_out,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  se3_log_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, n, (float*)psi_out);
  return (int)cudaGetLastError();
}
