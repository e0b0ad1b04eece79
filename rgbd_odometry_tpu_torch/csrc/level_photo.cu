// The photometric DVO pyramid of B frame pairs in one launch, for Hopper.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `solve_pyramid`'s level loop (rgbd_odometry_tpu/solvers/photometric.py:
// 226-247) over `solve_level`'s `lax.scan` (:162-223) of Gauss-Newton
// iterations on `photometric_residual` (:147-159) and `_sample_now`
// (:132-144), the reference's `gaussNewtonIterations` (RGBDOdometry.cpp:
// 514-597).
//
// One block of kThreads a pair runs every level in the order given and
// every iteration of each. An iteration: thread v takes the points v,
// v + kThreads, ... in order, moves each by R^T (X - t), projects it,
// tests visibility on the unsnapped (u, v), snaps both coordinates within
// 2e-3 of an integer onto it, samples the now image (floor, or bilinear
// with the rows blended first; coordinates clamped to the image), and adds
// eps^2, J_j w eps (6) and, with reweighting, (J_i w) J_j (21) into its
// running sums; the pairwise tree red[v] += red[v + s], s = 128, ..., 1,
// through shared memory; thread 0 then takes the step: |eps| (recorded in
// the history), the best iterate (|eps| <= best), the freeze at |eps| <
// eps_exit, psi = A^-1 (-J^T W eps) by se3.cuh's Cholesky (A the cached
// normal matrix or, reweighted, the sums plus 1e-6 max(trace, 1) / 6 on the
// diagonal), psi clamped to max_step, T <- T exp(psi)^-1. Each level starts
// from the previous level's best iterate, which is also the output.
//
// Every operation is the plain version's (kernels/level_photo.py), in its
// order, with round-to-nearest intrinsics: a fused multiply-add exactly
// where the plain version takes one (the warp's z, u and v, the bilinear
// blends but that of two columns among the first 8: where XLA:CPU
// contracts them), nothing else contracted; so the
// kernel's pose and history are bitwise the plain version's.
//
// What bounds it on the H100: not the bytes (~45 a point and iteration:
// the point's 3 + 1 + 6 floats, its validity and up to four image reads;
// K = 2048, six iterations is ~0.55 MB, 0.16 us at 3.35 TB/s) but the chain
// of serial steps, each a block-wide tree of eight barriers and a 6x6
// Cholesky with correctly rounded square roots and divisions and a double
// sin and cos on one thread: a latency chain, as level_lm's is.

#include <cstdint>

#include <cuda_runtime.h>

#include "se3.cuh"

namespace {

using rgbd::fadd;
using rgbd::fdiv;
using rgbd::fmul;
using rgbd::fsub;

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
constexpr int kMaxTerms = 28;  // |eps|^2, J^T W eps (6), J^T W J (21 upper entries)

struct Level {
  const float* pts;      // (B, K, 3)
  const float* inten;    // (B, K)
  const float* J;        // (B, K, 6)
  const float* A;        // (B, 6, 6)
  const uint8_t* valid;  // (B, K)
  const float* img;      // (B, H, W), rows contiguous, `stride` floats between images
  long long stride;
  int k, h, w;
  float fx, fy, cx, cy;
};

struct Levels {
  Level lv[kMaxLevels];
  int n;
};

struct Config {
  int iters;
  float eps_exit;
  int huber;
  float delta;
  float max_step;
  int reweight;
  int bilinear;
};

__device__ __forceinline__ float ffma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

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
  if (!bilinear) return img[(size_t)i0 * w + j0];
  const int j1 = min(j0 + 1, w - 1), i1 = min(i0 + 1, h - 1);
  const float fu = fsub(cu, fu0), fv = fsub(cv, fv0);
  const float gv = fsub(1.0f, fv);
  const float row0 = ffma(fv, img[(size_t)i1 * w + j0], fmul(gv, img[(size_t)i0 * w + j0]));
  const float row1 = ffma(fv, img[(size_t)i1 * w + j1], fmul(gv, img[(size_t)i0 * w + j1]));
  // XLA:CPU sums the first 8 column products as a vector, the rest as a
  // fused chain onto that sum
  const float head = fmul(fsub(1.0f, fu), row0);
  return j1 < 8 ? fadd(head, fmul(fu, row1)) : ffma(fu, row1, head);
}

__global__ void __launch_bounds__(kThreads)
level_photo_kernel(Levels L, Config cfg, const float* __restrict__ R0,
                   const float* __restrict__ t0, float* __restrict__ R_out,
                   float* __restrict__ t_out, float* __restrict__ hist) {
  __shared__ float red[kMaxTerms][kThreads];
  __shared__ float pose[12];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nterms = cfg.reweight ? kMaxTerms : 7;
  if (tid < 9) pose[tid] = R0[(size_t)b * 9 + tid];
  if (tid < 3) pose[9 + tid] = t0[(size_t)b * 3 + tid];
  // thread 0's step state
  float best[12];
  float best_e = 1e30f;
  bool done = false;
  __syncthreads();

  for (int l = 0; l < L.n; ++l) {
    const Level& lv = L.lv[l];
    const int k = lv.k;
    const float* P = lv.pts + (size_t)b * k * 3;
    const float* I = lv.inten + (size_t)b * k;
    const float* Jp = lv.J + (size_t)b * k * 6;
    const uint8_t* V = lv.valid + (size_t)b * k;
    const float* img = lv.img + (size_t)b * lv.stride;
    const float wf = (float)lv.w, hf = (float)lv.h;
    if (tid == 0) {
      for (int i = 0; i < 12; ++i) best[i] = pose[i];
      best_e = 1e30f;
      done = false;
    }
    for (int it = 0; it < cfg.iters; ++it) {
      float R[9], t[3];
      for (int i = 0; i < 9; ++i) R[i] = pose[i];
      for (int i = 0; i < 3; ++i) t[i] = pose[9 + i];
      float acc[kMaxTerms];
#pragma unroll
      for (int n = 0; n < kMaxTerms; ++n) acc[n] = 0.0f;
      for (int i = tid; i < k; i += kThreads) {
        const float d0 = fsub(P[3 * i + 0], t[0]);
        const float d1 = fsub(P[3 * i + 1], t[1]);
        const float d2 = fsub(P[3 * i + 2], t[2]);
        const float x0 = fadd(fadd(fmul(d0, R[0]), fmul(d1, R[3])), fmul(d2, R[6]));
        const float x1 = fadd(fadd(fmul(d0, R[1]), fmul(d1, R[4])), fmul(d2, R[7]));
        const float z = ffma(R[8], d2, ffma(R[5], d1, fmul(R[2], d0)));
        const float zs = fabsf(z) < 1e-12f ? 1e-12f : z;
        const float zinv = __frcp_rn(zs);
        const float u = ffma(fmul(lv.fx, x0), zinv, lv.cx);
        const float v = ffma(fmul(lv.fy, x1), zinv, lv.cy);
        const bool vis = u >= 0.0f && u < wf && v >= 0.0f && v < hf && V[i] != 0;
        const float inow = sample(img, lv.h, lv.w, snap(u), snap(v), cfg.bilinear != 0);
        const float eps = vis ? fsub(I[i], inow) : 0.0f;
        float wgt;
        if (cfg.huber) {
          const float a = fabsf(eps);
          wgt = a <= cfg.delta ? 1.0f : fdiv(cfg.delta, fmaxf(a, 1e-9f));
          wgt = vis ? wgt : 0.0f;
        } else {
          wgt = vis ? 1.0f : 0.0f;
        }
        const float we = fmul(wgt, eps);
        float Jr[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) Jr[j] = Jp[6 * i + j];
        acc[0] = fadd(acc[0], fmul(eps, eps));
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[1 + j] = fadd(acc[1 + j], fmul(Jr[j], we));
        if (cfg.reweight) {
          float jw[6];
#pragma unroll
          for (int j = 0; j < 6; ++j) jw[j] = fmul(Jr[j], wgt);
          int n = 7;
#pragma unroll
          for (int a = 0; a < 6; ++a)
#pragma unroll
            for (int c = a; c < 6; ++c, ++n) acc[n] = fadd(acc[n], fmul(jw[a], Jr[c]));
        }
      }
#pragma unroll
      for (int n = 0; n < kMaxTerms; ++n)
        if (n < nterms) red[n][tid] = acc[n];
      __syncthreads();
      for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (tid < s)
          for (int n = 0; n < nterms; ++n) red[n][tid] = fadd(red[n][tid], red[n][tid + s]);
        __syncthreads();
      }
      if (tid == 0) {
        const float enorm = __fsqrt_rn(red[0][0]);
        hist[((size_t)b * L.n + l) * cfg.iters + it] = enorm;
        if (enorm <= best_e) {
          best_e = enorm;
          for (int i = 0; i < 9; ++i) best[i] = R[i];
          for (int i = 0; i < 3; ++i) best[9 + i] = t[i];
        }
        const bool newly = enorm < cfg.eps_exit;
        float H[36], g[6], psi[6];
        for (int j = 0; j < 6; ++j) g[j] = -red[1 + j][0];
        if (cfg.reweight) {
          int n = 7;
          for (int a = 0; a < 6; ++a)
            for (int c = a; c < 6; ++c, ++n) H[a * 6 + c] = H[c * 6 + a] = red[n][0];
          float tr = H[0];
          for (int i = 1; i < 6; ++i) tr = fadd(tr, H[i * 7]);
          const float dmp = fdiv(fmul(1e-6f, fmaxf(tr, 1.0f)), 6.0f);
          for (int i = 0; i < 6; ++i) H[i * 7] = fadd(H[i * 7], dmp);
        } else {
          const float* A = lv.A + (size_t)b * 36;
          for (int i = 0; i < 36; ++i) H[i] = A[i];
        }
        rgbd::chol_solve6(H, g, psi);
        rgbd::trust_region(psi, cfg.max_step);
        float xR[9], xt[3];
        rgbd::se3_exp(psi, xR, xt);
        if (!done && !newly) {
          float xti[3];
          for (int i = 0; i < 3; ++i)
            xti[i] = -fadd(fadd(fmul(xR[0 * 3 + i], xt[0]), fmul(xR[1 * 3 + i], xt[1])),
                           fmul(xR[2 * 3 + i], xt[2]));
          for (int i = 0; i < 3; ++i)
            pose[9 + i] = fadd(t[i], fadd(fadd(fmul(R[i * 3 + 0], xti[0]),
                                               fmul(R[i * 3 + 1], xti[1])),
                                          fmul(R[i * 3 + 2], xti[2])));
          for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
              pose[i * 3 + j] = fadd(fadd(fmul(R[i * 3 + 0], xR[j * 3 + 0]),
                                          fmul(R[i * 3 + 1], xR[j * 3 + 1])),
                                     fmul(R[i * 3 + 2], xR[j * 3 + 2]));
        }
        done = done || newly;
      }
      __syncthreads();
    }
    if (tid == 0)
      for (int i = 0; i < 12; ++i) pose[i] = best[i];
    __syncthreads();
  }
  if (tid < 9) R_out[(size_t)b * 9 + tid] = pose[tid];
  if (tid < 3) t_out[(size_t)b * 3 + tid] = pose[9 + tid];
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// `levels` levels of `batch` pairs. ptrs: per level pts, intensity, J, A,
// valid, img (six device pointers); strides: the image batch stride a
// level (floats); ints: per level K, H, W; flts: per level fx, fy, cx, cy.
// R0 (B,3,3), t0 (B,3) float32. Outputs R (B,3,3), t (B,3), hist (B,
// levels, iters) float32. One launch on `stream`, does not synchronize.
extern "C" int level_photo(int device, int levels, int batch, const void* R0, const void* t0,
                           const long long* ptrs, const long long* strides, const int* ints,
                           const float* flts, int iters, float eps_exit, int huber, float delta,
                           float max_step, int reweight, int bilinear, void* R_out, void* t_out,
                           void* hist, void* stream) {
  if (levels < 0 || levels > kMaxLevels || batch < 1 || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Levels L = {};
  L.n = levels;
  for (int l = 0; l < levels; ++l) {
    Level& lv = L.lv[l];
    lv.pts = (const float*)ptrs[6 * l + 0];
    lv.inten = (const float*)ptrs[6 * l + 1];
    lv.J = (const float*)ptrs[6 * l + 2];
    lv.A = (const float*)ptrs[6 * l + 3];
    lv.valid = (const uint8_t*)ptrs[6 * l + 4];
    lv.img = (const float*)ptrs[6 * l + 5];
    lv.stride = strides[l];
    lv.k = ints[3 * l + 0];
    lv.h = ints[3 * l + 1];
    lv.w = ints[3 * l + 2];
    lv.fx = flts[4 * l + 0];
    lv.fy = flts[4 * l + 1];
    lv.cx = flts[4 * l + 2];
    lv.cy = flts[4 * l + 3];
  }
  const Config cfg = {iters, eps_exit, huber, delta, max_step, reweight, bilinear};
  level_photo_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      L, cfg, (const float*)R0, (const float*)t0, (float*)R_out, (float*)t_out, (float*)hist);
  return (int)cudaGetLastError();
}
