// Batched Gauss-Newton PnP with inlier scoring, for Hopper: B independent
// problems over the same K correspondences (stored keyframe points obj,
// query normalized image points imn), each `iters` iterations on its own
// point mask from its own start pose, then the count of scoring-mask points
// whose reprojection error is below a threshold.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `jax.vmap(gn_pnp)` and the inlier scoring of `ransac_pnp`
// (rgbd_odometry_tpu/solvers/pnp.py:46-97, :142-158). One launch serves both
// RANSAC phases: the hypotheses (B = 64, 4 iterations, 4-point masks) and
// the winner's refine (B = 1, 5 iterations on its inliers).
//
// Per iteration and problem: r = u_norm - dehom(R^T (P - t)), its 2x6
// Jacobian (the reference's J = -A1 A2, SolvePnP.cpp:252-292), the sums
// J^T J (21 entries) and J^T r (6) over the masked points, then one thread
// solves (J^T J + 1e-9 I) delta = -J^T r with the 6x6 Cholesky of se3.cuh
// and right-multiplies T exp(delta).
//
// Design. One block of 128 threads per problem. Thread k sums the terms of
// points k, k + 128, ... in order; the 27 partial sums are then reduced in
// a fixed pairwise tree in shared memory, so a result is the same bit for
// bit from run to run, and every operation is a round-to-nearest intrinsic
// so that the plain version (kernels/pnp_gn.py) reproduces it exactly. The
// pose lives in shared memory between iterations: the whole RANSAC phase is
// one launch instead of ~40 small ops per iteration. What bounds it on the
// H100: nothing in the arithmetic (about 130 float32 operations per point
// per iteration, K = 384); a launch is latency-bound by its serial chain of
// iterations, each a tree reduction plus one thread's 6x6 solve and
// exponential (sin and cos in double), and B = 64 blocks fill half the SMs.

#include <cstdint>

#include <cuda_runtime.h>

#include "se3.cuh"

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
              int* __restrict__ count_out, uint8_t* __restrict__ inl_out) {
  __shared__ float red[kTerms][kThreads];
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
    float acc[kTerms];
    for (int n = 0; n < kTerms; ++n) acc[n] = 0.0f;
    for (int i = tid; i < k; i += kThreads) {
      if (!M[i]) continue;
      const Point p = point_terms(obj + 3 * i, imn + 2 * i, R, t);
      int n = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c, ++n)
          acc[n] = fadd(acc[n], fadd(fmul(p.ju[a], p.ju[c]), fmul(p.jv[a], p.jv[c])));
      for (int a = 0; a < 6; ++a)
        acc[21 + a] = fadd(acc[21 + a], fadd(fmul(p.ju[a], p.r0), fmul(p.jv[a], p.r1)));
    }
    for (int n = 0; n < kTerms; ++n) red[n][tid] = acc[n];
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s)
        for (int n = 0; n < kTerms; ++n) red[n][tid] = fadd(red[n][tid], red[n][tid + s]);
      __syncthreads();
    }
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

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// obj (K,3), imn (K,2), R0 (B,3,3), t0 (B,3) float32; masks (B,K) and
// score_mask (K,) uint8; all contiguous. Outputs R (B,3,3), t (B,3) float32,
// counts (B,) int32 and, when inl_out is not null, inliers (B,K) uint8.
// Launches on `stream`, does not synchronize.
extern "C" int pnp_gn(int device, const void* obj, const void* imn, const void* masks,
                      const void* R0, const void* t0, const void* score_mask, int batch, int k,
                      int iters, float thresh, void* R_out, void* t_out, void* count_out,
                      void* inl_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    pnp_gn_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)obj, (const float*)imn, (const uint8_t*)masks, (const float*)R0,
        (const float*)t0, (const uint8_t*)score_mask, k, iters, thresh, (float*)R_out,
        (float*)t_out, (int*)count_out, (uint8_t*)inl_out);
  }
  return (int)cudaGetLastError();
}
