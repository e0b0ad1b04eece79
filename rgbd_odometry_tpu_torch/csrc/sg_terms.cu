// One iteration of the reference's sub-gradient level solve for a batch of
// frame pairs, for Hopper: g = J^T W eps (6), the energy and the visible
// count, plus the per-point residual and visibility.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `_jacobian_residual` in reference mode (rgbd_odometry_tpu/solvers/
// edge_dvo.py:293-398 with the floor gathers of
// ops/matmul_gather.gather_floor_value_cgrads_mm) and the sum of
// `_subgradient_step` (:780). For pair b at pose (R, t) over its K points:
//
//   X' = R^T (X - t), pinhole projection (u = fx xn + cx and v as one fused
//   multiply-add each, as XLA computes them), inclusive visibility
//   -> the float32 DT at the integer pixel and its central-difference
//      gradients there (REFLECT_101)
//   -> weight 6 / (6 + eps^2 / sigma^2) (getWeightOf; eps in DT units)
//   -> the "reference" Jacobian with the dehomogenized-coordinate quirk:
//      GA = [g0 fx, g1 fy, -(g0 fx xn + g1 fy yn)],
//      J = [-R GA | GA x R^T (xn, yn, 1)]
//   -> g = sum J (w eps), sum eps^2, count
//
// (one point's share of this is sg_point of project.cuh under its production
// semantics, which level_sg.cu,
// the whole-level kernel that took this one's place in the solver, runs too).
// Outputs: g (B,6), e2 (B,) float32 (the wrapper takes sqrt), n (B,) int32,
// eps (B,K) float32 and visible (B,K) uint8, written on every call.
//
// Design. One block of 256 threads per pair strides over the points (32
// per thread at the parity profile's K = 8192), keeps 8 running sums in
// registers and reduces them in the fixed tree of project.cuh: no atomics,
// the same bits from run to run. Per-point values are bitwise those of the
// plain version (kernels/sg_terms.py); only the order of the sums differs.
// What bounds it on the H100: per point ~60 float32 operations, a 12-byte
// point read, five scattered 4-byte DT reads and 5 bytes written; one pair
// is ~100 KB of traffic, so at batch 1 the launch is latency-bound.

#include "project.cuh"

namespace {

using rgbd::kThreads;
constexpr int kTerms = rgbd::kSgTerms;  // g (6), e2, count

__global__ void __launch_bounds__(kThreads)
sg_terms(const float* __restrict__ R, const float* __restrict__ T,
         const float* __restrict__ pts, const uint8_t* __restrict__ valid,
         const float* __restrict__ dt, long long dt_batch_stride, int k, int h, int w, float fx,
         float fy, float cx, float cy, float inv_sigma2, float* __restrict__ g_out,
         float* __restrict__ e2_out, int* __restrict__ n_out, float* __restrict__ eps_out,
         uint8_t* __restrict__ vis_out) {
  __shared__ float red[kTerms][kThreads];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const rgbd::Pose q = rgbd::load_pose(R, T, b);
  const float* P = pts + (size_t)b * k * 3;
  const uint8_t* V = valid + (size_t)b * k;
  const float* D = dt + (size_t)b * dt_batch_stride;

  float acc[kTerms];
#pragma unroll
  for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;

  for (int i = tid; i < k; i += kThreads) {
    float eps;
    bool vis;
    rgbd::sg_point(q, P[3 * i], P[3 * i + 1], P[3 * i + 2], V[i] != 0, D, h, w, fx, fy, cx, cy,
                   inv_sigma2, 1.0f / inv_sigma2, rgbd::sg_production(), acc, &eps, &vis);
    eps_out[(size_t)b * k + i] = eps;
    vis_out[(size_t)b * k + i] = vis ? 1 : 0;
  }

  rgbd::block_reduce(acc, red, tid);
  if (tid < 6) {
    g_out[(size_t)b * 6 + tid] = red[tid][0];
  } else if (tid == 6) {
    e2_out[b] = red[6][0];
  } else if (tid == 7) {
    n_out[b] = (int)red[7][0];
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// R (B,3,3), t (B,3), pts (B,K,3) float32, valid (B,K) uint8 contiguous;
// dt (B,H,W) float32 with rows contiguous and batch stride
// `dt_batch_stride` elements; inv_sigma2 = 1 / sigma^2 of the robust
// weight; outputs contiguous. Launches on `stream`, does not synchronize.
extern "C" int subgradient_terms(int device, const void* R, const void* t, const void* pts,
                                 const void* valid, const void* dt, long long dt_batch_stride,
                                 int batch, int k, int h, int w, float fx, float fy, float cx,
                                 float cy, float inv_sigma2, void* g_out, void* e2_out,
                                 void* n_out, void* eps_out, void* vis_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sg_terms<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, (const float*)pts, (const uint8_t*)valid,
      (const float*)dt, dt_batch_stride, k, h, w, fx, fy, cx, cy, inv_sigma2, (float*)g_out,
      (float*)e2_out, (int*)n_out, (float*)eps_out, (uint8_t*)vis_out);
  return (int)cudaGetLastError();
}
