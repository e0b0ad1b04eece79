// The residual pass of the edge-DVO solver for a batch of frame pairs, for
// Hopper: warp + project K reference edge points at pose (R, t), sample the
// DT there, and reduce to the energy and the visible count; on request also
// write the per-point residual and visibility.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `_project_and_sample` (rgbd_odometry_tpu/solvers/edge_dvo.py:261-275)
// with `_sample_dt` (:241-258). Two sample modes:
//
//   bilinear  the bf16 DT channel, border-clamped bilinear (Gauss-Newton;
//             the LM accept pass of every iteration, edge_dvo.py:526-533,
//             and the all-point diagnostics at a level's best pose, :593-609);
//   floor     the float32 DT at the integer pixel (the reference's
//             sub-gradient semantics, :252), with u and v each one fused
//             multiply-add, as sg_terms.cu projects.
//
// Outputs: e2 (B,) float32 (the wrapper takes sqrt), n (B,) int32, and when
// eps_out is not null eps (B,K) float32 (0 where invisible) and visible
// (B,K) uint8.
//
// Design. One block of 256 threads per pair strides over the points; the
// two sums are reduced in the fixed tree of project.cuh, so a result is the
// same bit for bit from run to run. The e2 partials are formed exactly as
// fused_gn.cu forms them (same thread-to-point map, same fused
// multiply-add, same tree), so at one pose over one point set the two
// kernels' energies are bitwise equal and the LM accept test sees exact
// ties as ties. What bounds it on the H100: per point ~25 float32
// operations, a 12-byte point read and one or four scattered reads of an
// L2-resident image; at the main path's B x 512..8192 points a launch is
// latency-bound, and the batch dimension fills the SMs.

#include "project.cuh"

namespace {

using rgbd::kThreads;

template <bool kBilinear>
__global__ void __launch_bounds__(kThreads)
residual(const float* __restrict__ R, const float* __restrict__ T,
         const float* __restrict__ pts, const uint8_t* __restrict__ valid,
         const void* __restrict__ img, long long img_batch_stride, int k, int h, int w,
         float fx, float fy, float cx, float cy, float* __restrict__ e2_out,
         int* __restrict__ n_out, float* __restrict__ eps_out, uint8_t* __restrict__ vis_out) {
  __shared__ float red[2][kThreads];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const rgbd::Pose pose = rgbd::load_pose(R, T, b);
  const float* P = pts + (size_t)b * k * 3;
  const uint8_t* V = valid + (size_t)b * k;

  float acc[2] = {0.0f, 0.0f};  // e2, count
  for (int i = tid; i < k; i += kThreads) {
    float eps = 0.0f;
    bool vis = false;
    if (V[i]) {
      const rgbd::Projected p = rgbd::project<!kBilinear>(pose, P + 3 * i, fx, fy, cx, cy);
      vis = rgbd::in_image(p.u, p.v, h, w);
      if (vis) {
        if (kBilinear) {
          float gu, gv;
          rgbd::sample_bilinear((const __nv_bfloat16*)img + (size_t)b * img_batch_stride, h, w,
                                p.u, p.v, &eps, &gu, &gv);
        } else {
          eps = rgbd::sample_floor((const float*)img + (size_t)b * img_batch_stride, h, w, p.u,
                                   p.v);
        }
        acc[0] = __fmaf_rn(eps, eps, acc[0]);
        acc[1] += 1.0f;
      }
    }
    if (eps_out != nullptr) {
      eps_out[(size_t)b * k + i] = eps;
      vis_out[(size_t)b * k + i] = vis ? 1 : 0;
    }
  }

  rgbd::block_reduce(acc, red, tid);
  if (tid == 0) {
    e2_out[b] = red[0][0];
    n_out[b] = (int)red[1][0];
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// R (B,3,3), t (B,3), pts (B,K,3) float32, valid (B,K) uint8 contiguous;
// img (B,H,W) with rows contiguous and batch stride `img_batch_stride`
// elements: bf16 when bilinear != 0, float32 otherwise. eps_out/vis_out
// (B,K) contiguous, or both null. Launches on `stream`, does not
// synchronize.
extern "C" int residual_pass(int device, const void* R, const void* t, const void* pts,
                             const void* valid, const void* img, long long img_batch_stride,
                             int bilinear, int batch, int k, int h, int w, float fx, float fy,
                             float cx, float cy, void* e2_out, void* n_out, void* eps_out,
                             void* vis_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = bilinear ? residual<true> : residual<false>;
  kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, (const float*)pts, (const uint8_t*)valid, img,
      img_batch_stride, k, h, w, fx, fy, cx, cy, (float*)e2_out, (int*)n_out, (float*)eps_out,
      (uint8_t*)vis_out);
  return (int)cudaGetLastError();
}
