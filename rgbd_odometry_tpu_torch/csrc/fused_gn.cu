// One Gauss-Newton iteration's normal-equation terms for a batch of
// frame pairs, for Hopper.
//
// Replaces the Pallas kernel `fused_gn_terms` / `_kernel`
// (rgbd_odometry_tpu/pallas/fused_iter.py:32-192). For pair b at pose
// (R, t) over its K reference edge points it fuses
//
//   X' = R^T (X - t), pinhole projection, inclusive visibility
//   (0 <= u <= W, 0 <= v <= H, point valid)
//   -> bilinear DT sample + exact interpolant gradients (border-clamped,
//      i1 = min(i0+1, n-1)) from the four bf16 corners
//   -> textbook 6-DoF image Jacobian of the right-multiplied update
//   -> robust weight 6 / (6 + eps_px^2 / sigma^2), eps_px = eps / scale[b]
//      (the residual in pixels when the DT is 0-255 normalized; scale 1
//      on a pixel-unit DT)
//   -> J^T W J (6x6), J^T W eps (6), sum eps^2, visible count
//
// so nothing between the point tensor and the 6x6 outputs touches device
// memory (one point's terms: `gn_point` of project.cuh under its production
// semantics, which level_lm.cu shares). Outputs: H (B,6,6), g (B,6), e2 (B,) float32 and n (B,) int32
// (the wrapper takes sqrt(e2) as the energy), and when eps_out is not null
// the per-point eps (B,K) float32 (0 where invisible) and visible (B,K)
// uint8, as residual.cu writes them (a stride-1 scan tracks both at its
// best iterate without a second pass).
//
// Design. The TPU kernel accumulates across sequential grid steps; blocks on
// the card run in parallel in no order, so here one block owns one pair:
// its 256 threads stride over the K points (2 per thread at the main path's
// K = 512), keep 29 running sums in registers (21 of the symmetric H, 6 of
// g, e2, count), and reduce them across the block in a fixed tree order
// (project.cuh). There are no atomics and no carry across blocks, so a
// result is the same bit for bit from run to run. The ragged tail is masked
// (the loop bound), not clamped to a divisor as the TPU wrapper does. The
// e2 partials are formed exactly as residual.cu forms them, so at the same
// pose over the same points the two kernels give the same energy bit for
// bit (the LM accept test compares them; an exact tie must stay a tie).
//
// Numerics differ from the TPU kernel in one documented place: it rounds
// the bilinear row weights to bf16 (fused_iter.py:61) before its one-hot
// MXU row mix; here the corners are widened to float32 and blended with
// float32 weights. The sums run in another order than XLA's einsums.
//
// What bounds it on the H100: per point ~100 float32 operations and four
// scattered 2-byte reads of an L2-resident image; per pair a few KB of
// points. At the main path's B pairs x 512 points a launch is far below
// the card's throughput, so its cost is launch latency plus the block
// reduction; the batch dimension is what fills the 132 SMs.

#include "project.cuh"

namespace {

using rgbd::kThreads;
constexpr int kTerms = rgbd::kGnTerms;

__global__ void __launch_bounds__(kThreads)
fused_gn(const float* __restrict__ R, const float* __restrict__ T,
         const float* __restrict__ pts, const uint8_t* __restrict__ valid,
         const __nv_bfloat16* __restrict__ img, long long img_batch_stride,
         const float* __restrict__ scale, int k, int h, int w, float fx, float fy, float cx,
         float cy, float inv_sigma2, float* __restrict__ h_out, float* __restrict__ g_out,
         float* __restrict__ e2_out, int* __restrict__ n_out, float* __restrict__ eps_out,
         uint8_t* __restrict__ vis_out) {
  __shared__ float red[kTerms][kThreads];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const rgbd::Pose pose = rgbd::load_pose(R, T, b);
  const float* P = pts + (size_t)b * k * 3;
  const uint8_t* V = valid + (size_t)b * k;
  const __nv_bfloat16* I = img + (size_t)b * img_batch_stride;
  const float sc = scale[b];

  float acc[kTerms];
#pragma unroll
  for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;

  for (int i = tid; i < k; i += kThreads) {
    float eps;
    bool vis;
    rgbd::gn_point(pose, P[3 * i], P[3 * i + 1], P[3 * i + 2], V[i] != 0,
                   rgbd::Planes<__nv_bfloat16>{{I, I, I}}, h, w, fx, fy, cx, cy, sc, inv_sigma2,
                   1.0f / inv_sigma2, rgbd::gn_production(), acc, &eps, &vis);
    if (eps_out != nullptr) {
      eps_out[(size_t)b * k + i] = eps;
      vis_out[(size_t)b * k + i] = vis ? 1 : 0;
    }
  }

  rgbd::block_reduce(acc, red, tid);
  if (tid < 36) {
    const int r = tid / 6, c = tid % 6;
    const int lo = min(r, c), hi = max(r, c);
    // index of (lo, hi) in the row-major upper triangle
    const int m = lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
    h_out[(size_t)b * 36 + tid] = red[m][0];
  } else if (tid < 42) {
    g_out[(size_t)b * 6 + (tid - 36)] = red[21 + tid - 36][0];
  } else if (tid == 42) {
    e2_out[b] = red[27][0];
  } else if (tid == 43) {
    n_out[b] = (int)red[28][0];
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// R (B,3,3), t (B,3), pts (B,K,3) float32, valid (B,K) uint8, scale (B,)
// float32, all contiguous; img (B,H,W) bf16 with rows contiguous and batch
// stride `img_batch_stride` elements; inv_sigma2 = 1 / sigma^2 of the
// robust weight; outputs contiguous; eps_out/vis_out (B,K), or both null.
// Launches on `stream`, does not synchronize.
extern "C" int fused_gn_terms(int device, const void* R, const void* t, const void* pts,
                              const void* valid, const void* img, long long img_batch_stride,
                              const void* scale, int batch, int k, int h, int w, float fx,
                              float fy, float cx, float cy, float inv_sigma2, void* h_out,
                              void* g_out, void* e2_out, void* n_out, void* eps_out,
                              void* vis_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  fused_gn<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, (const float*)pts, (const uint8_t*)valid,
      (const __nv_bfloat16*)img, img_batch_stride, (const float*)scale, k, h, w, fx, fy, cx, cy,
      inv_sigma2, (float*)h_out, (float*)g_out, (float*)e2_out, (int*)n_out, (float*)eps_out,
      (uint8_t*)vis_out);
  return (int)cudaGetLastError();
}
