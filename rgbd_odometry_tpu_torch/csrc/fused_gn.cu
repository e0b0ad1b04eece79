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
//   -> robust weight 6 / (6 + eps^2 / sigma^2)
//   -> J^T W J (6x6), J^T W eps (6), sum eps^2, visible count
//
// so nothing between the point tensor and the 6x6 outputs touches device
// memory. Outputs: H (B,6,6), g (B,6), e2 (B,) float32 and n (B,) int32;
// the wrapper takes sqrt(e2) as the energy.
//
// Design. The TPU kernel accumulates across sequential grid steps; blocks on
// the card run in parallel in no order, so here one block owns one pair:
// its 256 threads stride over the K points (2 per thread at the main path's
// K = 512), keep 29 running sums in registers (21 of the symmetric H, 6 of
// g, e2, count), and reduce them across the block in a fixed tree order.
// There are no atomics and no carry across blocks, so a result is the same
// bit for bit from run to run. The ragged tail is masked (the loop bound),
// not clamped to a divisor as the TPU wrapper does.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTerms = 29;  // 21 (upper triangle of H) + 6 (g) + e2 + count

__global__ void __launch_bounds__(kThreads)
fused_gn(const float* __restrict__ R, const float* __restrict__ T,
         const float* __restrict__ pts, const uint8_t* __restrict__ valid,
         const __nv_bfloat16* __restrict__ img, long long img_batch_stride,
         int k, int h, int w, float fx, float fy, float cx, float cy, float inv_sigma2,
         float* __restrict__ h_out, float* __restrict__ g_out,
         float* __restrict__ e2_out, int* __restrict__ n_out) {
  __shared__ float red[kTerms][kThreads];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Rb = R + (size_t)b * 9;
  const float r00 = Rb[0], r01 = Rb[1], r02 = Rb[2];
  const float r10 = Rb[3], r11 = Rb[4], r12 = Rb[5];
  const float r20 = Rb[6], r21 = Rb[7], r22 = Rb[8];
  const float t0 = T[b * 3 + 0], t1 = T[b * 3 + 1], t2 = T[b * 3 + 2];
  const float* P = pts + (size_t)b * k * 3;
  const uint8_t* V = valid + (size_t)b * k;
  const __nv_bfloat16* I = img + (size_t)b * img_batch_stride;

  float acc[kTerms];
#pragma unroll
  for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;

  for (int i = tid; i < k; i += kThreads) {
    if (!V[i]) continue;
    // Every per-point value below is computed with exactly the single,
    // once-rounded operations of the plain PyTorch version
    // (kernels/fused_iter.py: project_points, jacobian_terms; ops/interp.py),
    // in the same order, through round-to-nearest intrinsics that nvcc
    // cannot contract into FMAs: the per-point J, eps and weight are then
    // bitwise equal to the plain version's and only the summation order of
    // the block reduction differs. (A one-ulp difference in u or v could
    // move a point across a pixel boundary, where the gradient jumps.)
    const float d0 = __fsub_rn(P[3 * i + 0], t0);
    const float d1 = __fsub_rn(P[3 * i + 1], t1);
    const float d2 = __fsub_rn(P[3 * i + 2], t2);
    // X' = R^T (X - t)
    const float x0 = __fadd_rn(__fadd_rn(__fmul_rn(d0, r00), __fmul_rn(d1, r10)), __fmul_rn(d2, r20));
    const float x1 = __fadd_rn(__fadd_rn(__fmul_rn(d0, r01), __fmul_rn(d1, r11)), __fmul_rn(d2, r21));
    const float z = __fadd_rn(__fadd_rn(__fmul_rn(d0, r02), __fmul_rn(d1, r12)), __fmul_rn(d2, r22));
    const float zs = fabsf(z) < 1e-12f ? 1e-12f : z;
    const float inv = __frcp_rn(zs);
    const float xn = __fmul_rn(x0, inv);
    const float yn = __fmul_rn(x1, inv);
    const float u = __fadd_rn(__fmul_rn(fx, xn), cx);
    const float v = __fadd_rn(__fmul_rn(fy, yn), cy);
    if (!(u >= 0.0f && u <= (float)w && v >= 0.0f && v <= (float)h)) continue;

    // bilinear sample + interpolant gradients (fminf/fmaxf keep indices in
    // range whatever u, v are)
    const float uc = fminf(fmaxf(u, 0.0f), (float)(w - 1));
    const float vc = fminf(fmaxf(v, 0.0f), (float)(h - 1));
    const float j0f = floorf(uc), i0f = floorf(vc);
    const float fu = __fsub_rn(uc, j0f), fv = __fsub_rn(vc, i0f);
    const float omfu = __fsub_rn(1.0f, fu), omfv = __fsub_rn(1.0f, fv);
    const int j0 = (int)j0f, i0 = (int)i0f;
    const int j1 = min(j0 + 1, w - 1), i1 = min(i0 + 1, h - 1);
    const float a00 = __bfloat162float(I[(size_t)i0 * w + j0]);
    const float a01 = __bfloat162float(I[(size_t)i0 * w + j1]);
    const float a10 = __bfloat162float(I[(size_t)i1 * w + j0]);
    const float a11 = __bfloat162float(I[(size_t)i1 * w + j1]);
    const float row0 = __fadd_rn(__fmul_rn(omfv, a00), __fmul_rn(fv, a10));
    const float row1 = __fadd_rn(__fmul_rn(omfv, a01), __fmul_rn(fv, a11));
    const float eps = __fadd_rn(__fmul_rn(omfu, row0), __fmul_rn(fu, row1));
    const float gu = __fsub_rn(row1, row0);
    const float gv = __fadd_rn(__fmul_rn(omfu, __fsub_rn(a10, a00)),
                               __fmul_rn(fu, __fsub_rn(a11, a01)));
    // w = 6 / (6 + eps^2 / sigma^2), as PyTorch evaluates 6.0 / x
    const float wgt = __fmul_rn(
        __frcp_rn(__fadd_rn(6.0f, __fmul_rn(__fmul_rn(eps, eps), inv_sigma2))), 6.0f);

    // textbook image Jacobian: d eps / d[v, w] = G A1 [-I | hat(X')]
    const float ga0 = __fdiv_rn(__fmul_rn(gu, fx), zs);
    const float ga1 = __fdiv_rn(__fmul_rn(gv, fy), zs);
    const float ga2 = __fdiv_rn(
        -__fadd_rn(__fmul_rn(__fmul_rn(gu, fx), xn), __fmul_rn(__fmul_rn(gv, fy), yn)), zs);
    const float xz = __fmul_rn(xn, z), yz = __fmul_rn(yn, z);
    float J[6];
    J[0] = -ga0;
    J[1] = -ga1;
    J[2] = -ga2;
    J[3] = __fsub_rn(__fmul_rn(ga1, z), __fmul_rn(ga2, yz));
    J[4] = __fsub_rn(__fmul_rn(ga2, xz), __fmul_rn(ga0, z));
    J[5] = __fsub_rn(__fmul_rn(ga0, yz), __fmul_rn(ga1, xz));

    int m = 0;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float jw = __fmul_rn(J[r], wgt);
#pragma unroll
      for (int c = r; c < 6; ++c) acc[m++] += jw * J[c];
      acc[21 + r] += jw * eps;
    }
    acc[27] += eps * eps;
    acc[28] += 1.0f;
  }

#pragma unroll
  for (int m = 0; m < kTerms; ++m) red[m][tid] = acc[m];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int m = 0; m < kTerms; ++m) red[m][tid] += red[m][tid + s];
    }
    __syncthreads();
  }
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

// R (B,3,3), t (B,3), pts (B,K,3) float32, valid (B,K) uint8 contiguous;
// img (B,H,W) bf16 with rows contiguous and batch stride `img_batch_stride`
// elements; inv_sigma2 = 1 / sigma^2 of the robust weight; outputs
// contiguous. Launches on `stream`, does not synchronize.
extern "C" int fused_gn_terms(int device, const void* R, const void* t, const void* pts,
                              const void* valid, const void* img, long long img_batch_stride,
                              int batch, int k, int h, int w, float fx, float fy, float cx,
                              float cy, float inv_sigma2, void* h_out, void* g_out, void* e2_out,
                              void* n_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  fused_gn<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const float*)t, (const float*)pts, (const uint8_t*)valid,
      (const __nv_bfloat16*)img, img_batch_stride, k, h, w, fx, fy, cx, cy, inv_sigma2,
      (float*)h_out, (float*)g_out, (float*)e2_out, (int*)n_out);
  return (int)cudaGetLastError();
}
