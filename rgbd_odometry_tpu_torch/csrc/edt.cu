// Squared exact-L2 distance transform of a batch of edge masks, for Hopper.
//
// Replaces the Pallas kernel `edt_minplus_pallas` / `_edt_kernel`
// (rgbd_odometry_tpu/pallas/edt.py:25-69), reached through
// `edt_l2_squared_pallas`, and also takes in the column phase
// (`_column_distance`, rgbd_odometry_tpu/ops/distance_transform.py:31-42)
// and the +-R windowed row phase that the production profile uses
// (`edt_l2_squared_windowed`, same file :64-87). One call turns a
// (B, H, W) uint8 edge mask into D^2 (B, H, W) float32:
//
//   column phase  one thread per (image, column): a forward and a backward
//                 sweep give the integer distance g to the nearest edge in
//                 the column (1e7 if none), clamped to 65504; G^2 = g*g goes
//                 to a scratch buffer the wrapper allocates.
//   row phase     one block per (image, row): the G^2 row is staged in
//                 shared memory and each thread takes outputs x of the row,
//                 D^2[x] = min_i (G^2[i] + (x-i)^2) over the whole row
//                 (radius 0, the Pallas kernel) or over |x-i| <= radius with
//                 the reference's 4e9 out-of-image candidates (radius > 0).
//
// Exactness: g is an integer <= 65504, so G^2 is exact; every candidate
// G^2[i] + dx^2 is one float32 rounding, written with __fadd_rn/__fmul_rn
// so nvcc cannot contract it into an FMA. The result is bitwise equal to the
// plain PyTorch version and to the JAX/XLA functions.
//
// What bounds it on the H100: the row phase is O(H*W*W) (radius 0) or
// O(H*W*R) compare-and-add work on shared memory, no tensor-core work; the
// memory traffic is one read of the mask, one write+read of G^2 (L2-resident
// at these sizes) and one write of D^2. At the main path's shapes (30x40 up
// to 240x320 per image) a launch is small, so launch overhead dominates at
// batch 1; the two phases are two launches from one C call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1.0e7f;
constexpr float kGMax = 65504.0f;
constexpr float kPad = 4.0e9f;
constexpr int kColThreads = 128;

__global__ void edt_columns(const uint8_t* __restrict__ mask, float* __restrict__ g2,
                            int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const size_t base = (size_t)blockIdx.y * h * w + x;
  // forward sweep: distance to the nearest edge at or above row y
  int last = -1;
  for (int y = 0; y < h; ++y) {
    const size_t i = base + (size_t)y * w;
    if (mask[i]) last = y;
    g2[i] = last >= 0 ? (float)(y - last) : kBig;
  }
  // backward sweep: nearest edge at or below, then clamp and square
  int next = -1;
  for (int y = h - 1; y >= 0; --y) {
    const size_t i = base + (size_t)y * w;
    if (mask[i]) next = y;
    float g = g2[i];
    if (next >= 0) g = fminf(g, (float)(next - y));
    g = fminf(g, kGMax);
    g2[i] = __fmul_rn(g, g);
  }
}

__global__ void edt_rows(const float* __restrict__ g2, float* __restrict__ d2,
                         int h, int w, int radius) {
  extern __shared__ float row[];
  const size_t off = ((size_t)blockIdx.y * h + blockIdx.x) * w;
  for (int x = threadIdx.x; x < w; x += blockDim.x) row[x] = g2[off + x];
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    float best;
    if (radius <= 0) {
      best = __fadd_rn(row[0], (float)(x * x));
      for (int i = 1; i < w; ++i) {
        const int dx = x - i;
        best = fminf(best, __fadd_rn(row[i], (float)(dx * dx)));
      }
    } else {
      best = row[x];
      for (int dx = 1; dx <= radius; ++dx) {
        const float l = x - dx >= 0 ? row[x - dx] : kPad;
        const float r = x + dx < w ? row[x + dx] : kPad;
        best = fminf(best, __fadd_rn(fminf(l, r), (float)(dx * dx)));
      }
    }
    d2[off + x] = best;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// mask (B, H, W) uint8, g2 scratch and d2 output (B, H, W) float32, all
// contiguous on `device`; launches on `stream` and does not synchronize.
extern "C" int edt_squared(int device, const void* mask, void* g2, void* d2, int batch,
                           int h, int w, int radius, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 col_grid((w + kColThreads - 1) / kColThreads, batch);
  edt_columns<<<col_grid, kColThreads, 0, s>>>((const uint8_t*)mask, (float*)g2, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int threads = ((w + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  edt_rows<<<dim3(h, batch), threads, w * sizeof(float), s>>>((const float*)g2, (float*)d2,
                                                               h, w, radius);
  return (int)cudaGetLastError();
}
