// Batched mutual-nearest descriptor matching for Hopper: one query frame's
// keypoint descriptors against S stored keyframe slots.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `jax.vmap(features.match)` over the slot store
// (rgbd_odometry_tpu/pipeline/kf_matcher.py:103-108, ops/features.py:146-170).
// Per slot s and query keypoint i, over the slot's keypoints j:
//
//   sim_ij = sum_d q_id r_jd          (float32 fused multiply-adds, d ascending)
//   d2_ij  = max(2 - 2 sim_ij, 0), or 1e9 when q_i or r_j is invalid
//   ref_idx_i = argmin_j d2_ij        (lowest j among equals)
//   second_i  = min over j != ref_idx_i of d2_ij
//   mutual_i  = argmin_i' d2_i'j == i at j = ref_idx_i (lowest i' among equals)
//   dist_i    = sqrtf(d2 at ref_idx_i); min_d = min over valid i of dist_i
//   good_i    = q valid & mutual & dist_i <= max(factor min_d, floor)
//               & best <= ratio^2 second & best < 5e8
//
// The similarity is the chain acc = fma(q_d, r_d, acc) with __fmaf_rn, the
// order in which XLA:CPU's dot sums it, and the plain PyTorch version
// (kernels/match.py) emulates each fused multiply-add exactly: kernel,
// plain version and the JAX package agree on every similarity bit for bit.
// That matters where a frame is matched with its own duplicate: every true
// distance is then a few ulps from 0 and the distance gate decides on them.
//
// Design. One block per slot. The row pass keeps one query descriptor per
// thread in registers and streams the slot's descriptors from shared memory
// (every lane of a warp reads the same float4, a broadcast); the column pass
// swaps the roles, reusing the same shared buffer for the query
// descriptors. Both passes evaluate d2 by the same inline function, so the
// mutual test compares identical values. K x 64 float32 is 96 KB at K = 384,
// above the 48 KB static limit: dynamic shared memory with the opt-in
// attribute. What bounds it on the H100: S x K^2 x 64 x 2 multiply-adds
// (1.2 GFLOP at S = 64, K = 384) and the shared-memory reads that feed them,
// one float4 per four multiply-adds per warp; with one block per slot a
// launch at S = 64 occupies half of the 132 SMs. min_d and num_good are
// order-independent reductions (min, integer sum), so runs are bitwise
// repeatable.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kD = 64;
constexpr int kMaxThreads = 512;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float pair_d2(const float (&a)[kD], const float4* __restrict__ b) {
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < kD / 4; ++q) {
    const float4 v = b[q];
    acc = __fmaf_rn(a[4 * q + 0], v.x, acc);
    acc = __fmaf_rn(a[4 * q + 1], v.y, acc);
    acc = __fmaf_rn(a[4 * q + 2], v.z, acc);
    acc = __fmaf_rn(a[4 * q + 3], v.w, acc);
  }
  return fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, acc)), 0.0f);
}

__device__ __forceinline__ void load_row(float (&a)[kD], const float* __restrict__ src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < kD / 4; ++q) {
    const float4 v = s4[q];
    a[4 * q + 0] = v.x;
    a[4 * q + 1] = v.y;
    a[4 * q + 2] = v.z;
    a[4 * q + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
match_kernel(const float* __restrict__ slot_desc, const uint8_t* __restrict__ slot_valid,
             const float* __restrict__ q_desc, const uint8_t* __restrict__ q_valid, int k,
             float factor, float ratio2, float gate_floor, int* __restrict__ ref_idx_out,
             float* __restrict__ dist_out, uint8_t* __restrict__ good_out,
             int* __restrict__ num_good_out) {
  extern __shared__ float4 smem[];
  float4* desc = smem;                                        // K x 16 float4
  int* best_idx = reinterpret_cast<int*>(desc + (size_t)k * (kD / 4));
  float* best_d = reinterpret_cast<float*>(best_idx + k);
  float* second_d = best_d + k;
  int* col_arg = reinterpret_cast<int*>(second_d + k);
  uint8_t* rv = reinterpret_cast<uint8_t*>(col_arg + k);
  uint8_t* qv = rv + k;
  __shared__ float red_min[kMaxThreads / 32];
  __shared__ int red_cnt[kMaxThreads / 32];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* R = slot_desc + (size_t)s * k * kD;
  const uint8_t* RV = slot_valid + (size_t)s * k;

  for (int i = tid; i < k * (kD / 4); i += nt) desc[i] = reinterpret_cast<const float4*>(R)[i];
  for (int i = tid; i < k; i += nt) {
    rv[i] = RV[i];
    qv[i] = q_valid[i];
  }
  __syncthreads();

  // row pass: nearest and second-nearest slot keypoint per query keypoint
  float a[kD];
  for (int i = tid; i < k; i += nt) {
    float best = kBig, second = kBig;
    int arg = 0;
    if (qv[i]) {
      load_row(a, q_desc + (size_t)i * kD);
      for (int j = 0; j < k; ++j) {
        const float d2 = rv[j] ? pair_d2(a, desc + (size_t)j * (kD / 4)) : kBig;
        if (d2 < best) {
          second = best;
          best = d2;
          arg = j;
        } else if (d2 < second) {
          second = d2;
        }
      }
    }
    best_idx[i] = arg;
    best_d[i] = best;
    second_d[i] = second;
  }
  __syncthreads();

  // column pass: nearest query keypoint per slot keypoint
  for (int i = tid; i < k * (kD / 4); i += nt) desc[i] = reinterpret_cast<const float4*>(q_desc)[i];
  __syncthreads();
  for (int j = tid; j < k; j += nt) {
    float best = kBig;
    int arg = 0;
    if (rv[j]) {
      load_row(a, R + (size_t)j * kD);
      for (int i = 0; i < k; ++i) {
        const float d2 = qv[i] ? pair_d2(a, desc + (size_t)i * (kD / 4)) : kBig;
        if (d2 < best) {
          best = d2;
          arg = i;
        }
      }
    }
    col_arg[j] = arg;
  }
  __syncthreads();

  // min_d over valid query keypoints
  float mn = __int_as_float(0x7f800000);  // +inf
  for (int i = tid; i < k; i += nt) {
    if (qv[i]) mn = fminf(mn, __fsqrt_rn(best_d[i]));
  }
  for (int off = 16; off > 0; off >>= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  if ((tid & 31) == 0) red_min[tid >> 5] = mn;
  __syncthreads();
  if (tid == 0) {
    float m = red_min[0];
    for (int w = 1; w < (nt + 31) / 32; ++w) m = fminf(m, red_min[w]);
    red_min[0] = m;
  }
  __syncthreads();
  const float gate = fmaxf(__fmul_rn(factor, red_min[0]), gate_floor);

  int cnt = 0;
  for (int i = tid; i < k; i += nt) {
    const float best = best_d[i];
    const float dist = __fsqrt_rn(best);
    const int arg = best_idx[i];
    const bool good = qv[i] && col_arg[arg] == i && dist <= gate &&
                      best <= __fmul_rn(ratio2, second_d[i]) && best < 0.5f * kBig;
    const size_t o = (size_t)s * k + i;
    ref_idx_out[o] = arg;
    dist_out[o] = dist;
    good_out[o] = good ? 1 : 0;
    cnt += good ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  __syncthreads();
  if ((tid & 31) == 0) red_cnt[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int w = 0; w < (nt + 31) / 32; ++w) c += red_cnt[w];
    num_good_out[s] = c;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// slot_desc (S,K,D) float32, slot_valid (S,K) uint8, q_desc (K,D) float32,
// q_valid (K,) uint8, all contiguous; D must be 64. Outputs ref_idx (S,K)
// int32, dist (S,K) float32, good (S,K) uint8, num_good (S,) int32.
// Launches on `stream`, does not synchronize.
extern "C" int match_mutual(int device, const void* slot_desc, const void* slot_valid,
                            const void* q_desc, const void* q_valid, int slots, int k, int d,
                            float factor, float ratio2, float gate_floor, void* ref_idx_out,
                            void* dist_out, void* good_out, void* num_good_out, void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)k * kD * sizeof(float) + (size_t)k * 4 * sizeof(int) +
                      (size_t)k * 2;
  static rgbd::SharedOptIn opted;
  err = rgbd::opt_in_shared(match_kernel, device, (long long)smem, &opted);
  if (err != cudaSuccess) return (int)err;
  int threads = ((k + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  if (slots > 0 && k > 0) {
    match_kernel<<<slots, threads, smem, (cudaStream_t)stream>>>(
        (const float*)slot_desc, (const uint8_t*)slot_valid, (const float*)q_desc,
        (const uint8_t*)q_valid, k, factor, ratio2, gate_floor, (int*)ref_idx_out,
        (float*)dist_out, (uint8_t*)good_out, (int*)num_good_out);
  }
  return (int)cudaGetLastError();
}
