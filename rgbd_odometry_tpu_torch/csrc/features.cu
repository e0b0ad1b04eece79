// Harris corners, their top-K and 8x8 patch descriptors in one launch, for
// Hopper; with a depth map, each keypoint back-projected in the same launch.
//
// Replaces XLA code of the JAX package, which has no Pallas kernel for it:
// `detect_and_describe` (rgbd_odometry_tpu/ops/features.py:69): the Harris
// response (:38-56 over ops/gradient.sobel3), the 3x3 non-maximum test,
// `lax.top_k` of the peak scores (:91), the descriptors' one-hot MXU gather
// over 64 shifted images (:106) and their normalization; with depth, the
// matcher's fused back-projection (`_detect_backproject`,
// rgbd_odometry_tpu/pipeline/kf_matcher.py:123-133).
//
// Bitwise its plain version (ops/features.py detect_and_describe_plain and
// backproject_keypoints_plain): every operation a round-to-nearest
// intrinsic in the plain version's order (nothing contracted into a fused
// multiply-add), the descriptor sums in XLA:CPU's windows of 32, the norm's
// square root in float64 rounded once, each division of the back-projection
// rounded once.
//
// One launch of ceil(W / 32) x ceil(H / 16) blocks of 512 threads:
//   1. each block computes the response of its 32x16 tile and a one-pixel
//      ring in shared memory (the image with a 3-pixel halo, the gradient
//      products with 2, each at its clamped pixel: replicate borders);
//   2. a pixel of the tile is a candidate when it is inside the border, no
//      neighbour's response exceeds it (>=: plateaus stay) and it is above
//      0 (every peak is: the threshold is 1e-4 of a positive maximum); the
//      block's candidates go to a global list as 64-bit keys (the response's
//      order-preserving bits, then ~index, so that descending keys are
//      (score descending, index ascending), `lax.top_k`'s order), at an
//      offset from one atomicAdd, and its largest response to one
//      atomicMax;
//   3. the last block to finish (an atomic ticket after a fence) takes the
//      threshold from the maximum, counts the peaks, finds the K-th largest
//      peak key by an 8-pass radix select when there are more than K (no cap
//      on the peak count), gathers the chosen keys into shared memory and
//      sorts them by a bitonic sort; slot s < count is the s-th key, the
//      slots past it take the first non-peak pixel indices in order (all of
//      them below K: a flag a pixel below K and a block scan);
//   4. the same block writes each slot: uv, score (-inf past the peaks),
//      valid, the descriptor (a thread a slot: 64 loads, the windowed sums,
//      the norm, 64 divisions; zeros where invalid) and, with depth, the
//      back-projected point and its validity.
// The wrapper's memset zeroes the 16-byte header (maximum, candidate count,
// ticket) before the launch; no host synchronization.
// What bounds it on the H100: not the bytes (the image once, 307 KB at
// 320x240, and the outputs, ~100 KB at K = 384: ~0.12 us) but the last
// block's serial work on one SM: the radix passes over the candidates, the
// bitonic sort's log^2 barriers, and a slot's descriptor chain.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "se3.cuh"
#include "warp.cuh"

namespace {

using rgbd::fadd;
using rgbd::fdiv;
using rgbd::fmul;
using rgbd::fsub;
using rgbd::kFull;

constexpr int kTileW = 32, kTileH = 16, kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kImgH = kTileH + 6, kImgW = kTileW + 6;    // rows y0-3 .. y0+18
constexpr int kGradH = kTileH + 4, kGradW = kTileW + 4;  // rows y0-2 .. y0+17
constexpr int kRespH = kTileH + 2, kRespW = kTileW + 2;  // rows y0-1 .. y0+16
constexpr int kPatch = 8;

struct Header {
  unsigned max_key, n_cand, ticket, pad;
};

__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A candidate key's response (candidates are positive) and pixel index.
__device__ __forceinline__ float key_score(unsigned long long key) {
  return __uint_as_float((unsigned)(key >> 32) & 0x7fffffffu);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)key);
}

struct Params {
  const float* gray;
  const float* depth;
  int h, w, k_max, border;
  float frac, fx, fy, cx, cy, min_depth;
  Header* head;
  unsigned long long* cand;
  float* uv;
  float* score;
  float* desc;
  uint8_t* valid;
  int* count;
  float* pts;
  uint8_t* pts_valid;
};

// Slot s's outputs for pixel `idx`.
__device__ void write_slot(const Params& P, int s, int idx, bool valid, float score) {
  const int y = idx / P.w, x = idx - (idx / P.w) * P.w;
  const float u = (float)x, v = (float)y;
  P.uv[2 * s] = u;
  P.uv[2 * s + 1] = v;
  P.score[s] = score;
  P.valid[s] = valid ? 1 : 0;
  float* D = P.desc + (size_t)s * kPatch * kPatch;
  if (valid) {
    float d[kPatch * kPatch];
#pragma unroll
    for (int r = 0; r < kPatch; ++r) {
      const int row = ((y + r - kPatch / 2) % P.h + P.h) % P.h;
#pragma unroll
      for (int c = 0; c < kPatch; ++c) {
        const int col = ((x + c - kPatch / 2) % P.w + P.w) % P.w;
        d[r * kPatch + c] = P.gray[(size_t)row * P.w + col];
      }
    }
    // the mean: two windows of 32 in order, then their sum
    float a0 = d[0], a1 = d[32];
#pragma unroll
    for (int i = 1; i < 32; ++i) {
      a0 = fadd(a0, d[i]);
      a1 = fadd(a1, d[32 + i]);
    }
    const float mu = fmul(fadd(a0, a1), 0.015625f);  // / 64, exact
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = fsub(d[i], mu);
    float q0 = fmul(d[0], d[0]), q1 = fmul(d[32], d[32]);
#pragma unroll
    for (int i = 1; i < 32; ++i) {
      q0 = fadd(q0, fmul(d[i], d[i]));
      q1 = fadd(q1, fmul(d[32 + i], d[32 + i]));
    }
    const float norm = __double2float_rn(__dsqrt_rn((double)fadd(q0, q1)));
    const float nrm = fmaxf(norm, 1e-6f);
#pragma unroll
    for (int i = 0; i < 64; ++i) D[i] = fdiv(d[i], nrm);
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) D[i] = 0.0f;
  }
  if (P.depth != nullptr) {
    const float z_mm = P.depth[idx];
    const float z = fdiv(z_mm, 1000.0f);
    P.pts[3 * s] = fdiv(fmul(z, fsub(u, P.cx)), P.fx);
    P.pts[3 * s + 1] = fdiv(fmul(z, fsub(v, P.cy)), P.fy);
    P.pts[3 * s + 2] = z;
    P.pts_valid[s] = (valid && z_mm > P.min_depth) ? 1 : 0;
  }
}

// Exclusive prefix sum of one value a thread over the block (512 threads);
// `warp_tot` holds kWarps ints.
__device__ int block_exclusive_scan(int x, int* warp_tot, int lane, int warp) {
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += u;
    }
    if (lane < kWarps) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_tot[warp - 1];
  const int out = before + incl - x;
  __syncthreads();  // warp_tot is reused by the caller
  return out;
}

__global__ void __launch_bounds__(kThreads)
detect_describe_kernel(Params P) {
  __shared__ float img[kImgH][kImgW];
  __shared__ float pxx[kGradH][kGradW], pyy[kGradH][kGradW], pxy[kGradH][kGradW];
  __shared__ float resp[kRespH][kRespW];
  __shared__ int warp_tot[kWarps];
  __shared__ unsigned block_max;
  __shared__ int base, is_last;
  extern __shared__ __align__(16) unsigned char dyn[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = P.h, w = P.w;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;

  // 1. the image, the gradient products and the response, each at clamped pixels
  for (int e = tid; e < kImgH * kImgW; e += kThreads) {
    const int r = y0 - 3 + e / kImgW, c = x0 - 3 + e % kImgW;
    if (r >= 0 && r < h && c >= 0 && c < w) img[e / kImgW][e % kImgW] = P.gray[(size_t)r * w + c];
  }
  if (tid == 0) block_max = 0u;
  __syncthreads();
#define IMG(r, c) img[(r) - y0 + 3][(c) - x0 + 3]
  for (int e = tid; e < kGradH * kGradW; e += kThreads) {
    const int r = y0 - 2 + e / kGradW, c = x0 - 2 + e % kGradW;
    if (r < 0 || r >= h || c < 0 || c >= w) continue;
    const int rm = max(r - 1, 0), rp = min(r + 1, h - 1), cm = max(c - 1, 0), cp = min(c + 1, w - 1);
    const float syp = fadd(fadd(IMG(rm, cp), fmul(2.0f, IMG(r, cp))), IMG(rp, cp));
    const float sym = fadd(fadd(IMG(rm, cm), fmul(2.0f, IMG(r, cm))), IMG(rp, cm));
    const float sxp = fadd(fadd(IMG(rp, cm), fmul(2.0f, IMG(rp, c))), IMG(rp, cp));
    const float sxm = fadd(fadd(IMG(rm, cm), fmul(2.0f, IMG(rm, c))), IMG(rm, cp));
    const float gx = fsub(syp, sym), gy = fsub(sxp, sxm);
    pxx[e / kGradW][e % kGradW] = fmul(gx, gx);
    pyy[e / kGradW][e % kGradW] = fmul(gy, gy);
    pxy[e / kGradW][e % kGradW] = fmul(gx, gy);
  }
#undef IMG
  __syncthreads();
  for (int e = tid; e < kRespH * kRespW; e += kThreads) {
    const int r = y0 - 1 + e / kRespW, c = x0 - 1 + e % kRespW;
    if (r < 0 || r >= h || c < 0 || c >= w) continue;
    int rr[3], cc[3];
    rr[0] = max(r - 1, 0) - y0 + 2;
    rr[1] = r - y0 + 2;
    rr[2] = min(r + 1, h - 1) - y0 + 2;
    cc[0] = max(c - 1, 0) - x0 + 2;
    cc[1] = c - x0 + 2;
    cc[2] = min(c + 1, w - 1) - x0 + 2;
    float sxx = pxx[rr[0]][cc[0]], syy = pyy[rr[0]][cc[0]], sxy = pxy[rr[0]][cc[0]];
#pragma unroll
    for (int n = 1; n < 9; ++n) {
      sxx = fadd(sxx, pxx[rr[n / 3]][cc[n % 3]]);
      syy = fadd(syy, pyy[rr[n / 3]][cc[n % 3]]);
      sxy = fadd(sxy, pxy[rr[n / 3]][cc[n % 3]]);
    }
    const float det = fsub(fmul(sxx, syy), fmul(sxy, sxy));
    const float tr = fadd(sxx, syy);
    resp[e / kRespW][e % kRespW] = fsub(det, fmul(fmul(0.04f, tr), tr));
  }
  __syncthreads();

  // 2. the tile's candidates and its largest response
  const int ty = tid / kTileW, tx = tid % kTileW;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside_img = y < h && x < w;
  bool cand = false;
  float r0 = 0.0f;
  if (inside_img) {
    r0 = resp[ty + 1][tx + 1];
    bool peak = true;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int ny = y + dy, nx = x + dx;
        if ((dy || dx) && ny >= 0 && ny < h && nx >= 0 && nx < w)
          peak = peak && r0 >= resp[ty + 1 + dy][tx + 1 + dx];
      }
    const bool inside = y >= P.border && y < h - P.border && x >= P.border && x < w - P.border;
    cand = peak && inside && r0 > 0.0f;
  }
  const unsigned mk = __reduce_max_sync(kFull, inside_img ? ordered(r0) : 0u);
  if (lane == 0 && mk) atomicMax(&block_max, mk);
  const int off = block_exclusive_scan(cand ? 1 : 0, warp_tot, lane, warp);
  if (tid == kThreads - 1) {
    const int total = off + (cand ? 1 : 0);
    base = total ? (int)atomicAdd(&P.head->n_cand, (unsigned)total) : 0;
    atomicMax(&P.head->max_key, block_max);
  }
  __syncthreads();
  if (cand)
    P.cand[base + off] = ((unsigned long long)ordered(r0) << 32) |
                         (unsigned long long)(0xffffffffu - (unsigned)(y * w + x));

  // 3. the last block to finish selects
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&P.head->ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const int k_max = P.k_max;
  int npow = 1;
  while (npow < k_max) npow <<= 1;
  unsigned long long* sel = (unsigned long long*)dyn;
  uint8_t* flag = dyn + 8 * (size_t)npow;
  __shared__ unsigned hist[256];
  __shared__ int n_peaks, n_sel, s_digit;
  __shared__ unsigned s_above;

  const float thr = fmul(P.frac, from_ordered(__ldcg(&P.head->max_key)));
  const int n = (int)__ldcg(&P.head->n_cand);
  if (tid == 0) {
    n_peaks = 0;
    n_sel = 0;
  }
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < n; i += kThreads) mine += key_score(__ldcg(P.cand + i)) > thr ? 1 : 0;
  mine = __reduce_add_sync(kFull, mine);
  if (lane == 0 && mine) atomicAdd(&n_peaks, mine);
  __syncthreads();
  const int count = n_peaks;
  const int kk = min(count, k_max);
  unsigned long long T = 0ull;  // the smallest chosen key
  if (count > k_max) {
    unsigned long long prefix = 0ull, mask = 0ull;
    unsigned need = (unsigned)k_max;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += kThreads) hist[b] = 0u;
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        const unsigned long long key = __ldcg(P.cand + i);
        if (key_score(key) > thr && (key & mask) == prefix)
          atomicAdd(&hist[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (warp == 0) {
        unsigned loc[8], sum = 0u;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          loc[b] = hist[8 * lane + b];
          sum += loc[b];
        }
        unsigned suf = sum;  // over lanes >= lane
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned t = __shfl_down_sync(kFull, suf, o);
          if (lane + o < 32) suf += t;
        }
        const unsigned above = suf - sum;
        if (above < need && need <= suf) {
          unsigned run = above;
          for (int b = 7; b >= 0; --b) {
            if (run + loc[b] >= need) {
              s_digit = 8 * lane + b;
              s_above = run;
              break;
            }
            run += loc[b];
          }
        }
      }
      __syncthreads();
      prefix |= (unsigned long long)s_digit << shift;
      mask |= 0xffull << shift;
      need -= s_above;
    }
    T = prefix;
  }
  for (int i = tid; i < n; i += kThreads) {
    const unsigned long long key = __ldcg(P.cand + i);
    if (key_score(key) > thr && key >= T) sel[atomicAdd(&n_sel, 1)] = key;
  }
  __syncthreads();
  for (int i = kk + tid; i < npow; i += kThreads) sel[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= npow; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < npow; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = sel[i], b = sel[j];
          if ((i & size) == 0 ? a < b : a > b) {
            sel[i] = b;
            sel[j] = a;
          }
        }
      }
      __syncthreads();
    }
  if (tid == 0) *P.count = kk;

  // 4. the peaks' slots, then the first non-peak pixels past them
  for (int s = tid; s < kk; s += kThreads) write_slot(P, s, key_index(sel[s]), true, key_score(sel[s]));
  if (kk < k_max) {
    for (int i = tid; i < k_max; i += kThreads) flag[i] = 0;
    __syncthreads();
    for (int s = tid; s < kk; s += kThreads) {
      const int idx = key_index(sel[s]);
      if (idx < k_max) flag[idx] = 1;
    }
    __syncthreads();
    const int chunk = (k_max + kThreads - 1) / kThreads;
    const int lo = min(tid * chunk, k_max), hi = min(lo + chunk, k_max);
    int free_ = 0;
    for (int i = lo; i < hi; ++i) free_ += flag[i] ? 0 : 1;
    int rank = block_exclusive_scan(free_, warp_tot, lane, warp);
    const int fill = k_max - kk;
    for (int i = lo; i < hi && rank < fill; ++i)
      if (!flag[i]) write_slot(P, kk + rank++, i, false, __int_as_float(0xff800000));
  }
}

rgbd::SharedOptIn opted;

// The dynamic shared memory a launch takes for k_max slots: the sort's keys
// (a power of two at least k_max) and a flag a pixel below k_max.
long long selection_smem(int k_max) {
  long long npow = 1;
  while (npow < k_max) npow <<= 1;
  return 8 * npow + ((k_max + 15) / 16) * 16;
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// gray (H,W) float32, depth (H,W) float32 or null, both contiguous;
// scratch: 16 + 8 H W bytes, 16-byte aligned (the header, zeroed here by a
// memset, and the candidate keys). Outputs uv (K,2), score (K,), desc
// (K,64) float32, valid (K,) uint8, count () int32 and, with depth, pts
// (K,3) float32 and pts_valid (K,) uint8. One kernel launch after the
// memset on `stream`, no synchronization.
extern "C" int detect_describe(int device, const void* gray, const void* depth, int h, int w,
                               int k_max, int border, float frac, float fx, float fy, float cx,
                               float cy, float min_depth, void* scratch, void* uv, void* score,
                               void* desc, void* valid, void* count, void* pts, void* pts_valid,
                               void* stream) {
  if (h < 1 || w < 1 || k_max < 1 || (long long)k_max > (long long)h * w)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long smem = selection_smem(k_max);
  err = rgbd::opt_in_shared(detect_describe_kernel, device, smem, &opted);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, sizeof(Header), s);
  if (err != cudaSuccess) return (int)err;
  Params P;
  P.gray = (const float*)gray;
  P.depth = (const float*)depth;
  P.h = h;
  P.w = w;
  P.k_max = k_max;
  P.border = border;
  P.frac = frac;
  P.fx = fx;
  P.fy = fy;
  P.cx = cx;
  P.cy = cy;
  P.min_depth = min_depth;
  P.head = (Header*)scratch;
  P.cand = (unsigned long long*)((char*)scratch + sizeof(Header));
  P.uv = (float*)uv;
  P.score = (float*)score;
  P.desc = (float*)desc;
  P.valid = (uint8_t*)valid;
  P.count = (int*)count;
  P.pts = (float*)pts;
  P.pts_valid = (uint8_t*)pts_valid;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  detect_describe_kernel<<<grid, kThreads, (size_t)smem, s>>>(P);
  return (int)cudaGetLastError();
}
