// Canny edge maps of a batch of 8-bit-valued float images, for Hopper.
//
// Replaces the XLA ops of rgbd_odometry_tpu/ops/canny.py: `_grad_mag` (:166,
// with `sobel3`, ops/gradient.py:38), `_nms` (:26) and `hysteresis` (:125,
// the `lax.while_loop` :148-162), reached through `canny` (:234). One C call
// turns (B, H, W) float32 into the (B, H, W) bool edge map of
// cv::Canny(img, high, low, 3, L2gradient=true), in two launches:
//
//   canny_front       one thread per pixel, a 32x8 tile per block. The tile is
//                     staged with a 2-pixel halo in shared memory, rounded half
//                     to even and clamped to 0..255 (replicate border); the
//                     squared Sobel magnitude of the tile and a 1-pixel halo
//                     goes to shared memory, 0 outside the image (OpenCV's
//                     zero-padded neighbours); every thread then takes the TG22
//                     sector test and its keep rule. A warp is 32 neighbouring
//                     columns of one row, so `__ballot_sync` packs its weak and
//                     strong flags into one 32-bit word each.
//   canny_hysteresis  one block per image. The packed weak and edge planes
//                     stay in shared memory for the whole fixpoint (320x240:
//                     2 x 242 x 12 words = 23 KB with the zero guard ring). A
//                     pass, per word: the OR of the three rows' words, each
//                     spread one column left and right with the carry bits of
//                     the neighbouring words, masked by weak, then run along
//                     the weak runs inside the word. A thread sweeps 8 rows of
//                     a word column down and up again, so a pass carries an
//                     edge 8 rows and 32 columns. The changed flag is a
//                     `__syncthreads_or`; the loop ends when no word changed
//                     (cap H*W passes, as in JAX). No flag reaches the host.
//
// Exactness. Every value is an exact small integer in float32 (|gx|, |gy| <=
// 1020, mag < 2^24, |gx| * 13573 < 2^24, |gy| * 2^15 a shift) except tg67x =
// tg22x + |gx| * 65536, one rounding, written with __fmul_rn/__fadd_rn so nvcc
// cannot contract it. The hysteresis result is the least set that contains
// strong and is closed under 8-neighbour steps inside weak: it is unique, so
// updating words in place, in any order, with reads that may see a
// neighbour's old or new word, reaches the same set; a pass in which no thread
// wrote read only final words, so it is the fixpoint. The edge map is
// bitwise equal to the plain PyTorch version's and to JAX's.
//
// What bounds it on the H100: 4 bytes read and 1 written per pixel, ~40
// float32 operations per pixel in the front kernel; the hysteresis is a
// latency chain of block barriers (one per pass) over shared memory. Bit
// packing is chosen on the card's own grounds: a ballot packs a warp's
// flags for free and a pass touches 32 pixels per shared-memory access.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;  // one warp, one packed word
constexpr int kTileH = 8;
constexpr int kImgW = kTileW + 4, kImgH = kTileH + 4;  // image tile, 2-pixel halo
constexpr int kMagW = kTileW + 2, kMagH = kTileH + 2;  // magnitude tile, 1-pixel halo
constexpr int kFrontThreads = kTileW * kTileH;
constexpr int kMaxHystThreads = 1024;
constexpr int kChunk = 8;  // rows per unit of a hysteresis pass
constexpr int kMaxDynamicSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

// Aperture-3 Sobel at the tile position `p` points to, in `sobel3`'s
// operation order (exact integers either way).
__device__ __forceinline__ void sobel(const float* p, float& gx, float& gy) {
  const float syl = (p[-kImgW - 1] + 2.0f * p[-1]) + p[kImgW - 1];
  const float syr = (p[-kImgW + 1] + 2.0f * p[1]) + p[kImgW + 1];
  gx = syr - syl;
  const float sxu = (p[-kImgW - 1] + 2.0f * p[-kImgW]) + p[-kImgW + 1];
  const float sxd = (p[kImgW - 1] + 2.0f * p[kImgW]) + p[kImgW + 1];
  gy = sxd - sxu;
}

__global__ void __launch_bounds__(kFrontThreads)
canny_front(const float* __restrict__ img, uint32_t* __restrict__ weak,
            uint32_t* __restrict__ strong, int h, int w, int words, float low2, float high2) {
  __shared__ float s_img[kImgH * kImgW];
  __shared__ float s_mag[kMagH * kMagW];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const float* I = img + (size_t)blockIdx.z * h * w;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  for (int i = tid; i < kImgH * kImgW; i += kFrontThreads) {
    const int r = i / kImgW, c = i - r * kImgW;
    const int y = min(max(y0 - 2 + r, 0), h - 1), x = min(max(x0 - 2 + c, 0), w - 1);
    s_img[i] = fminf(fmaxf(rintf(I[(size_t)y * w + x]), 0.0f), 255.0f);
  }
  __syncthreads();
  for (int i = tid; i < kMagH * kMagW; i += kFrontThreads) {
    const int r = i / kMagW, c = i - r * kMagW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float m = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      float gx, gy;
      sobel(&s_img[(r + 1) * kImgW + c + 1], gx, gy);
      m = gx * gx + gy * gy;
    }
    s_mag[i] = m;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  bool wk = false, st = false;
  if (x < w && y < h) {
    float gx, gy;
    sobel(&s_img[(threadIdx.y + 2) * kImgW + threadIdx.x + 2], gx, gy);
    const float* m = &s_mag[(threadIdx.y + 1) * kMagW + threadIdx.x + 1];
    const float c = m[0];
    const float ax = fabsf(gx);
    const float ay = __fmul_rn(fabsf(gy), 32768.0f);
    const float tg22x = __fmul_rn(ax, 13573.0f);
    const float tg67x = __fadd_rn(tg22x, __fmul_rn(ax, 65536.0f));
    bool keep;
    if (ay < tg22x) {
      keep = c > m[-1] && c >= m[1];
    } else if (ay > tg67x) {
      keep = c > m[-kMagW] && c >= m[kMagW];
    } else if (__fmul_rn(gx, gy) < 0.0f) {
      keep = c > m[-kMagW + 1] && c > m[kMagW - 1];
    } else {
      keep = c > m[-kMagW - 1] && c > m[kMagW + 1];
    }
    wk = keep && c > low2;
    st = wk && c > high2;
  }
  const unsigned wbits = __ballot_sync(0xffffffffu, wk);
  const unsigned sbits = __ballot_sync(0xffffffffu, st);
  if (threadIdx.x == 0 && y < h) {
    const size_t o = ((size_t)blockIdx.z * h + y) * words + blockIdx.x;
    weak[o] = wbits;
    strong[o] = sbits;
  }
}

// The word at `j` with every bit also set at its left and right neighbour
// column (bit i is column 32 k + i; the carries come from the words beside).
__device__ __forceinline__ uint32_t spread(const volatile uint32_t* e, int j) {
  const uint32_t v = e[j];
  return v | (v << 1) | (v >> 1) | (e[j - 1] >> 31) | (e[j + 1] << 31);
}

__global__ void canny_hysteresis(const uint32_t* __restrict__ weak,
                                 const uint32_t* __restrict__ strong,
                                 uint8_t* __restrict__ edges, int h, int w, int words) {
  extern __shared__ uint32_t smem[];
  const int pitch = words + 2, n = (h + 2) * pitch;
  uint32_t* W = smem;
  volatile uint32_t* E = smem + n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)blockIdx.x * h * words;

  for (int i = tid; i < n; i += nt) {
    const int r = i / pitch, c = i - r * pitch;
    uint32_t wk = 0, e = 0;
    if (r >= 1 && r <= h && c >= 1 && c <= words) {
      const size_t o = base + (size_t)(r - 1) * words + (c - 1);
      wk = weak[o];
      e = strong[o] & wk;
    }
    W[i] = wk;
    E[i] = e;
  }
  __syncthreads();

  // A unit of work is kChunk rows of one word column, swept down and then up
  // in place, so that within a pass an edge runs the whole chunk vertically
  // and 32 columns horizontally.
  const int chunks = (h + kChunk - 1) / kChunk, units = words * chunks;
  const long long cap = (long long)h * w;
  for (long long pass = 0; pass < cap; ++pass) {
    int changed = 0;
    for (int u = tid; u < units; u += nt) {
      const int k = u / words, c = u - k * words;
      const int ya = k * kChunk, yb = min(ya + kChunk, h);
      for (int step = 0; step < 2 * (yb - ya) - 1; ++step) {
        const int y = step < yb - ya ? ya + step : 2 * yb - ya - 2 - step;
        const int j = (y + 1) * pitch + c + 1;
        const uint32_t wk = W[j];
        const uint32_t e = E[j];
        if (e == wk) continue;  // nothing left to gain in this word
        uint32_t now = (e | spread(E, j - pitch) | spread(E, j) | spread(E, j + pitch)) & wk;
        for (;;) {  // along the weak runs inside the word
          const uint32_t next = (now | (now << 1) | (now >> 1)) & wk;
          if (next == now) break;
          now = next;
        }
        if (now != e) {
          E[j] = now;
          changed = 1;
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  uint8_t* out = edges + (size_t)blockIdx.x * h * w;
  if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
    uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
    for (int i = tid; i < h * (w >> 2); i += nt) {
      const int y = i / (w >> 2), x = (i - y * (w >> 2)) << 2;
      const uint32_t b = E[(y + 1) * pitch + (x >> 5) + 1] >> (x & 31);
      out4[i] = (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
    }
  } else {
    for (int i = tid; i < h * w; i += nt) {
      const int y = i / w, x = i - y * w;
      out[i] = (E[(y + 1) * pitch + (x >> 5) + 1] >> (x & 31)) & 1u;
    }
  }
}

bool g_opted_in[kMaxDevices];

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// img (B, H, W) float32; weak and strong scratch (B, H, ceil(W / 32)) 32-bit
// words each; edges output (B, H, W) bytes, 0 or 1. All contiguous on
// `device`; launches on `stream` and does not synchronize. low2 and high2
// are the squared thresholds, low2 <= high2.
extern "C" int canny(int device, const void* img, void* weak, void* strong, void* edges,
                     int batch, int h, int w, float low2, float high2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int words = (w + kTileW - 1) / kTileW;
  const size_t smem = (size_t)2 * (h + 2) * (words + 2) * sizeof(uint32_t);
  if (smem > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  // above 48 KB (640x480) the opt-in is needed: set once per device
  if (smem > 48 * 1024 && (device >= kMaxDevices || !g_opted_in[device])) {
    err = cudaFuncSetAttribute(canny_hysteresis, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) g_opted_in[device] = true;
  }
  const dim3 grid(words, (h + kTileH - 1) / kTileH, batch);
  canny_front<<<grid, dim3(kTileW, kTileH), 0, s>>>((const float*)img, (uint32_t*)weak,
                                                    (uint32_t*)strong, h, w, words, low2, high2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a thread per unit of the passes, and at least one per 4 words for the
  // loads before and the byte writes after
  const int units = words * ((h + kChunk - 1) / kChunk);
  const int work = units > h * words / 4 ? units : h * words / 4;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 64 ? 64 : (threads > kMaxHystThreads ? kMaxHystThreads : threads);
  canny_hysteresis<<<batch, threads, smem, s>>>((const uint32_t*)weak, (const uint32_t*)strong,
                                                (uint8_t*)edges, h, w, words);
  return (int)cudaGetLastError();
}
