// Canny edge maps of a pyramid of 8-bit-valued float images, for Hopper.
//
// Replaces the XLA ops of rgbd_odometry_tpu/ops/canny.py: `_grad_mag` (:166,
// with `sobel3`, ops/gradient.py:38), `_nms` (:26) and `hysteresis` (:125,
// the `lax.while_loop` :148-162), reached through `canny` (:234) and, for a
// whole pyramid, `canny_multi` (:182) behind `_pyramid_edges`
// (solvers/edge_dvo.py:933). The edge map is that of cv::Canny(img, high,
// low, 3, L2gradient=true). One C entry, `canny_pyramid`, turns every level
// of a pyramid of B images into its edge maps in two launches (one level is
// a pyramid of one):
//
//   canny_pyramid_front       one grid over the 32x32 tiles of all levels
//                             and images (a small level table, passed by
//                             value, maps a block to its level). 256 threads
//                             stage the tile with a 2-pixel ring, 16 bytes a
//                             load where the row allows it, rounded half to
//                             even and clamped to 0..255 (replicate border);
//                             the squared Sobel magnitude of the tile (each
//                             thread 4 pixels of its column, their Sobel kept
//                             in registers) and of a 1-pixel ring (13% over
//                             the tile) goes to shared memory, 0 outside the
//                             image (OpenCV's zero-padded neighbours); each
//                             thread then takes the TG22 sector test and keep
//                             rule of its 4 pixels. A warp is 32 neighbouring
//                             columns of one row, so `__ballot_sync` packs
//                             weak and strong into one 32-bit word each.
//   canny_pyramid_hysteresis  one block per (level, image), all in one
//                             launch: a frame's fixpoint costs its slowest
//                             level, not the sum of the levels. A block keeps
//                             the image's packed weak and edge planes in
//                             shared memory for the whole fixpoint (320x240:
//                             2 x 242 x 12 words = 23 KB with the zero guard
//                             ring; 640x480: 85 KB). A pass, per word: the OR
//                             of the three rows' words, each spread one
//                             column left and right with the carry bits of
//                             the neighbouring words, masked by weak, then
//                             filled along the weak runs inside the word by
//                             two carry chains (an integer add each way). A
//                             thread sweeps 8 rows of a word column down and
//                             up, so a pass carries an edge 8 rows and 32
//                             columns. The changed flag is a
//                             `__syncthreads_or`; the loop ends when no word
//                             changed (cap H*W passes, as in JAX). It can
//                             write each fixpoint's pass count.
//
// Exactness. Every value is an exact small integer in float32 (|gx|, |gy| <=
// 1020, mag < 2^24, |gx| * 13573 < 2^24, |gy| * 2^15 a shift) except tg67x =
// tg22x + |gx| * 65536, one rounding, written with __fmul_rn/__fadd_rn so nvcc
// cannot contract it. The hysteresis result is the least set that contains
// strong and is closed under 8-neighbour steps inside weak: it is unique, and
// every update only adds pixels that such steps reach, so updating words in
// place, in any order, with reads that may see a neighbour's old or new word,
// reaches the same set. The block barrier that ends a pass makes every write
// of the pass visible to the next; a pass in which no thread wrote read only
// final words, so it is the fixpoint. The edge maps are bitwise equal to the
// plain PyTorch version's and to JAX's.
//
// What bounds it on the H100: 4 bytes read and 1 written per pixel and ~34
// float32 operations per pixel in the front kernel (bytes); the hysteresis is
// a latency chain of barriers (one per pass) over shared memory. Bit packing
// is chosen on the card's own grounds: a ballot packs a warp's flags for free
// and a pass touches 32 pixels per shared-memory access.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTileW = 32;  // one warp, one packed word
constexpr int kBlockH = 8;  // a front block is 32x8 threads
constexpr int kTileRows = 32;  // a 32x32 tile: its magnitude ring is 13% of the tile
constexpr int kRowsPerThread = kTileRows / kBlockH;
constexpr int kImgH = kTileRows + 4;
constexpr int kImgW = kTileW + 8;  // columns x0 - 4 .. x0 + 35: ten aligned float4
constexpr int kMagW = kTileW + 2, kMagH = kTileRows + 2;  // magnitude tile, 1-pixel ring
constexpr int kFrontThreads = kTileW * kBlockH;
constexpr int kMaxHystThreads = 1024;
constexpr int kChunk = 8;  // rows per unit of a hysteresis pass
constexpr int kMaxDynamicSmem = 227 * 1024;

// Aperture-3 Sobel at the tile position `p` points to, rows `S` floats
// apart, in `sobel3`'s operation order (exact integers either way).
template <int S>
__device__ __forceinline__ void sobel(const float* p, float& gx, float& gy) {
  const float syl = (p[-S - 1] + 2.0f * p[-1]) + p[S - 1];
  const float syr = (p[-S + 1] + 2.0f * p[1]) + p[S + 1];
  gx = syr - syl;
  const float sxu = (p[-S - 1] + 2.0f * p[-S]) + p[-S + 1];
  const float sxd = (p[S - 1] + 2.0f * p[S]) + p[S + 1];
  gy = sxd - sxu;
}

// OpenCV's TG22 sector test and keep rule for the pixel whose squared
// magnitude `m` points to (magnitude rows kMagW floats apart), from its
// Sobel gx, gy.
__device__ __forceinline__ bool nms_keep(const float* m, float gx, float gy) {
  const float c = m[0];
  const float ax = fabsf(gx);
  const float ay = __fmul_rn(fabsf(gy), 32768.0f);
  const float tg22x = __fmul_rn(ax, 13573.0f);
  const float tg67x = __fadd_rn(tg22x, __fmul_rn(ax, 65536.0f));
  if (ay < tg22x) return c > m[-1] && c >= m[1];
  if (ay > tg67x) return c > m[-kMagW] && c >= m[kMagW];
  if (__fmul_rn(gx, gy) < 0.0f) return c > m[-kMagW + 1] && c > m[kMagW - 1];
  return c > m[-kMagW - 1] && c > m[kMagW + 1];
}

// The word at `j` with every bit also set at its left and right neighbour
// column (bit i is column 32 k + i; the carries come from the words beside).
__device__ __forceinline__ uint32_t spread(const volatile uint32_t* e, int j) {
  const uint32_t v = e[j];
  return v | (v << 1) | (v >> 1) | (e[j - 1] >> 31) | (e[j + 1] << 31);
}

struct PyrLevel {
  const float* img;        // (B, H, W) float32
  int h, w, words;         // words = ceil(W / 32)
  int tiles_x, tile_begin;  // front tiles across, and the level's first tile
  long long word_off;      // its (B, H, words) block in each packed plane
  long long edge_off;      // its (B, H, W) block of the edge maps, bytes
};

struct Pyramid {
  PyrLevel lv[kMaxLevels];
  int levels, batch;
  long long plane;  // words in one plane: weak first, strong after
  float low2, high2;
};

// Level `l` of the table, selected with constant indices only (a dynamic
// index into a kernel parameter would copy the table to local memory).
__device__ __forceinline__ PyrLevel level_at(const Pyramid& P, int l) {
  PyrLevel L = P.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) L = P.lv[i];
  return L;
}

__global__ void __launch_bounds__(kFrontThreads)
canny_pyramid_front(const __grid_constant__ Pyramid P, uint32_t* __restrict__ planes) {
  __shared__ __align__(16) float s_img[kImgH * kImgW];
  __shared__ float s_mag[kMagH * kMagW];
  int l = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < P.levels && (int)blockIdx.x >= P.lv[i].tile_begin) l = i;
  const PyrLevel L = level_at(P, l);
  const int h = L.h, w = L.w;
  const int t = blockIdx.x - L.tile_begin, tr = t / L.tiles_x;
  const int x0 = (t - tr * L.tiles_x) * kTileW, y0 = tr * kTileRows;
  const float* I = L.img + (size_t)blockIdx.y * h * w;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(I) & 15) == 0;

  // rows y0 - 2 .. y0 + 33, columns x0 - 4 .. x0 + 35, rounded half to even
  // and clamped to 0..255; every index is clamped into the image (replicate
  // border), so a 16-byte load is taken only where all four lie inside
  for (int i = tid; i < kImgH * (kImgW / 4); i += kFrontThreads) {
    const int r = i / (kImgW / 4), xa = x0 - 4 + 4 * (i - r * (kImgW / 4));
    const float* row = I + (size_t)min(max(y0 - 2 + r, 0), h - 1) * w;
    float4 v;
    if (vec && xa >= 0 && xa + 3 < w) {
      v = __ldg(reinterpret_cast<const float4*>(row + xa));
    } else {
      v.x = __ldg(row + min(max(xa, 0), w - 1));
      v.y = __ldg(row + min(max(xa + 1, 0), w - 1));
      v.z = __ldg(row + min(max(xa + 2, 0), w - 1));
      v.w = __ldg(row + min(max(xa + 3, 0), w - 1));
    }
    v.x = fminf(fmaxf(rintf(v.x), 0.0f), 255.0f);
    v.y = fminf(fmaxf(rintf(v.y), 0.0f), 255.0f);
    v.z = fminf(fmaxf(rintf(v.z), 0.0f), 255.0f);
    v.w = fminf(fmaxf(rintf(v.w), 0.0f), 255.0f);
    reinterpret_cast<float4*>(s_img)[i] = v;
  }
  __syncthreads();
  // the squared magnitude of the tile and a 1-pixel ring, 0 outside the
  // image: each thread its own 4 pixels, whose Sobel it keeps in registers
  // for the sector test, then the 132 positions of the ring
  const int x = x0 + threadIdx.x;
  float gxs[kRowsPerThread], gys[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int ty = threadIdx.y + j * kBlockH, y = y0 + ty;
    sobel<kImgW>(&s_img[(ty + 2) * kImgW + threadIdx.x + 4], gxs[j], gys[j]);
    s_mag[(ty + 1) * kMagW + threadIdx.x + 1] =
        x < w && y < h ? gxs[j] * gxs[j] + gys[j] * gys[j] : 0.0f;
  }
  if (tid < 2 * kMagW + 2 * kTileRows) {
    int r, c;
    if (tid < 2 * kMagW) {  // the top and bottom rows
      r = tid < kMagW ? 0 : kMagH - 1;
      c = tid < kMagW ? tid : tid - kMagW;
    } else {  // the left and right columns
      r = 1 + ((tid - 2 * kMagW) >> 1);
      c = ((tid - 2 * kMagW) & 1) ? kMagW - 1 : 0;
    }
    const int y = y0 - 1 + r, xr = x0 - 1 + c;
    float m = 0.0f;
    if (y >= 0 && y < h && xr >= 0 && xr < w) {
      float gx, gy;
      sobel<kImgW>(&s_img[(r + 1) * kImgW + c + 3], gx, gy);
      m = gx * gx + gy * gy;
    }
    s_mag[r * kMagW + c] = m;
  }
  __syncthreads();

  uint32_t* weak = planes + L.word_off + (size_t)blockIdx.y * h * L.words + x0 / kTileW;
  uint32_t* strong = weak + P.plane;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int ty = threadIdx.y + j * kBlockH, y = y0 + ty;
    bool wk = false, st = false;
    if (x < w && y < h) {
      const float* m = &s_mag[(ty + 1) * kMagW + threadIdx.x + 1];
      wk = nms_keep(m, gxs[j], gys[j]) && m[0] > P.low2;
      st = wk && m[0] > P.high2;
    }
    const unsigned wbits = __ballot_sync(0xffffffffu, wk);
    const unsigned sbits = __ballot_sync(0xffffffffu, st);
    if (threadIdx.x == 0 && y < h) {
      weak[(size_t)y * L.words] = wbits;
      strong[(size_t)y * L.words] = sbits;
    }
  }
}

// The bits of `m` in every run of set bits of `m` that holds a bit of
// s (s a subset of m): one row's weak pixels inside a word, reached from
// the seeds along the row. Adding s to m carries from each run's lowest
// seed to the run's top, which the xor marks; the bit-reversed sum does the
// same downwards.
__device__ __forceinline__ uint32_t fill_runs(uint32_t s, uint32_t m) {
  const uint32_t up = (((m + s) ^ m) & m) | s;
  const uint32_t rm = __brev(m), rs = __brev(s);
  return up | __brev((((rm + rs) ^ rm) & rm) | rs);
}

// grid (B, L): one block per (level, image).
__global__ void canny_pyramid_hysteresis(const __grid_constant__ Pyramid P,
                                         const uint32_t* __restrict__ planes,
                                         uint8_t* __restrict__ edges, int* __restrict__ passes) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x, l = blockIdx.y;
  const PyrLevel L = level_at(P, l);
  const int h = L.h, w = L.w, words = L.words, pitch = words + 2, n = (h + 2) * pitch;
  uint32_t* W = smem;
  volatile uint32_t* E = smem + n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const uint32_t* weak = planes + L.word_off + (size_t)b * h * words;
  const uint32_t* strong = weak + P.plane;

  // the image's rows at 1..h, a zero guard row above and below, a zero guard
  // column on each side
  for (int i = tid; i < n; i += nt) {
    const int r = i / pitch, c = i - r * pitch;
    uint32_t wk = 0, e = 0;
    if (r >= 1 && r <= h && c >= 1 && c <= words) {
      const size_t o = (size_t)(r - 1) * words + (c - 1);
      wk = weak[o];
      e = strong[o] & wk;
    }
    W[i] = wk;
    E[i] = e;
  }
  __syncthreads();

  // a unit is kChunk rows of one word column, swept down and up in place
  const int units = words * ((h + kChunk - 1) / kChunk);
  const long long cap = (long long)h * w;
  long long pass = 0;
  while (pass < cap) {
    int changed = 0;
    for (int u = tid; u < units; u += nt) {
      const int k = u / words, c = u - k * words;
      const int ra = 1 + k * kChunk, rb = min(ra + kChunk, h + 1);
      for (int step = 0; step < 2 * (rb - ra) - 1; ++step) {
        const int r = step < rb - ra ? ra + step : 2 * rb - ra - 2 - step;
        const int j = r * pitch + c + 1;
        const uint32_t wk = W[j];
        const uint32_t e = E[j];
        if (e == wk) continue;  // nothing left to gain in this word
        const uint32_t now =
            fill_runs((e | spread(E, j - pitch) | spread(E, j) | spread(E, j + pitch)) & wk, wk);
        if (now != e) {
          E[j] = now;
          changed = 1;
        }
      }
    }
    ++pass;
    if (!__syncthreads_or(changed)) break;
  }

  uint8_t* out = edges + L.edge_off + (size_t)b * h * w;
  if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
    uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
    const int q = w >> 2;
    for (int i = tid; i < h * q; i += nt) {
      const int r = i / q, x = (i - r * q) << 2;
      const uint32_t v = E[(r + 1) * pitch + (x >> 5) + 1] >> (x & 31);
      out4[i] = (v & 1u) | ((v & 2u) << 7) | ((v & 4u) << 14) | ((v & 8u) << 21);
    }
  } else {
    for (int i = tid; i < h * w; i += nt) {
      const int r = i / w, x = i - r * w;
      out[i] = (E[(r + 1) * pitch + (x >> 5) + 1] >> (x & 31)) & 1u;
    }
  }
  if (passes != nullptr && tid == 0) passes[l * P.batch + b] = (int)pass;
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every level of B images: level l's (B, H_l, W_l) float32 images start at
// imgs[l] (contiguous), with H_l = hw[2 l] and W_l = hw[2 l + 1]; its (B,
// H_l, ceil(W_l / 32)) packed words start word_off[l] words into each of the
// two planes (weak at `planes`, strong `plane` words after it), its (B, H_l,
// W_l) edge bytes edge_off[l] bytes into `edges`. passes (L, B) int32 gets
// each fixpoint's pass count, or is null. Launches on `stream` and does not
// synchronize; low2 <= high2 are the squared thresholds.
extern "C" int canny_pyramid(int device, int levels, int batch, const long long* imgs,
                             const int* hw, const long long* word_off, const long long* edge_off,
                             long long plane, void* planes, void* edges, void* passes, float low2,
                             float high2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > kMaxLevels || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Pyramid P{};
  P.levels = levels;
  P.batch = batch;
  P.plane = plane;
  P.low2 = low2;
  P.high2 = high2;
  int tiles = 0, threads = 64;
  long long smem = 0;
  for (int l = 0; l < levels; ++l) {
    PyrLevel& L = P.lv[l];
    L.img = reinterpret_cast<const float*>(imgs[l]);
    L.h = hw[2 * l];
    L.w = hw[2 * l + 1];
    if (L.h < 1 || L.w < 1) return (int)cudaErrorInvalidValue;
    L.words = (L.w + kTileW - 1) / kTileW;
    L.tiles_x = L.words;
    L.tile_begin = tiles;
    tiles += L.tiles_x * ((L.h + kTileRows - 1) / kTileRows);
    L.word_off = word_off[l];
    L.edge_off = edge_off[l];
    // the two planes with their guard ring; a thread per unit of a pass and
    // at least one per 4 words for the loads and the byte writes
    const long long need = 2LL * (L.h + 2) * (L.words + 2) * (long long)sizeof(uint32_t);
    smem = need > smem ? need : smem;
    const int units = L.words * ((L.h + kChunk - 1) / kChunk);
    const int work = units > L.h * L.words / 4 ? units : L.h * L.words / 4;
    const int t = ((work + 31) / 32) * 32;
    threads = t > threads ? t : threads;
  }
  if (smem > (long long)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  threads = threads > kMaxHystThreads ? kMaxHystThreads : threads;
  static rgbd::SharedOptIn opted;
  err = rgbd::opt_in_shared(canny_pyramid_hysteresis, device, smem, &opted);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  canny_pyramid_front<<<dim3(tiles, batch), dim3(kTileW, kBlockH), 0, s>>>(P, (uint32_t*)planes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  canny_pyramid_hysteresis<<<dim3(batch, levels), threads, (size_t)smem, s>>>(
      P, (const uint32_t*)planes, (uint8_t*)edges, (int*)passes);
  return (int)cudaGetLastError();
}
