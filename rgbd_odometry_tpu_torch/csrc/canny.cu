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
//   canny_pyramid_hysteresis  one block, or one cluster of c blocks, per
//                             (level, image), all in one launch: a frame's
//                             fixpoint costs its slowest level, not the sum
//                             of the levels. A block keeps the image's packed
//                             weak and edge planes in shared memory for the
//                             whole fixpoint (320x240: 2 x 242 x 12 words =
//                             23 KB with the zero guard ring; 640x480: 85 KB;
//                             one block holds up to ~1280x690). A level one
//                             block cannot hold, or whose units outnumber a
//                             block's threads where the card holds the
//                             launch's clusters at once (the wrapper's rule),
//                             goes to a cluster of c = 2, 4 or 8 blocks, a
//                             band of rows each (a multiple of 8 rows), whose
//                             boundary rows the neighbouring bands read
//                             through distributed shared memory (640x480 at
//                             B = 1 on 8 blocks: 31.2 -> 16.5 us on an H100
//                             80GB HBM3 at 700 W; at B = 64 one block an
//                             image is faster);
//                             the launch's blocks come in clusters of c, the
//                             one-block (level, image)s c to a cluster, each
//                             on its own. A pass, per word: the OR
//                             of the three rows' words, each spread one
//                             column left and right with the carry bits of
//                             the neighbouring words, masked by weak, then
//                             filled along the weak runs inside the word by
//                             two carry chains (an integer add each way). A
//                             thread sweeps 8 rows of a word column down and
//                             up, so a pass carries an edge 8 rows and 32
//                             columns. The changed flag is a
//                             `__syncthreads_or`; in a cluster each block's
//                             flag is written into every block's shared
//                             memory, in a slot of the pass's parity, and one
//                             cluster barrier a pass makes the flags and the
//                             pass's words visible. The loop ends when no
//                             word changed (cap H*W passes, as in JAX). It
//                             can write each fixpoint's pass count.
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
// final words, so it is the fixpoint. The banded schedule keeps the
// argument: a pixel set by any band's sweep is reached by 8-neighbour steps
// inside weak from strong, so it is in the least fixed point whatever order
// the bands' sweeps run in and whether a band reads its neighbour's
// boundary row before or after that neighbour wrote it in the same pass.
// The cluster barrier that ends a pass (release, then acquire) makes every
// band's writes visible to every band; a pass in which no band wrote read
// only final words. Every band reads its flags only from its own shared
// memory after the last barrier, so no block reads another's memory once
// one may have exited. The edge maps are bitwise equal to the plain PyTorch
// version's and to JAX's.
//
// What bounds it on the H100: 4 bytes read and 1 written per pixel and ~34
// float32 operations per pixel in the front kernel (bytes); the hysteresis is
// a latency chain of barriers (one per pass, a cluster barrier in a band)
// over shared memory; its size is bounded by one band's planes fitting 227
// KB, which a cluster of 8 does for any level of at most 2560 rows and 2560
// columns. Bit packing
// is chosen on the card's own grounds: a ballot packs a warp's flags for free
// and a pass touches 32 pixels per shared-memory access.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

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
  int ranks, band;         // hysteresis: blocks an image (1 or the launch's c), rows a block
  int block_begin;         // the level's first hysteresis block
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

// Load a band's `rows` rows of packed weak and strong words (image rows
// from those `weak` points to on) at local rows 1..rows of W and E, with a
// zero guard column on each side and zero guard rows 0 and rows + 1.
__device__ __forceinline__ void load_band(const uint32_t* __restrict__ weak,
                                          const uint32_t* __restrict__ strong, int rows,
                                          int words, uint32_t* W, volatile uint32_t* E) {
  const int pitch = words + 2, n = (rows + 2) * pitch;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / pitch, c = i - r * pitch;
    uint32_t wk = 0, e = 0;
    if (r >= 1 && r <= rows && c >= 1 && c <= words) {
      const size_t o = (size_t)(r - 1) * words + (c - 1);
      wk = weak[o];
      e = strong[o] & wk;
    }
    W[i] = wk;
    E[i] = e;
  }
}

// Write a band's edge bytes (local rows 1..rows of E) to `out`, its first
// image row.
__device__ __forceinline__ void store_band(const volatile uint32_t* E, int rows, int w,
                                           int pitch, uint8_t* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0) {
    uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
    const int q = w >> 2;
    for (int i = tid; i < rows * q; i += nt) {
      const int r = i / q, x = (i - r * q) << 2;
      const uint32_t v = E[(r + 1) * pitch + (x >> 5) + 1] >> (x & 31);
      out4[i] = (v & 1u) | ((v & 2u) << 7) | ((v & 4u) << 14) | ((v & 8u) << 21);
    }
  } else {
    for (int i = tid; i < rows * w; i += nt) {
      const int r = i / w, x = i - r * w;
      out[i] = (E[(r + 1) * pitch + (x >> 5) + 1] >> (x & 31)) & 1u;
    }
  }
}

// One pass over a band's units (kChunk rows of one word column, swept down
// and up in place); `up` and `down` are the rows above its first and below
// its last row (the zero guard rows, or with BANDED the neighbouring bands'
// boundary rows in their blocks' shared memory). Returns whether this
// thread changed a word.
template <bool BANDED>
__device__ __forceinline__ int sweep(const uint32_t* W, volatile uint32_t* E, int rows, int words,
                                     const volatile uint32_t* up,
                                     const volatile uint32_t* down) {
  const int pitch = words + 2;
  const int units = words * ((rows + kChunk - 1) / kChunk);
  int changed = 0;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int k = u / words, c = u - k * words;
    const int ra = 1 + k * kChunk, rb = min(ra + kChunk, rows + 1);
    for (int step = 0; step < 2 * (rb - ra) - 1; ++step) {
      const int r = step < rb - ra ? ra + step : 2 * rb - ra - 2 - step;
      const int j = r * pitch + c + 1;
      const uint32_t wk = W[j];
      const uint32_t e = E[j];
      if (e == wk) continue;  // nothing left to gain in this word
      uint32_t seed;
      if (BANDED) {
        const volatile uint32_t* above = r == 1 ? up : E + (r - 1) * pitch;
        const volatile uint32_t* below = r == rows ? down : E + (r + 1) * pitch;
        seed = e | spread(above, c + 1) | spread(E, j) | spread(below, c + 1);
      } else {
        seed = e | spread(E, j - pitch) | spread(E, j) | spread(E, j + pitch);
      }
      const uint32_t now = fill_runs(seed & wk, wk);
      if (now != e) {
        E[j] = now;
        changed = 1;
      }
    }
  }
  return changed;
}

// grid: P's hysteresis blocks, in clusters of the launch's c along x. Level
// l's blocks start at its block_begin: (image b, rank r) is block
// block_begin + b * ranks + r; blocks past the last level's are idle pads.
__global__ void canny_pyramid_hysteresis(const __grid_constant__ Pyramid P,
                                         const uint32_t* __restrict__ planes,
                                         uint8_t* __restrict__ edges, int* __restrict__ passes) {
  extern __shared__ uint32_t smem[];
  const int bx = blockIdx.x;
  int l = -1;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (i < P.levels && bx >= P.lv[i].block_begin &&
        bx < P.lv[i].block_begin + P.batch * P.lv[i].ranks)
      l = i;
  }
  if (l < 0) return;  // a pad of the last cluster of one-block images
  const PyrLevel L = level_at(P, l);
  const int b = (bx - L.block_begin) / L.ranks, rank = bx - L.block_begin - b * L.ranks;
  const int h = L.h, w = L.w, words = L.words, pitch = words + 2;
  const int r0 = rank * L.band, rows = max(0, min(L.band, h - r0));
  uint32_t* W = smem;
  uint32_t* Ew = smem + (L.band + 2) * pitch;  // the same offset in every block of the level
  volatile uint32_t* E = Ew;
  int* flags = reinterpret_cast<int*>(smem + 2 * (L.band + 2) * pitch);  // [parity][rank]
  const size_t first = (size_t)b * h * words + (size_t)r0 * words;
  const uint32_t* weak = planes + L.word_off + first;
  load_band(weak, weak + P.plane, rows, words, W, E);

  const long long cap = (long long)h * w;
  long long pass = 0;
  if (L.ranks == 1) {
    __syncthreads();
    while (pass < cap) {
      const int changed = sweep<false>(W, E, rows, words, E, E);
      ++pass;
      if (!__syncthreads_or(changed)) break;
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every band is loaded
    // the neighbours' boundary rows: the last row of the band above, the
    // first of the band below (a band above this one is full: `band` rows)
    const volatile uint32_t* up =
        rank > 0 ? cluster.map_shared_rank(Ew, rank - 1) + L.band * pitch : Ew;
    const volatile uint32_t* down =
        r0 + rows < h ? cluster.map_shared_rank(Ew, rank + 1) + pitch : Ew + (rows + 1) * pitch;
    while (pass < cap) {
      const int changed = __syncthreads_or(sweep<true>(W, E, rows, words, up, down));
      int* slot = flags + (int)(pass & 1) * rgbd::kMaxCluster + rank;
      if ((int)threadIdx.x < L.ranks) *cluster.map_shared_rank(slot, threadIdx.x) = changed;
      ++pass;
      cluster.sync();  // this pass's words and flags are visible to every band
      int any = 0;
      for (int q = 0; q < L.ranks; ++q) any |= slot[q - rank];
      if (!any) break;
    }
  }
  store_band(E, rows, w, pitch, edges + L.edge_off + (size_t)b * h * w + (size_t)r0 * w);
  if (passes != nullptr && rank == 0 && threadIdx.x == 0) passes[l * P.batch + b] = (int)pass;
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every level of B images: level l's (B, H_l, W_l) float32 images start at
// imgs[l] (contiguous), with H_l = hw[2 l] and W_l = hw[2 l + 1]; its (B,
// H_l, ceil(W_l / 32)) packed words start word_off[l] words into each of the
// two planes (weak at `planes`, strong `plane` words after it), its (B, H_l,
// W_l) edge bytes edge_off[l] bytes into `edges`. ranks[l] is 1 (one
// hysteresis block an image) or `cluster` (a cluster of that many blocks, 2,
// 4 or 8, a band of rows each); `cluster` is 1 when every level is one
// block. passes (L, B) int32 gets each fixpoint's pass count, or is null.
// Launches on `stream` and does not synchronize; low2 <= high2 are the
// squared thresholds.
extern "C" int canny_pyramid(int device, int levels, int batch, const long long* imgs,
                             const int* hw, const int* ranks, int cluster,
                             const long long* word_off, const long long* edge_off,
                             long long plane, void* planes, void* edges, void* passes, float low2,
                             float high2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > kMaxLevels || batch < 1 || batch > 65535 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return (int)cudaErrorInvalidValue;
  Pyramid P{};
  P.levels = levels;
  P.batch = batch;
  P.plane = plane;
  P.low2 = low2;
  P.high2 = high2;
  int tiles = 0, threads = 64;
  long long smem = 0, blocks = 0;
  for (int pass = 0; pass < 2; ++pass) {  // the clustered levels' blocks first
    for (int l = 0; l < levels; ++l) {
      PyrLevel& L = P.lv[l];
      if ((ranks[l] > 1) != (pass == 0)) continue;
      if (ranks[l] != 1 && ranks[l] != cluster) return (int)cudaErrorInvalidValue;
      L.img = reinterpret_cast<const float*>(imgs[l]);
      L.h = hw[2 * l];
      L.w = hw[2 * l + 1];
      if (L.h < 1 || L.w < 1) return (int)cudaErrorInvalidValue;
      L.words = (L.w + kTileW - 1) / kTileW;
      L.tiles_x = L.words;
      L.word_off = word_off[l];
      L.edge_off = edge_off[l];
      L.ranks = ranks[l];
      // a band: the rows of one of `ranks` blocks, a multiple of kChunk
      L.band = L.ranks == 1 ? L.h : ((L.h + L.ranks - 1) / L.ranks + kChunk - 1) / kChunk * kChunk;
      L.block_begin = (int)blocks;
      blocks += (long long)batch * L.ranks;
      // the two planes of a band with their guard ring (and a band's flags);
      // a thread per unit of a pass and at least one per 4 words for the
      // loads and the byte writes
      const long long need = 2LL * (L.band + 2) * (L.words + 2) * (long long)sizeof(uint32_t) +
                             (L.ranks > 1 ? 2 * rgbd::kMaxCluster * (long long)sizeof(int) : 0);
      smem = need > smem ? need : smem;
      const int units = L.words * ((L.band + kChunk - 1) / kChunk);
      const int work = units > L.band * L.words / 4 ? units : L.band * L.words / 4;
      const int t = ((work + 31) / 32) * 32;
      threads = t > threads ? t : threads;
    }
  }
  for (int l = 0; l < levels; ++l) {  // the front grid's tiles, in level order
    PyrLevel& L = P.lv[l];
    L.tile_begin = tiles;
    tiles += L.tiles_x * ((L.h + kTileRows - 1) / kTileRows);
  }
  if (smem > (long long)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  blocks = (blocks + cluster - 1) / cluster * cluster;  // pads to whole clusters
  threads = threads > kMaxHystThreads ? kMaxHystThreads : threads;
  cudaStream_t s = (cudaStream_t)stream;
  canny_pyramid_front<<<dim3(tiles, batch), dim3(kTileW, kBlockH), 0, s>>>(P, (uint32_t*)planes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static rgbd::ClusterLaunch state;
  return (int)rgbd::launch_cluster(canny_pyramid_hysteresis, device, dim3((unsigned)blocks),
                                   dim3(threads), smem, cluster, s, &state, P,
                                   (const uint32_t*)planes, (uint8_t*)edges, (int*)passes);
}
