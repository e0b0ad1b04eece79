// Keyframe edge-point extraction of a pyramid of B images, for Hopper.
//
// Replaces the XLA ops of rgbd_odometry_tpu/solvers/edge_dvo.py
// `extract_ref_level` (:100-185) over every level, as `extract_ref_features`
// (:910) runs it: the predicate mask = edge & depth > min_depth, the top-k of
// score = mask + priority (the exact branch: one top-k over all n pixels;
// the segmented branch, taken when n >= 8 k: the top 32 of every 256-pixel
// segment, then the top k of those candidates), and the back-projection of
// the chosen pixels. One C entry, `extract_pyramid`, does every level of B
// images in one launch, one block per (level, image); the level table is
// passed by value, as canny.cu's is.
//
// No sort. priority = (perm + 0.5) / n for a fixed permutation perm of the
// n pixels (np.random.default_rng(n)), so the priorities are 1/n apart; for
// n < 2^22 that is more than two float32 ulps of 1 + priority (2^-23 each),
// so every score is distinct and the order by score is exactly the order by
// the pair (mask, perm). A top-k is then a stable partition of the pixels
// taken in descending priority: first the pixels in the class "high", in
// that order, then those in the class "low", cut at k. The host uploads
// each level's `order` once (pixel indices by descending perm) and, for the
// segmented branch, `seg` (each segment's offsets by descending perm), and
// the kernel needs only prefix sums:
//
//   exact      high = mask, low = not mask. A high pixel's slot is the
//              number of high pixels before it in `order`; a low pixel's is
//              E + the number of low pixels before it, E the level's mask
//              count. count = min(E, k).
//   segmented  a pixel is a candidate when its rank by (mask, perm) inside
//              its segment is below 32; high = candidate & mask, low =
//              candidate & not mask, then the same partition with E the
//              number of high candidates. count = min(E, k), which is
//              sum(valid) here. The zero pads of a last partial segment
//              (s segments, r real pixels in the last) are never chosen:
//              the real candidates number 32 (s - 1) + min(r, 32) >=
//              32 (s - 1) + r / 8 = n / 8 >= k, and every real score is
//              above a pad's 0.
//
// A block of 1024 threads per (level, image) runs three phases over two
// shared-memory tables: the class words, a (high, low) pair of 32-pixel
// bitmaps per word, and a staging buffer of one chunk's slots:
//   (1) one pass over the image in row-major order: the mask into the high
//       words (exact: its complement into the low words), a lane reading 16
//       pixels' edges in one 16-byte load with the next 16 in flight (a warp
//       32 bytes a word where the level is not 16-byte aligned), the depth
//       read only under an edge;
//   (2) segmented only, a warp per 256-pixel segment: with m <= 32 high
//       pixels in the segment (rendered frames, almost always) every high
//       pixel is a candidate and the lows are the first 32 - m among the
//       segment's first 32 offsets, one a lane; else the first 32 high
//       pixels of its 256 offsets, 8 a lane; the segment's 8 class words
//       become (candidate & mask, candidate & ~mask), each a warp OR;
//   (3) the block streams `order` in chunks of 16384 entries, 16
//       consecutive a thread: one class lookup each, one block-wide
//       exclusive scan of the packed (high, low) counts; the chunk's pixels
//       that get a slot are staged in slot order and the block writes the
//       slots, consecutive threads on consecutive slots. It stops once the
//       first min(E, k) high and the first max(k - E, 0) low pixels are
//       placed, which every slot is then.
//
// Back-projection, as the plain PyTorch version computes it on the card
// (torch divides a CUDA tensor by a CPU scalar as a product with the
// scalar's float32 reciprocal): xs = idx % w, ys = idx / w as float; z =
// (valid ? depth : 0) * (1 / 1000); x3 = z * (xs - cx) * (1 / fx), y3 the
// same with cy and fy, each operation once-rounded (__fsub_rn, __fmul_rn,
// __fdiv_rn for the reciprocals) so that nvcc cannot contract them. Every
// output is bitwise the plain version's.
//
// What bounds it on the H100: every image's edge map (1 byte a pixel) and
// the depth under its edges are read once, `order` (4 bytes a pixel) once
// per image from L2, and k slots of 21 bytes written. One block owns an
// image, so the launch costs its level-0 block's latency whatever B, most
// of it in phase 3 (at 320x240 five chunks, each a scan, a staging pass and
// four barriers).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // consecutive entries of `order` per thread and chunk: four int4
constexpr int kChunk = kThreads * kItems;
constexpr int kSeg = 256;
constexpr int kSegKeep = 32;
constexpr int kMaxDynamicSmem = 227 * 1024;

struct ExLevel {
  const uint8_t* edges;  // (B, H, W) bool
  const float* depth;    // (B, H, W) float32 millimetres
  const int* order;      // (n4,) pixel indices by descending priority, -1 past n
  const uint8_t* seg;    // (S * 256,) offsets by descending priority per segment; null: exact
  float* pts3d;          // (B, K, 3)
  float* uv;             // (B, K, 2)
  uint8_t* valid;        // (B, K)
  int* count;            // (B,)
  int w, n, n4, k;       // n = H * W pixels, n4 = n rounded up to 4, k slots
  float fx, fy, cx, cy;
};

struct ExPyramid {
  ExLevel lv[kMaxLevels];
  int levels;
  int words;  // class words: the largest level's 8 per 256-pixel segment
  float min_depth;
};

// Level `l` of the table, selected with constant indices only (a dynamic
// index into a kernel parameter would copy the table to local memory).
__device__ __forceinline__ ExLevel level_at(const ExPyramid& P, int l) {
  ExLevel L = P.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) L = P.lv[i];
  return L;
}

// Inclusive prefix sum of `v` over the 32 lanes of a warp.
__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// Exclusive prefix sum of `v` over the block, and the block's `total`.
// `scratch` holds kWarps ints; a caller that scans again before every
// thread has read this scan's result uses another scratch (two barriers).
__device__ __forceinline__ int block_exclusive(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = warp_inclusive(v);
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = warp_inclusive(lane < kWarps ? scratch[lane] : 0);
    if (lane < kWarps) scratch[lane] = s;
  }
  __syncthreads();
  total = scratch[kWarps - 1];
  return (warp > 0 ? scratch[warp - 1] : 0) + x - v;
}

// Slot `pos` of image `b`: pixel `p`, valid when `high`, at depth `zr` (mm).
__device__ __forceinline__ void emit(const ExLevel& L, int b, int pos, int p, bool high, float zr,
                                     float inv_mm, float inv_fx, float inv_fy) {
  const int y = p / L.w, x = p - y * L.w;
  const float xs = (float)x, ys = (float)y;
  const float z = __fmul_rn(zr, inv_mm);
  const size_t slot = (size_t)b * L.k + pos;
  float* o = L.pts3d + slot * 3;
  o[0] = __fmul_rn(__fmul_rn(z, __fsub_rn(xs, L.cx)), inv_fx);
  o[1] = __fmul_rn(__fmul_rn(z, __fsub_rn(ys, L.cy)), inv_fy);
  o[2] = z;
  L.uv[slot * 2] = xs;
  L.uv[slot * 2 + 1] = ys;
  L.valid[slot] = high ? 1 : 0;
}

// The bits of the `n_real` pixels of a 32-pixel word that lie in the image.
__device__ __forceinline__ uint32_t real_bits(int n_real) {
  return n_real >= 32 ? 0xffffffffu : (n_real > 0 ? (1u << n_real) - 1u : 0u);
}

// Segment `s` of a segmented level (`row`: its 256 offsets by descending
// priority): rewrite its 8 class words, cls[w].x = mask on entry, to (high,
// low) = (candidate & mask, candidate & ~mask), a pixel being a candidate
// when its rank by (mask, perm) inside the segment is below 32. With m <= 32
// high pixels (rendered frames, almost always) every high pixel is one and
// the lows are the first 32 - m among the segment's first 32 offsets, one a
// lane; else the candidates are the first 32 high pixels of the 256 offsets,
// 8 a lane. Returns, on lane 0, min(m, 32), else 0.
__device__ __forceinline__ int segment_candidates(const uint8_t* row, int s, int n, uint2* cls) {
  const int lane = threadIdx.x & 31;
  const uint32_t mword = lane < 8 ? cls[s * 8 + lane].x : 0u;  // lanes 0-7: a word each
  const int m = __reduce_add_sync(0xffffffffu, __popc(mword));
  uint32_t keep = 0;  // lanes 0-7: the candidate bits of their word
  if (m <= kSegKeep) {
    const int off = row[lane];
    const int p = s * kSeg + off;
    const bool low = p < n && !((cls[p >> 5].x >> (p & 31)) & 1u);
    const uint32_t lows = __ballot_sync(0xffffffffu, low);
    const bool take = low && __popc(lows & ((1u << lane) - 1u)) < kSegKeep - m;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint32_t word =
          __reduce_or_sync(0xffffffffu, take && (off >> 5) == w ? 1u << (off & 31) : 0u);
      if (lane == w) keep = word | mword;
    }
  } else {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row) + lane);
    int off[8];
    uint32_t high = 0;  // bit i: item i is a high pixel
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      off[i] = (int)(((i < 4 ? raw.x : raw.y) >> (8 * (i & 3))) & 0xffu);
      const int p = s * kSeg + off[i];
      if (p < n && ((cls[p >> 5].x >> (p & 31)) & 1u)) high |= 1u << i;
    }
    const int before_lane = warp_inclusive(__popc(high)) - __popc(high);
    uint32_t part[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};  // this lane's bits of the 8 words
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool take = ((high >> i) & 1u) && before_lane + __popc(high & ((1u << i) - 1u)) <
                                                   kSegKeep;
      const uint32_t b = take ? 1u << (off[i] & 31) : 0u;
#pragma unroll
      for (int w = 0; w < 8; ++w) part[w] |= (off[i] >> 5) == w ? b : 0u;
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint32_t word = __reduce_or_sync(0xffffffffu, part[w]);
      if (lane == w) keep = word;
    }
  }
  if (lane < 8) cls[s * 8 + lane] = make_uint2(mword & keep, keep & ~mword);
  return lane == 0 ? (m < kSegKeep ? m : kSegKeep) : 0;
}

// This thread's kItems consecutive entries of `order` from entry `c` on
// (int4 loads; -1 past the table).
__device__ __forceinline__ void load_entries(const ExLevel& L, int c, int* px) {
  const int4* order4 = reinterpret_cast<const int4*>(L.order);
#pragma unroll
  for (int j = 0; j < kItems / 4; ++j) {
    const int q = ((c + (int)threadIdx.x * kItems) >> 2) + j;
    const int4 v = q < (L.n4 >> 2) ? __ldg(order4 + q) : make_int4(-1, -1, -1, -1);
    px[4 * j] = v.x;
    px[4 * j + 1] = v.y;
    px[4 * j + 2] = v.z;
    px[4 * j + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads) extract_pyramid_kernel(const ExPyramid P) {
  extern __shared__ uint2 smem[];
  uint2* cls = smem;  // P.words (high, low) class words: 8 a 256-pixel segment
  int* staged = reinterpret_cast<int*>(smem + P.words);  // kChunk pixels in slot order
  int* scratch = staged + kChunk;                         // 3 x kWarps
  const ExLevel L = level_at(P, blockIdx.y);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t img = (size_t)b * L.n;
  const uint8_t* edges = L.edges + img;
  const float* depth = L.depth + img;
  const int words = (L.n + 31) >> 5;
  const int segs = (L.n + kSeg - 1) / kSeg;
  const bool segmented = L.seg != nullptr;

  // (1) the mask into cls[].x (and, exact, its complement in the image into
  // cls[].y); E counts the high pixels. Where the image is 16-byte aligned
  // and n a multiple of 16 a lane reads 16 pixels' edges in one load, the
  // next 16 in flight, and two lanes form a word; else a warp reads a word's
  // 32 bytes. The depth is read only under an edge.
  int e_local = 0;
  if ((L.n & 15) == 0 && (reinterpret_cast<uintptr_t>(edges) & 15) == 0) {
    const uint4* e16 = reinterpret_cast<const uint4*>(edges);
    const int groups = L.n >> 4;
    const uint4 none = make_uint4(0u, 0u, 0u, 0u);
    uint4 v = warp * 32 + lane < groups ? __ldg(e16 + warp * 32 + lane) : none;
    for (int g0 = warp * 32; g0 < groups; g0 += kThreads) {
      const int g = g0 + lane;
      const uint4 vn = g + kThreads < groups ? __ldg(e16 + g + kThreads) : none;  // the next
      uint32_t bits = 0;
      if (g < groups) {
        const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if ((q[i >> 2] >> (8 * (i & 3))) & 0xffu) {
            if (__ldg(depth + 16 * g + i) > P.min_depth) bits |= 1u << i;
          }
        }
      }
      const uint32_t hi = __shfl_down_sync(0xffffffffu, bits, 1);
      if ((lane & 1) == 0 && g < groups) {
        const uint32_t word = bits | (hi << 16);
        cls[g >> 1] = make_uint2(word, ~word & real_bits(L.n - 16 * g));
        e_local += segmented ? 0 : __popc(word);
      }
      v = vn;
    }
  } else {
    for (int p = tid; p < words * 32; p += kThreads) {
      bool m = false;
      if (p < L.n && edges[p]) m = __ldg(depth + p) > P.min_depth;
      const uint32_t word = __ballot_sync(0xffffffffu, m);
      if (lane == 0) {
        cls[p >> 5] = make_uint2(word, ~word & real_bits(L.n - p));
        e_local += segmented ? 0 : __popc(word);
      }
    }
  }
  for (int w = words + tid; w < segs * 8; w += kThreads) cls[w] = make_uint2(0u, 0u);
  __syncthreads();

  // (2) segmented: the top 32 of every segment by (mask, perm), a warp a
  // segment
  if (segmented) {
    for (int s = warp; s < segs; s += kWarps) {
      e_local += segment_candidates(L.seg + (size_t)s * kSeg, s, L.n, cls);
    }
    __syncthreads();
  }
  int E;
  block_exclusive(e_local, scratch, E);

  // (3) the stable partition in priority order, a chunk at a time: the
  // chunk's high then low pixels that get a slot are staged in shared memory
  // in slot order, and the block writes their slots, consecutive threads on
  // consecutive slots
  const int k = L.k;
  const int need_high = E < k ? E : k, need_low = E < k ? k - E : 0;
  const float inv_mm = __fdiv_rn(1.0f, 1000.0f);
  const float inv_fx = __fdiv_rn(1.0f, L.fx), inv_fy = __fdiv_rn(1.0f, L.fy);
  int taken_high = 0, taken_low = 0;
  for (int c = 0, it = 1; (taken_high < need_high || taken_low < need_low) && c < L.n4;
       c += kChunk, ++it) {
    int px[kItems];
    load_entries(L, c, px);
    uint32_t high = 0, low = 0;  // bit i: entry i is a high / low pixel
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = px[i];
      if (p >= 0) {
        const uint2 v = cls[p >> 5];
        high |= ((v.x >> (p & 31)) & 1u) << i;
        low |= ((v.y >> (p & 31)) & 1u) << i;
      }
    }
    int total;
    const int ex = block_exclusive(__popc(high) | __popc(low) << 16,
                                   scratch + (it & 1) * kWarps + kWarps, total);
    const int chunk_high = total & 0xffff, chunk_low = total >> 16;
    const int put_high = min(max(need_high - taken_high, 0), chunk_high);
    const int put_low = min(max(need_low - taken_low, 0), chunk_low);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const uint32_t before = (1u << i) - 1u;
      if ((high >> i) & 1u) {
        const int j = (ex & 0xffff) + __popc(high & before);
        if (j < put_high) staged[j] = px[i];
      } else if ((low >> i) & 1u) {
        const int j = (ex >> 16) + __popc(low & before);
        if (j < put_low) staged[put_high + j] = px[i];
      }
    }
    __syncthreads();
    for (int j = tid; j < put_high + put_low; j += kThreads) {
      const bool is_high = j < put_high;
      const int p = staged[j];
      emit(L, b, is_high ? taken_high + j : E + taken_low + (j - put_high), p, is_high,
           is_high ? __ldg(depth + p) : 0.0f, inv_mm, inv_fx, inv_fy);
    }
    __syncthreads();  // the next chunk restages
    taken_high += chunk_high;
    taken_low += chunk_low;
  }
  if (tid == 0) L.count[b] = need_high;
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every level of B images. ptrs[8 l .. 8 l + 7] are level l's views:
// edges (B, H, W) bool and depth (B, H, W) float32, contiguous; order (n4,)
// int32 and seg (ceil(n / 256) * 256,) uint8, or 0 for the exact branch;
// outputs pts3d (B, K, 3) and uv (B, K, 2) float32, valid (B, K) bool,
// count (B,) int32. dims[4 l ..] = H, W, K, n4; intr[4 l ..] = fx, fy, cx,
// cy. Launches on `stream` and does not synchronize.
extern "C" int extract_pyramid(int device, int levels, int batch, const long long* ptrs,
                               const int* dims, const float* intr, float min_depth,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > kMaxLevels || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  ExPyramid P{};
  P.levels = levels;
  P.min_depth = min_depth;
  int words = 1;
  for (int l = 0; l < levels; ++l) {
    ExLevel& L = P.lv[l];
    const int h = dims[4 * l], w = dims[4 * l + 1];
    L.w = w;
    L.n = h * w;
    L.k = dims[4 * l + 2];
    L.n4 = dims[4 * l + 3];
    if (h < 1 || w < 1 || L.k < 1 || L.k > L.n || L.n4 < L.n || (L.n4 & 3)) {
      return (int)cudaErrorInvalidValue;
    }
    const long long* q = ptrs + 8 * l;
    L.edges = reinterpret_cast<const uint8_t*>(q[0]);
    L.depth = reinterpret_cast<const float*>(q[1]);
    L.order = reinterpret_cast<const int*>(q[2]);
    L.seg = reinterpret_cast<const uint8_t*>(q[3]);
    L.pts3d = reinterpret_cast<float*>(q[4]);
    L.uv = reinterpret_cast<float*>(q[5]);
    L.valid = reinterpret_cast<uint8_t*>(q[6]);
    L.count = reinterpret_cast<int*>(q[7]);
    L.fx = intr[4 * l];
    L.fy = intr[4 * l + 1];
    L.cx = intr[4 * l + 2];
    L.cy = intr[4 * l + 3];
    const int lw = (L.n + kSeg - 1) / kSeg * (kSeg / 32);  // whole segments
    words = lw > words ? lw : words;
  }
  P.words = words;
  const long long smem = 8LL * words + 4LL * (kChunk + 3 * kWarps);
  if (smem > (long long)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  static rgbd::SharedOptIn opted;
  err = rgbd::opt_in_shared(extract_pyramid_kernel, device, smem, &opted);
  if (err != cudaSuccess) return (int)err;
  extract_pyramid_kernel<<<dim3(batch, levels), kThreads, (size_t)smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
