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
// A cluster of c blocks of 1024 threads (c in {1, 2, 4, 8}, one c a launch,
// chosen by the wrapper from the largest level, the levels and B) owns one
// (level, image). Rank r of the cluster computes the class words of the
// r-th contiguous range of the level's 256-pixel segments, a (high, low)
// pair of 32-pixel bitmaps per word, in its shared memory beside a staging
// buffer of one chunk's slots:
//   (1) one pass over the rank's pixels in row-major order: the mask into
//       the high words (exact: its complement into the low words), a lane
//       reading 16 pixels' edges in one 16-byte load with the next 16 in
//       flight (a warp 32 bytes a word where the level is not 16-byte
//       aligned), the depth read only under an edge;
//   (2) segmented only, a warp per 256-pixel segment of the rank: with m <=
//       32 high pixels in the segment (rendered frames, almost always) every
//       high pixel is a candidate and the lows are the first 32 - m among
//       the segment's first 32 offsets, one a lane; else the first 32 high
//       pixels of its 256 offsets, 8 a lane; the segment's 8 class words
//       become (candidate & mask, candidate & ~mask), each a warp OR. E, the
//       level's high count, is summed over the ranks behind a cluster
//       barrier. Where the largest level's words fit one block beside a
//       chunk (up to ~800k pixels) every rank then copies the other ranks'
//       words from their shared memory, 16 bytes a load, and looks every
//       pixel up in its own copy; past that each rank keeps its share and a
//       lookup goes to the rank that holds the word through distributed
//       shared memory (~1 ns a lookup: what the larger levels pay);
//   (3) rank r takes the r-th contiguous range of `order`. With c > 1, pass
//       A counts the range's high and low pixels, the ranks publish their
//       counts, and behind a second cluster barrier each rank sums the
//       counts of the ranks before it: the number of high and low pixels
//       that come before its range in priority order. Pass B streams the
//       range in chunks of 16384 entries from those offsets, 16 consecutive
//       a thread (8192 and 8 where the class words leave too little room to
//       stage 16384: a level above ~650k pixels, one copy a rank): one class
//       lookup each, one block-wide exclusive scan of the packed (high, low)
//       counts; the chunk's pixels that get a slot are staged in slot order
//       and the block writes the slots, consecutive threads on consecutive
//       slots. It stops once its range is done or the first min(E, k) high
//       and the first max(k - E, 0) low pixels are placed; a rank whose
//       offsets are already past both streams nothing. A last cluster
//       barrier keeps every rank's words alive until no rank reads them.
//
// Why the cluster is bitwise the one block: the slots are a stable
// partition of `order` into high then low pixels, and a pixel's slot is the
// number of pixels of its class before it in `order` (plus E for a low
// one). The ranks' ranges are consecutive pieces of `order`, so that number
// is the count in the earlier ranges, which the scan of pass A's counts
// gives, plus the count before it in its own range, which pass B's chunk
// scans give exactly as the one block's do. The class words are the same
// bits wherever they are held. c = 1 is the one-block kernel: no pass A and
// no cluster barrier.
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
// per image from L2, and k slots of 21 bytes written. With one block an
// image the launch costs its level-0 block's latency whatever B, most of it
// in phase 3 (at 320x240 five chunks, each a scan, a staging pass and four
// barriers); a cluster of c cuts phases 1-3 by c for three cluster barriers,
// the copy of the words and pass A's count, which pays where the images are
// few (on an H100 80GB HBM3 at 700 W, B = 1, c = 8: 39 -> 15.5 us at
// 320x240, 140 -> 35 us at 640x480) and loses where one block an image
// already fills the card (B = 64). The level size is bounded by n < 2^22 (distinct priorities) and by a
// rank's share of the class words and one staged chunk fitting 227 KB: with
// c = 8 any level below 2^22 pixels does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// consecutive entries of `order` per thread and chunk (four int4s), and the
// chunk; a launch whose ranks' class words leave too little shared memory
// for that chunk's staging takes half of it (8 entries, two int4s); where
// both fit the full chunk is 5-10% faster a launch (PERF.md §6)
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;
constexpr int kItemsLarge = kItems / 2;
constexpr int kSeg = 256;
constexpr int kSegKeep = 32;
constexpr int kMaxDynamicSmem = 227 * 1024;
constexpr int kMail = 4;  // a rank's published ints: E, pass A's high and low counts

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
  int segs_per_rank;     // consecutive segments whose class words a rank holds
  int entries_per_rank;  // consecutive entries of `order` a rank streams (a multiple of 16)
  float fx, fy, cx, cy;
};

struct ExPyramid {
  ExLevel lv[kMaxLevels];
  int levels;
  int ranks;       // c, blocks a (level, image)
  int replicated;  // every rank holds all the class words (else only its share's)
  int words;       // class words a rank holds: 8 a segment of the largest level (or its share)
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
// priority): rewrite its 8 class words (class word w at cls[w - base]),
// cls[].x = mask on entry, to (high, low) = (candidate & mask, candidate &
// ~mask), a pixel being a candidate when its rank by (mask, perm) inside
// the segment is below 32. With m <= 32 high pixels (rendered frames, almost
// always) every high pixel is one and the lows are the first 32 - m among
// the segment's first 32 offsets, one a lane; else the candidates are the
// first 32 high pixels of the 256 offsets, 8 a lane. Returns, on lane 0,
// min(m, 32), else 0.
__device__ __forceinline__ int segment_candidates(const uint8_t* row, int s, int n, uint2* cls,
                                                  int base) {
  const int lane = threadIdx.x & 31;
  const uint32_t mword = lane < 8 ? cls[s * 8 + lane - base].x : 0u;  // lanes 0-7: a word each
  const int m = __reduce_add_sync(0xffffffffu, __popc(mword));
  uint32_t keep = 0;  // lanes 0-7: the candidate bits of their word
  if (m <= kSegKeep) {
    const int off = row[lane];
    const int p = s * kSeg + off;
    const bool low = p < n && !((cls[(p >> 5) - base].x >> (p & 31)) & 1u);
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
      if (p < n && ((cls[(p >> 5) - base].x >> (p & 31)) & 1u)) high |= 1u << i;
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
  if (lane < 8) cls[s * 8 + lane - base] = make_uint2(mword & keep, keep & ~mword);
  return lane == 0 ? (m < kSegKeep ? m : kSegKeep) : 0;
}

// This thread's ITEMS consecutive entries of `order` from entry `c` on
// (int4 loads; -1 at and past entry `end`, a multiple of 4).
template <int ITEMS>
__device__ __forceinline__ void load_entries(const ExLevel& L, int c, int end, int* px) {
  const int4* order4 = reinterpret_cast<const int4*>(L.order);
#pragma unroll
  for (int j = 0; j < ITEMS / 4; ++j) {
    const int q = ((c + (int)threadIdx.x * ITEMS) >> 2) + j;
    const int4 v = q < (end >> 2) ? __ldg(order4 + q) : make_int4(-1, -1, -1, -1);
    px[4 * j] = v.x;
    px[4 * j + 1] = v.y;
    px[4 * j + 2] = v.z;
    px[4 * j + 3] = v.w;
  }
}

// The class words of the ITEMS pixels `px` (-1: none) as two bitmaps, bit
// i for entry i: high and low. Class word w lies in this block's own `cls`
// at index w, or with `remote` in rank w / words_per_rank at index w %
// words_per_rank.
template <int ITEMS>
__device__ __forceinline__ void classes(const int* px, const uint2* cls, bool remote, int ranks,
                                        int words_per_rank, uint32_t& high, uint32_t& low) {
  high = 0;
  low = 0;
  if (!remote) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = px[i];
      if (p >= 0) {
        const uint2 v = cls[p >> 5];
        high |= ((v.x >> (p & 31)) & 1u) << i;
        low |= ((v.y >> (p & 31)) & 1u) << i;
      }
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int p = px[i];
    if (p >= 0) {
      const int w = p >> 5;
      int r = 0;  // w / words_per_rank, with ranks <= 8
#pragma unroll
      for (int j = 1; j < rgbd::kMaxCluster; ++j) r += j < ranks && w >= j * words_per_rank;
      const uint2 v = *cluster.map_shared_rank(cls + (w - r * words_per_rank), r);
      high |= ((v.x >> (p & 31)) & 1u) << i;
      low |= ((v.y >> (p & 31)) & 1u) << i;
    }
  }
}

// The sum of `v` over the block (every thread gets it); `scratch` holds
// kWarps ints and is free again when this returns.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int total = __reduce_add_sync(0xffffffffu, lane < kWarps ? scratch[lane] : 0);
  __syncthreads();
  return total;
}

// grid (B * c, L) in clusters of (c, 1, 1): cluster b of row l is (level l,
// image b), its block of rank r the r-th share.
template <int ITEMS>
__global__ void __launch_bounds__(kThreads) extract_pyramid_kernel(const ExPyramid P) {
  constexpr int CHUNK = kThreads * ITEMS;
  extern __shared__ __align__(16) uint2 smem[];
  uint2* cls = smem;  // P.words (high, low) class words: 8 a 256-pixel segment
  int* staged = reinterpret_cast<int*>(smem + P.words);  // CHUNK pixels in slot order
  int* scratch = staged + CHUNK;                          // 3 x kWarps
  int* mail = scratch + 3 * kWarps;                       // kMail: what this rank publishes
  const ExLevel L = level_at(P, blockIdx.y);
  const int ranks = P.ranks;
  const int b = blockIdx.x / ranks, rank = blockIdx.x - b * ranks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t img = (size_t)b * L.n;
  const uint8_t* edges = L.edges + img;
  const float* depth = L.depth + img;
  const int segs = (L.n + kSeg - 1) / kSeg;
  const bool segmented = L.seg != nullptr;
  // this rank's segments [s_lo, s_hi): pixels [px_lo, px_hi), class words
  // from `base` on (0 where every rank holds every word)
  const int s_lo = min(rank * L.segs_per_rank, segs);
  const int s_hi = min(s_lo + L.segs_per_rank, segs);
  const bool remote = ranks > 1 && !P.replicated;  // class lookups in other ranks
  const int base = remote ? s_lo * (kSeg / 32) : 0;
  const int px_lo = s_lo * kSeg, px_hi = min(s_hi * kSeg, L.n);
  const int words_hi = (px_hi + 31) >> 5;  // the words holding real pixels end here

  // (1) the mask into cls[].x (and, exact, its complement in the image into
  // cls[].y); E counts the high pixels. Where the image is 16-byte aligned
  // and n a multiple of 16 a lane reads 16 pixels' edges in one load, the
  // next 16 in flight, and two lanes form a word; else a warp reads a word's
  // 32 bytes. The depth is read only under an edge.
  int e_local = 0;
  if ((L.n & 15) == 0 && (reinterpret_cast<uintptr_t>(edges) & 15) == 0) {
    const uint4* e16 = reinterpret_cast<const uint4*>(edges);
    const int g_lo = px_lo >> 4, groups = (px_hi - px_lo) >> 4;
    const uint4 none = make_uint4(0u, 0u, 0u, 0u);
    uint4 v = warp * 32 + lane < groups ? __ldg(e16 + g_lo + warp * 32 + lane) : none;
    for (int g0 = warp * 32; g0 < groups; g0 += kThreads) {
      const int gl = g0 + lane, g = g_lo + gl;
      const uint4 vn = gl + kThreads < groups ? __ldg(e16 + g + kThreads) : none;  // the next
      uint32_t bits = 0;
      if (gl < groups) {
        const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if ((q[i >> 2] >> (8 * (i & 3))) & 0xffu) {
            if (__ldg(depth + 16 * g + i) > P.min_depth) bits |= 1u << i;
          }
        }
      }
      const uint32_t hi = __shfl_down_sync(0xffffffffu, bits, 1);
      if ((lane & 1) == 0 && gl < groups) {
        const uint32_t word = bits | (hi << 16);
        cls[(g >> 1) - base] = make_uint2(word, ~word & real_bits(L.n - 16 * g));
        e_local += segmented ? 0 : __popc(word);
      }
      v = vn;
    }
  } else {
    for (int p = px_lo + tid; p < words_hi * 32; p += kThreads) {
      bool m = false;
      if (p < L.n && edges[p]) m = __ldg(depth + p) > P.min_depth;
      const uint32_t word = __ballot_sync(0xffffffffu, m);
      if (lane == 0) {
        cls[(p >> 5) - base] = make_uint2(word, ~word & real_bits(L.n - p));
        e_local += segmented ? 0 : __popc(word);
      }
    }
  }
  for (int w = max(words_hi, base) + tid; w < s_hi * 8; w += kThreads) {
    cls[w - base] = make_uint2(0u, 0u);  // a last partial segment's pad words
  }
  __syncthreads();

  // (2) segmented: the top 32 of every segment by (mask, perm), a warp a
  // segment
  if (segmented) {
    for (int s = s_lo + warp; s < s_hi; s += kWarps) {
      e_local += segment_candidates(L.seg + (size_t)s * kSeg, s, L.n, cls, base);
    }
    __syncthreads();
  }
  int E = block_sum(e_local, scratch);
  // the entries of `order` this rank streams: [e_lo, e_hi)
  const int e_lo = min(rank * L.entries_per_rank, L.n4);
  const int e_hi = min(e_lo + L.entries_per_rank, L.n4);
  const int words_per_rank = L.segs_per_rank * (kSeg / 32);
  int taken_high = 0, taken_low = 0;  // pixels of each class before this rank's range
  cg::cluster_group cluster = cg::this_cluster();
  if (ranks > 1) {
    if (tid == 0) mail[0] = E;
    cluster.sync();  // every rank's class words and E are in place
    E = 0;
    for (int r = 0; r < ranks; ++r) E += *cluster.map_shared_rank(mail, r);
    if (!remote) {  // copy the other ranks' shares: every lookup is then local
      uint4* own = reinterpret_cast<uint4*>(cls);
      for (int i = tid; i < segs * (kSeg / 64); i += kThreads) {
        int r = 0;  // (2 i) / words_per_rank, with ranks <= 8
#pragma unroll
        for (int j = 1; j < rgbd::kMaxCluster; ++j) {
          r += j < ranks && 2 * i >= j * words_per_rank;
        }
        if (r != rank) own[i] = *cluster.map_shared_rank(own + i, r);
      }
      __syncthreads();
    }
    // pass A: the range's high and low counts
    int n_high = 0, n_low = 0;
    for (int c = e_lo; c < e_hi; c += CHUNK) {
      int px[ITEMS];
      load_entries<ITEMS>(L, c, e_hi, px);
      uint32_t high, low;
      classes<ITEMS>(px, cls, remote, ranks, words_per_rank, high, low);
      n_high += __popc(high);
      n_low += __popc(low);
    }
    n_high = block_sum(n_high, scratch);
    n_low = block_sum(n_low, scratch);
    if (tid == 0) {
      mail[1] = n_high;
      mail[2] = n_low;
    }
    cluster.sync();  // every rank's counts are published
    for (int r = 0; r < rank; ++r) {
      taken_high += *cluster.map_shared_rank(mail + 1, r);
      taken_low += *cluster.map_shared_rank(mail + 2, r);
    }
  }

  // (3) pass B, the stable partition in priority order, a chunk at a time:
  // the chunk's high then low pixels that get a slot are staged in shared
  // memory in slot order, and the block writes their slots, consecutive
  // threads on consecutive slots
  const int k = L.k;
  const int need_high = E < k ? E : k, need_low = E < k ? k - E : 0;
  const float inv_mm = __fdiv_rn(1.0f, 1000.0f);
  const float inv_fx = __fdiv_rn(1.0f, L.fx), inv_fy = __fdiv_rn(1.0f, L.fy);
  for (int c = e_lo, it = 1; (taken_high < need_high || taken_low < need_low) && c < e_hi;
       c += CHUNK, ++it) {
    int px[ITEMS];
    load_entries<ITEMS>(L, c, e_hi, px);
    uint32_t high, low;  // bit i: entry i is a high / low pixel
    classes<ITEMS>(px, cls, remote, ranks, words_per_rank, high, low);
    int total;
    const int ex = block_exclusive(__popc(high) | __popc(low) << 16,
                                   scratch + (it & 1) * kWarps + kWarps, total);
    const int chunk_high = total & 0xffff, chunk_low = total >> 16;
    const int put_high = min(max(need_high - taken_high, 0), chunk_high);
    const int put_low = min(max(need_low - taken_low, 0), chunk_low);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
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
  if (rank == 0 && tid == 0) L.count[b] = need_high;
  if (ranks > 1) cluster.sync();  // no rank reads another's words past here
}

// Shared memory of a launch whose ranks hold `words` class words each and
// stage chunks of kThreads * ITEMS entries.
long long smem_bytes(int words, int items) {
  return 8LL * words + 4LL * (kThreads * items + 3 * kWarps + kMail);
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Every level of B images, in clusters of `ranks` blocks (1, 2, 4 or 8) a
// (level, image). ptrs[8 l .. 8 l + 7] are level l's views: edges (B, H, W)
// bool and depth (B, H, W) float32, contiguous; order (n4,) int32 and seg
// (ceil(n / 256) * 256,) uint8, or 0 for the exact branch; outputs pts3d
// (B, K, 3) and uv (B, K, 2) float32, valid (B, K) bool, count (B,) int32.
// dims[4 l ..] = H, W, K, n4; intr[4 l ..] = fx, fy, cx, cy. Launches on
// `stream` and does not synchronize.
extern "C" int extract_pyramid(int device, int levels, int batch, int ranks,
                               const long long* ptrs, const int* dims, const float* intr,
                               float min_depth, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > kMaxLevels || batch < 1 || batch > 65535 ||
      (ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8))
    return (int)cudaErrorInvalidValue;
  ExPyramid P{};
  P.levels = levels;
  P.ranks = ranks;
  P.min_depth = min_depth;
  int words = 1, share = 1;
  for (int l = 0; l < levels; ++l) {
    ExLevel& L = P.lv[l];
    const int h = dims[4 * l], w = dims[4 * l + 1];
    L.w = w;
    L.k = dims[4 * l + 2];
    L.n4 = dims[4 * l + 3];
    if (h < 1 || w < 1 || (long long)h * w >= (1LL << 22)) return (int)cudaErrorInvalidValue;
    L.n = h * w;
    if (L.k < 1 || L.k > L.n || L.n4 < L.n || (L.n4 & 3)) return (int)cudaErrorInvalidValue;
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
    const int segs = (L.n + kSeg - 1) / kSeg;
    L.segs_per_rank = (segs + ranks - 1) / ranks;
    L.entries_per_rank = ((L.n4 + ranks - 1) / ranks + kItems - 1) / kItems * kItems;
    words = segs * (kSeg / 32) > words ? segs * (kSeg / 32) : words;
    share = L.segs_per_rank * (kSeg / 32) > share ? L.segs_per_rank * (kSeg / 32) : share;
  }
  // every rank holds every class word where they fit beside a chunk (the
  // half chunk if need be), else only its share's
  P.replicated = smem_bytes(words, kItemsLarge) <= (long long)kMaxDynamicSmem;
  P.words = P.replicated ? words : share;
  words = P.words;
  const dim3 grid(batch * ranks, levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (smem_bytes(words, kItems) <= (long long)kMaxDynamicSmem) {
    static rgbd::ClusterLaunch state;
    return (int)rgbd::launch_cluster(extract_pyramid_kernel<kItems>, device, grid, kThreads,
                                     smem_bytes(words, kItems), ranks, s, &state, P);
  }
  if (smem_bytes(words, kItemsLarge) > (long long)kMaxDynamicSmem)
    return (int)cudaErrorInvalidValue;
  static rgbd::ClusterLaunch state_large;
  return (int)rgbd::launch_cluster(extract_pyramid_kernel<kItemsLarge>, device, grid, kThreads,
                                   smem_bytes(words, kItemsLarge), ranks, s, &state_large, P);
}
