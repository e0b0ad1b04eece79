// Exact-L2 distance transform of a batch of edge masks and the now-frame
// targets built from it, for Hopper.
//
// Replaces the Pallas kernel `edt_minplus_pallas` / `_edt_kernel`
// (rgbd_odometry_tpu/pallas/edt.py:25-69), reached through
// `edt_l2_squared_pallas`, with the column phase (`_column_distance`,
// rgbd_odometry_tpu/ops/distance_transform.py:31-42) and the +-R windowed row
// phase that the production profile uses (`edt_l2_squared_windowed`, same file
// :64-87); and, behind it, the XLA ops of `prepare_now_level`
// (rgbd_odometry_tpu/solvers/edge_dvo.py:183-219) over every level of
// `prepare_now_targets` (:941): sqrt, the per-image 0-255 min-max
// normalization, `central_gradient` (ops/gradient.py:24) and the [dt, dgx,
// dgy] channel stack. Two C entry points on the same phases:
//
//   edt_squared  (B, H, W) mask -> D^2 (B, H, W) float32: `edt_columns` then
//                `edt_rows`, two launches (off the paths; its checks).
//   dt_pyramid   every level of B masks -> per level dt, dgx, dgy float32,
//                scale (B,), chans (B, 3, H, W) bf16 or float32, in ONE
//                launch (`dt_pyramid_kernel`); one level is a pyramid of one.
//                A level of 2^20 pixels or more (1280x960 and up) takes the
//                per-level route instead, after that launch: `edt_columns`,
//                then `dt_level_tail`, or `dt_level_raw` and
//                `dt_level_normalize`, each a grid over the whole card, the
//                image's min and max by atomics (below, and PERF.md: 8 SMs
//                an image are too few there). Both routes run the same
//                tile steps (`tail_tile`, `raw_tile`, `normalize_tile`), so
//                the tail's arithmetic is written once.
//
// dt_pyramid_kernel: a small level table, passed by value, maps a block to
// its (level, image) and its rank among the 1, 2, 4 or 8 blocks of 512
// threads that own it (the wrapper's route rule, `dt_route`, picks a
// level's count; the launch's clusters are the largest count, and the
// (level, image)s are laid out largest count first, so that none straddles
// a cluster). Each (level, image) does, on its blocks:
//   phase 1, columns  the image's strips of at most 64 columns (a multiple
//       of 4), sized so that they deal out evenly over the ranks (a 320-wide
//       level on 8 ranks: one strip of 40 each); a strip is staged in shared
//       memory with cp.async, each column split into 512 / strip row
//       segments swept by different threads (the first and last edge row of
//       each segment, a short combine over the segment summaries, then a
//       forward and a backward sweep): g = min(distance to the nearest edge
//       in the column, 65504) (65504 if none: the 1e7 sentinel clamped)
//       goes to a uint16 scratch.
//   barrier           a cluster barrier (barrier.cluster.arrive.release /
//       wait.acquire: the scratch written by every rank is visible to every
//       rank; the scratch is then read past L1 with ld.global.cg), where the
//       launch has clusters; a block barrier where it has none.
//   phase 2, rows     each rank takes a band of ceil(H / ranks) rows, in
//       tiles (plus one halo row above and below under REFLECT_101,
//       reflected into the neighbouring bands' rows, when the tail follows
//       at once): the whole band where it fits shared memory and the launch
//       has no more blocks than the card has SMs (B = 1), else what fits 48
//       KB (more blocks an SM). G^2 = g * g (one float32 rounding, as in
//       JAX) goes to shared memory, 8 bytes of g a load, with R + 4
//       out-of-image candidates of 4e9 a side under a window, and each row's
//       least candidate (min G^2, and 4e9 under a window) to a lower bound
//       lb. D^2[x] = min_i fl(G^2[i] + (x - i)^2) is a search outward from
//       x, four offsets a step, that stops at the first offset e with
//       fl(lb + e^2) >= best (or past the window R, or past the row): every
//       candidate not yet seen is fl(G^2[i] + e'^2) with G^2[i] >= lb and
//       e' >= e, so by the monotonicity of rounding it is >= fl(lb + e^2) >=
//       best and cannot lower the minimum. A thread searches four
//       neighbouring pixels at once: a step reads their seven candidates on
//       either side as four aligned 16-byte loads (neighbouring threads read
//       neighbouring 16 bytes, no bank conflict) for sixteen (pixel, offset)
//       pairs. The work per pixel is about its distance to the nearest edge
//       (an edge-free row stops at once), not W.
//   tail              without normalization: dt = sqrt(D^2) of the tile and
//       its halo rows stays in shared memory and the central gradients and
//       the channels are written from it, four pixels a thread (16-byte
//       stores, 8 for four bf16). With it: raw dt goes to a float32 scratch
//       and each block folds its band's min and max; rank r writes its pair
//       into every rank's shared memory (distributed shared memory, no
//       global atomics, nothing to initialise before a graph replay), a
//       second cluster barrier, then every rank reads the image's min and
//       max from its own shared memory and writes its band's tiles from the
//       scratch (halo rows from the neighbouring bands): (dt - dmin) *
//       (255 / max(dmax - dmin, 1e-12)), then the gradients and channels.
// No block touches another's shared memory after the last cluster barrier,
// so none reads the memory of a block that may have exited. Blocks that own
// no (level, image) (the last cluster's pads) keep the barriers and exit.
//
// Exactness: every candidate G^2[i] + e^2 is one float32 rounding, written
// with __fadd_rn/__fmul_rn so nvcc cannot contract it; the minimum over the
// searched candidates is the minimum over all (above); sqrt, the division
// and the normalization use the round-to-nearest intrinsics; the gradients
// are 0.5 * (a - b); bf16 rounds to nearest. Every output is bitwise equal
// to the plain PyTorch version's and to the JAX/XLA functions'.
//
// What bounds it on the H100: bytes, one read and 18-24 written a pixel
// (the uint16 g and, with normalization, the raw dt scratch are
// L2-resident at these sizes), and at B = 1 the latency of one image's
// chain on its blocks: columns, a barrier, rows, (a barrier, the tail). A
// level never has more than 8 blocks an image in the pyramid kernel, so at
// B = 1 a large level runs on 8 SMs (hence the per-level route of the
// largest; a 720x960 level, below that route's 2^20 pixels, is slower on its
// 8 SMs than on the per-level kernels); the search's cost follows the
// distance to the nearest edge, which is large on sparse edge maps without a
// window.
// Shared memory bounds the shapes: a strip of 4 columns holds ~18000 rows,
// a one-row tile ~9000 columns; the wrapper takes up to 2560 a side.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGMax = 65504;  // column-distance clamp that keeps g^2 finite
constexpr float kPad = 4.0e9f;  // out-of-image candidate of the windowed row phase
constexpr int kStrip = 32;  // columns of an edt_columns strip
constexpr int kStripNarrow = 16;  // where 32 columns of every row do not fit
constexpr int kMaxStrip = 64;  // columns of a dt_pyramid strip, at most (8 segments)
constexpr int kThreads = 256;  // edt_squared's blocks
constexpr int kPyrThreads = 512;  // dt_pyramid's blocks
constexpr int kMaxTile = 8;  // rows of an edt_rows tile
constexpr int kMaxLevels = 8;
constexpr int kSmemLimit = 48 * 1024;
constexpr int kOptInLimit = 227 * 1024;  // the most a block may have on Hopper
// dt_pyramid_kernel's static shared memory: the segment summaries, the
// warps' partial min and max, the ranks' min and max
constexpr int kPyrStatic =
    2 * kPyrThreads * 4 + 2 * (kPyrThreads / 32) * 4 + 2 * rgbd::kMaxCluster * 4;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Every thread of the cluster: the writes before it (global and
// distributed shared memory) are visible to every thread of the cluster
// after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

// Row y under BORDER_REFLECT_101, clamped for the rows past a ragged tile.
__device__ __forceinline__ int reflect_row(int y, int h) {
  if (y < 0) y = -y;
  if (y >= h) y = 2 * h - 2 - y;
  return min(max(y, 0), h - 1);
}

// Phase 1 on one strip: `cols` (<= strip) columns of an image of h rows of
// w bytes; M and G point at the strip's first column of the mask and of g.
// `smem` holds h * strip * 3 bytes; s_first and s_last one int a thread.
// The block's threads split each column into blockDim.x / strip segments.
// No barrier at the end: the caller syncs before the buffers are reused.
__device__ __forceinline__ void column_strip(const uint8_t* __restrict__ M,
                                             uint16_t* __restrict__ G, unsigned char* smem,
                                             int* s_first, int* s_last, int h, int w, int cols,
                                             int strip) {
  uint8_t* sm = smem;  // (h, strip) mask strip
  uint16_t* sup = reinterpret_cast<uint16_t*>(smem + (size_t)h * strip);  // (h, strip)
  const int tid = threadIdx.x, nt = blockDim.x, segs = nt / strip;
  if ((w & 3) == 0 && aligned4(M)) {
    const int q4 = strip / 4;
    for (int i = tid; i < h * q4; i += nt) {
      const int y = i / q4, q = (i - y * q4) * 4;
      if (q < cols) cp_async4(&sm[y * strip + q], &M[(size_t)y * w + q]);
    }
    cp_async_wait_all();
  } else {
    for (int i = tid; i < h * strip; i += nt) {
      const int y = i / strip, c = i - y * strip;
      if (c < cols) sm[i] = M[(size_t)y * w + c];
    }
  }
  __syncthreads();

  const int c = tid % strip, seg = tid / strip;
  const int len = (h + segs - 1) / segs;
  const int ya = min(seg * len, h), yb = min(ya + len, h);
  int first = -1, last = -1;
  if (c < cols) {
    for (int y = ya; y < yb; ++y) {
      if (sm[y * strip + c]) {
        if (first < 0) first = y;
        last = y;
      }
    }
  }
  s_first[seg * strip + c] = first;
  s_last[seg * strip + c] = last;
  __syncthreads();
  if (c >= cols) return;

  int above = -1, below = -1;  // nearest edge rows outside the segment
  for (int k = seg - 1; k >= 0 && above < 0; --k) above = s_last[k * strip + c];
  for (int k = seg + 1; k < segs && below < 0; ++k) below = s_first[k * strip + c];
  int edge = above;
  for (int y = ya; y < yb; ++y) {
    if (sm[y * strip + c]) edge = y;
    sup[y * strip + c] = (uint16_t)(edge >= 0 ? min(y - edge, kGMax) : kGMax);
  }
  edge = below;
  for (int y = yb - 1; y >= ya; --y) {
    if (sm[y * strip + c]) edge = y;
    int d = sup[y * strip + c];
    if (edge >= 0) d = min(d, edge - y);
    G[(size_t)y * w + c] = (uint16_t)d;
  }
}

// The out-of-image candidates a padded G^2 row has on either side: under a
// window `radius` (4e9 each, as in JAX) and 4 more that four-pixel steps
// may read past the window; none for the whole row.
__host__ __device__ __forceinline__ int pad_of(int radius) { return radius > 0 ? radius + 4 : 0; }

// D^2 at column x of a padded G^2 row (p points at x; under a window,
// WINDOW, the row has pad_of(radius) out-of-image candidates on either
// side): the search outward from x with the stopping rule of the header (lb
// <= every candidate of the row), four offsets a step. An offset past the
// window adds +inf (no candidate); past the row, without a window, the
// index is clamped to the row's end, whose candidate at a larger offset is
// no less than the true one at its own offset, so the minimum does not
// change. For rows whose width is no multiple of 4.
template <bool WINDOW>
__device__ __forceinline__ float row_search(const float* __restrict__ p, int x, int w, int radius,
                                            float lb) {
  float best = p[0];
  const int lim = WINDOW ? radius : max(x, w - 1 - x);
  for (int dx = 1; dx <= lim; dx += 4) {
    if (__fadd_rn(lb, (float)(dx * dx)) >= best) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = dx + k;
      const float d = !WINDOW || e <= radius ? (float)(e * e) : inf_f();
      const float a = p[WINDOW ? -e : -min(e, x)], b = p[WINDOW ? e : min(e, w - 1 - x)];
      best = fminf(best, __fadd_rn(fminf(a, b), d));
    }
  }
  return best;
}

// The same for the four pixels x0 .. x0 + 3 of a row (p points at x0,
// 16-byte aligned): a step of four offsets e .. e + 3 (e = 1 mod 4) reads
// the seven candidates left of the pixels and the seven right of them once
// for all sixteen (pixel, offset) pairs, as four aligned 16-byte loads
// (neighbouring threads read neighbouring 16 bytes: no bank conflict; where
// the row ends inside the step, seven clamped loads a side), and the search
// stops when the bound reaches every pixel's best.
template <bool WINDOW>
__device__ __forceinline__ float4 row_search4(const float* __restrict__ p, int x0, int w,
                                              int radius, float lb) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  float b0 = c.x, b1 = c.y, b2 = c.z, b3 = c.w;
  const int first = -x0, last = w - 1 - x0;  // the row's ends, relative to x0
  const int lim = WINDOW ? radius : max(x0 + 3, last);
  for (int e = 1; e <= lim; e += 4) {
    if (__fadd_rn(lb, (float)(e * e)) >= fmaxf(fmaxf(b0, b1), fmaxf(b2, b3))) break;
    float l[7], r[7];  // l[t] = p[t - e - 3], r[t] = p[e + t]
    if (WINDOW || (e + 3 <= x0 && e + 6 <= last)) {
      const float4 la = *reinterpret_cast<const float4*>(p - e - 3);
      const float4 lb4 = *reinterpret_cast<const float4*>(p - e + 1);
      const float4 ra = *reinterpret_cast<const float4*>(p + e - 1);
      const float4 rb = *reinterpret_cast<const float4*>(p + e + 3);
      l[0] = la.x, l[1] = la.y, l[2] = la.z, l[3] = la.w, l[4] = lb4.x, l[5] = lb4.y;
      l[6] = lb4.z;
      r[0] = ra.y, r[1] = ra.z, r[2] = ra.w, r[3] = rb.x, r[4] = rb.y, r[5] = rb.z;
      r[6] = rb.w;
    } else {
#pragma unroll
      for (int t = 0; t < 7; ++t) {
        l[t] = p[max(t - e - 3, first)];
        r[t] = p[min(e + t, last)];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // offset e + k: pixel j reads l[j - k + 3] and r[j + k]
      const int ek = e + k;
      const float d = !WINDOW || ek <= radius ? (float)(ek * ek) : inf_f();
      b0 = fminf(b0, __fadd_rn(fminf(l[3 - k], r[k]), d));
      b1 = fminf(b1, __fadd_rn(fminf(l[4 - k], r[1 + k]), d));
      b2 = fminf(b2, __fadd_rn(fminf(l[5 - k], r[2 + k]), d));
      b3 = fminf(b3, __fadd_rn(fminf(l[6 - k], r[3 + k]), d));
    }
  }
  return make_float4(b0, b1, b2, b3);
}

__device__ __forceinline__ float square16(unsigned v) {
  const float f = (float)(v & 0xffffu);
  return __fmul_rn(f, f);
}

// Phase 2 on `rows` rows of an image (h, w) of g starting at row `top`
// (each reflected under REFLECT_101): the padded G^2 rows into s_g2 ((rows,
// w + 2 pad_of(radius)) floats; 8 bytes of g a load where the rows allow),
// each row's lower bound into s_lb, then op(i, d2) for every pixel i = r *
// w + x of the tile (four pixels a thread where w is a multiple of 4). No
// barrier at the end.
template <bool WINDOW, typename Op>
__device__ __forceinline__ void row_tile(const uint16_t* __restrict__ G, int h, int w, int radius,
                                         int top, int rows, float* s_lb, float* s_g2, Op op) {
  const int tid = threadIdx.x, nt = blockDim.x, pad = pad_of(radius), pitch = w + 2 * pad;
  const bool vec = ((w | pad) & 3) == 0;  // 16-byte aligned rows of four-pixel units
  if (vec && (reinterpret_cast<uintptr_t>(G) & 7) == 0) {
    const int q = w >> 2;
#pragma unroll 4
    for (int u = tid; u < rows * q; u += nt) {
      const int r = u / q, x = (u - r * q) << 2;
      const uint2 v =
          __ldcg(reinterpret_cast<const uint2*>(G + (size_t)reflect_row(top + r, h) * w + x));
      *reinterpret_cast<float4*>(s_g2 + r * pitch + pad + x) =
          make_float4(square16(v.x), square16(v.x >> 16), square16(v.y), square16(v.y >> 16));
    }
    for (int i = tid; i < rows * 2 * pad; i += nt) {  // the pads
      const int r = i / (2 * pad), k = i - r * 2 * pad;
      s_g2[r * pitch + (k < pad ? k : w + k)] = kPad;
    }
  } else {
    for (int i = tid; i < rows * pitch; i += nt) {
      const int r = i / pitch, x = i - r * pitch - pad;
      float v = kPad;
      if (x >= 0 && x < w) v = square16(__ldcg(G + (size_t)reflect_row(top + r, h) * w + x));
      s_g2[i] = v;
    }
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int r = tid >> 5; r < rows; r += nt >> 5) {
    const float* row = s_g2 + r * pitch + pad;
    float m = WINDOW ? kPad : inf_f();
    for (int x = lane; x < w; x += 32) m = fminf(m, row[x]);
    for (int s = 16; s > 0; s >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, s));
    if (lane == 0) s_lb[r] = m;
  }
  __syncthreads();
  if (vec) {
    const int q = w >> 2;
    for (int u = tid; u < rows * q; u += nt) {
      const int r = u / q, x = (u - r * q) << 2, i = r * w + x;
      const float4 v = row_search4<WINDOW>(s_g2 + r * pitch + pad + x, x, w, radius, s_lb[r]);
      op(i, v.x);
      op(i + 1, v.y);
      op(i + 2, v.z);
      op(i + 3, v.w);
    }
    return;
  }
  for (int i = tid; i < rows * w; i += nt) {
    const int r = i / w, x = i - r * w;
    op(i, row_search<WINDOW>(s_g2 + r * pitch + pad + x, x, w, radius, s_lb[r]));
  }
}

// (v - dmin) * scale, the plain version's operations in its order.
__device__ __forceinline__ float normalized(float v, float dmin, float scale) {
  return __fmul_rn(__fsub_rn(v, dmin), scale);
}

__device__ __forceinline__ float half_diff(float a, float b) {
  return __fmul_rn(0.5f, __fsub_rn(a, b));
}

// Four floats as four bf16, each rounded to nearest, in one 8-byte word.
__device__ __forceinline__ uint2 pack_bf16(float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const unsigned*>(&a), *reinterpret_cast<const unsigned*>(&b));
}

// One image's output planes: dt, dgx, dgy (h, w) float32 and chans (3, h,
// w), bf16 when `bf16`, else float32; 16-byte aligned.
struct ImageOut {
  float* dt;
  float* dgx;
  float* dgy;
  void* chans;
  int bf16;
};

// The planes of the image whose first element is `first` in the dt, dgx and
// dgy buffers (3 first in `chans`).
__device__ __forceinline__ ImageOut image_out(float* dt, float* dgx, float* dgy, void* chans,
                                              int bf16, size_t first) {
  void* ch = bf16 ? (void*)(reinterpret_cast<__nv_bfloat16*>(chans) + 3 * first)
                  : (void*)(reinterpret_cast<float*>(chans) + 3 * first);
  return ImageOut{dt + first, dgx + first, dgy + first, ch, bf16};
}

// dt, the central gradients under REFLECT_101 and the channels of rows
// y0 .. y0 + rows - 1 of one image from the dt tile `s_dt` ((rows + 2, w),
// one halo row above and below) in shared memory, into the image's planes
// `o` (four pixels a thread where w is a multiple of 4).
__device__ __forceinline__ void write_tail(const float* __restrict__ s_dt, int y0, int rows, int h,
                                           int w, const ImageOut& o) {
  float* __restrict__ dt = o.dt;
  float* __restrict__ dgx = o.dgx;
  float* __restrict__ dgy = o.dgy;
  void* chans = o.chans;
  const int bf16 = o.bf16;
  const size_t plane = (size_t)h * w;
  if ((w & 3) == 0) {
    const int q = w >> 2;
    for (int u = threadIdx.x; u < rows * q; u += blockDim.x) {
      const int r = u / q, x = (u - r * q) << 2;
      const float* row = s_dt + (r + 1) * w;
      const float4 c = *reinterpret_cast<const float4*>(row + x);
      const float4 up = *reinterpret_cast<const float4*>(row - w + x);
      const float4 dn = *reinterpret_cast<const float4*>(row + w + x);
      const float l = row[x > 0 ? x - 1 : 1], rr = row[x + 4 < w ? x + 4 : w - 2];
      const float4 gx = make_float4(half_diff(c.y, l), half_diff(c.z, c.x), half_diff(c.w, c.y),
                                    half_diff(rr, c.z));
      const float4 gy = make_float4(half_diff(dn.x, up.x), half_diff(dn.y, up.y),
                                    half_diff(dn.z, up.z), half_diff(dn.w, up.w));
      const size_t p = (size_t)(y0 + r) * w + x;
      *reinterpret_cast<float4*>(dt + p) = c;
      *reinterpret_cast<float4*>(dgx + p) = gx;
      *reinterpret_cast<float4*>(dgy + p) = gy;
      if (bf16) {
        uint2* ch = reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(chans) + p);
        const size_t qp = plane / 4;  // a plane in groups of four bf16
        ch[0] = pack_bf16(c);
        ch[qp] = pack_bf16(gx);
        ch[2 * qp] = pack_bf16(gy);
      } else {
        float* ch = reinterpret_cast<float*>(chans) + p;
        *reinterpret_cast<float4*>(ch) = c;
        *reinterpret_cast<float4*>(ch + plane) = gx;
        *reinterpret_cast<float4*>(ch + 2 * plane) = gy;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int r = i / w, x = i - r * w;
    const float* row = s_dt + (r + 1) * w;
    const int xl = x > 0 ? x - 1 : 1, xr = x < w - 1 ? x + 1 : w - 2;
    const float v = row[x];
    const float gx = half_diff(row[xr], row[xl]);
    const float gy = half_diff(row[w + x], row[x - w]);
    const size_t p = (size_t)(y0 + r) * w + x;
    dt[p] = v;
    dgx[p] = gx;
    dgy[p] = gy;
    if (bf16) {
      __nv_bfloat16* ch = reinterpret_cast<__nv_bfloat16*>(chans);
      ch[p] = __float2bfloat16_rn(v);
      ch[p + plane] = __float2bfloat16_rn(gx);
      ch[p + 2 * plane] = __float2bfloat16_rn(gy);
    } else {
      float* ch = reinterpret_cast<float*>(chans);
      ch[p] = v;
      ch[p + plane] = gx;
      ch[p + 2 * plane] = gy;
    }
  }
}

// A row-phase tile's shared memory, in floats: each row's lower bound
// (rounded up to 4), the padded G^2 rows and, with the tail (kTail), the dt
// rows; with normalization (kRaw) the second pass reuses it for the
// normalized dt of the tile and its halo rows. kD2 is edt_rows' (no halo).
enum TileMode { kD2 = 0, kTail = 1, kRaw = 2 };

__host__ __device__ __forceinline__ int lb_floats(int rows) { return (rows + 3) & ~3; }

// The three steps of a tile of `rows` rows from y0 of one image, shared by
// both of dt_pyramid's routes (the cluster kernel's band loop and the
// per-level kernels' one tile a block). Shared memory at smem_f: s_lb, the
// rows' lower bounds, then at s_g2 the padded G^2 rows (and, for the tail,
// the dt rows past them). None ends in a barrier.

// The tail at once: D^2 of the tile and its halo rows, dt = sqrt(D^2) in
// shared memory, then the gradients and channels into `o`. s_g2 starts
// lb_floats(rows + 2) floats in.
template <bool WINDOW>
__device__ __forceinline__ void tail_tile(const uint16_t* __restrict__ G, int h, int w, int radius,
                                          int y0, int rows, float* s_lb, float* s_g2,
                                          const ImageOut& o) {
  float* s_dt = s_g2 + (((rows + 2) * (w + 2 * pad_of(radius)) + 3) & ~3);  // 16-byte aligned
  row_tile<WINDOW>(G, h, w, radius, y0 - 1, rows + 2, s_lb, s_g2,
                   [&](int i, float d2) { s_dt[i] = __fsqrt_rn(d2); });
  __syncthreads();
  write_tail(s_dt, y0, rows, h, w, o);
}

// The first pass of the normalization: raw dt = sqrt(D^2) of the tile into
// the image's scratch `raw`, its least and largest value folded into this
// thread's lo and hi.
template <bool WINDOW>
__device__ __forceinline__ void raw_tile(const uint16_t* __restrict__ G, int h, int w, int radius,
                                         int y0, int rows, float* s_lb, float* s_g2,
                                         float* __restrict__ raw, float& lo, float& hi) {
  float* out = raw + (size_t)y0 * w;
  row_tile<WINDOW>(G, h, w, radius, y0, rows, s_lb, s_g2, [&](int i, float d2) {
    const float v = __fsqrt_rn(d2);
    out[i] = v;
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  });
}

// The second pass: (dt - dmin) * scale of the tile and its halo rows
// (REFLECT_101) from the raw scratch into shared memory at s_dt, then the
// gradients and channels into `o`.
__device__ __forceinline__ void normalize_tile(const float* __restrict__ raw, int h, int w, int y0,
                                               int rows, float dmin, float scale, float* s_dt,
                                               const ImageOut& o) {
  if ((w & 3) == 0) {
    const int q = w >> 2;
    for (int u = threadIdx.x; u < (rows + 2) * q; u += blockDim.x) {
      const int r = u / q, x = (u - r * q) << 2;
      const float* src = raw + (size_t)reflect_row(y0 - 1 + r, h) * w + x;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src));
      *reinterpret_cast<float4*>(s_dt + r * w + x) =
          make_float4(normalized(v.x, dmin, scale), normalized(v.y, dmin, scale),
                      normalized(v.z, dmin, scale), normalized(v.w, dmin, scale));
    }
  } else {
    for (int i = threadIdx.x; i < (rows + 2) * w; i += blockDim.x) {
      const int r = i / w, x = i - r * w;
      s_dt[i] = normalized(__ldcg(raw + (size_t)reflect_row(y0 - 1 + r, h) * w + x), dmin, scale);
    }
  }
  __syncthreads();
  write_tail(s_dt, y0, rows, h, w, o);
}

// A warp's least and largest value, in every lane.
__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
  for (int s = 16; s > 0; s >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, s));
  }
}

// The normalization's scale: 255 / max(dmax - dmin, 1e-12), a true division.
__device__ __forceinline__ float scale_of(float dmin, float dmax) {
  return __fdiv_rn(255.0f, fmaxf(__fsub_rn(dmax, dmin), 1e-12f));
}

// ---------------------------------------------------------------------------
// edt_squared: one launch a phase
// ---------------------------------------------------------------------------

// grid (strips, B): one strip of one image a block; with `minmax`, block
// (0, b) first sets image b's (min, max) pair to (+inf, 0) for the atomics
// of dt_level_raw.
__global__ void __launch_bounds__(kThreads)
edt_columns(const uint8_t* __restrict__ mask, uint16_t* __restrict__ g, int* __restrict__ minmax,
            int h, int w, int strip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_first[kThreads], s_last[kThreads];
  const int x0 = blockIdx.x * strip;
  if (minmax != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    minmax[2 * blockIdx.y] = 0x7f800000;  // +inf
    minmax[2 * blockIdx.y + 1] = 0;
  }
  const size_t img = (size_t)blockIdx.y * h * w + x0;
  column_strip(mask + img, g + img, smem_raw, s_first, s_last, h, w, min(strip, w - x0), strip);
}

// grid (tiles, B): `tile` rows of one image a block, D^2 written out.
__global__ void __launch_bounds__(kThreads)
edt_rows(const uint16_t* __restrict__ g, float* __restrict__ d2, int h, int w, int radius,
         int tile) {
  extern __shared__ __align__(16) float smem_f[];
  const int y0 = blockIdx.x * tile, rows = min(tile, h - y0);
  float* out = d2 + ((size_t)blockIdx.y * h + y0) * w;
  const uint16_t* G = g + (size_t)blockIdx.y * h * w;
  float* s_g2 = smem_f + lb_floats(tile);
  auto op = [&](int i, float v) { out[i] = v; };
  if (radius > 0) {
    row_tile<true>(G, h, w, radius, y0, rows, smem_f, s_g2, op);
  } else {
    row_tile<false>(G, h, w, radius, y0, rows, smem_f, s_g2, op);
  }
}

// ---------------------------------------------------------------------------
// dt_pyramid's per-level route (`dt_route`'s 0: a level of 2^20 pixels or
// more, where 8 blocks an image leave most of the card idle at a small B):
// edt_columns, then one block a tile of rows over the whole grid, the image's
// min and max by atomics on a (B, 2) pair that edt_columns resets, and a
// third launch for the normalization. A block runs the cluster route's
// tile steps (tail_tile, or raw_tile and normalize_tile) on its one tile.
// ---------------------------------------------------------------------------

struct LevelOut {  // one level's planes, its first image at each pointer
  float* dt;
  float* dgx;
  float* dgy;
  float* scale;  // (B,)
  void* chans;  // (B, 3, h, w)
  float* raw;  // the raw dt scratch (normalization only)
  int* minmax;  // (B, 2) (normalization only)
  int bf16;
};

// grid (tiles, B): `tile` rows of one image a block with a halo row above
// and below, dt, the gradients and the channels written out.
__global__ void __launch_bounds__(kThreads)
dt_level_tail(const uint16_t* __restrict__ g, LevelOut o, int h, int w, int radius, int tile) {
  extern __shared__ __align__(16) float smem_f[];
  const int b = blockIdx.y, y0 = blockIdx.x * tile, rows = min(tile, h - y0);
  const size_t first = (size_t)b * h * w;
  const ImageOut io = image_out(o.dt, o.dgx, o.dgy, o.chans, o.bf16, first);
  float* s_g2 = smem_f + lb_floats(tile + 2);
  if (radius > 0) {
    tail_tile<true>(g + first, h, w, radius, y0, rows, smem_f, s_g2, io);
  } else {
    tail_tile<false>(g + first, h, w, radius, y0, rows, smem_f, s_g2, io);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) o.scale[b] = 1.0f;
}

// grid (tiles, B): raw dt of `tile` rows of one image a block; the block's
// min and max folded into the image's pair with atomicMin / atomicMax on
// the bit patterns (dt >= 0, so the integer order is the float order and
// the order of arrival does not matter).
__global__ void __launch_bounds__(kThreads)
dt_level_raw(const uint16_t* __restrict__ g, LevelOut o, int h, int w, int radius, int tile) {
  extern __shared__ __align__(16) float smem_f[];
  const int b = blockIdx.y, y0 = blockIdx.x * tile, rows = min(tile, h - y0);
  const size_t first = (size_t)b * h * w;
  float lo = inf_f(), hi = 0.0f;
  float* s_g2 = smem_f + lb_floats(tile);
  if (radius > 0) {
    raw_tile<true>(g + first, h, w, radius, y0, rows, smem_f, s_g2, o.raw + first, lo, hi);
  } else {
    raw_tile<false>(g + first, h, w, radius, y0, rows, smem_f, s_g2, o.raw + first, lo, hi);
  }
  warp_minmax(lo, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&o.minmax[2 * b], __float_as_int(lo));
    atomicMax(&o.minmax[2 * b + 1], __float_as_int(hi));
  }
}

// grid (tiles, B): (dt - dmin) * scale of `tile` rows of one image and its
// halo rows from the raw scratch, then the tail.
__global__ void __launch_bounds__(kThreads)
dt_level_normalize(LevelOut o, int h, int w, int tile) {
  extern __shared__ __align__(16) float smem_f[];
  const int b = blockIdx.y, y0 = blockIdx.x * tile, rows = min(tile, h - y0);
  const size_t first = (size_t)b * h * w;
  const float dmin = __int_as_float(o.minmax[2 * b]), dmax = __int_as_float(o.minmax[2 * b + 1]);
  const float scale = scale_of(dmin, dmax);
  normalize_tile(o.raw + first, h, w, y0, rows, dmin, scale, smem_f,
                 image_out(o.dt, o.dgx, o.dgy, o.chans, o.bf16, first));
  if (blockIdx.x == 0 && threadIdx.x == 0) o.scale[b] = scale;
}

// ---------------------------------------------------------------------------
// dt_pyramid: every level of B images in one launch
// ---------------------------------------------------------------------------

struct DtLevel {
  const uint8_t* mask;  // (B, h, w)
  long long off;  // the level's first element in the g, raw, dt, dgx, dgy planes; chans at 3 off
  int h, w;
  int ranks;  // blocks an image: 1, 2, 4 or 8
  int band;  // rows a rank
  int tile;  // rows a row-phase tile
  int strip;  // columns a column-phase strip
  int block_begin;  // (image b, rank r) is block block_begin + b * ranks + r
};

struct DtPyramid {
  DtLevel lv[kMaxLevels];
  uint16_t* g;
  float* raw;  // null without normalization
  float* dt;
  float* dgx;
  float* dgy;
  float* scale;  // (levels, B)
  void* chans;
  int levels, batch, radius, normalize, bf16;
  int cluster;  // the launch's cluster size (1: no cluster)
};

// P.lv[l] in registers (a dynamic index into the parameters would copy the
// table to local memory).
__device__ __forceinline__ DtLevel level_at(const DtPyramid& P, int l) {
  DtLevel L = P.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) L = P.lv[i];
  return L;
}

// Phase 2 and the tail of rank `rank`'s band of rows of one (level, image):
// `img` is the image's first element in the planes. Ends in the tail of
// the last tile; with normalization, between the two passes, the band's
// min and max are combined over the (level, image)'s ranks (through
// distributed shared memory and a cluster barrier where `clustered`).
template <bool WINDOW>
__device__ __forceinline__ void rows_and_tail(const DtPyramid& P, const DtLevel& L, int l, int b,
                                              int rank, size_t img, bool clustered,
                                              float* smem_f, float (*s_red)[kPyrThreads / 32],
                                              float (*s_mm)[2]) {
  const int h = L.h, w = L.w, radius = P.radius, tid = threadIdx.x;
  const int r0 = min(rank * L.band, h), r1 = min(r0 + L.band, h);
  const uint16_t* G = P.g + img;
  const ImageOut o = image_out(P.dt, P.dgx, P.dgy, P.chans, P.bf16, img);
  float* scale_out = P.scale + (size_t)l * P.batch + b;
  if (!P.normalize) {
    float* s_g2 = smem_f + lb_floats(L.tile + 2);
    for (int y0 = r0; y0 < r1; y0 += L.tile) {
      tail_tile<WINDOW>(G, h, w, radius, y0, min(L.tile, r1 - y0), smem_f, s_g2, o);
      __syncthreads();
    }
    if (rank == 0 && tid == 0) *scale_out = 1.0f;
    return;
  }

  float* raw = P.raw + img;
  float* s_g2 = smem_f + lb_floats(L.tile);
  float lo = inf_f(), hi = 0.0f;
  for (int y0 = r0; y0 < r1; y0 += L.tile) {
    raw_tile<WINDOW>(G, h, w, radius, y0, min(L.tile, r1 - y0), smem_f, s_g2, raw, lo, hi);
    __syncthreads();
  }
  warp_minmax(lo, hi);
  if ((tid & 31) == 0) {
    s_red[0][tid >> 5] = lo;
    s_red[1][tid >> 5] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kPyrThreads / 32; ++k) {
      lo = fminf(lo, s_red[0][k]);
      hi = fmaxf(hi, s_red[1][k]);
    }
    if (clustered) {  // into every rank's shared memory, slot `rank`
      cg::cluster_group cluster = cg::this_cluster();
      const unsigned base = cluster.block_rank() - (unsigned)rank;
      for (int q = 0; q < L.ranks; ++q) {
        float* slot = cluster.map_shared_rank(&s_mm[rank][0], base + (unsigned)q);
        slot[0] = lo;
        slot[1] = hi;
      }
    } else {
      s_mm[0][0] = lo;
      s_mm[0][1] = hi;
    }
  }
  if (clustered) {
    cluster_barrier();  // every rank's raw band and min and max are visible
  } else {
    __syncthreads();
  }
  float dmin = inf_f(), dmax = 0.0f;
  for (int q = 0; q < L.ranks; ++q) {
    dmin = fminf(dmin, s_mm[q][0]);
    dmax = fmaxf(dmax, s_mm[q][1]);
  }
  const float scale = scale_of(dmin, dmax);
  for (int y0 = r0; y0 < r1; y0 += L.tile) {
    normalize_tile(raw, h, w, y0, min(L.tile, r1 - y0), dmin, scale, smem_f, o);
    __syncthreads();
  }
  if (rank == 0 && tid == 0) *scale_out = scale;
}

// grid: every (level, image)'s blocks (`DtLevel::block_begin`), in clusters
// of P.cluster along x; blocks past the last level's are pads.
__global__ void __launch_bounds__(kPyrThreads)
dt_pyramid_kernel(const __grid_constant__ DtPyramid P) {
  extern __shared__ __align__(16) float smem_f[];
  __shared__ int s_first[kPyrThreads], s_last[kPyrThreads];
  __shared__ float s_red[2][kPyrThreads / 32];
  __shared__ float s_mm[rgbd::kMaxCluster][2];  // each rank's band min and max
  const bool clustered = P.cluster > 1;
  const int bx = blockIdx.x;
  int l = -1;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (i < P.levels && bx >= P.lv[i].block_begin &&
        bx < P.lv[i].block_begin + P.batch * P.lv[i].ranks)
      l = i;
  }
  if (l < 0) {  // a pad of the last cluster: it keeps the cluster's barriers
    if (clustered) {
      cluster_barrier();
      if (P.normalize) cluster_barrier();
    }
    return;
  }
  const DtLevel L = level_at(P, l);
  const int b = (bx - L.block_begin) / L.ranks, rank = bx - L.block_begin - b * L.ranks;
  const int h = L.h, w = L.w;
  const size_t plane = (size_t)h * w, img = (size_t)L.off + (size_t)b * plane;

  // phase 1: this rank's column strips
  const int strips = (w + L.strip - 1) / L.strip;
  for (int s = rank; s < strips; s += L.ranks) {
    const int x0 = s * L.strip;
    column_strip(L.mask + (size_t)b * plane + x0, P.g + img + x0,
                 reinterpret_cast<unsigned char*>(smem_f), s_first, s_last, h, w,
                 min(L.strip, w - x0), L.strip);
    __syncthreads();
  }
  if (clustered) cluster_barrier();  // every rank's columns are in g

  if (P.radius > 0) {
    rows_and_tail<true>(P, L, l, b, rank, img, clustered, smem_f, s_red, s_mm);
  } else {
    rows_and_tail<false>(P, L, l, b, rank, img, clustered, smem_f, s_red, s_mm);
  }
}

// Shared memory of a row-phase tile of `tile` rows (bytes).
size_t tile_smem(int tile, int w, int radius, int mode) {
  const size_t padded = (size_t)(w + 2 * pad_of(radius)) * 4;
  if (mode == kD2) return lb_floats(tile) * 4 + (size_t)tile * padded;
  if (mode == kTail)
    return lb_floats(tile + 2) * 4 + ((size_t)(tile + 2) * padded + 15) / 16 * 16 +
           (size_t)(tile + 2) * w * 4;
  const size_t a = lb_floats(tile) * 4 + (size_t)tile * padded, b = (size_t)(tile + 2) * w * 4;
  return a > b ? a : b;
}

// The most rows of a row-phase tile, at most `most`, whose shared memory
// fits `budget`, else fits `limit` through the opt-in; 0 if one row does not.
int rows_per_tile(int w, int radius, int mode, int most, size_t budget, size_t limit) {
  const size_t budgets[2] = {budget, limit};
  for (int i = 0; i < 2; ++i) {
    int lo = 0, hi = most;  // the largest tile in [1, most] that fits
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (tile_smem(mid, w, radius, mode) <= budgets[i]) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    if (lo > 0) return lo;
  }
  return 0;
}

// edt_columns' strip of an h-row image: 32 columns where their 3 bytes a
// row fit `limit`, else 16; 0 if neither does.
int strip_for(int h, size_t limit) {
  if ((size_t)h * kStrip * 3 <= limit) return kStrip;
  if ((size_t)h * kStripNarrow * 3 <= limit) return kStripNarrow;
  return 0;
}

// dt_pyramid's strip of an (h, w) level over `ranks` blocks: a rank's share
// of the columns in as few strips of at most kMaxStrip columns (a multiple
// of 4, for the 4-byte copies) as fit `budget`, else `limit`, so that the
// strips deal out evenly over the ranks; 0 if none fits.
int pyramid_strip(int h, int w, int ranks, size_t budget, size_t limit) {
  const int share = (w + ranks - 1) / ranks;
  const size_t limits[2] = {budget, limit};
  for (int i = 0; i < 2; ++i) {
    for (int n = (share + kMaxStrip - 1) / kMaxStrip; n <= share; ++n) {
      const int strip = ((share + n - 1) / n + 3) & ~3;
      if ((size_t)h * strip * 3 <= limits[i]) return strip;
    }
  }
  return 0;
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory where that is
// more than 48 KB (once per device and size, `launch.cuh`).
template <typename Kernel>
cudaError_t opt_in_past_default(Kernel kernel, int device, size_t smem,
                                rgbd::SharedOptIn* opted) {
  if (smem <= (size_t)kSmemLimit) return cudaSuccess;
  return rgbd::opt_in_shared(kernel, device, (long long)smem, opted);
}

// edt_columns over B images of one (h, w) level (strips of 32 columns, 16
// past ~2400 rows), opted in past 48 KB once per device and size; with
// `minmax`, each image's pair reset for dt_level_raw.
cudaError_t launch_columns(int device, const void* mask, void* g, int* minmax, int batch, int h,
                           int w, cudaStream_t s) {
  const int strip = strip_for(h, (size_t)kOptInLimit - sizeof(int) * 2 * kThreads);
  if (strip == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)h * strip * 3;
  static rgbd::SharedOptIn opted;
  const cudaError_t err = opt_in_past_default(edt_columns, device, smem, &opted);
  if (err != cudaSuccess) return err;
  edt_columns<<<dim3((w + strip - 1) / strip, batch), kThreads, smem, s>>>(
      (const uint8_t*)mask, (uint16_t*)g, minmax, h, w, strip);
  return cudaGetLastError();
}

// One level of B images on the per-level route: edt_columns, then
// dt_level_tail, or dt_level_raw and dt_level_normalize; a tile of rows a
// block, within 48 KB where it fits.
cudaError_t launch_level(int device, const void* mask, void* g, const LevelOut& o, int batch,
                         int h, int w, int radius, int normalize, cudaStream_t s) {
  const int mode = normalize ? kRaw : kTail;
  const int tile = rows_per_tile(w, radius, mode, kMaxTile, kSmemLimit, kOptInLimit);
  if (tile == 0) return cudaErrorInvalidValue;
  cudaError_t err = launch_columns(device, mask, g, normalize ? o.minmax : nullptr, batch, h, w, s);
  if (err != cudaSuccess) return err;
  const size_t smem = tile_smem(tile, w, radius, mode);
  const dim3 grid((h + tile - 1) / tile, batch);
  const uint16_t* G = (const uint16_t*)g;
  if (!normalize) {
    static rgbd::SharedOptIn opted;
    err = opt_in_past_default(dt_level_tail, device, smem, &opted);
    if (err != cudaSuccess) return err;
    dt_level_tail<<<grid, kThreads, smem, s>>>(G, o, h, w, radius, tile);
    return cudaGetLastError();
  }
  static rgbd::SharedOptIn opted_raw, opted_norm;
  err = opt_in_past_default(dt_level_raw, device, smem, &opted_raw);
  if (err != cudaSuccess) return err;
  dt_level_raw<<<grid, kThreads, smem, s>>>(G, o, h, w, radius, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_norm = (size_t)(tile + 2) * w * 4;
  err = opt_in_past_default(dt_level_normalize, device, smem_norm, &opted_norm);
  if (err != cudaSuccess) return err;
  dt_level_normalize<<<grid, kThreads, smem_norm, s>>>(o, h, w, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// mask (B, H, W) uint8, g scratch (B, H, W) 16-bit, d2 output (B, H, W)
// float32, all contiguous on `device`; launches on `stream` and does not
// synchronize.
extern "C" int edt_squared(int device, const void* mask, void* g, void* d2, int batch, int h,
                           int w, int radius, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int tile = rows_per_tile(w, radius, kD2, kMaxTile, kSmemLimit, kOptInLimit);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  err = launch_columns(device, mask, g, nullptr, batch, h, w, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = tile_smem(tile, w, radius, kD2);
  static rgbd::SharedOptIn opted_rows;
  err = opt_in_past_default(edt_rows, device, smem, &opted_rows);
  if (err != cudaSuccess) return (int)err;
  edt_rows<<<dim3((h + tile - 1) / tile, batch), kThreads, smem, s>>>(
      (const uint16_t*)g, (float*)d2, h, w, radius, tile);
  return (int)cudaGetLastError();
}

// Every level of B masks. Level l's (B, H_l, W_l) uint8 masks start at
// masks[l] (contiguous), H_l = hw[2 l], W_l = hw[2 l + 1] (both >= 2);
// ranks[l] in {1, 2, 4, 8} is its blocks an image in the one launch of
// dt_pyramid_kernel, or 0 for the per-level route (two or three launches of
// its own after it); `cluster` is the launch's cluster size (>= every
// ranks[l]; 1: no cluster); `sms` is the card's SM count (the one the
// wrapper's route rule read). Its g (16-bit), raw (float32, only with
// `normalize`; else null), dt, dgx, dgy (float32) planes (B, H_l, W_l)
// start offs[l] elements into those buffers (a multiple of 8), its chans
// (B, 3, H_l, W_l) (bf16 when `bf16`, else float32) 3 offs[l] elements into
// `chans`, its scale (B,) float32 at scale + l B, and, on the per-level
// route with `normalize`, its (B, 2) int32 min-max pairs at minmax + 2 l B.
// All on `device`, 16-byte aligned; launches on `stream` and does not
// synchronize. A launch of no more blocks than the card has SMs (B = 1)
// takes a whole band of rows a tile where it fits the opt-in; a larger one
// keeps its tiles to 48 KB, for more blocks an SM.
extern "C" int dt_pyramid(int device, int levels, int batch, const long long* masks,
                          const int* hw, const int* ranks, int cluster, int sms,
                          const long long* offs,
                          void* g, void* raw, void* minmax, void* dt, void* dgx, void* dgy,
                          void* scale, void* chans, int radius, int normalize, int bf16,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 1 || levels > kMaxLevels || batch < 1 || batch > 65535 || radius < 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || sms < 1 ||
      (normalize && raw == nullptr))
    return (int)cudaErrorInvalidValue;
  long long blocks = 0;
  for (int l = 0; l < levels; ++l) {
    if ((ranks[l] != 0 && ranks[l] != 1 && ranks[l] != 2 && ranks[l] != 4 && ranks[l] != 8) ||
        ranks[l] > cluster || (ranks[l] == 0 && normalize && minmax == nullptr) ||
        (offs[l] & 7) != 0 || hw[2 * l] < 2 || hw[2 * l + 1] < 2)
      return (int)cudaErrorInvalidValue;
    blocks += (long long)batch * ranks[l];
  }
  const size_t limit = (size_t)kOptInLimit - kPyrStatic;
  const size_t budget = blocks <= sms ? limit : (size_t)kSmemLimit;
  DtPyramid P{};
  P.levels = levels;
  P.batch = batch;
  P.radius = radius;
  P.normalize = normalize;
  P.bf16 = bf16;
  P.cluster = cluster;
  P.g = (uint16_t*)g;
  P.raw = (float*)raw;
  P.dt = (float*)dt;
  P.dgx = (float*)dgx;
  P.dgy = (float*)dgy;
  P.scale = (float*)scale;
  P.chans = chans;
  blocks = 0;
  size_t smem = 0;
  for (int r = rgbd::kMaxCluster; r >= 1; r >>= 1) {  // the largest counts first
    for (int l = 0; l < levels; ++l) {
      if (ranks[l] != r) continue;
      DtLevel& L = P.lv[l];
      L.mask = reinterpret_cast<const uint8_t*>(masks[l]);
      L.off = offs[l];
      L.h = hw[2 * l];
      L.w = hw[2 * l + 1];
      L.ranks = r;
      L.band = (L.h + r - 1) / r;
      L.strip = pyramid_strip(L.h, L.w, r, budget, limit);
      const int mode = normalize ? kRaw : kTail;
      L.tile = rows_per_tile(L.w, radius, mode, L.band, budget, limit);
      if (L.strip == 0 || L.tile == 0) return (int)cudaErrorInvalidValue;
      L.block_begin = (int)blocks;
      blocks += (long long)batch * r;
      const size_t cols = (size_t)L.h * L.strip * 3, rows = tile_smem(L.tile, L.w, radius, mode);
      const size_t need = cols > rows ? cols : rows;
      smem = need > smem ? need : smem;
    }
  }
  if (smem > limit || blocks > 0x7fffffff - cluster) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    blocks = (blocks + cluster - 1) / cluster * cluster;  // pads to whole clusters
    static rgbd::ClusterLaunch state;
    err = rgbd::launch_cluster(dt_pyramid_kernel, device, dim3((unsigned)blocks),
                               dim3(kPyrThreads), (long long)smem, cluster, s, &state, P);
    if (err != cudaSuccess) return (int)err;
  }
  for (int l = 0; l < levels; ++l) {  // the per-level route
    if (ranks[l] != 0) continue;
    const size_t off = (size_t)offs[l];
    LevelOut o;
    o.dt = (float*)dt + off;
    o.dgx = (float*)dgx + off;
    o.dgy = (float*)dgy + off;
    o.scale = (float*)scale + (size_t)l * batch;
    o.chans = bf16 ? (void*)((__nv_bfloat16*)chans + 3 * off) : (void*)((float*)chans + 3 * off);
    o.raw = normalize ? (float*)raw + off : nullptr;
    o.minmax = normalize ? (int*)minmax + (size_t)2 * l * batch : nullptr;
    o.bf16 = bf16;
    err = launch_level(device, (const void*)masks[l], (uint16_t*)g + off, o, batch, hw[2 * l],
                       hw[2 * l + 1], radius, normalize, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
