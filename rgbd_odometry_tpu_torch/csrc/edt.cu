// Exact-L2 distance transform of a batch of edge masks and the now-frame
// targets built from it, for Hopper.
//
// Replaces the Pallas kernel `edt_minplus_pallas` / `_edt_kernel`
// (rgbd_odometry_tpu/pallas/edt.py:25-69), reached through
// `edt_l2_squared_pallas`, with the column phase (`_column_distance`,
// rgbd_odometry_tpu/ops/distance_transform.py:31-42) and the +-R windowed row
// phase that the production profile uses (`edt_l2_squared_windowed`, same file
// :64-87); and, behind it, the XLA ops of `prepare_now_level`
// (rgbd_odometry_tpu/solvers/edge_dvo.py:183-219): sqrt, the per-image 0-255
// min-max normalization, `central_gradient` (ops/gradient.py:24) and the
// [dt, dgx, dgy] channel stack. Two C entry points on the same phases:
//
//   edt_squared   (B, H, W) mask -> D^2 (B, H, W) float32: phases 1-2.
//   dt_channels   (B, H, W) mask -> dt, dgx, dgy float32, scale (B,), chans
//                 (B, 3, H, W) bf16 or float32: phases 1-2 with the tail
//                 fused (two launches), or phases 1-3 with normalization.
//
//   phase 1, columns  one block per (image, strip of 32 columns; 16 where
//       32 columns of every row would exceed 227 KB, past 2400 rows), the
//       mask strip staged in shared memory with cp.async (3 bytes a row:
//       above 480 rows the kernel opts in to more than 48 KB). Each column is split
//       into 8 row segments swept by different threads: the first and last
//       edge row of the segment, a short combine over the segment summaries
//       (nearest edge above and below the segment), then a forward and a
//       backward sweep of the segment. The dependent chain is H/8 steps in
//       shared memory instead of 2 H in device memory. g = min(distance to
//       the nearest edge in the column, 65504) (65504 if none: the 1e7
//       sentinel clamped) goes out as uint16.
//   phase 2, rows     one block per (image, tile of 8, 4, 2 or 1 rows, the
//       most that fit 48 KB, else 227 KB through the opt-in (rows wider than
//       1600), plus one halo row above and below under REFLECT_101 when the
//       tail is fused in). The g tile
//       is staged with cp.async; G^2 = g * g is formed again in float32
//       (exact: g is an integer <= 65504); D^2[x] = min_i (G^2[i] + (x-i)^2)
//       over the whole row (radius 0, the Pallas kernel) or over |x-i| <=
//       radius with the reference's 4e9 out-of-image candidates. Then, for
//       dt_channels, dt = sqrt(D^2) (correctly rounded) stays in shared
//       memory and the central gradients and the channels are written from
//       it; with normalization the raw dt goes to a scratch buffer instead
//       and the tile's min and max are folded into a (B, 2) buffer with
//       atomicMin/atomicMax on the bit patterns (dt >= 0, so the integer
//       order is the float order and the order of arrival does not matter).
//   phase 3, normalize  (only with normalization) one block per (image, tile
//       of rows + halo): (dt - dmin) * scale with scale = 255 / max(dmax -
//       dmin, 1e-12), in the plain version's operations and order, then the
//       gradients and channels as above.
//
// Exactness: every candidate G^2[i] + dx^2 is one float32 rounding, written
// with __fadd_rn/__fmul_rn so nvcc cannot contract it; sqrt, the division
// and the normalization use the round-to-nearest intrinsics; the gradients
// are 0.5 * (a - b). Every output is bitwise equal to the plain PyTorch
// version's and to the JAX/XLA functions'.
//
// What bounds it on the H100: bytes. One byte read and 4 (edt_squared) or
// 18-24 (dt_channels) written per pixel; the uint16 g scratch (and the raw
// dt with normalization) is L2-resident at these sizes. The row phase is
// O(W) (radius 0) or O(R) compare-and-add work per pixel on shared memory.
// The two image-wide dependencies (whole columns before rows; an image's min
// and max before its normalization) are the launch boundaries. Shared memory
// bounds the shapes: a column strip of 16 holds 4800 rows, a one-row tile
// of the row phase ~7700 columns; the wrapper takes up to 2560 a side.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kGMax = 65504;  // column-distance clamp that keeps g^2 finite
constexpr float kPad = 4.0e9f;  // out-of-image candidate of the windowed row phase
constexpr int kStrip = 32;  // columns per block of the column phase
constexpr int kStripNarrow = 16;  // where 32 columns of every row do not fit
constexpr int kSegs = 8;  // row segments per column
constexpr int kRowThreads = 256;
constexpr int kSmemLimit = 48 * 1024;
constexpr int kOptInLimit = 227 * 1024;  // the most a block may have on Hopper

enum Mode { kD2 = 0, kTail = 1, kRaw = 2 };

struct Out {
  float* d2;  // kD2: D^2; kRaw: the raw dt scratch
  float* dt;
  float* dgx;
  float* dgy;
  float* scale;
  void* chans;
  int* minmax;
  int bf16;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

template <int STRIP>
__global__ void __launch_bounds__(STRIP * kSegs)
edt_columns(const uint8_t* __restrict__ mask, uint16_t* __restrict__ g, int* __restrict__ minmax,
            int h, int w) {
  constexpr int kColThreads = STRIP * kSegs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sm = smem_raw;  // (h, STRIP) mask strip
  uint16_t* sup = reinterpret_cast<uint16_t*>(smem_raw + (size_t)h * STRIP);  // (h, STRIP)
  __shared__ int s_first[kSegs][STRIP], s_last[kSegs][STRIP];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * STRIP;
  const int cols = min(STRIP, w - x0);
  const uint8_t* M = mask + (size_t)blockIdx.y * h * w + x0;
  if (minmax != nullptr && blockIdx.x == 0 && tid == 0) {
    minmax[2 * blockIdx.y] = 0x7f800000;  // +inf
    minmax[2 * blockIdx.y + 1] = 0;
  }

  if ((w & 3) == 0 && aligned4(M)) {
    for (int i = tid; i < h * (STRIP / 4); i += kColThreads) {
      const int y = i / (STRIP / 4), q = (i - y * (STRIP / 4)) * 4;
      if (q < cols) cp_async4(&sm[y * STRIP + q], &M[(size_t)y * w + q]);
    }
    cp_async_wait_all();
  } else {
    for (int i = tid; i < h * STRIP; i += kColThreads) {
      const int y = i / STRIP, c = i - y * STRIP;
      if (c < cols) sm[i] = M[(size_t)y * w + c];
    }
  }
  __syncthreads();

  const int c = tid % STRIP, seg = tid / STRIP;
  const int len = (h + kSegs - 1) / kSegs;
  const int ya = min(seg * len, h), yb = min(ya + len, h);
  int first = -1, last = -1;
  if (c < cols) {
    for (int y = ya; y < yb; ++y) {
      if (sm[y * STRIP + c]) {
        if (first < 0) first = y;
        last = y;
      }
    }
  }
  s_first[seg][c] = first;
  s_last[seg][c] = last;
  __syncthreads();
  if (c >= cols) return;

  int above = -1, below = -1;  // nearest edge rows outside the segment
  for (int k = seg - 1; k >= 0 && above < 0; --k) above = s_last[k][c];
  for (int k = seg + 1; k < kSegs && below < 0; ++k) below = s_first[k][c];
  int edge = above;
  for (int y = ya; y < yb; ++y) {
    if (sm[y * STRIP + c]) edge = y;
    sup[y * STRIP + c] = (uint16_t)(edge >= 0 ? min(y - edge, kGMax) : kGMax);
  }
  edge = below;
  uint16_t* G = g + (size_t)blockIdx.y * h * w + x0 + c;
  for (int y = yb - 1; y >= ya; --y) {
    if (sm[y * STRIP + c]) edge = y;
    int d = sup[y * STRIP + c];
    if (edge >= 0) d = min(d, edge - y);
    G[(size_t)y * w] = (uint16_t)d;
  }
}

// D^2 at column x of a G^2 row in shared memory; with a window the row has
// `radius` out-of-image candidates (4e9) on either side.
__device__ __forceinline__ float row_min(const float* __restrict__ row, int x, int w, int radius) {
  float best;
  if (radius <= 0) {
    best = __fadd_rn(row[0], (float)(x * x));
    for (int i = 1; i < w; ++i) {
      const int dx = x - i;
      best = fminf(best, __fadd_rn(row[i], (float)(dx * dx)));
    }
  } else {
    const float* p = row + x;
    best = p[0];
#pragma unroll 4
    for (int dx = 1; dx <= radius; ++dx) {
      best = fminf(best, __fadd_rn(fminf(p[-dx], p[dx]), (float)(dx * dx)));
    }
  }
  return best;
}

// dt, the central gradients under REFLECT_101 and the channels of rows
// y0 .. y0 + tile - 1 from the dt tile `s_dt` ((tile + 2, w), one halo row
// above and below) in shared memory.
__device__ __forceinline__ void write_tail(const float* __restrict__ s_dt, int y0, int tile, int b,
                                           int h, int w, const Out& o) {
  const size_t plane = (size_t)h * w;
  for (int i = threadIdx.x; i < tile * w; i += blockDim.x) {
    const int r = i / w, x = i - r * w, y = y0 + r;
    if (y >= h) break;
    const float* row = s_dt + (r + 1) * w;
    const int xl = x > 0 ? x - 1 : 1, xr = x < w - 1 ? x + 1 : w - 2;
    const float dt = row[x];
    const float gx = __fmul_rn(0.5f, __fsub_rn(row[xr], row[xl]));
    const float gy = __fmul_rn(0.5f, __fsub_rn(row[w + x], row[x - w]));
    const size_t p = (size_t)b * plane + (size_t)y * w + x;
    o.dt[p] = dt;
    o.dgx[p] = gx;
    o.dgy[p] = gy;
    const size_t q = (size_t)b * 3 * plane + (size_t)y * w + x;
    if (o.bf16) {
      __nv_bfloat16* ch = reinterpret_cast<__nv_bfloat16*>(o.chans);
      ch[q] = __float2bfloat16_rn(dt);
      ch[q + plane] = __float2bfloat16_rn(gx);
      ch[q + 2 * plane] = __float2bfloat16_rn(gy);
    } else {
      float* ch = reinterpret_cast<float*>(o.chans);
      ch[q] = dt;
      ch[q + plane] = gx;
      ch[q + 2 * plane] = gy;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kRowThreads)
edt_rows(const uint16_t* __restrict__ g, Out o, int h, int w, int radius, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int halo = MODE == kTail ? 1 : 0;
  const int rows = tile + 2 * halo, n = rows * w;
  const int pitch = w + 2 * radius;  // a G^2 row with its window's pad candidates
  float* s_g2 = reinterpret_cast<float*>(smem_raw);  // (rows, pitch)
  float* s_dt = s_g2 + rows * pitch;  // (rows, w), kTail only
  uint16_t* s_g = reinterpret_cast<uint16_t*>(s_dt + (MODE == kTail ? n : 0));  // (rows, w) staged g
  const int tid = threadIdx.x, b = blockIdx.y, y0 = blockIdx.x * tile;
  const uint16_t* G = g + (size_t)b * h * w;

  if ((w & 1) == 0 && aligned4(G)) {
    const int half = w >> 1;
    for (int i = tid; i < rows * half; i += kRowThreads) {
      const int r = i / half, q = (i - r * half) * 2;
      cp_async4(&s_g[r * w + q], &G[(size_t)reflect_row(y0 - halo + r, h) * w + q]);
    }
    cp_async_wait_all();
  } else {
    for (int i = tid; i < n; i += kRowThreads) {
      const int r = i / w, x = i - r * w;
      s_g[i] = G[(size_t)reflect_row(y0 - halo + r, h) * w + x];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * pitch; i += kRowThreads) {
    const int r = i / pitch, x = i - r * pitch - radius;
    const float v = x >= 0 && x < w ? (float)s_g[r * w + x] : 0.0f;
    s_g2[i] = x >= 0 && x < w ? __fmul_rn(v, v) : kPad;
  }
  __syncthreads();

  float lo = __int_as_float(0x7f800000), hi = 0.0f;
  for (int i = tid; i < n; i += kRowThreads) {
    const int r = i / w, x = i - r * w, y = y0 - halo + r;
    const float d2 = row_min(s_g2 + r * pitch + radius, x, w, radius);
    if (MODE == kTail) {
      s_dt[i] = __fsqrt_rn(d2);
    } else if (y < h) {
      const float v = MODE == kRaw ? __fsqrt_rn(d2) : d2;
      o.d2[((size_t)b * h + y) * w + x] = v;
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
  if (MODE == kRaw) {
    for (int s = 16; s > 0; s >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, s));
    }
    if ((tid & 31) == 0) {
      atomicMin(&o.minmax[2 * b], __float_as_int(lo));
      atomicMax(&o.minmax[2 * b + 1], __float_as_int(hi));
    }
  }
  if (MODE == kTail) {
    __syncthreads();
    if (blockIdx.x == 0 && tid == 0) o.scale[b] = 1.0f;
    write_tail(s_dt, y0, tile, b, h, w, o);
  }
}

__global__ void __launch_bounds__(kRowThreads)
dt_normalize(const float* __restrict__ raw, Out o, int h, int w, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_dt = reinterpret_cast<float*>(smem_raw);  // (tile + 2, w)
  const int tid = threadIdx.x, b = blockIdx.y, y0 = blockIdx.x * tile;
  const float dmin = __int_as_float(o.minmax[2 * b]), dmax = __int_as_float(o.minmax[2 * b + 1]);
  const float span = fmaxf(__fsub_rn(dmax, dmin), 1e-12f);
  const float scale = __fdiv_rn(255.0f, span);
  const float* D = raw + (size_t)b * h * w;
  for (int i = tid; i < (tile + 2) * w; i += kRowThreads) {
    const int r = i / w, x = i - r * w;
    const float v = D[(size_t)reflect_row(y0 - 1 + r, h) * w + x];
    s_dt[i] = __fmul_rn(__fsub_rn(v, dmin), scale);
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid == 0) o.scale[b] = scale;
  write_tail(s_dt, y0, tile, b, h, w, o);
}

// Shared memory of the row phase: per row the padded G^2 row, the staged
// g (2 B) and, with the tail, dt (4 B).
size_t row_smem(int rows, int w, int radius, bool tail) {
  return (size_t)rows * ((size_t)(w + 2 * radius) * 4 + (size_t)w * (tail ? 6 : 2));
}

// The rows per tile of the row phase: the largest of 8, 4, 2, 1 whose rows
// (`halo` more above and below) fit 48 KB, else the largest that fits 227
// KB through the opt-in (rows wider than 1600); 0 if none does.
int rows_per_tile(int w, int radius, int halo) {
  const int limits[2] = {kSmemLimit, kOptInLimit};
  for (int i = 0; i < 2; ++i) {
    for (int tile = 8; tile >= 1; tile >>= 1) {
      if (row_smem(tile + 2 * halo, w, radius, halo > 0) <= (size_t)limits[i]) return tile;
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

// The column phase stages a whole column strip: 3 bytes a row (the mask and
// the uint16 upward distance) over 32 columns, or 16 where 32 do not fit
// 227 KB (past 2400 rows). Up to 48 KB that is the default; a taller image
// (more than 480 rows) opts the kernel in to more, once per device and size
// (`launch.cuh`), up to the 227 KB a block may have.
template <int STRIP>
int launch_columns_of(int device, const void* mask, void* g, void* minmax, int batch, int h,
                      int w, cudaStream_t s) {
  const size_t smem = (size_t)h * STRIP * 3;
  const size_t fixed = sizeof(int) * 2 * kSegs * STRIP;  // the static segment summaries
  if (smem > (size_t)kOptInLimit - fixed) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kSmemLimit - fixed) {
    static rgbd::SharedOptIn opted;
    const cudaError_t err =
        rgbd::opt_in_shared(edt_columns<STRIP>, device, (long long)smem, &opted);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w + STRIP - 1) / STRIP, batch);
  edt_columns<STRIP><<<grid, STRIP * kSegs, smem, s>>>((const uint8_t*)mask, (uint16_t*)g,
                                                       (int*)minmax, h, w);
  return (int)cudaGetLastError();
}

int launch_columns(int device, const void* mask, void* g, void* minmax, int batch, int h, int w,
                   cudaStream_t s) {
  const size_t fixed = sizeof(int) * 2 * kSegs * kStrip;
  if ((size_t)h * kStrip * 3 <= (size_t)kOptInLimit - fixed) {
    return launch_columns_of<kStrip>(device, mask, g, minmax, batch, h, w, s);
  }
  return launch_columns_of<kStripNarrow>(device, mask, g, minmax, batch, h, w, s);
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
  const int tile = rows_per_tile(w, radius, 0);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  int code = launch_columns(device, mask, g, nullptr, batch, h, w, s);
  if (code != 0) return code;
  Out o{};
  o.d2 = (float*)d2;
  const size_t smem = row_smem(tile, w, radius, false);
  static rgbd::SharedOptIn opted;
  err = opt_in_past_default(edt_rows<kD2>, device, smem, &opted);
  if (err != cudaSuccess) return (int)err;
  edt_rows<kD2><<<dim3((h + tile - 1) / tile, batch), kRowThreads, smem, s>>>(
      (const uint16_t*)g, o, h, w, radius, tile);
  return (int)cudaGetLastError();
}

// mask (B, H, W) uint8 -> dt, dgx, dgy (B, H, W) float32, scale (B,)
// float32 and chans (B, 3, H, W) bf16 (`bf16` != 0) or float32. Scratch: g
// (B, H, W) 16-bit and, with `normalize`, raw (B, H, W) float32 and minmax
// (B, 2) int32. H, W >= 2. All contiguous on `device`; launches on `stream`
// and does not synchronize.
extern "C" int dt_channels(int device, const void* mask, void* g, void* raw, void* minmax,
                           void* dt, void* dgx, void* dgy, void* scale, void* chans, int batch,
                           int h, int w, int radius, int normalize, int bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int tile = rows_per_tile(w, radius, 1);
  if (tile == 0 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  int code = launch_columns(device, mask, g, normalize ? minmax : nullptr, batch, h, w, s);
  if (code != 0) return code;
  Out o{};
  o.d2 = (float*)raw;
  o.dt = (float*)dt;
  o.dgx = (float*)dgx;
  o.dgy = (float*)dgy;
  o.scale = (float*)scale;
  o.chans = chans;
  o.minmax = (int*)minmax;
  o.bf16 = bf16;
  const dim3 grid((h + tile - 1) / tile, batch);
  if (!normalize) {
    const size_t smem = row_smem(tile + 2, w, radius, true);
    static rgbd::SharedOptIn opted;
    err = opt_in_past_default(edt_rows<kTail>, device, smem, &opted);
    if (err != cudaSuccess) return (int)err;
    edt_rows<kTail><<<grid, kRowThreads, smem, s>>>((const uint16_t*)g, o, h, w, radius, tile);
    return (int)cudaGetLastError();
  }
  const size_t smem = row_smem(tile, w, radius, false);
  static rgbd::SharedOptIn opted_raw;
  err = opt_in_past_default(edt_rows<kRaw>, device, smem, &opted_raw);
  if (err != cudaSuccess) return (int)err;
  edt_rows<kRaw><<<grid, kRowThreads, smem, s>>>((const uint16_t*)g, o, h, w, radius, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_norm = (size_t)(tile + 2) * w * 4;
  static rgbd::SharedOptIn opted_norm;
  err = opt_in_past_default(dt_normalize, device, smem_norm, &opted_norm);
  if (err != cudaSuccess) return (int)err;
  dt_normalize<<<grid, kRowThreads, smem_norm, s>>>((const float*)raw, o, h, w, tile);
  return (int)cudaGetLastError();
}
