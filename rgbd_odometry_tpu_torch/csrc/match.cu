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
// For the same reason no tensor core is used: TF32 or bf16 products change
// those bits.
//
// Design: one tiled pass over the valid pairs, spread over the card.
//   - A cluster of `ranks` blocks (1, 2, 4 or 8, a function of S alone: S x
//     ranks blocks fill the 132 SMs) takes one slot. Each block compacts the
//     valid keypoints (ballots and a prefix over 32-entry chunks): the
//     query's into qi, the slot's into rj. Rank r takes the r-th of `ranks`
//     equal runs of the compacted query rows. Only valid x valid pairs are
//     loaded or computed.
//   - Each pair's chain is computed once, in 128 x 128 tiles of (query rows,
//     slot keypoints) staged in shared memory with cp.async, double-buffered
//     over the tiles so the next tile loads while this one computes. A
//     thread owns 8 x 8 pairs: 64 independent chains, each float4 read from
//     shared memory feeding eight of them, every chain still in d order
//     (the multiply-adds are issued component by component over the 64
//     pairs, so no chain waits on its own last result). A
//     row of 64 floats keeps its 16-byte quad q at q ^ ((row / 8) % 8), so
//     the 16 rows a half-warp reads at one quad fall on 8 distinct banks.
//   - The same tile feeds both directions. Rows: the running (best, index,
//     second) over the thread's columns in ascending j, merged across the
//     16 threads of a row by shuffles. Columns: the minimum of (d2, i) over
//     the thread's rows as one 64-bit key (float bits << 32 | i, which
//     orders as the pair because d2 >= 0), merged over the block through
//     shared memory (a thread a column, the warps' keys in a fixed order),
//     then across the ranks through distributed shared memory.
//     Every merge is a lexicographic minimum on (d2, index), and second is
//     the minimum of d2 over j != best index (a multiset minimum), so any
//     tiling, rank count and merge order gives the parent's values.
//   - The epilogue (min_d, the gate, good, num_good) runs in the same
//     launch behind a cluster barrier, each rank over its own rows;
//     num_good is an integer sum into rank 0. Runs are bitwise repeatable.
// What bounds it on the H100: at full validity the float32 multiply-adds,
// (valid pairs) x 64 (1.2 GFLOP at S = 64, K = 384: 18 us at 67 TFLOP/s);
// at the rendered frames' ~80 valid keypoints of 384 the descriptors'
// bytes, and then one block's latency: a tile's load, 4096 multiply-adds
// on the busiest thread, two cluster barriers.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 64;
constexpr int kQuads = kD / 4;      // float4s a descriptor
constexpr int kThreads = 256;       // 16 x 16 threads of kSub x kSub pairs
constexpr int kSub = 8;             // a thread's rows and columns
constexpr int kTile = 16 * kSub;    // a tile's query rows and slot keypoints
constexpr int kMaxK = 1024;
constexpr int kChunks = kMaxK / 32;
constexpr float kBig = 1e9f;
constexpr int kNone = 0x7fffffff;
constexpr unsigned long long kNoKey = ~0ull;
constexpr size_t kStageFloats = 2 * (size_t)kTile * kD;  // a query tile and a slot tile

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The running (best, arg, second) of a row over its columns in ascending
// index order.
__device__ __forceinline__ void row_push(float d2, int j, float& best, int& arg, float& second) {
  const bool lt = d2 < best;  // selects, not branches: the 64 pushes diverge otherwise
  second = lt ? best : fminf(second, d2);
  arg = lt ? j : arg;
  best = lt ? d2 : best;
}

// Merge another summary of the same row over other columns into this one:
// the lexicographic minimum of (best, arg), and second the least of the
// rest.
__device__ __forceinline__ void row_merge(float ob, int oa, float os, float& best, int& arg,
                                          float& second) {
  if (ob < best || (ob == best && oa < arg)) {
    second = fminf(os, best);
    best = ob;
    arg = oa;
  } else {
    second = fminf(second, ob);
  }
}

struct Step {
  int qt, sc, ra, rb;  // query tile, slot tile, their valid rows
};

__device__ __forceinline__ Step step_of(int step, int nsc, int rows, int nr) {
  Step st;
  st.qt = step / nsc;
  st.sc = step - st.qt * nsc;
  st.ra = min(kTile, rows - st.qt * kTile);
  st.rb = min(kTile, nr - st.sc * kTile);
  return st;
}

// The 16-byte quad of a tile row at which quad q is kept: the 16 rows a
// half-warp reads at one quad (one a thread) fall on distinct banks.
__device__ __forceinline__ int swizzle(int row, int q) { return q ^ ((row / kSub) & 7); }

// Stage step `st`'s query rows and slot keypoints into buffer `buf`.
__device__ __forceinline__ void load_step(const Step& st, float* buf, const float* q_desc,
                                          const float* sd, const int* qi, const int* rj, int q0,
                                          int tid) {
  const int total = (st.ra + st.rb) * kQuads;
  for (int x = tid; x < total; x += kThreads) {
    int row = x / kQuads;
    const int q = x - row * kQuads;
    const float* src;
    float* dst;
    if (row < st.ra) {
      src = q_desc + (size_t)qi[q0 + st.qt * kTile + row] * kD;
      dst = buf;
    } else {
      row -= st.ra;
      src = sd + (size_t)rj[st.sc * kTile + row] * kD;
      dst = buf + kTile * kD;
    }
    cp_async16(dst + row * kD + 4 * swizzle(row, q), src + 4 * q);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
match_kernel(const float* __restrict__ slot_desc, const uint8_t* __restrict__ slot_valid,
             const float* __restrict__ q_desc, const uint8_t* __restrict__ q_valid, int k,
             float factor, float ratio2, float gate_floor, int ranks,
             long long* __restrict__ ref_idx_out, float* __restrict__ dist_out,
             uint8_t* __restrict__ good_out, int* __restrict__ num_good_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // 2 buffers of kStageFloats
  unsigned long long* colkey = reinterpret_cast<unsigned long long*>(stage + 2 * kStageFloats);
  int* qi = reinterpret_cast<int*>(colkey + k);  // compacted query rows
  int* rj = qi + k;                              // compacted slot keypoints
  float* row_best = reinterpret_cast<float*>(rj + k);
  int* row_arg = reinterpret_cast<int*>(row_best + k);  // compacted slot index or kNone
  float* row_second = reinterpret_cast<float*>(row_arg + k);
  __shared__ unsigned ballot_q[kChunks], ballot_r[kChunks];
  __shared__ int chunk_q[kChunks], chunk_r[kChunks];
  __shared__ unsigned long long col_part[kThreads / 32][kTile];  // a step's column keys a warp
  __shared__ int counts[2];
  __shared__ float red_min[kThreads / 32];
  __shared__ int red_cnt[kThreads / 32];
  __shared__ float min_part;  // this rank's least distance
  __shared__ int good_total;  // rank 0's: the ranks' good counts

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % ranks;
  const int s = blockIdx.x / ranks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* sd = slot_desc + (size_t)s * k * kD;
  const uint8_t* sv = slot_valid + (size_t)s * k;
  const int nchunks = (k + 31) / 32;
  const unsigned below = (1u << lane) - 1u;

  // compaction of both sides' valid keypoints: a ballot a 32-entry chunk,
  // an exclusive prefix over the chunks on warp 0
  for (int c = warp; c < nchunks; c += kThreads / 32) {
    const int i = c * 32 + lane;
    const unsigned bq = __ballot_sync(0xffffffffu, i < k && q_valid[i]);
    const unsigned br = __ballot_sync(0xffffffffu, i < k && sv[i]);
    if (lane == 0) {
      ballot_q[c] = bq;
      ballot_r[c] = br;
    }
  }
  for (int x = tid; x < k; x += kThreads) {
    colkey[x] = kNoKey;
    row_best[x] = kBig;
    row_arg[x] = kNone;
    row_second[x] = kBig;
  }
  if (tid == 0) good_total = 0;
  __syncthreads();
  if (warp == 0) {
    const int cq = lane < nchunks ? __popc(ballot_q[lane]) : 0;
    const int cr = lane < nchunks ? __popc(ballot_r[lane]) : 0;
    int sq = cq, sr = cr;  // inclusive scans
    for (int o = 1; o < 32; o <<= 1) {
      const int uq = __shfl_up_sync(0xffffffffu, sq, o), ur = __shfl_up_sync(0xffffffffu, sr, o);
      if (lane >= o) {
        sq += uq;
        sr += ur;
      }
    }
    chunk_q[lane] = sq - cq;
    chunk_r[lane] = sr - cr;
    if (lane == 31) {
      counts[0] = sq;
      counts[1] = sr;
    }
  }
  __syncthreads();
  for (int c = warp; c < nchunks; c += kThreads / 32) {
    const int i = c * 32 + lane;
    const unsigned bq = ballot_q[c], br = ballot_r[c];
    if ((bq >> lane) & 1u) qi[chunk_q[c] + __popc(bq & below)] = i;
    if ((br >> lane) & 1u) rj[chunk_r[c] + __popc(br & below)] = i;
  }
  __syncthreads();
  const int nq = counts[0], nr = counts[1];
  const int q0 = (int)((long long)nq * rank / ranks);
  const int q1 = (int)((long long)nq * (rank + 1) / ranks);
  const int rows = q1 - q0;
  const int nsc = (nr + kTile - 1) / kTile;
  const int steps = nr > 0 ? ((rows + kTile - 1) / kTile) * nsc : 0;

  // the tiles: thread (tr, tc) owns rows 8 tr .. 8 tr + 7 and columns
  // 8 tc .. 8 tc + 7 of a tile; a half-warp is one tr, 16 tc
  const int tc = lane & 15, tr = warp * 2 + (lane >> 4);
  float rbest[kSub], rsecond[kSub];
  int rarg[kSub];
  if (steps > 0)
    load_step(step_of(0, nsc, rows, nr), stage, q_desc, sd, qi, rj, q0, tid);
  for (int step = 0; step < steps; ++step) {
    const Step st = step_of(step, nsc, rows, nr);
    if (step + 1 < steps) {
      load_step(step_of(step + 1, nsc, rows, nr), stage + ((step + 1) & 1) * kStageFloats,
                q_desc, sd, qi, rj, q0, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (st.sc == 0) {
#pragma unroll
      for (int m = 0; m < kSub; ++m) {
        rbest[m] = kBig;
        rsecond[m] = kBig;
        rarg[m] = kNone;
      }
    }
    const float* A = stage + (step & 1) * kStageFloats;
    const float* B = A + kTile * kD;
    unsigned long long ckey[kSub];
#pragma unroll
    for (int n = 0; n < kSub; ++n) ckey[n] = kNoKey;
    if (kSub * tr < st.ra && kSub * tc < st.rb) {
      float acc[kSub][kSub];
#pragma unroll
      for (int m = 0; m < kSub; ++m)
#pragma unroll
        for (int n = 0; n < kSub; ++n) acc[m][n] = 0.0f;
      const float4* a4 = reinterpret_cast<const float4*>(A + kSub * tr * kD);
      const float4* b4 = reinterpret_cast<const float4*>(B + kSub * tc * kD);
#pragma unroll 2
      for (int q = 0; q < kQuads; ++q) {
        float4 a[kSub], b[kSub];
#pragma unroll
        for (int m = 0; m < kSub; ++m) a[m] = a4[m * kQuads + swizzle(kSub * tr, q)];
#pragma unroll
        for (int n = 0; n < kSub; ++n) b[n] = b4[n * kQuads + swizzle(kSub * tc, q)];
        // component by component over all 64 pairs: a pair's next
        // multiply-add is 64 instructions after its last
#pragma unroll
        for (int m = 0; m < kSub; ++m)
#pragma unroll
          for (int n = 0; n < kSub; ++n) acc[m][n] = __fmaf_rn(a[m].x, b[n].x, acc[m][n]);
#pragma unroll
        for (int m = 0; m < kSub; ++m)
#pragma unroll
          for (int n = 0; n < kSub; ++n) acc[m][n] = __fmaf_rn(a[m].y, b[n].y, acc[m][n]);
#pragma unroll
        for (int m = 0; m < kSub; ++m)
#pragma unroll
          for (int n = 0; n < kSub; ++n) acc[m][n] = __fmaf_rn(a[m].z, b[n].z, acc[m][n]);
#pragma unroll
        for (int m = 0; m < kSub; ++m)
#pragma unroll
          for (int n = 0; n < kSub; ++n) acc[m][n] = __fmaf_rn(a[m].w, b[n].w, acc[m][n]);
      }
      // d2 of the valid pairs (+inf elsewhere), then both directions
#pragma unroll
      for (int m = 0; m < kSub; ++m)
#pragma unroll
        for (int n = 0; n < kSub; ++n)
          acc[m][n] = (kSub * tr + m < st.ra && kSub * tc + n < st.rb)
                          ? fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, acc[m][n])), 0.0f)
                          : pos_inf();
      const int jbase = st.sc * kTile + kSub * tc;
      const int ibase = q0 + st.qt * kTile + kSub * tr;
#pragma unroll
      for (int m = 0; m < kSub; ++m)
#pragma unroll
        for (int n = 0; n < kSub; ++n) row_push(acc[m][n], jbase + n, rbest[m], rarg[m], rsecond[m]);
#pragma unroll
      for (int n = 0; n < kSub; ++n) {
        float cb = pos_inf();
        int ci = kNone;
#pragma unroll
        for (int m = 0; m < kSub; ++m) {
          const bool lt = acc[m][n] < cb;
          ci = lt ? ibase + m : ci;
          cb = lt ? acc[m][n] : cb;
        }
        if (ci != kNone)
          ckey[n] = ((unsigned long long)__float_as_uint(cb) << 32) | (unsigned)ci;
      }
    }
    // columns: the two rows of threads of a warp, then the block's key
#pragma unroll
    for (int n = 0; n < kSub; ++n) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, ckey[n], 16);
      ckey[n] = o < ckey[n] ? o : ckey[n];
    }
    if (lane < 16) {
#pragma unroll
      for (int n = 0; n < kSub; ++n) col_part[warp][kSub * tc + n] = ckey[n];
    }
    // rows: after the last slot tile, merge the 16 threads of each row
    if (st.sc == nsc - 1) {
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
#pragma unroll
        for (int m = 0; m < kSub; ++m) {
          const float ob = __shfl_xor_sync(0xffffffffu, rbest[m], o);
          const int oa = __shfl_xor_sync(0xffffffffu, rarg[m], o);
          const float os = __shfl_xor_sync(0xffffffffu, rsecond[m], o);
          row_merge(ob, oa, os, rbest[m], rarg[m], rsecond[m]);
        }
      }
      if (tc == 0) {
#pragma unroll
        for (int m = 0; m < kSub; ++m) {
          const int ii = kSub * tr + m;
          if (ii < st.ra) {
            const int x = q0 + st.qt * kTile + ii;
            row_best[x] = rbest[m];
            row_arg[x] = rarg[m];
            row_second[x] = rsecond[m];
          }
        }
      }
    }
    __syncthreads();
    // columns: a thread a column, the warps' keys and the running key
    if (tid < st.rb) {
      unsigned long long key = colkey[st.sc * kTile + tid];
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) key = col_part[w][tid] < key ? col_part[w][tid] : key;
      colkey[st.sc * kTile + tid] = key;
    }
    __syncthreads();  // col_part and the buffer are free for the next steps
  }

  // the epilogue: min_d over every rank's rows, then each rank's rows
  float mn = pos_inf();
  for (int x = q0 + tid; x < q1; x += kThreads) mn = fminf(mn, __fsqrt_rn(row_best[x]));
  for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  if (lane == 0) red_min[warp] = mn;
  __syncthreads();
  if (tid == 0) {
    float m = red_min[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fminf(m, red_min[w]);
    min_part = m;
  }
  if (ranks > 1) cluster.sync();  // every rank's keys, rows and min_part are final
  else __syncthreads();
  float min_d = min_part;
  for (int r = 0; r < ranks; ++r)
    if (r != rank) min_d = fminf(min_d, *cluster.map_shared_rank(&min_part, r));
  const float gate = fmaxf(__fmul_rn(factor, min_d), gate_floor);
  int cnt = 0;
  for (int x = q0 + tid; x < q1; x += kThreads) {
    const int i = qi[x];
    const float best = row_best[x];
    const int ja = row_arg[x];
    const float dist = __fsqrt_rn(best);
    bool mutual = false;
    if (ja != kNone) {
      unsigned long long key = colkey[ja];
      for (int r = 0; r < ranks; ++r) {
        if (r == rank) continue;
        const unsigned long long o = *cluster.map_shared_rank(&colkey[ja], r);
        key = o < key ? o : key;
      }
      mutual = (int)(key & 0xffffffffu) == x;
    }
    const bool good = mutual && dist <= gate && best <= __fmul_rn(ratio2, row_second[x]) &&
                      best < 0.5f * kBig;
    const size_t o = (size_t)s * k + i;
    ref_idx_out[o] = ja == kNone ? 0 : rj[ja];
    dist_out[o] = dist;
    good_out[o] = good ? 1 : 0;
    cnt += good ? 1 : 0;
  }
  // the invalid query rows of this rank's share of the K
  const int i0 = (int)((long long)k * rank / ranks), i1 = (int)((long long)k * (rank + 1) / ranks);
  for (int i = i0 + tid; i < i1; i += kThreads) {
    if (q_valid[i]) continue;
    const size_t o = (size_t)s * k + i;
    ref_idx_out[o] = 0;
    dist_out[o] = __fsqrt_rn(kBig);
    good_out[o] = 0;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if (lane == 0) red_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int w = 0; w < kThreads / 32; ++w) c += red_cnt[w];
    if (ranks > 1) atomicAdd(cluster.map_shared_rank(&good_total, 0), c);
    else good_total = c;
  }
  if (ranks > 1) cluster.sync();  // every count is in; no rank reads another past here
  if (rank == 0 && tid == 0) num_good_out[s] = good_total;
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of a launch at K keypoints: two stage buffers, the
// column keys, both compacted index lists and the row summaries.
static long long match_smem(int k) {
  return (long long)(2 * kStageFloats * sizeof(float)) + (long long)k * (8 + 4 * 5);
}

// slot_desc (S,K,D) float32, slot_valid (S,K) uint8, q_desc (K,D) float32,
// q_valid (K,) uint8, all contiguous and 16-byte aligned; D must be 64, K at
// most 1024. `ranks` blocks a slot (1, 2, 4 or 8). Outputs ref_idx (S,K)
// int64, dist (S,K) float32, good (S,K) uint8, num_good (S,) int32.
// Launches on `stream`, does not synchronize.
extern "C" int match_mutual(int device, const void* slot_desc, const void* slot_valid,
                            const void* q_desc, const void* q_valid, int slots, int k, int d,
                            float factor, float ratio2, float gate_floor, int ranks,
                            void* ref_idx_out, void* dist_out, void* good_out,
                            void* num_good_out, void* stream) {
  if (d != kD || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (slots < 1) return (int)cudaSuccess;
  static rgbd::ClusterLaunch state;
  err = rgbd::launch_cluster(match_kernel, device, dim3(slots * ranks), dim3(kThreads),
                             match_smem(k), ranks, (cudaStream_t)stream, &state,
                             (const float*)slot_desc, (const uint8_t*)slot_valid,
                             (const float*)q_desc, (const uint8_t*)q_valid, k, factor, ratio2,
                             gate_floor, ranks, (long long*)ref_idx_out, (float*)dist_out,
                             (uint8_t*)good_out, (int*)num_good_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
