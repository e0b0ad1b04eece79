// IMU propagation and preintegration of B windows of T samples in one
// launch, for Hopper.
//
// Replaces the two `lax.scan` loops of the JAX package's IMU solver (XLA
// code, no Pallas kernel): `propagate_batch` over `propagate_step`
// (rgbd_odometry_tpu/solvers/imu.py:94-130) and `preintegrate`
// (:194-250), with the `jax.vmap` over windows around them
// (rgbd_odometry_tpu/pipeline/fused.py:276).
//
// propagate: each sample, R from the quaternion, the bias-corrected specific
// force rotated into the world frame plus gravity, p += v dt + acc dt^2 / 2,
// v += acc dt, q <- q exp(w dt) normalized; the state after every sample is
// written out. preintegrate: each sample, the window's (dR, dv, dp) and the
// 9x9 covariance of its error state, cov <- A cov A^T + (B diag Q) B^T, A
// the 9x9 error-state transition and B the 9x6 noise input of
// kernels/imu.py `transition`.
//
// What bounds it on the H100: not the bytes (6 floats in a sample, 10 out
// in propagate; B = 1, T = 400 is 0.008 us of traffic) nor the operations,
// but the serial chain over the samples. Most of a sample's work does not
// depend on the state: the bias corrections, the rotation vector's
// quaternion (propagate) or Exp and the right Jacobian (preintegrate), each
// with a correctly rounded root and division and a double sin and cos. The
// design takes that work off the chain. A window's samples stream through
// shared memory in chunks (kPropChunk or kPreChunk samples, the next
// chunks' acc and gyr copied by cp.async while this one runs; any T, the
// last chunk short):
//
//   propagate     a window on four warps, three chunks in flight: warp 0
//                 runs chunk i's carried chain q <- normalize(q dq) on
//                 lanes 0..3 (a product, a sum of squares and a root alike,
//                 then each lane divides one component and the four are
//                 exchanged by shuffles: one division on the chain, not
//                 four), while warps 1..3 take chunk i + 1's state-free half
//                 (a, w dt, dq = quat_from_rotvec(w dt), a sample a thread)
//                 and finish chunk i - 1 (R(q) a + g a sample a thread, the
//                 p and v chains on three threads, the chunk's states copied
//                 out coalesced); one 128-thread barrier a chunk. A window
//                 of kSerialSteps samples or fewer (`fused`'s prior) runs on
//                 one thread, without the hand-offs.
//   preintegrate  a window on one warp: a sample a lane (16 or fewer: Exp
//                 on lane k, Jr on lane 16 + k), a, phi, Exp(phi) and
//                 Jr(phi) dt; lane 0 runs dR <- dR E; a sample a lane again,
//                 dR a and A's blocks -dR hat(a) dt and -0.5 dR hat(a) dt^2;
//                 B, B diag Q and N = (B diag Q) B^T spread over the lanes;
//                 then lanes 0..8 carry the covariance, lane r row r of cov
//                 <- (A cov) A^T + N from the whole previous cov in shared
//                 memory, one warp barrier a sample, each entry the in-order
//                 chain of multiply-adds torch.matmul forms in the plain
//                 version over the dense terms, the zero ones left out (a
//                 window's first sample is N itself); lanes 0..2 carry dv
//                 and dp beside it. A window of one sample (`fused
//                 --imu-refine`) skips the chunks: cov is N itself.
//
// The nominal chain (states, dR, dv, dp) is the plain version's
// (kernels/imu.py) operation for operation: round-to-nearest intrinsics, a
// fused multiply-add exactly where the plain version takes one (where
// XLA:CPU contracts a product into a sum), sin and cos in double rounded
// once, correctly rounded square roots and divisions; so it is bitwise the
// plain version's. So is the covariance wherever torch.matmul sums in order
// (batched small products on an H100 do, a batch of one does not); it
// agrees to float32 rounding in any case.

#include <cstdint>

#include <cuda_runtime.h>

#include "se3.cuh"

namespace {

using rgbd::fadd;
using rgbd::fdiv;
using rgbd::fmul;
using rgbd::fsub;

constexpr int kState = 10;
constexpr int kParams = 11;  // accel bias (3), gyro bias (3), accel var, gyro var, gravity (3)
constexpr int kPropChunk = 64;  // propagate: samples a chunk, two a lane
constexpr int kPreChunk = 32;   // preintegrate: one a lane
// a per-sample array's row stride in shared memory: one float past the
// chunk, so that lanes reading different rows at one sample hit different
// banks
constexpr int kPropStride = kPropChunk + 1, kPreStride = kPreChunk + 1;

__device__ __forceinline__ float ffma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

__device__ __forceinline__ float sq3(const float w[3]) {
  return ffma(w[2], w[2], ffma(w[1], w[1], fmul(w[0], w[0])));
}

__device__ __forceinline__ float sq4(const float q[4]) {
  return ffma(q[3], q[3], ffma(q[2], q[2], ffma(q[1], q[1], fmul(q[0], q[0]))));
}

// R a, each row a chain of fused multiply-adds.
__device__ __forceinline__ void mv3(const float R[9], const float a[3], float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = ffma(R[i * 3 + 2], a[2], ffma(R[i * 3 + 1], a[1], fmul(R[i * 3 + 0], a[0])));
}

// C = A B (3x3 row-major), each entry mv3's chain.
__device__ __forceinline__ void mm3(const float A[9], const float B[9], float C[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = ffma(A[i * 3 + 2], B[2 * 3 + j],
                          ffma(A[i * 3 + 1], B[1 * 3 + j], fmul(A[i * 3 + 0], B[0 * 3 + j])));
}

__device__ __forceinline__ void hat(const float w[3], float W[9]) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

// The normalized quaternion's rotation (core/geometry.rotmat_from_quat).
__device__ __forceinline__ void rot_of_quat(const float q[4], float R[9]) {
  const float n = __fsqrt_rn(sq4(q));
  const float x = fdiv(q[0], n), y = fdiv(q[1], n), z = fdiv(q[2], n), w = fdiv(q[3], n);
  R[0] = fsub(1.0f, fmul(2.0f, ffma(y, y, fmul(z, z))));
  R[1] = fmul(2.0f, ffma(x, y, -fmul(w, z)));
  R[2] = fmul(2.0f, ffma(x, z, fmul(w, y)));
  R[3] = fmul(2.0f, ffma(x, y, fmul(w, z)));
  R[4] = fsub(1.0f, fmul(2.0f, ffma(x, x, fmul(z, z))));
  R[5] = fmul(2.0f, ffma(y, z, -fmul(w, x)));
  R[6] = fmul(2.0f, ffma(x, z, -fmul(w, y)));
  R[7] = fmul(2.0f, ffma(y, z, fmul(w, x)));
  R[8] = fsub(1.0f, fmul(2.0f, ffma(x, x, fmul(y, y))));
}

__device__ __forceinline__ void quat_from_rotvec(const float w[3], float q[4]) {
  const float phi2 = sq3(w);
  const float phi = __fsqrt_rn(fadd(phi2, 1e-24f));
  const float half = fmul(0.5f, phi);
  double s, c;
  sincos((double)half, &s, &c);
  const float k = phi < 1e-6f ? fsub(0.5f, fdiv(phi2, 48.0f)) : fdiv((float)s, phi);
  q[0] = fmul(w[0], k);
  q[1] = fmul(w[1], k);
  q[2] = fmul(w[2], k);
  q[3] = (float)c;
}

__device__ __forceinline__ void quat_mul(const float a[4], const float b[4], float o[4]) {
  const float ax = a[0], ay = a[1], az = a[2], aw = a[3];
  const float bx = b[0], by = b[1], bz = b[2], bw = b[3];
  o[0] = ffma(-az, by, ffma(ay, bz, ffma(aw, bx, fmul(ax, bw))));
  o[1] = ffma(az, bx, ffma(ay, bw, ffma(aw, by, -fmul(ax, bz))));
  o[2] = ffma(az, bw, ffma(-ay, bx, ffma(aw, bz, fmul(ax, by))));
  o[3] = ffma(-az, bz, ffma(-ay, by, ffma(aw, bw, -fmul(ax, bx))));
}

// Exp(w) (core/geometry.so3_exp): I + a W + b W^2, Taylor below theta^2 = 1e-8.
__device__ __forceinline__ void so3_exp(const float w[3], float E[9]) {
  const float theta2 = sq3(w);
  const float theta = __fsqrt_rn(fadd(theta2, 1e-16f));
  const bool small = theta2 < 1e-8f;
  double s, c;
  sincos((double)theta, &s, &c);
  const float a = small ? fsub(1.0f, fdiv(theta2, 6.0f)) : fdiv((float)s, theta);
  const float b = small ? fsub(0.5f, fdiv(theta2, 24.0f)) : fdiv(fsub(1.0f, (float)c), theta2);
  float W[9], WW[9];
  hat(w, W);
  mm3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 9; ++i) E[i] = ffma(b, WW[i], ffma(a, W[i], (i % 4 == 0) ? 1.0f : 0.0f));
}

// The right Jacobian of SO(3) (JAX _so3_right_jacobian), Taylor below
// theta = 1e-5; it enters only the covariance.
__device__ __forceinline__ void right_jacobian(const float phi[3], float J[9]) {
  const float th2 = sq3(phi);
  const float th = __fsqrt_rn(fadd(th2, 1e-24f));
  const bool small = th < 1e-5f;
  double s, c;
  sincos((double)th, &s, &c);
  const float c1 = small ? fsub(0.5f, fdiv(th2, 24.0f))
                         : fdiv(fsub(1.0f, (float)c), fmaxf(th2, 1e-24f));
  const float c2 = small ? fsub((float)(1.0 / 6.0), fdiv(th2, 120.0f))
                         : fdiv(fsub(th, (float)s), fmaxf(fmul(th2, th), 1e-24f));
  float K[9], KK[9];
  hat(phi, K);
  mm3(K, K, KK);
#pragma unroll
  for (int i = 0; i < 9; ++i)
    J[i] = fadd(fsub((i % 4 == 0) ? 1.0f : 0.0f, fmul(c1, K[i])), fmul(c2, KK[i]));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy samples k0 .. k0 + n - 1 of a window's acc and gyr (3 floats a
// sample) into A and G, thread t of `threads`, one cp.async group.
__device__ __forceinline__ void load_chunk(const float* acc, const float* gyr, int k0, int n,
                                           float* A, float* G, int t, int threads = 32) {
  for (int e = t; e < 3 * n; e += threads) {
    cp_async4(A + e, acc + 3 * (size_t)k0 + e);
    cp_async4(G + e, gyr + 3 * (size_t)k0 + e);
  }
  cp_async_commit();
}

// A named barrier of `count` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

constexpr int kPropThreads = 128;  // warp 0 the chain, warps 1..3 the rest
constexpr int kSerialSteps = 2;    // windows this short run on one thread
constexpr int kWorkers = kPropThreads - 32;

struct PropShared {
  float raw[2][2][3 * kPropChunk];   // [chunk parity][acc, gyr][sample, axis]
  float a[3][3][kPropStride];        // [chunk mod 3] acc - b_a
  float dq[2][4][kPropStride];       // [chunk parity] the sample's rotation increment
  float qs[2][kPropChunk * 4];       // [chunk parity] q after each sample
  float qin[2][4];                   // [chunk parity] q entering the chunk
  float ac[3][kPropStride];          // R a + g
  float out[kPropChunk * kState];    // a chunk's states, as traj lays them out
};

// Propagation of one window on four warps, chunk i of its samples in
// flight three ways at once: warp 0 (lanes 0..3) runs the carried chain of
// chunk i while warps 1..3 take the state-free half of chunk i + 1 and
// finish chunk i - 1 (R(q) a + g, the p and v chains on three threads, the
// coalesced copy out); one 128-thread barrier hands the chunks on.
__global__ void __launch_bounds__(kPropThreads)
propagate_kernel(int steps, const float* __restrict__ acc, const float* __restrict__ gyr,
                 const float* __restrict__ params, const float* __restrict__ state0, float dt,
                 float* __restrict__ traj) {
  __shared__ __align__(16) PropShared S;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool chain = tid < 32;
  const int wt = tid - 32;  // a worker's index
  float prm[kParams];
#pragma unroll
  for (int i = 0; i < kParams; ++i) prm[i] = params[i];
  const float* Aw = acc + (size_t)b * steps * 3;
  const float* Gw = gyr + (size_t)b * steps * 3;
  float* out = traj + (size_t)b * steps * kState;
  if (steps <= kSerialSteps) {  // a window of a sample or two: one thread, no hand-offs
    if (tid != 0) return;
    float q[4], p[3], v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[i] = state0[(size_t)b * kState + i];
      v[i] = state0[(size_t)b * kState + 3 + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = state0[(size_t)b * kState + 6 + i];
    for (int k = 0; k < steps; ++k) {
      float R[9], a[3], w[3], ra[3], d[4], qm[4];
      rot_of_quat(q, R);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a[i] = fsub(Aw[3 * k + i], prm[i]);
        w[i] = fmul(fsub(Gw[3 * k + i], prm[3 + i]), dt);
      }
      mv3(R, a, ra);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float ac = fadd(ra[i], prm[8 + i]);
        p[i] = ffma(fmul(fmul(0.5f, ac), dt), dt, ffma(v[i], dt, p[i]));
        v[i] = ffma(ac, dt, v[i]);
      }
      quat_from_rotvec(w, d);
      quat_mul(q, d, qm);
      const float nrm = __fsqrt_rn(sq4(qm));
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = fdiv(qm[i], nrm);
      float* o = out + (size_t)k * kState;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        o[i] = p[i];
        o[3 + i] = v[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o[6 + i] = q[i];
    }
    return;
  }
  const int chunks = (steps + kPropChunk - 1) / kPropChunk;
  // lanes 0..3 of warp 0: q (the same on each); workers 0..2: p and v of axis wt
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = state0[(size_t)b * kState + 6 + i];
  const int ax = wt >= 0 && wt < 3 ? wt : 0;
  float p = state0[(size_t)b * kState + ax];
  float v = state0[(size_t)b * kState + 3 + ax];

  // the state-free half of chunk c's samples, from raw[c & 1]: a and dq
  auto free_half = [&](int c) {
    const int n = min(kPropChunk, steps - c * kPropChunk);
    const float* A = S.raw[c & 1][0];
    const float* G = S.raw[c & 1][1];
    for (int k = wt; k < n; k += kWorkers) {
      float w[3], d[4];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        S.a[c % 3][i][k] = fsub(A[3 * k + i], prm[i]);
        w[i] = fmul(fsub(G[3 * k + i], prm[3 + i]), dt);
      }
      quat_from_rotvec(w, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) S.dq[c & 1][i][k] = d[i];
    }
  };

  if (!chain) {
    load_chunk(Aw, Gw, 0, min(kPropChunk, steps), S.raw[0][0], S.raw[0][1], wt, kWorkers);
    cp_async_wait_all();
    named_sync(2, kWorkers);
    if (chunks > 1)
      load_chunk(Aw, Gw, kPropChunk, min(kPropChunk, steps - kPropChunk), S.raw[1][0],
                 S.raw[1][1], wt, kWorkers);
    free_half(0);
  }
  named_sync(1, kPropThreads);
  for (int i = 0; i <= chunks; ++i) {
    if (chain) {
      if (i < chunks && lane < 4) {
        // the carried chain q <- normalize(q dq): each of lanes 0..3 forms
        // the product, its sum of squares and root alike, divides its own
        // component and takes the other three by shuffles (one division on
        // the chain, not four)
        const int n = min(kPropChunk, steps - i * kPropChunk);
        const float(*dq)[kPropStride] = S.dq[i & 1];
        float* qs = S.qs[i & 1];
        S.qin[i & 1][lane] = q[lane == 0 ? 0 : lane == 1 ? 1 : lane == 2 ? 2 : 3];
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = dq[j][0];
        for (int k = 0; k < n; ++k) {
          const int kn = k + 1 < n ? k + 1 : k;  // the next sample's increment, read ahead
          float dn[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) dn[j] = dq[j][kn];
          float qm[4];
          quat_mul(q, d, qm);
          const float nrm = __fsqrt_rn(sq4(qm));
          const float own = lane == 0 ? qm[0] : lane == 1 ? qm[1] : lane == 2 ? qm[2] : qm[3];
          const float mine = fdiv(own, nrm);
          qs[4 * k + lane] = mine;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            q[j] = __shfl_sync(0xfu, mine, j);
            d[j] = dn[j];
          }
        }
      }
    } else {
      if (i + 1 < chunks) {  // chunk i + 1's state-free half, chunk i + 2's samples in flight
        cp_async_wait_all();
        named_sync(2, kWorkers);
        if (i + 2 < chunks)
          load_chunk(Aw, Gw, (i + 2) * kPropChunk, min(kPropChunk, steps - (i + 2) * kPropChunk),
                     S.raw[i & 1][0], S.raw[i & 1][1], wt, kWorkers);
        free_half(i + 1);
      }
      if (i >= 1) {  // finish chunk i - 1
        const int c = i - 1, k0 = c * kPropChunk, n = min(kPropChunk, steps - k0);
        const float* qs = S.qs[c & 1];
        for (int k = wt; k < n; k += kWorkers) {
          const float* qk = k == 0 ? S.qin[c & 1] : qs + 4 * (k - 1);
          const float qq[4] = {qk[0], qk[1], qk[2], qk[3]};
          float R[9], a[3], ra[3];
          rot_of_quat(qq, R);
#pragma unroll
          for (int j = 0; j < 3; ++j) a[j] = S.a[c % 3][j][k];
          mv3(R, a, ra);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            S.ac[j][k] = fadd(ra[j], prm[8 + j]);
            S.out[k * kState + 6 + j] = qs[4 * k + j];
          }
          S.out[k * kState + 9] = qs[4 * k + 3];
        }
        named_sync(2, kWorkers);
        if (wt < 3) {  // the p and v chains, an axis a thread
#pragma unroll 4
          for (int k = 0; k < n; ++k) {
            const float a = S.ac[wt][k];
            p = ffma(fmul(fmul(0.5f, a), dt), dt, ffma(v, dt, p));
            v = ffma(a, dt, v);
            S.out[k * kState + wt] = p;
            S.out[k * kState + 3 + wt] = v;
          }
        }
        named_sync(2, kWorkers);
        float* o = out + (size_t)k0 * kState;
        for (int e = wt; e < n * kState; e += kWorkers) o[e] = S.out[e];
      }
    }
    named_sync(1, kPropThreads);
  }
}

struct PreShared {
  float raw[2][2][3 * kPreChunk];  // [buffer][acc, gyr][sample, axis]
  float a[3][kPreStride];          // acc - b_a
  float E[9][kPreStride];          // Exp(phi)
  float Jdt[9][kPreStride];        // Jr(phi) dt
  float dR[9][kPreStride];         // dR before the sample
  float X[9][kPreStride];          // A's dR hat(a) blocks: -dR hat(a) dt
  float Y[9][kPreStride];          //   and -0.5 dR hat(a) dt^2
  float B[54][kPreStride];         // the noise input B (9x6), and B diag Q
  float BQ[54][kPreStride];
  float N[81][kPreStride];         // (B diag Q) B^T
  float ra[3][kPreStride];         // dR a
  float cov[2][81];                // row-major, two buffers
  float dRout[9];
};

__global__ void __launch_bounds__(32)
preintegrate_kernel(int steps, const float* __restrict__ acc, const float* __restrict__ gyr,
                    const float* __restrict__ params, float dt, float* __restrict__ dR_out,
                    float* __restrict__ dv_out, float* __restrict__ dp_out,
                    float* __restrict__ cov_out) {
  __shared__ __align__(16) PreShared S;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  float prm[kParams];
#pragma unroll
  for (int i = 0; i < kParams; ++i) prm[i] = params[i];
  const float qg = prm[7], qa = prm[6];  // Q: gyro variance (3), then accel variance (3)
  const float* Aw = acc + (size_t)b * steps * 3;
  const float* Gw = gyr + (size_t)b * steps * 3;
  if (steps == 1) {  // a window of one sample (`fused --imu-refine`): no chunk, no chain
    // Exp(phi) on lanes 0..15, Jr(phi) dt on lanes 16..31 (their double
    // sincos side by side), into shared memory
    float a[3], phi[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[i] = fsub(Aw[i], prm[i]);
      phi[i] = fmul(fsub(Gw[i], prm[3 + i]), dt);
    }
    float M[9];
    if (lane < 16) so3_exp(phi, M);
    else right_jacobian(phi, M);
    if (lane == 0 || lane == 16) {
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        if (lane == 0) S.E[i][0] = M[i];
        else S.Jdt[i][0] = fmul(M[i], dt);
      }
    }
    __syncwarp();
    // dR = I E and dR a with dR before the sample the identity, dv and dp
    // from zero, and cov = A 0 A^T + N = N (each entry of A 0 A^T is a
    // zero, and a zero plus N is N): N's entries over the lanes, B (9x6)
    // with the identity's rows
    const float I3[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    float E[9], Jd[9], dR[9], ra[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      E[i] = S.E[i][0];
      Jd[i] = S.Jdt[i][0];
    }
    mm3(I3, E, dR);
    mv3(I3, a, ra);
    float B[54];
#pragma unroll
    for (int r = 0; r < 9; ++r)
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        const int i = r % 3, j = m % 3;
        float v = 0.0f;
        if (r < 3 && m < 3) v = Jd[3 * i + j];
        if (r >= 3 && r < 6 && m >= 3) v = fmul(I3[3 * i + j], dt);
        if (r >= 6 && m >= 3) v = fmul(fmul(fmul(0.5f, I3[3 * i + j]), dt), dt);
        B[r * 6 + m] = v;
      }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int e = lane + 32 * u;
      if (e < 81) {
        const int r = e / 9, c = e - 9 * r;
        float v = 0.0f;
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          float br = 0.0f, bc = 0.0f;
#pragma unroll
          for (int rr = 0; rr < 9; ++rr) {
            br = rr == r ? B[rr * 6 + m] : br;
            bc = rr == c ? B[rr * 6 + m] : bc;
          }
          v = ffma(fmul(br, m < 3 ? qg : qa), bc, v);
        }
        cov_out[(size_t)b * 81 + e] = v;
      }
    }
    if (lane < 9) {
#pragma unroll
      for (int i = 0; i < 9; ++i)
        if (i == lane) dR_out[(size_t)b * 9 + i] = dR[i];
    }
    if (lane < 3) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (i == lane) {
          dp_out[(size_t)b * 3 + i] = ffma(fmul(fmul(0.5f, ra[i]), dt), dt, ffma(0.0f, dt, 0.0f));
          dv_out[(size_t)b * 3 + i] = ffma(ra[i], dt, 0.0f);
        }
    }
    return;
  }
  // lane 0: dR; lanes 0..2: dv and dp of axis `lane`
  float dR[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float dv = 0.0f, dp = 0.0f;
  for (int e = lane; e < 81; e += 32) S.cov[0][e] = 0.0f;
  int cb = 0;  // the buffer holding cov
  load_chunk(Aw, Gw, 0, min(kPreChunk, steps), S.raw[0][0], S.raw[0][1], lane);
  for (int k0 = 0, c = 0; k0 < steps; k0 += kPreChunk, c ^= 1) {
    const int n = min(kPreChunk, steps - k0);
    const float* A = S.raw[c][0];
    const float* G = S.raw[c][1];
    cp_async_wait_all();
    __syncwarp();
    if (k0 + kPreChunk < steps)
      load_chunk(Aw, Gw, k0 + kPreChunk, min(kPreChunk, steps - k0 - kPreChunk),
                 S.raw[c ^ 1][0], S.raw[c ^ 1][1], lane);
    // the state-free half of the sample: a, phi, Exp(phi), Jr(phi) dt, a
    // lane a sample, or with 16 samples or fewer Exp on lane k and Jr on
    // lane 16 + k, each with its double sincos
    {
      const int k = n <= 16 ? (lane & 15) : lane;
      const bool exp_here = n > 16 || lane < 16, jr_here = n > 16 || lane >= 16;
      if (k < n) {
        float a[3], phi[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a[i] = fsub(A[3 * k + i], prm[i]);
          phi[i] = fmul(fsub(G[3 * k + i], prm[3 + i]), dt);
        }
        if (exp_here) {
          float E[9];
          so3_exp(phi, E);
#pragma unroll
          for (int i = 0; i < 3; ++i) S.a[i][k] = a[i];
#pragma unroll
          for (int i = 0; i < 9; ++i) S.E[i][k] = E[i];
        }
        if (jr_here) {
          float Jr[9];
          right_jacobian(phi, Jr);
#pragma unroll
          for (int i = 0; i < 9; ++i) S.Jdt[i][k] = fmul(Jr[i], dt);
        }
      }
    }
    __syncwarp();
    // the carried rotation: dR before each sample, then dR <- dR E
    if (lane == 0) {
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float E[9], nR[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          E[i] = S.E[i][k];
          S.dR[i][k] = dR[i];
        }
        mm3(dR, E, nR);
#pragma unroll
        for (int i = 0; i < 9; ++i) dR[i] = nR[i];
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) S.dRout[i] = dR[i];
    }
    __syncwarp();
    // what the sample's dR gives: dR a, A's blocks -dR hat(a) dt and
    // -0.5 dR hat(a) dt^2, and N = (B diag Q) B^T
    if (lane < n) {
      const int k = lane;
      float R[9], a[3], ha[9], hRa[9], ra[3];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = S.dR[i][k];
#pragma unroll
      for (int i = 0; i < 3; ++i) a[i] = S.a[i][k];
      mv3(R, a, ra);
#pragma unroll
      for (int i = 0; i < 3; ++i) S.ra[i][k] = ra[i];
      hat(a, ha);
      mm3(R, ha, hRa);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        S.X[i][k] = fmul(-hRa[i], dt);
        S.Y[i][k] = fmul(fmul(fmul(-0.5f, hRa[i]), dt), dt);
      }
    }
    __syncwarp();
    // B (9x6): rows 0..2 Jr dt on the gyro noise; rows 3..5 dR dt and rows
    // 6..8 0.5 dR dt^2 on the accel noise, zeros included; and B diag Q:
    // the chunk's 54 n entries spread over the lanes
    for (int x = lane; x < 54 * n; x += 32) {
      const int k = x / 54, e = x - 54 * k, r = e / 6, m = e - 6 * r;
      const int i = r % 3, j = m % 3;
      float v = 0.0f;
      if (r < 3 && m < 3) v = S.Jdt[3 * i + j][k];
      if (r >= 3 && r < 6 && m >= 3) v = fmul(S.dR[3 * i + j][k], dt);
      if (r >= 6 && m >= 3) v = fmul(fmul(fmul(0.5f, S.dR[3 * i + j][k]), dt), dt);
      S.B[e][k] = v;
      S.BQ[e][k] = fmul(v, m < 3 ? qg : qa);
    }
    __syncwarp();
    // N = (B diag Q) B^T as torch.matmul forms it, each entry an in-order
    // chain of multiply-adds over the 6 dense terms: the chunk's 81 n
    // entries spread over the lanes
    for (int x = lane; x < 81 * n; x += 32) {
      const int k = x / 81, e = x - 81 * k, r = e / 9, c = e - 9 * r;
      float v = 0.0f;
#pragma unroll
      for (int m = 0; m < 6; ++m) v = ffma(S.BQ[r * 6 + m][k], S.B[c * 6 + m][k], v);
      S.N[e][k] = v;
    }
    __syncwarp();
    // the carried covariance on lanes 0..8, lane r row r: cov <- (A cov)
    // A^T + N as torch.matmul forms it, each entry the in-order chain of
    // multiply-adds over the dense terms of which the zero ones are left
    // out (a zero term adds nothing: the sums here are never -0 and the
    // terms finite) and a unit coefficient's is an addition; the whole
    // previous cov read from shared memory, one warp barrier a sample.
    // Lanes 0..2 carry dv and dp beside it.
    if (lane < 9) {
      const int r = lane;
      // the first sample of a window: cov is 0, so A 0 A^T + N is N (each
      // entry of A 0 A^T is a zero, and a zero plus N is N)
      const int k1 = k0 == 0 ? 1 : 0;
      if (k0 == 0) {
#pragma unroll
        for (int c = 0; c < 9; ++c) S.cov[cb ^ 1][9 * r + c] = S.N[9 * r + c][0];
        cb ^= 1;
        if (r < 3) {
          const float ra = S.ra[r][0];
          dp = ffma(fmul(fmul(0.5f, ra), dt), dt, ffma(dv, dt, dp));
          dv = ffma(ra, dt, dv);
        }
        __syncwarp(0x1ffu);
      }
      for (int k = k1; k < n; ++k) {
        float E[9], X[9], Y[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          E[i] = S.E[i][k];
          X[i] = S.X[i][k];
          Y[i] = S.Y[i][k];
        }
        // row r of A: a[0..2] on cov's rows 0..2 (read by the lane's own
        // index from shared memory, not from the arrays above, which would
        // then live in local memory), dt on row r - 3 (rows 6..8), 1 on row
        // r itself (rows 3..8)
        const int ri = r < 3 ? r : (r < 6 ? r - 3 : r - 6);
        float a[3];
#pragma unroll
        for (int n2 = 0; n2 < 3; ++n2)
          a[n2] = r < 3 ? S.E[3 * n2 + ri][k] : (r < 6 ? S.X[3 * ri + n2][k] : S.Y[3 * ri + n2][k]);
        const float d = r >= 6 ? dt : 0.0f, o = r >= 3 ? 1.0f : 0.0f;
        const int rd = r >= 6 ? r - 3 : 0;
        const float* C = S.cov[cb];
        float M[9];  // row r of A cov
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          float v = fmul(a[0], C[j]);
          v = ffma(a[1], C[9 + j], v);
          v = ffma(a[2], C[18 + j], v);
          v = ffma(d, C[9 * rd + j], v);
          M[j] = ffma(o, C[9 * r + j], v);
        }
        // row r of (A cov) A^T + N
        float* Cn = S.cov[cb ^ 1];
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          float v;
          if (c < 3) {
            v = ffma(M[2], E[6 + c], ffma(M[1], E[3 + c], fmul(M[0], E[c])));
          } else if (c < 6) {
            const int i = c - 3;
            v = fadd(ffma(M[2], X[3 * i + 2], ffma(M[1], X[3 * i + 1], fmul(M[0], X[3 * i]))),
                     M[c]);
          } else {
            const int i = c - 6;
            v = fadd(ffma(M[c - 3], dt, ffma(M[2], Y[3 * i + 2],
                                             ffma(M[1], Y[3 * i + 1], fmul(M[0], Y[3 * i])))),
                     M[c]);
          }
          Cn[9 * r + c] = fadd(v, S.N[9 * r + c][k]);
        }
        cb ^= 1;
        if (r < 3) {  // the nominal update of axis r (pre-update dR and dv on the right)
          const float ra = S.ra[r][k];
          dp = ffma(fmul(fmul(0.5f, ra), dt), dt, ffma(dv, dt, dp));
          dv = ffma(ra, dt, dv);
        }
        __syncwarp(0x1ffu);
      }
    }
    __syncwarp();
    cb = __shfl_sync(0xffffffffu, cb, 0);
  }
  for (int e = lane; e < 81; e += 32) cov_out[(size_t)b * 81 + e] = S.cov[cb][e];
  if (lane < 9) dR_out[(size_t)b * 9 + lane] = S.dRout[lane];
  if (lane < 3) {
    dv_out[(size_t)b * 3 + lane] = dv;
    dp_out[(size_t)b * 3 + lane] = dp;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// mode 0 (propagate): traj (B,T,10) from state0 (B,10); out1..3 unused.
// mode 1 (preintegrate): dR (B,3,3), dv (B,3), dp (B,3), cov (B,9,9) into
// out0..out3; state0 unused. acc, gyr (B,T,3) and params (11,) float32, all
// contiguous. One warp a window; launches on `stream`, does not synchronize.
extern "C" int imu_scan(int device, int mode, int batch, int steps, const void* acc,
                        const void* gyr, const void* params, const void* state0, float dt,
                        void* out0, void* out1, void* out2, void* out3, void* stream) {
  if (batch < 1 || steps < 1 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    propagate_kernel<<<batch, kPropThreads, 0, s>>>(steps, (const float*)acc, (const float*)gyr,
                                          (const float*)params, (const float*)state0, dt,
                                          (float*)out0);
  } else {
    preintegrate_kernel<<<batch, 32, 0, s>>>(steps, (const float*)acc, (const float*)gyr,
                                             (const float*)params, dt, (float*)out0,
                                             (float*)out1, (float*)out2, (float*)out3);
  }
  return (int)cudaGetLastError();
}
