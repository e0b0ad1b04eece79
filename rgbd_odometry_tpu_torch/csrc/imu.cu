// IMU propagation and preintegration of B windows of T samples in one
// launch, for Hopper.
//
// Replaces the two `lax.scan` loops of the JAX package's IMU solver (XLA
// code, no Pallas kernel): `propagate_batch` over `propagate_step`
// (rgbd_odometry_tpu/solvers/imu.py:94-130) and `preintegrate`
// (:194-250), with the `jax.vmap` over windows around them
// (rgbd_odometry_tpu/pipeline/fused.py:276).
//
// propagate_kernel: one thread a window. Each sample: R from the
// quaternion, the bias-corrected specific force rotated into the world
// frame plus gravity, p += v dt + acc dt^2 / 2, v += acc dt, q <- q exp(w
// dt) normalized; the state after every sample is written out.
//
// preintegrate_kernel: one warp a window. Every lane runs the nominal
// chain (dR, dv, dp, and the sample's Exp(phi), right Jacobian and dR
// hat(a)) alike; the 81 covariance entries are spread over the lanes
// (entry e on lane e % 32), cov <- (A cov) A^T + (B diag Q) B^T through the
// warp's shared memory, A the 9x9 error-state transition and B the 9x6
// noise input of kernels/imu.py `transition`.
//
// The nominal chain is the plain version's (kernels/imu.py) operation for
// operation: round-to-nearest intrinsics, a fused multiply-add exactly where
// the plain version takes one (where XLA:CPU contracts a product into a
// sum), sin and cos in double rounded once, correctly rounded square roots
// and divisions; so states, dR, dv and dp are bitwise the plain version's.
// The covariance sums are fused multiply-add chains in index order, which
// agree with torch.matmul's to float32 rounding.
//
// What bounds it on the H100: not the bytes (6 floats in and 10 out a
// sample; 5 us for B = 64, T = 400 at 3.35 TB/s is 0.03 us of traffic) but
// the serial chain of T samples, each ~100 dependent float32 operations, a
// correctly rounded square root and division, and a double sin and cos.
// Windows run in parallel, so the time is T samples' latency for any B up
// to the card's threads.

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
constexpr int kPropThreads = 64;
constexpr int kWarps = 4;  // windows a block in preintegrate

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

__global__ void __launch_bounds__(kPropThreads)
propagate_kernel(int batch, int steps, const float* __restrict__ acc,
                 const float* __restrict__ gyr, const float* __restrict__ params,
                 const float* __restrict__ state0, float dt, float* __restrict__ traj) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float prm[kParams];
#pragma unroll
  for (int i = 0; i < kParams; ++i) prm[i] = params[i];
  float p[3], v[3], q[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = state0[(size_t)b * kState + i];
    v[i] = state0[(size_t)b * kState + 3 + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = state0[(size_t)b * kState + 6 + i];
  const float* A = acc + (size_t)b * steps * 3;
  const float* G = gyr + (size_t)b * steps * 3;
  float* out = traj + (size_t)b * steps * kState;
  for (int k = 0; k < steps; ++k) {
    float R[9], a[3], w[3], ra[3];
    rot_of_quat(q, R);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[i] = fsub(A[k * 3 + i], prm[i]);
      w[i] = fmul(fsub(G[k * 3 + i], prm[3 + i]), dt);
    }
    mv3(R, a, ra);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float ac = fadd(ra[i], prm[8 + i]);
      p[i] = ffma(fmul(fmul(0.5f, ac), dt), dt, ffma(v[i], dt, p[i]));
      v[i] = ffma(ac, dt, v[i]);
    }
    float dq[4], qm[4];
    quat_from_rotvec(w, dq);
    quat_mul(q, dq, qm);
    const float n = __fsqrt_rn(sq4(qm));
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = fdiv(qm[i], n);
    float* o = out + (size_t)k * kState;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[i] = p[i];
      o[3 + i] = v[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) o[6 + i] = q[i];
  }
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

struct WarpScratch {
  float A[81];
  float B[54];
  float cov[81];
  float M[81];
};

__global__ void __launch_bounds__(kWarps * 32)
preintegrate_kernel(int batch, int steps, const float* __restrict__ acc,
                    const float* __restrict__ gyr, const float* __restrict__ params, float dt,
                    float* __restrict__ dR_out, float* __restrict__ dv_out,
                    float* __restrict__ dp_out, float* __restrict__ cov_out) {
  __shared__ WarpScratch scratch[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // a whole warp leaves together
  WarpScratch& S = scratch[warp];
  float prm[kParams];
#pragma unroll
  for (int i = 0; i < kParams; ++i) prm[i] = params[i];
  float Q[6];
#pragma unroll
  for (int n = 0; n < 6; ++n) Q[n] = n < 3 ? prm[7] : prm[6];
  for (int e = lane; e < 81; e += 32) S.cov[e] = 0.0f;
  float dR[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float dv[3] = {0.0f, 0.0f, 0.0f}, dp[3] = {0.0f, 0.0f, 0.0f};
  const float* Aw = acc + (size_t)b * steps * 3;
  const float* Gw = gyr + (size_t)b * steps * 3;
  for (int k = 0; k < steps; ++k) {
    float a[3], phi[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[i] = fsub(Aw[k * 3 + i], prm[i]);
      phi[i] = fmul(fsub(Gw[k * 3 + i], prm[3 + i]), dt);
    }
    float E[9], Jr[9], ha[9], hRa[9];
    so3_exp(phi, E);
    right_jacobian(phi, Jr);
    hat(a, ha);
    mm3(dR, ha, hRa);
    // A and B of this sample into the warp's shared memory, entry e by lane
    // e % 32 (constant indices into the registers above)
#pragma unroll
    for (int r = 0; r < 9; ++r) {
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        if ((r * 9 + c) % 32 != lane) continue;
        const int br = r / 3, bc = c / 3, i = r % 3, j = c % 3;
        float x = 0.0f;
        if (br == 0 && bc == 0) x = E[j * 3 + i];
        if (br == 1 && bc == 0) x = fmul(-hRa[i * 3 + j], dt);
        if (br == 1 && bc == 1) x = i == j ? 1.0f : 0.0f;
        if (br == 2 && bc == 0) x = fmul(fmul(fmul(-0.5f, hRa[i * 3 + j]), dt), dt);
        if (br == 2 && bc == 1) x = i == j ? dt : 0.0f;
        if (br == 2 && bc == 2) x = i == j ? 1.0f : 0.0f;
        S.A[r * 9 + c] = x;
      }
    }
#pragma unroll
    for (int r = 0; r < 9; ++r) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if ((r * 6 + c) % 32 != lane) continue;
        const int br = r / 3, bc = c / 3, i = r % 3, j = c % 3;
        float x = 0.0f;
        if (br == 0 && bc == 0) x = fmul(Jr[i * 3 + j], dt);
        if (br == 1 && bc == 1) x = fmul(dR[i * 3 + j], dt);
        if (br == 2 && bc == 1) x = fmul(fmul(fmul(0.5f, dR[i * 3 + j]), dt), dt);
        S.B[r * 6 + c] = x;
      }
    }
    __syncwarp();
    for (int e = lane; e < 81; e += 32) {  // M = A cov
      const int r = e / 9, c = e % 9;
      float s = 0.0f;
      for (int m = 0; m < 9; ++m) s = ffma(S.A[r * 9 + m], S.cov[m * 9 + c], s);
      S.M[e] = s;
    }
    __syncwarp();
    float next[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) {  // cov = M A^T + (B diag Q) B^T
      const int e = lane + 32 * u;
      if (e >= 81) break;
      const int r = e / 9, c = e % 9;
      float s = 0.0f;
      for (int m = 0; m < 9; ++m) s = ffma(S.M[r * 9 + m], S.A[c * 9 + m], s);
      float n = 0.0f;
#pragma unroll
      for (int m = 0; m < 6; ++m) n = ffma(fmul(S.B[r * 6 + m], Q[m]), S.B[c * 6 + m], n);
      next[u] = fadd(s, n);
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (lane + 32 * u < 81) S.cov[lane + 32 * u] = next[u];
    __syncwarp();
    // the nominal update (pre-update dR and dv on the right)
    float ra[3];
    mv3(dR, a, ra);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dp[i] = ffma(fmul(fmul(0.5f, ra[i]), dt), dt, ffma(dv[i], dt, dp[i]));
      dv[i] = ffma(ra[i], dt, dv[i]);
    }
    float nR[9];
    mm3(dR, E, nR);
#pragma unroll
    for (int i = 0; i < 9; ++i) dR[i] = nR[i];
  }
  for (int e = lane; e < 81; e += 32) cov_out[(size_t)b * 81 + e] = S.cov[e];
  if (lane < 9) {
#pragma unroll
    for (int i = 0; i < 9; ++i)
      if (i == lane) dR_out[(size_t)b * 9 + i] = dR[i];
  }
  if (lane < 3) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i == lane) {
        dv_out[(size_t)b * 3 + i] = dv[i];
        dp_out[(size_t)b * 3 + i] = dp[i];
      }
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// mode 0 (propagate): traj (B,T,10) from state0 (B,10); out1..3 unused.
// mode 1 (preintegrate): dR (B,3,3), dv (B,3), dp (B,3), cov (B,9,9) into
// out0..out3; state0 unused. acc, gyr (B,T,3) and params (11,) float32, all
// contiguous. Launches on `stream`, does not synchronize.
extern "C" int imu_scan(int device, int mode, int batch, int steps, const void* acc,
                        const void* gyr, const void* params, const void* state0, float dt,
                        void* out0, void* out1, void* out2, void* out3, void* stream) {
  if (batch < 1 || steps < 1 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    const int blocks = (batch + kPropThreads - 1) / kPropThreads;
    propagate_kernel<<<blocks, kPropThreads, 0, s>>>(
        batch, steps, (const float*)acc, (const float*)gyr, (const float*)params,
        (const float*)state0, dt, (float*)out0);
  } else {
    const int blocks = (batch + kWarps - 1) / kWarps;
    preintegrate_kernel<<<blocks, kWarps * 32, 0, s>>>(
        batch, steps, (const float*)acc, (const float*)gyr, (const float*)params, dt,
        (float*)out0, (float*)out1, (float*)out2, (float*)out3);
  }
  return (int)cudaGetLastError();
}
