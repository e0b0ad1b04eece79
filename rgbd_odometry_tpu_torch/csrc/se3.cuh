// Small dense pose algebra for one thread: the 6x6 Cholesky solve, the
// SE(3) exponential and the Levenberg-Marquardt step (damped system, trust
// region), element by element with round-to-nearest intrinsics (nothing is
// contracted into a fused multiply-add). The plain PyTorch twins are the
// functions of the same names in kernels/se3_plain.py, which perform these
// operations in this order; the math is that of ops/linalg6.chol_solve6
// (1e-20 pivot floor), core/geometry.se3_exp (sin and cos taken in double
// and rounded once) and kernels/level_lm.lm_psi. The level solvers' step on
// a warp (warp.cuh) builds on these; its log, compose and Newton-Schulz
// are warp.cuh's own.
#pragma once

#include <cuda_runtime.h>

namespace rgbd {

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// The Cholesky factor of SPD H (6x6, row-major): L's lower triangle (row-
// major, the diagonal included) is written; its upper entries are not.
__device__ inline void chol_factor6(const float H[36], float L[36]) {
  for (int j = 0; j < 6; ++j) {
    float s[6];
    for (int r = j; r < 6; ++r) {
      float acc = 0.0f;
      for (int c = 0; c < j; ++c) acc = fadd(acc, fmul(L[r * 6 + c], L[j * 6 + c]));
      s[r - j] = fsub(H[r * 6 + j], acc);
    }
    const float d = __fsqrt_rn(fmaxf(s[0], 1e-20f));
    L[j * 6 + j] = d;
    const float inv = __frcp_rn(d);
    for (int r = j + 1; r < 6; ++r) L[r * 6 + j] = fmul(s[r - j], inv);
  }
}

// Solve L L^T x = g by the two substitutions, L from chol_factor6.
__device__ inline void chol_subst6(const float L[36], const float g[6], float x[6]) {
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < i; ++c) acc = fadd(acc, fmul(L[i * 6 + c], y[c]));
    y[i] = fdiv(fsub(g[i], acc), L[i * 6 + i]);
  }
  for (int i = 5; i >= 0; --i) {
    float acc = 0.0f;
    for (int c = i + 1; c < 6; ++c) acc = fadd(acc, fmul(L[c * 6 + i], x[c]));
    x[i] = fdiv(fsub(y[i], acc), L[i * 6 + i]);
  }
}

// Solve H x = g for SPD H (6x6, row-major): the factor, then the
// substitutions (a caller whose H does not change factors once and
// substitutes each time, with the same bits).
__device__ inline void chol_solve6(const float H[36], const float g[6], float x[6]) {
  float L[36];
  chol_factor6(H, L);
  chol_subst6(L, g, x);
}

// C = A B for 3x3 row-major matrices.
__device__ __forceinline__ void mat3(const float A[9], const float B[9], float C[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = fadd(fadd(fmul(A[i * 3 + 0], B[0 * 3 + j]), fmul(A[i * 3 + 1], B[1 * 3 + j])),
                          fmul(A[i * 3 + 2], B[2 * 3 + j]));
}

// Twist psi = [v, w] -> (R row-major, t): R = I + a W + b W^2, t = (I + b W
// + c W^2) v with (a, b, c) = (sin t / t, (1 - cos t) / t^2, (t - sin t) /
// t^3), Taylor forms below theta^2 = 1e-8.
__device__ inline void se3_exp(const float psi[6], float R[9], float t[3]) {
  const float w0 = psi[3], w1 = psi[4], w2 = psi[5];
  const float theta2 = fadd(fadd(fmul(w0, w0), fmul(w1, w1)), fmul(w2, w2));
  const float theta = __fsqrt_rn(fadd(theta2, 1e-16f));
  const bool small = theta2 < 1e-8f;
  const float sn = (float)sin((double)theta);
  const float cs = (float)cos((double)theta);
  const float a = small ? fsub(1.0f, fdiv(theta2, 6.0f)) : fdiv(sn, theta);
  const float b = small ? fsub(0.5f, fdiv(theta2, 24.0f)) : fdiv(fsub(1.0f, cs), theta2);
  const float c = small ? fsub((float)(1.0 / 6.0), fdiv(theta2, 120.0f))
                        : fdiv(fsub(theta, sn), fmul(theta2, theta));
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float WW[9];
  mat3(W, W, WW);
  float V[9];
  for (int i = 0; i < 9; ++i) {
    const float e = (i % 4 == 0) ? 1.0f : 0.0f;
    R[i] = fadd(fadd(e, fmul(a, W[i])), fmul(b, WW[i]));
    V[i] = fadd(fadd(e, fmul(b, W[i])), fmul(c, WW[i]));
  }
  for (int i = 0; i < 3; ++i)
    t[i] = fadd(fadd(fmul(V[i * 3 + 0], psi[0]), fmul(V[i * 3 + 1], psi[1])),
                fmul(V[i * 3 + 2], psi[2]));
}

// sign(x) of so3_log's near-pi branch, 0 (and NaN) mapped to +1.
__device__ __forceinline__ float sign_or_one(float x) {
  return x < 0.0f ? -1.0f : 1.0f;
}

// |psi|: the squares summed in order, then a correctly rounded sqrt.
__device__ __forceinline__ float norm6(const float p[6]) {
  float acc = fmul(p[0], p[0]);
  for (int i = 1; i < 6; ++i) acc = fadd(acc, fmul(p[i], p[i]));
  return __fsqrt_rn(acc);
}

// psi scaled back onto the ball |psi| <= radius, in place.
__device__ __forceinline__ void trust_region(float psi[6], float radius) {
  const float n = norm6(psi);
  if (n > radius) {
    const float s = fdiv(radius, fmaxf(n, 1e-30f));
    for (int i = 0; i < 6; ++i) psi[i] = fmul(psi[i], s);
  }
}

// The damped system H + lam diag(max(diag H, 1e-8)) (6x6 row-major).
__device__ __forceinline__ void lm_damped(const float H[36], float lam, float A[36]) {
  for (int i = 0; i < 36; ++i)
    A[i] = (i % 7 == 0) ? fadd(H[i], fmul(lam, fmaxf(H[i], 1e-8f))) : H[i];
}

// The Levenberg-Marquardt step psi = -(H + lam diag H)^-1 g, projected onto
// the trust region.
__device__ inline void lm_psi(const float H[36], const float g[6], float lam, float radius,
                              float psi[6]) {
  float A[36], x[6];
  lm_damped(H, lam, A);
  chol_solve6(A, g, x);
  for (int i = 0; i < 6; ++i) psi[i] = -x[i];
  trust_region(psi, radius);
}

}  // namespace rgbd
