// Small dense pose algebra for one thread: the 6x6 Cholesky solve, the
// SE(3) exponential and logarithm, the compose of a right-multiplied
// update, the Newton-Schulz re-orthogonalization and the Levenberg-Marquardt
// step (damped system, trust region), element by element with
// round-to-nearest intrinsics (nothing is contracted into a fused
// multiply-add). The plain PyTorch twins are the functions of the same
// names in kernels/se3_plain.py, which perform these operations in this
// order; the math is that of ops/linalg6.chol_solve6 (1e-20 pivot floor),
// core/geometry (se3_exp, so3_log and se3_log with sin, cos and arccos taken
// in double and rounded once, compose, rotationize_newton) and
// kernels/level_lm.lm_psi.
#pragma once

#include <cuda_runtime.h>

namespace rgbd {

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// Solve H x = g for SPD H (6x6, row-major).
__device__ inline void chol_solve6(const float H[36], const float g[6], float x[6]) {
  float L[36];
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

__device__ __forceinline__ float sign_or_one(float x) {
  return x < 0.0f ? -1.0f : 1.0f;  // sign(x) with 0 (and NaN) mapped to +1
}

// Log map of SO(3), R row-major -> w, in three branches: Taylor for cos
// theta > 1 - 1e-6, the generic theta / (2 sin theta) vee(R - R^T), and for
// cos theta < -(1 - 5e-7) the axis from the diagonal of (R + R^T)/2 - cos
// theta I with the signs from its off-diagonals (the largest component
// carries +1; the first wins a tie).
__device__ inline void so3_log(const float R[9], float w[3]) {
  const float trace = fadd(fadd(R[0], R[4]), R[8]);
  const float cs = fminf(fmaxf(fmul(fsub(trace, 1.0f), 0.5f), -1.0f), 1.0f);
  const bool small = cs > 0.999999f;
  const bool near_pi = cs < -0.9999995f;
  const float theta = (float)acos((double)(small ? 0.0f : cs));
  if (near_pi) {
    const float denom = fmaxf(fsub(1.0f, cs), 1e-8f);
    float a2[3];
    for (int i = 0; i < 3; ++i)
      a2[i] = fmaxf(fdiv(fsub(fmul(0.5f, fadd(R[4 * i], R[4 * i])), cs), denom), 0.0f);
    const float s01 = sign_or_one(fmul(0.5f, fadd(R[1], R[3])));
    const float s02 = sign_or_one(fmul(0.5f, fadd(R[2], R[6])));
    const float s12 = sign_or_one(fmul(0.5f, fadd(R[5], R[7])));
    const int imax = (a2[0] >= a2[1] && a2[0] >= a2[2]) ? 0 : (a2[1] >= a2[2] ? 1 : 2);
    const float sgn[3] = {imax == 0 ? 1.0f : (imax == 1 ? s01 : s02),
                          imax == 1 ? 1.0f : (imax == 0 ? s01 : s12),
                          imax == 2 ? 1.0f : (imax == 0 ? s02 : s12)};
    for (int i = 0; i < 3; ++i) w[i] = fmul(fmul(theta, __fsqrt_rn(a2[i])), sgn[i]);
    return;
  }
  float k;
  if (small) {
    k = fmul(0.5f, fadd(1.0f, fdiv(fmul(2.0f, fsub(1.0f, cs)), 6.0f)));
  } else {
    const float sn = (float)sin((double)theta);
    k = fdiv(fmul(0.5f, theta), fabsf(sn) < 1e-8f ? 1.0f : sn);
  }
  w[0] = fmul(k, fsub(R[7], R[5]));
  w[1] = fmul(k, fsub(R[2], R[6]));
  w[2] = fmul(k, fsub(R[3], R[1]));
}

// (R, t) -> twist [v, w], the inverse of se3_exp: v = V^-1 t with V^-1 = I -
// W/2 + coef W^2, coef = 1/12 + theta^2/720 below theta^2 = 1e-3, else
// (1 - a / (2 b)) / theta^2.
__device__ inline void se3_log(const float R[9], const float t[3], float psi[6]) {
  float w[3];
  so3_log(R, w);
  const float theta2 = fadd(fadd(fmul(w[0], w[0]), fmul(w[1], w[1])), fmul(w[2], w[2]));
  float coef;
  if (theta2 < 1e-3f) {
    coef = fadd((float)(1.0 / 12.0), fdiv(theta2, 720.0f));
  } else {
    const float theta = __fsqrt_rn(fadd(theta2, 1e-16f));
    const float a = fdiv((float)sin((double)theta), theta);
    const float b = fdiv(fsub(1.0f, (float)cos((double)theta)), theta2);
    coef = fdiv(fsub(1.0f, fdiv(a, fmul(2.0f, b))), fmaxf(theta2, 1e-16f));
  }
  const float W[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
  float WW[9];
  mat3(W, W, WW);
  for (int i = 0; i < 3; ++i) {
    float V[3];
    for (int j = 0; j < 3; ++j)
      V[j] = fadd(fsub(i == j ? 1.0f : 0.0f, fmul(0.5f, W[i * 3 + j])), fmul(coef, WW[i * 3 + j]));
    psi[i] = fadd(fadd(fmul(V[0], t[0]), fmul(V[1], t[1])), fmul(V[2], t[2]));
    psi[3 + i] = w[i];
  }
}

// C = A^T B for 3x3 row-major matrices.
__device__ __forceinline__ void mat3_tn(const float A[9], const float B[9], float C[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = fadd(fadd(fmul(A[0 * 3 + i], B[0 * 3 + j]), fmul(A[1 * 3 + i], B[1 * 3 + j])),
                          fmul(A[2 * 3 + i], B[2 * 3 + j]));
}

// The right-multiplied update (R xR, t + R xt).
__device__ inline void compose(const float R[9], const float t[3], const float xR[9],
                               const float xt[3], float Ro[9], float to[3]) {
  mat3(R, xR, Ro);
  for (int i = 0; i < 3; ++i)
    to[i] = fadd(t[i], fadd(fadd(fmul(R[i * 3 + 0], xt[0]), fmul(R[i * 3 + 1], xt[1])),
                            fmul(R[i * 3 + 2], xt[2])));
}

// Newton-Schulz polar iteration X <- X (1.5 I - 0.5 X^T X), 3 steps, in place.
__device__ inline void rotationize_newton(float X[9]) {
  for (int it = 0; it < 3; ++it) {
    float M[9], Y[9], Z[9];
    mat3_tn(X, X, M);
    for (int i = 0; i < 9; ++i) Y[i] = fsub((i % 4 == 0) ? 1.5f : 0.0f, fmul(0.5f, M[i]));
    mat3(X, Y, Z);
    for (int i = 0; i < 9; ++i) X[i] = Z[i];
  }
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
