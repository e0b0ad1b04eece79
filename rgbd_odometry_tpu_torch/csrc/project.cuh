// Device code shared by the point kernels (fused_gn.cu, residual.cu,
// sg_terms.cu, level_lm.cu, level_sg.cu): the warp and pinhole projection of
// a reference edge point, the inclusive visibility test, the two ways of
// sampling the DT at the projected point, one point's Gauss-Newton terms,
// one point's sub-gradient terms, and the fixed-order block reduction.
//
// Every per-point value is computed with exactly the single, once-rounded
// operations of the plain PyTorch versions (ops/project.py: project_points;
// ops/interp.py), in the same order, through round-to-
// nearest intrinsics that nvcc cannot contract into FMAs. A kernel's
// per-point values are then bitwise equal to its plain version's; a one-ulp
// difference in u or v could move a point across a pixel boundary, where a
// floor lookup changes value and the bilinear gradient jumps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rgbd {

constexpr int kThreads = 256;  // one block of kThreads per frame pair

struct Pose {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;  // R, row-major
  float t0, t1, t2;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ R,
                                          const float* __restrict__ T, int b) {
  const float* Rb = R + (size_t)b * 9;
  const float* Tb = T + (size_t)b * 3;
  return Pose{Rb[0], Rb[1], Rb[2], Rb[3], Rb[4], Rb[5], Rb[6], Rb[7], Rb[8],
              Tb[0], Tb[1], Tb[2]};
}

struct Projected {
  float xn, yn, z, zs, u, v;
};

// X' = R^T (X - t) of the point at P (3 floats), then the pinhole projection
// with the JAX `_project`'s 1e-12 guard on z. kFmaUV: u = fx * xn + cx and
// v likewise as one fused multiply-add each, as XLA computes them (the
// floor-lookup kernels take JAX's pixel decisions at an identity start,
// where every point lands exactly on a pixel boundary); else a multiply and
// an add, each rounded.
template <bool kFmaUV = false>
__device__ __forceinline__ Projected project_xyz(const Pose& p, float X, float Y, float Z,
                                                 float fx, float fy, float cx, float cy) {
  const float d0 = __fsub_rn(X, p.t0);
  const float d1 = __fsub_rn(Y, p.t1);
  const float d2 = __fsub_rn(Z, p.t2);
  const float x0 = __fadd_rn(__fadd_rn(__fmul_rn(d0, p.r00), __fmul_rn(d1, p.r10)), __fmul_rn(d2, p.r20));
  const float x1 = __fadd_rn(__fadd_rn(__fmul_rn(d0, p.r01), __fmul_rn(d1, p.r11)), __fmul_rn(d2, p.r21));
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(d0, p.r02), __fmul_rn(d1, p.r12)), __fmul_rn(d2, p.r22));
  const float zs = fabsf(z) < 1e-12f ? 1e-12f : z;
  const float inv = __frcp_rn(zs);
  const float xn = __fmul_rn(x0, inv);
  const float yn = __fmul_rn(x1, inv);
  if constexpr (kFmaUV) return Projected{xn, yn, z, zs, __fmaf_rn(fx, xn, cx), __fmaf_rn(fy, yn, cy)};
  return Projected{xn, yn, z, zs, __fadd_rn(__fmul_rn(fx, xn), cx), __fadd_rn(__fmul_rn(fy, yn), cy)};
}

// `project_xyz` of the point at P (3 floats).
template <bool kFmaUV = false>
__device__ __forceinline__ Projected project(const Pose& p, const float* __restrict__ P,
                                             float fx, float fy, float cx, float cy) {
  return project_xyz<kFmaUV>(p, P[0], P[1], P[2], fx, fy, cx, cy);
}

// Visibility inclusive of the far image edge (u <= W, v <= H), as the
// reference's bound check.
__device__ __forceinline__ bool in_image(float u, float v, int h, int w) {
  return u >= 0.0f && u <= (float)w && v >= 0.0f && v <= (float)h;
}

// Bilinear sample of a bf16 image + the exact interpolant gradients
// (border-clamped, i1 = min(i0+1, n-1)); the four corners are widened to
// float32 and blended with float32 weights. fminf/fmaxf keep the indices in
// range whatever u, v are. The corners are read through the read-only data
// path (the image is L2-resident and never written by the kernel).
__device__ __forceinline__ void sample_bilinear(const __nv_bfloat16* __restrict__ I, int h, int w,
                                                float u, float v, float* val, float* gu, float* gv) {
  const float uc = fminf(fmaxf(u, 0.0f), (float)(w - 1));
  const float vc = fminf(fmaxf(v, 0.0f), (float)(h - 1));
  const float j0f = floorf(uc), i0f = floorf(vc);
  const float fu = __fsub_rn(uc, j0f), fv = __fsub_rn(vc, i0f);
  const float omfu = __fsub_rn(1.0f, fu), omfv = __fsub_rn(1.0f, fv);
  const int j0 = (int)j0f, i0 = (int)i0f;
  const int j1 = min(j0 + 1, w - 1), i1 = min(i0 + 1, h - 1);
  const unsigned short* U = reinterpret_cast<const unsigned short*>(I);
  const float a00 = __bfloat162float(__ushort_as_bfloat16(__ldg(U + (size_t)i0 * w + j0)));
  const float a01 = __bfloat162float(__ushort_as_bfloat16(__ldg(U + (size_t)i0 * w + j1)));
  const float a10 = __bfloat162float(__ushort_as_bfloat16(__ldg(U + (size_t)i1 * w + j0)));
  const float a11 = __bfloat162float(__ushort_as_bfloat16(__ldg(U + (size_t)i1 * w + j1)));
  const float row0 = __fadd_rn(__fmul_rn(omfv, a00), __fmul_rn(fv, a10));
  const float row1 = __fadd_rn(__fmul_rn(omfv, a01), __fmul_rn(fv, a11));
  *val = __fadd_rn(__fmul_rn(omfu, row0), __fmul_rn(fu, row1));
  *gu = __fsub_rn(row1, row0);
  *gv = __fadd_rn(__fmul_rn(omfu, __fsub_rn(a10, a00)), __fmul_rn(fu, __fsub_rn(a11, a01)));
}

// floor(clamp(c, 0, n-1)): the reference's floor lookup with clamped indices.
__device__ __forceinline__ int floor_index(float c, int n) {
  return (int)floorf(fminf(fmaxf(c, 0.0f), (float)(n - 1)));
}

// REFLECT_101: -1 -> 1, n -> n-2.
__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i > n - 1 ? 2 * (n - 1) - i : i);
}

// Floor lookup of a float32 image (the reference's DT sampling).
__device__ __forceinline__ float sample_floor(const float* __restrict__ D, int h, int w,
                                              float u, float v) {
  return D[(size_t)floor_index(v, h) * w + floor_index(u, w)];
}

// Floor lookup plus the central-difference gradients at the same pixel,
// 0.5 (D[i, j+1] - D[i, j-1]) and 0.5 (D[i+1, j] - D[i-1, j]) under
// REFLECT_101: the values of the precomputed gradient channels there.
__device__ __forceinline__ void sample_floor_cgrads(const float* __restrict__ D, int h, int w,
                                                    float u, float v, float* val, float* gx,
                                                    float* gy) {
  const int i = floor_index(v, h), j = floor_index(u, w);
  const float* row = D + (size_t)i * w;
  *val = __ldg(row + j);
  *gx = __fmul_rn(0.5f, __fsub_rn(__ldg(row + reflect101(j + 1, w)),
                                  __ldg(row + reflect101(j - 1, w))));
  *gy = __fmul_rn(0.5f, __fsub_rn(__ldg(D + (size_t)reflect101(i + 1, h) * w + j),
                                  __ldg(D + (size_t)reflect101(i - 1, h) * w + j)));
}

constexpr int kGnTerms = 29;  // 21 (upper triangle of H) + 6 (g) + e2 + count

// One reference point's Gauss-Newton terms at `pose` against the bf16 DT I:
// bilinear sample + interpolant gradients, robust weight 6 / (6 + eps_px^2
// / sigma^2) with eps_px = eps / sc, the textbook image Jacobian of the
// right-multiplied update, and its addends to the 29 running sums acc (the
// row-major upper triangle of J^T W J, J^T W eps, then e2 and the visible
// count). Writes the residual (0 where invisible) and the visibility.
__device__ __forceinline__ void gn_point(const Pose& pose, float X, float Y, float Z, bool valid,
                                         const __nv_bfloat16* __restrict__ I, int h, int w,
                                         float fx, float fy, float cx, float cy, float sc,
                                         float inv_sigma2, float (&acc)[kGnTerms], float* eps_o,
                                         bool* vis_o) {
  float eps = 0.0f;
  bool vis = false;
  if (valid) {
    const Projected p = project_xyz(pose, X, Y, Z, fx, fy, cx, cy);
    vis = in_image(p.u, p.v, h, w);
    if (vis) {
      float gu, gv;
      sample_bilinear(I, h, w, p.u, p.v, &eps, &gu, &gv);
      // w = 6 / (6 + eps_px^2 / sigma^2), as PyTorch evaluates 6.0 / x
      const float eps_px = __fdiv_rn(eps, sc);
      const float wgt = __fmul_rn(
          __frcp_rn(__fadd_rn(6.0f, __fmul_rn(__fmul_rn(eps_px, eps_px), inv_sigma2))), 6.0f);

      // textbook image Jacobian: d eps / d[v, w] = G A1 [-I | hat(X')]
      const float ga0 = __fdiv_rn(__fmul_rn(gu, fx), p.zs);
      const float ga1 = __fdiv_rn(__fmul_rn(gv, fy), p.zs);
      const float ga2 = __fdiv_rn(
          -__fadd_rn(__fmul_rn(__fmul_rn(gu, fx), p.xn), __fmul_rn(__fmul_rn(gv, fy), p.yn)),
          p.zs);
      const float xz = __fmul_rn(p.xn, p.z), yz = __fmul_rn(p.yn, p.z);
      float J[6];
      J[0] = -ga0;
      J[1] = -ga1;
      J[2] = -ga2;
      J[3] = __fsub_rn(__fmul_rn(ga1, p.z), __fmul_rn(ga2, yz));
      J[4] = __fsub_rn(__fmul_rn(ga2, xz), __fmul_rn(ga0, p.z));
      J[5] = __fsub_rn(__fmul_rn(ga0, yz), __fmul_rn(ga1, xz));

      int m = 0;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const float jw = __fmul_rn(J[r], wgt);
#pragma unroll
        for (int c = r; c < 6; ++c) acc[m++] += jw * J[c];
        acc[21 + r] += jw * eps;
      }
      acc[27] = __fmaf_rn(eps, eps, acc[27]);
      acc[28] += 1.0f;
    }
  }
  *eps_o = eps;
  *vis_o = vis;
}

constexpr int kSgTerms = 8;  // g = J^T W eps (6), e2, the visible count

// One reference point's sub-gradient terms at `pose` against the float32 DT
// D: the projection with u and v as one fused multiply-add each, the floor
// DT value and its central gradients, the weight 6 / (6 + eps^2 / sigma^2)
// (eps in DT units), the "reference" Jacobian with the dehomogenized-
// coordinate quirk, GA = [g0 fx, g1 fy, -(g0 fx xn + g1 fy yn)], J = [-R GA |
// GA x R^T (xn, yn, 1)], and its addends to the 8 running sums acc (J^T W
// eps, e2, the visible count). Writes the residual (0 where invisible) and
// the visibility.
__device__ __forceinline__ void sg_point(const Pose& q, float X, float Y, float Z, bool valid,
                                         const float* __restrict__ D, int h, int w, float fx,
                                         float fy, float cx, float cy, float inv_sigma2,
                                         float (&acc)[kSgTerms], float* eps_o, bool* vis_o) {
  float eps = 0.0f;
  bool vis = false;
  if (valid) {
    const Projected p = project_xyz<true>(q, X, Y, Z, fx, fy, cx, cy);
    vis = in_image(p.u, p.v, h, w);
    if (vis) {
      float gx, gy;
      sample_floor_cgrads(D, h, w, p.u, p.v, &eps, &gx, &gy);
      // w = 6 / (6 + eps^2 / sigma^2), as PyTorch evaluates 6.0 / x
      const float wgt = __fmul_rn(
          __frcp_rn(__fadd_rn(6.0f, __fmul_rn(__fmul_rn(eps, eps), inv_sigma2))), 6.0f);
      const float ga0 = __fmul_rn(gx, fx);
      const float ga1 = __fmul_rn(gy, fy);
      const float ga2 = -__fadd_rn(__fmul_rn(ga0, p.xn), __fmul_rn(ga1, p.yn));
      // translation block -R GA; rotation block GA x m, m = R^T (xn, yn, 1)
      float J[6];
      J[0] = -__fadd_rn(__fadd_rn(__fmul_rn(ga0, q.r00), __fmul_rn(ga1, q.r01)), __fmul_rn(ga2, q.r02));
      J[1] = -__fadd_rn(__fadd_rn(__fmul_rn(ga0, q.r10), __fmul_rn(ga1, q.r11)), __fmul_rn(ga2, q.r12));
      J[2] = -__fadd_rn(__fadd_rn(__fmul_rn(ga0, q.r20), __fmul_rn(ga1, q.r21)), __fmul_rn(ga2, q.r22));
      const float m0 = __fadd_rn(__fadd_rn(__fmul_rn(p.xn, q.r00), __fmul_rn(p.yn, q.r10)), q.r20);
      const float m1 = __fadd_rn(__fadd_rn(__fmul_rn(p.xn, q.r01), __fmul_rn(p.yn, q.r11)), q.r21);
      const float m2 = __fadd_rn(__fadd_rn(__fmul_rn(p.xn, q.r02), __fmul_rn(p.yn, q.r12)), q.r22);
      J[3] = __fsub_rn(__fmul_rn(ga1, m2), __fmul_rn(ga2, m1));
      J[4] = __fsub_rn(__fmul_rn(ga2, m0), __fmul_rn(ga0, m2));
      J[5] = __fsub_rn(__fmul_rn(ga0, m1), __fmul_rn(ga1, m0));
      const float we = __fmul_rn(wgt, eps);
#pragma unroll
      for (int r = 0; r < 6; ++r) acc[r] = __fmaf_rn(J[r], we, acc[r]);
      acc[6] = __fmaf_rn(eps, eps, acc[6]);
      acc[7] += 1.0f;
    }
  }
  *eps_o = eps;
  *vis_o = vis;
}

// Sum N per-thread partials over the block in a fixed tree order; the sums
// end in red[m][0]. No atomics: a result is the same bit for bit from run
// to run. Every thread of the block must call it.
template <int N>
__device__ __forceinline__ void block_reduce(const float (&acc)[N], float (*red)[kThreads],
                                             int tid) {
#pragma unroll
  for (int m = 0; m < N; ++m) red[m][tid] = acc[m];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int m = 0; m < N; ++m) red[m][tid] += red[m][tid + s];
    }
    __syncthreads();
  }
}

}  // namespace rgbd
