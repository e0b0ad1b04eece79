// Device code shared by the point kernels (fused_gn.cu, residual.cu,
// sg_terms.cu, level_lm.cu, level_sg.cu): the warp and pinhole projection of
// a reference edge point, the inclusive visibility test, the ways of
// sampling the DT at the projected point, one point's Gauss-Newton terms,
// one point's sub-gradient terms, and the fixed-order block reduction.
//
// `gn_point` and `sg_point` compute one point's terms under a `PointSem`
// that is the same for every point of a launch (kernels/point_sem.py): the
// production semantics (`gn_production`, `sg_production`) and every other
// branch of the JAX package's per-point terms
// (rgbd_odometry_tpu/solvers/edge_dvo.py `_sample_dt` :241-259,
// `_jacobian_residual` :293-398; ops/interp.py): the projection with or
// without XLA's fused multiply-adds, the sampler, the weight's divisions
// and the Jacobian. The plain twins are those of kernels/fused_iter.py
// (gn_point_terms), kernels/sg_terms.py (sg_point_terms) and
// kernels/residual.py (sample_value).
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
// an add, each rounded. kFmaZ: z = fma(d2, R22, fma(d1, R12, d0 R02)), as
// XLA's CPU dot forms the third column of the JAX `_project`'s warp (the
// reference-parity configurations' projection).
template <bool kFmaUV = false, bool kFmaZ = false>
__device__ __forceinline__ Projected project_xyz(const Pose& p, float X, float Y, float Z,
                                                 float fx, float fy, float cx, float cy) {
  const float d0 = __fsub_rn(X, p.t0);
  const float d1 = __fsub_rn(Y, p.t1);
  const float d2 = __fsub_rn(Z, p.t2);
  const float x0 = __fadd_rn(__fadd_rn(__fmul_rn(d0, p.r00), __fmul_rn(d1, p.r10)), __fmul_rn(d2, p.r20));
  const float x1 = __fadd_rn(__fadd_rn(__fmul_rn(d0, p.r01), __fmul_rn(d1, p.r11)), __fmul_rn(d2, p.r21));
  const float z = kFmaZ
      ? __fmaf_rn(d2, p.r22, __fmaf_rn(d1, p.r12, __fmul_rn(d0, p.r02)))
      : __fadd_rn(__fadd_rn(__fmul_rn(d0, p.r02), __fmul_rn(d1, p.r12)), __fmul_rn(d2, p.r22));
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

// One element of a bf16 or float32 plane, widened to float32, through the
// read-only data path (a plane is L2-resident and never written by a kernel).
__device__ __forceinline__ float load(const __nv_bfloat16* __restrict__ I, size_t i) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(I) + i)));
}
__device__ __forceinline__ float load(const float* __restrict__ I, size_t i) { return __ldg(I + i); }

// Bilinear sample of a bf16 or float32 plane + the exact interpolant
// gradients (border-clamped, i1 = min(i0+1, n-1)); the four corners are
// widened to float32 and blended with float32 weights. fminf/fmaxf keep the
// indices in range whatever u, v are.
template <typename T>
__device__ __forceinline__ void sample_bilinear(const T* __restrict__ I, int h, int w, float u,
                                                float v, float* val, float* gu, float* gv) {
  const float uc = fminf(fmaxf(u, 0.0f), (float)(w - 1));
  const float vc = fminf(fmaxf(v, 0.0f), (float)(h - 1));
  const float j0f = floorf(uc), i0f = floorf(vc);
  const float fu = __fsub_rn(uc, j0f), fv = __fsub_rn(vc, i0f);
  const float omfu = __fsub_rn(1.0f, fu), omfv = __fsub_rn(1.0f, fv);
  const int j0 = (int)j0f, i0 = (int)i0f;
  const int j1 = min(j0 + 1, w - 1), i1 = min(i0 + 1, h - 1);
  const float a00 = load(I, (size_t)i0 * w + j0);
  const float a01 = load(I, (size_t)i0 * w + j1);
  const float a10 = load(I, (size_t)i1 * w + j0);
  const float a11 = load(I, (size_t)i1 * w + j1);
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

// The reference's interpolated DT on JAX's one-hot route (`interpolate_dt`
// with "mxu" gathers): sqrt(max(., 0)) of the bilinear blend of F^2, the
// four corners squared and blended in sample_bilinear's order.
__device__ __forceinline__ float sample_sqrt_mxu(const float* __restrict__ D, int h, int w,
                                                 float u, float v) {
  const float uc = fminf(fmaxf(u, 0.0f), (float)(w - 1));
  const float vc = fminf(fmaxf(v, 0.0f), (float)(h - 1));
  const float j0f = floorf(uc), i0f = floorf(vc);
  const float fu = __fsub_rn(uc, j0f), fv = __fsub_rn(vc, i0f);
  const float omfu = __fsub_rn(1.0f, fu), omfv = __fsub_rn(1.0f, fv);
  const int j0 = (int)j0f, i0 = (int)i0f;
  const int j1 = min(j0 + 1, w - 1), i1 = min(i0 + 1, h - 1);
  const float f00 = __ldg(D + (size_t)i0 * w + j0), f01 = __ldg(D + (size_t)i0 * w + j1);
  const float f10 = __ldg(D + (size_t)i1 * w + j0), f11 = __ldg(D + (size_t)i1 * w + j1);
  const float a00 = __fmul_rn(f00, f00), a01 = __fmul_rn(f01, f01);
  const float a10 = __fmul_rn(f10, f10), a11 = __fmul_rn(f11, f11);
  const float row0 = __fadd_rn(__fmul_rn(omfv, a00), __fmul_rn(fv, a10));
  const float row1 = __fadd_rn(__fmul_rn(omfv, a01), __fmul_rn(fv, a11));
  return __fsqrt_rn(fmaxf(__fadd_rn(__fmul_rn(omfu, row0), __fmul_rn(fu, row1)), 0.0f));
}

// The reference's `interpolate` on JAX's "take" route (ops/interp.py
// gather_sqrt_bilinear): the far corner clamp(ceil(c), 0, n-1), the blends
// of squares as XLA contracts them on the CPU (one fused multiply-add over
// the second product), a correctly rounded sqrt.
__device__ __forceinline__ float sample_sqrt_take(const float* __restrict__ D, int h, int w,
                                                  float u, float v) {
  const float uc = fminf(fmaxf(u, 0.0f), (float)(w - 1));
  const float vc = fminf(fmaxf(v, 0.0f), (float)(h - 1));
  const float x0f = floorf(uc), y0f = floorf(vc);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min((int)ceilf(uc), w - 1), y1 = min((int)ceilf(vc), h - 1);
  const float fx = __fsub_rn(uc, x0f), fy = __fsub_rn(vc, y0f);
  const float omfx = __fsub_rn(1.0f, fx);
  const float f00 = __ldg(D + (size_t)y0 * w + x0), f01 = __ldg(D + (size_t)y0 * w + x1);
  const float f10 = __ldg(D + (size_t)y1 * w + x0), f11 = __ldg(D + (size_t)y1 * w + x1);
  const float top2 = __fmaf_rn(__fmul_rn(omfx, f00), f00, __fmul_rn(__fmul_rn(fx, f01), f01));
  const float bot2 = __fmaf_rn(__fmul_rn(fx, f11), f11, __fmul_rn(__fmul_rn(omfx, f10), f10));
  return __fsqrt_rn(__fmaf_rn(__fsub_rn(1.0f, fy), top2, __fmul_rn(fy, bot2)));
}

// ops/interp.py gather_bilinear of up to three float32 planes at one point
// (JAX's "take" route for Gauss-Newton): i1 = min(i0+1, n-1), the top and
// bottom rows blended along x, then along y, each a*x + b*y one fused
// multiply-add over the second product, as XLA contracts it on the CPU.
template <int kPlanes>
__device__ __forceinline__ void sample_take(const float* const (&D)[3], int h, int w, float u,
                                            float v, float (&out)[3]) {
  const float uc = fminf(fmaxf(u, 0.0f), (float)(w - 1));
  const float vc = fminf(fmaxf(v, 0.0f), (float)(h - 1));
  const float x0f = floorf(uc), y0f = floorf(vc);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const float fx = __fsub_rn(uc, x0f), fy = __fsub_rn(vc, y0f);
  const float omfx = __fsub_rn(1.0f, fx), omfy = __fsub_rn(1.0f, fy);
#pragma unroll
  for (int c = 0; c < kPlanes; ++c) {
    const float* P = D[c];
    const float top = __fmaf_rn(__ldg(P + (size_t)y0 * w + x0), omfx,
                                __fmul_rn(__ldg(P + (size_t)y0 * w + x1), fx));
    const float bot = __fmaf_rn(__ldg(P + (size_t)y1 * w + x0), omfx,
                                __fmul_rn(__ldg(P + (size_t)y1 * w + x1), fx));
    out[c] = __fmaf_rn(top, omfy, __fmul_rn(bot, fy));
  }
}

// The per-point semantics of a launch (kernels/point_sem.py PointSem).
enum Sampler : int {
  kSgFloor = 0,     // the float32 DT at the floor pixel and its central differences
  kSgSqrtMxu = 1,   // sample_sqrt_mxu; floor gradients
  kSgSqrtTake = 2,  // sample_sqrt_take; floor gradients
  kGnInterp = 3,    // sample_bilinear of plane 0 with its interpolant's gradients
  kGnChannels = 4,  // sample_bilinear of planes 0, 1, 2 ([dt, dgx, dgy] channels)
  kGnTake = 5,      // sample_take of the float32 dt, dgx, dgy
};

struct PointSem {
  int sampler;
  int reference;   // the reference's dehomogenized Jacobian, else the textbook one
  int fma_uv;      // u = fx xn + cx (and v) as one fused multiply-add each
  int fma_z;       // z = fma(d2, R22, fma(d1, R12, d0 R02)), XLA's CPU dot
  int div_weight;  // 6 / (6 + (r^2 / sigma^2)) by divisions, else 6 rcp(6 + r^2 (1 / sigma^2))
};

// The production semantics (kernels/point_sem.py production): bilinear
// samples with the interpolant's gradients and the textbook Jacobian for
// Gauss-Newton; u, v by fused multiply-adds, floor lookups with central
// gradients and the reference Jacobian for the sub-gradient.
__host__ __device__ constexpr PointSem gn_production() {
  return PointSem{kGnInterp, 0, 0, 0, 0};
}
__host__ __device__ constexpr PointSem sg_production() {
  return PointSem{kSgFloor, 1, 1, 0, 0};
}
__host__ __device__ constexpr bool same_sem(const PointSem& a, const PointSem& b) {
  return a.sampler == b.sampler && a.reference == b.reference && a.fma_uv == b.fma_uv &&
         a.fma_z == b.fma_z && a.div_weight == b.div_weight;
}

// A level's planes, the pair's batch offset applied: plane 0 (the DT, or
// the DT channel), planes 1 and 2 (the gradients, where read).
template <typename T>
struct Planes {
  const T* p[3];
};

// project_xyz with the fused multiply-adds `sem` names.
__device__ __forceinline__ Projected project_sem(const Pose& p, float X, float Y, float Z,
                                                 float fx, float fy, float cx, float cy,
                                                 const PointSem& sem) {
  if (sem.fma_z) return project_xyz<true, true>(p, X, Y, Z, fx, fy, cx, cy);
  if (sem.fma_uv) return project_xyz<true, false>(p, X, Y, Z, fx, fy, cx, cy);
  return project_xyz<false, false>(p, X, Y, Z, fx, fy, cx, cy);
}

// The DT residual and its two gradients at (u, v) by a Gauss-Newton
// sampler; "take" reads float32 planes only.
template <typename T>
__device__ __forceinline__ void sample_gn(const Planes<T>& P, int h, int w, float u, float v,
                                          int sampler, float* val, float* g0, float* g1) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (sampler == kGnTake) {
      float out[3];
      sample_take<3>(P.p, h, w, u, v, out);
      *val = out[0];
      *g0 = out[1];
      *g1 = out[2];
      return;
    }
  }
  if (sampler == kGnChannels) {
    float a, b;
    sample_bilinear(P.p[0], h, w, u, v, val, &a, &b);
    sample_bilinear(P.p[1], h, w, u, v, g0, &a, &b);
    sample_bilinear(P.p[2], h, w, u, v, g1, &a, &b);
  } else {
    sample_bilinear(P.p[0], h, w, u, v, val, g0, g1);
  }
}

// The DT residual alone at (u, v) by a Gauss-Newton sampler
// (kernels/residual.py sample_value): the value sample_gn gives, from
// plane 0.
template <typename T>
__device__ __forceinline__ float sample_value_gn(const Planes<T>& P, int h, int w, float u,
                                                 float v, int sampler) {
  float val, a, b;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (sampler == kGnTake) {
      float out[3];
      sample_take<1>(P.p, h, w, u, v, out);
      return out[0];
    }
  }
  sample_bilinear(P.p[0], h, w, u, v, &val, &a, &b);
  return val;
}

// The float32 DT at the floor pixel and its central differences, the value
// replaced by the interpolated DT where a sub-gradient sampler says so.
__device__ __forceinline__ void sample_sg(const float* __restrict__ D, int h, int w, float u,
                                          float v, int sampler, float* val, float* g0,
                                          float* g1) {
  sample_floor_cgrads(D, h, w, u, v, val, g0, g1);
  if (sampler == kSgSqrtMxu) *val = sample_sqrt_mxu(D, h, w, u, v);
  else if (sampler == kSgSqrtTake) *val = sample_sqrt_take(D, h, w, u, v);
}

// The robust weight 6 / (6 + r^2 / sigma^2): by true divisions (JAX
// `_robust_weights`, the port's general terms) or as PyTorch evaluates
// 6.0 / x with r^2 times 1 / sigma^2 (the production terms).
__device__ __forceinline__ float robust_weight(float r, float inv_sigma2, float sigma2, int div) {
  if (div) return __fdiv_rn(6.0f, __fadd_rn(6.0f, __fdiv_rn(__fmul_rn(r, r), sigma2)));
  return __fmul_rn(__frcp_rn(__fadd_rn(6.0f, __fmul_rn(__fmul_rn(r, r), inv_sigma2))), 6.0f);
}

// A point's Jacobian from the sampled DT gradients g0, g1 at its
// projection p under pose q: the reference's dehomogenized [-R GA | GA x
// R^T (xn, yn, 1)], GA = (g0 fx, g1 fy, -(g0 fx xn + g1 fy yn)) (the
// sub-gradient's production one), or the textbook [-GA | GA x X'], GA =
// (g0 fx, g1 fy, -(...)) / z (Gauss-Newton's).
__device__ __forceinline__ void jacobian_sem(const Pose& q, const Projected& p, float g0,
                                             float g1, float fx, float fy, int reference,
                                             float (&J)[6]) {
  if (reference) {
    const float ga0 = __fmul_rn(g0, fx);
    const float ga1 = __fmul_rn(g1, fy);
    const float ga2 = -__fadd_rn(__fmul_rn(ga0, p.xn), __fmul_rn(ga1, p.yn));
    J[0] = -__fadd_rn(__fadd_rn(__fmul_rn(ga0, q.r00), __fmul_rn(ga1, q.r01)), __fmul_rn(ga2, q.r02));
    J[1] = -__fadd_rn(__fadd_rn(__fmul_rn(ga0, q.r10), __fmul_rn(ga1, q.r11)), __fmul_rn(ga2, q.r12));
    J[2] = -__fadd_rn(__fadd_rn(__fmul_rn(ga0, q.r20), __fmul_rn(ga1, q.r21)), __fmul_rn(ga2, q.r22));
    const float m0 = __fadd_rn(__fadd_rn(__fmul_rn(p.xn, q.r00), __fmul_rn(p.yn, q.r10)), q.r20);
    const float m1 = __fadd_rn(__fadd_rn(__fmul_rn(p.xn, q.r01), __fmul_rn(p.yn, q.r11)), q.r21);
    const float m2 = __fadd_rn(__fadd_rn(__fmul_rn(p.xn, q.r02), __fmul_rn(p.yn, q.r12)), q.r22);
    J[3] = __fsub_rn(__fmul_rn(ga1, m2), __fmul_rn(ga2, m1));
    J[4] = __fsub_rn(__fmul_rn(ga2, m0), __fmul_rn(ga0, m2));
    J[5] = __fsub_rn(__fmul_rn(ga0, m1), __fmul_rn(ga1, m0));
  } else {
    const float ga0 = __fdiv_rn(__fmul_rn(g0, fx), p.zs);
    const float ga1 = __fdiv_rn(__fmul_rn(g1, fy), p.zs);
    const float ga2 = __fdiv_rn(
        -__fadd_rn(__fmul_rn(__fmul_rn(g0, fx), p.xn), __fmul_rn(__fmul_rn(g1, fy), p.yn)), p.zs);
    const float xz = __fmul_rn(p.xn, p.z), yz = __fmul_rn(p.yn, p.z);
    J[0] = -ga0;
    J[1] = -ga1;
    J[2] = -ga2;
    J[3] = __fsub_rn(__fmul_rn(ga1, p.z), __fmul_rn(ga2, yz));
    J[4] = __fsub_rn(__fmul_rn(ga2, xz), __fmul_rn(ga0, p.z));
    J[5] = __fsub_rn(__fmul_rn(ga0, yz), __fmul_rn(ga1, xz));
  }
}

constexpr int kGnTerms = 29;  // 21 (upper triangle of H) + 6 (g) + e2 + count

// One reference point's Gauss-Newton terms at `pose` on the planes P under
// the semantics `sem` (kernels/fused_iter.py gn_point_terms): the
// projection, the sample, the robust weight of eps_px = eps / sc and the
// Jacobian `sem` names, and their addends to the 29 running sums acc (the
// row-major upper triangle of J^T W J, J^T W eps, then e2 and the visible
// count). Writes the residual (0 where invisible) and the visibility.
template <typename T>
__device__ __forceinline__ void gn_point(const Pose& pose, float X, float Y, float Z, bool valid,
                                         const Planes<T>& P, int h, int w, float fx, float fy,
                                         float cx, float cy, float sc, float inv_sigma2,
                                         float sigma2, const PointSem& sem,
                                         float (&acc)[kGnTerms], float* eps_o, bool* vis_o) {
  float eps = 0.0f;
  bool vis = false;
  if (valid) {
    const Projected p = project_sem(pose, X, Y, Z, fx, fy, cx, cy, sem);
    vis = in_image(p.u, p.v, h, w);
    if (vis) {
      float gu, gv;
      sample_gn(P, h, w, p.u, p.v, sem.sampler, &eps, &gu, &gv);
      const float wgt = robust_weight(__fdiv_rn(eps, sc), inv_sigma2, sigma2, sem.div_weight);
      float J[6];
      jacobian_sem(pose, p, gu, gv, fx, fy, sem.reference, J);
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

// The residual alone of one point under a Gauss-Newton `sem` (0 where
// invisible), and its visibility: the value gn_point takes at that pose.
template <typename T>
__device__ __forceinline__ float residual_gn(const Pose& pose, float X, float Y, float Z,
                                             bool valid, const Planes<T>& P, int h, int w,
                                             float fx, float fy, float cx, float cy,
                                             const PointSem& sem, bool* vis_o) {
  float eps = 0.0f;
  bool vis = false;
  if (valid) {
    const Projected p = project_sem(pose, X, Y, Z, fx, fy, cx, cy, sem);
    vis = in_image(p.u, p.v, h, w);
    if (vis) eps = sample_value_gn(P, h, w, p.u, p.v, sem.sampler);
  }
  *vis_o = vis;
  return eps;
}

constexpr int kSgTerms = 8;  // g = J^T W eps (6), e2, the visible count

// One reference point's sub-gradient terms at `pose` against the float32
// DT D under the semantics `sem` (kernels/sg_terms.py sg_point_terms): the
// projection, the sample, the robust weight (eps in DT units) and the
// Jacobian `sem` names, and their addends to the 8 running sums acc (J^T W
// eps, e2, the visible count). Writes the residual (0 where invisible) and
// the visibility.
__device__ __forceinline__ void sg_point(const Pose& q, float X, float Y, float Z, bool valid,
                                         const float* __restrict__ D, int h, int w, float fx,
                                         float fy, float cx, float cy, float inv_sigma2,
                                         float sigma2, const PointSem& sem,
                                         float (&acc)[kSgTerms], float* eps_o, bool* vis_o) {
  float eps = 0.0f;
  bool vis = false;
  if (valid) {
    const Projected p = project_sem(q, X, Y, Z, fx, fy, cx, cy, sem);
    vis = in_image(p.u, p.v, h, w);
    if (vis) {
      float gx, gy;
      sample_sg(D, h, w, p.u, p.v, sem.sampler, &eps, &gx, &gy);
      const float wgt = robust_weight(eps, inv_sigma2, sigma2, sem.div_weight);
      float J[6];
      jacobian_sem(q, p, gx, gy, fx, fy, sem.reference, J);
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
