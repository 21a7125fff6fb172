// Candidate arithmetic shared by the port's sweep kernels: K1
// (sweep_select.cu), K2 (winner.cu) and K3 (sweep_codes.cu); the table
// kernel (tables.cu) takes the table layouts and the min/max from here.
//
// candidate_code evaluates the expressions of
// cbtr_tpu_torch/ops/intersect.py::_candidates_core in the same order.  With
// -fmad=false and IEEE sqrt/division (see cuda_sweep.NVCC_FLAGS) every
// operation rounds like the plain twins' separate torch ops, and 1/sqrt is
// written out where the TPU kernels used an approximate rsqrt.  Every kernel
// includes this one definition, so their candidates are bit-identical to
// each other's and to the twins'.
//
// A patch row is read through an accessor that names its address space:
// SharedRow for a block staged in shared memory (LDS broadcasts: all 128
// threads of a tile read the same row at once), GlobalRow for a row read
// straight from the L2-resident table (__ldg; K1's and K2's retries).  The
// code is a template over the accessor and is inlined into each caller.
// Without contraction nvcc does not reassociate f32 arithmetic, so every
// instance rounds the same way: a retry's distance read through GlobalRow is
// bit-identical to the one the sweep computed through SharedRow.  Aligned
// column groups (the control net, the divider planes, the bounding sphere)
// are read as 16-byte quads.
//
// The sweep's arithmetic is a template over a math policy (the `M` of
// interpolate, patch_normal, surface_diff and candidate_code): the division
// of the plane hit, the bracket, the secant and the Newton steps, and the
// type the Bernstein and normal sums accumulate in.  SweepMath<MODE> gives
// the four modes of config.fast_newton and config.bf16_sweep (bit 0 and bit
// 1 of MODE, `intersect.SweepMode.code`); every sweep kernel (K1-K3) is
// built once a mode.  SweepMath<0> is the exact arithmetic above, op for
// op.  The fast division is the JAX package's `_fast_recip` (an integer
// subtract and two Newton refinements, written as separate multiplies and
// subtracts), not rcp.approx; the bf16 sums round every product and sum to
// bf16 with <cuda_bf16.h>'s non-contracting __hmul_rn and __hadd_rn, as
// torch's bf16 ops do (a product of two bf16 values is exact in f32, and an
// f32 sum rounded to bf16 is the bf16 sum: 24 >= 2 * 8 + 2), so each mode
// is bit-equal to its plain twin.  SweepMath sits behind __CUDACC__: the
// recompute kernels, which include this file and stay exact in every mode,
// are also compiled for the host by g++ in the tests.
//
// Everything here has internal linkage: each kernel source is built into a
// library of its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>

#include <type_traits>
#endif

namespace {

constexpr int TILE_R = 128;
constexpr int N_ROWS = 64;
constexpr int N_BOUNDS = 12;  // cuda_sweep.block_bounds columns

// feature columns of the packed patch table (cuda_sweep._ROW_*)
constexpr int ROW_PLANE = 30;
constexpr int ROW_BINV = 34;
constexpr int ROW_H = 43;
constexpr int ROW_DB = 45;
constexpr int ROW_DIV = 48;
constexpr int ROW_BSPHERE = 60;

constexpr int WHAT_NONE = 3;
constexpr int WHAT_INTERSECT = 4;
constexpr float BIG_F = 3.4e38f;

struct Params {
  float ray_plane_eps;
  float estimation_eps;
  float max_ray_dist;
  float minimal_ray_distance;
  int iters;
  int clamp_secant;
};

struct Ray {
  float sx, sy, sz, dx, dy, dz;
};

// a patch row in shared memory (a staged block: K1, K2, K3); rows start
// 256-byte aligned
struct SharedRow {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const { return p[i]; }
  __device__ __forceinline__ float4 quad(int i) const {
    return *reinterpret_cast<const float4*>(p + i);
  }
};

// a patch row of the device-memory table, through the read-only cache
struct GlobalRow {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const { return __ldg(p + i); }
  __device__ __forceinline__ float4 quad(int i) const {
    return __ldg(reinterpret_cast<const float4*>(p + i));
  }
};

__device__ __forceinline__ float safe_div(float num, float den) {
  // constants go through double, as torch converts a Python float scalar
  const float eps = static_cast<float>(1e-12);
  const float den_safe = fabsf(den) < eps ? (den < 0.0f ? -eps : eps) : den;
  return num / den_safe;
}

#ifdef __CUDACC__
// the modes of the sweep's arithmetic (bits of SweepMath's MODE)
constexpr int MODE_FAST_NEWTON = 1;  // config.fast_newton
constexpr int MODE_BF16_SWEEP = 2;   // config.bf16_sweep
constexpr int N_MODES = 4;

// intersect.fast_recip (pallas_sweep._fast_recip): the exponent negated by an
// integer subtract, then two Newton refinements; relative error under 1e-5
__device__ __forceinline__ float fast_recip(float x) {
  const float ax = fabsf(x);
  float r = __int_as_float(0x7EF311C3 - __float_as_int(ax));
  r = r * (2.0f - ax * r);
  r = r * (2.0f - ax * r);
  return x < 0.0f ? -r : r;
}

// intersect.fast_safe_div: safe_div's clamp, then the fast reciprocal
__device__ __forceinline__ float fast_safe_div(float num, float den) {
  const float eps = static_cast<float>(1e-12);
  const float den_safe = fabsf(den) < eps ? (den < 0.0f ? -eps : eps) : den;
  return num * fast_recip(den_safe);
}

// The sweep's math policy in mode MODE: div, and the accumulation type Acc
// with acc (from f32), mul, add and out (to f32)
template <int MODE>
struct SweepMath {
  static constexpr bool kFast = (MODE & MODE_FAST_NEWTON) != 0;
  static constexpr bool kBf16 = (MODE & MODE_BF16_SWEEP) != 0;
  using Acc = std::conditional_t<kBf16, __nv_bfloat16, float>;

  static __device__ __forceinline__ float div(float num, float den) {
    if constexpr (kFast) {
      return fast_safe_div(num, den);
    } else {
      return safe_div(num, den);
    }
  }
  static __device__ __forceinline__ Acc acc(float x) {
    if constexpr (kBf16) {
      return __float2bfloat16_rn(x);
    } else {
      return x;
    }
  }
  static __device__ __forceinline__ Acc mul(Acc a, Acc b) {
    if constexpr (kBf16) {
      return __hmul_rn(a, b);
    } else {
      return a * b;
    }
  }
  static __device__ __forceinline__ Acc add(Acc a, Acc b) {
    if constexpr (kBf16) {
      return __hadd_rn(a, b);
    } else {
      return a + b;
    }
  }
  static __device__ __forceinline__ float out(Acc x) {
    if constexpr (kBf16) {
      return __bfloat162float(x);
    } else {
      return x;
    }
  }
};
#endif  // __CUDACC__

// torch.maximum / torch.minimum: NaN propagates.  One instruction each
// (max.NaN / min.NaN) where a select on two NaN tests took five; the two
// forms can differ only in which zero a tie of +0 and -0 returns, and the
// kernels stay bit-equal to their twins at every shape chip_smoke checks.
__device__ __forceinline__ float tmax(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}
__device__ __forceinline__ float tmin(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}

// columns 0..31 of a row as 8 quads: the control net (0..29) and two
// plane columns nobody reads from this copy
template <class Row>
__device__ __forceinline__ void load_net(const Row& row, float (&cp)[32]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = row.quad(4 * q);
    cp[4 * q] = v.x;
    cp[4 * q + 1] = v.y;
    cp[4 * q + 2] = v.z;
    cp[4 * q + 3] = v.w;
  }
}

// bary = M @ p, each row a left-to-right sum
template <class Row>
__device__ __forceinline__ void apply_mat3(const Row& row, float px, float py,
                                           float pz, float& b0, float& b1,
                                           float& b2) {
  const int m = ROW_BINV;
  b0 = row[m + 0] * px + row[m + 1] * py + row[m + 2] * pz;
  b1 = row[m + 3] * px + row[m + 4] * py + row[m + 5] * pz;
  b2 = row[m + 6] * px + row[m + 7] * py + row[m + 8] * pz;
}

// cubic surface point: sum_k w_k * cp_k, k = 0..9 left to right, the
// weights in f32, the sum in M::Acc
template <class M>
__device__ __forceinline__ void interpolate(const float (&cp)[32], float b0,
                                            float b1, float b2, float& fx,
                                            float& fy, float& fz) {
  const float b0_2 = b0 * b0, b1_2 = b1 * b1, b2_2 = b2 * b2;
  const float w[10] = {
      b0 * b0_2,        b1 * b1_2,        b2 * b2_2,
      3.0f * b1 * b0_2, 3.0f * b0 * b1_2, 3.0f * b2 * b1_2,
      3.0f * b1 * b2_2, 3.0f * b0 * b2_2, 3.0f * b2 * b0_2,
      6.0f * b0 * b1 * b2,
  };
  typename M::Acc ax = M::mul(M::acc(w[0]), M::acc(cp[0]));
  typename M::Acc ay = M::mul(M::acc(w[0]), M::acc(cp[1]));
  typename M::Acc az = M::mul(M::acc(w[0]), M::acc(cp[2]));
#pragma unroll
  for (int k = 1; k < 10; ++k) {
    ax = M::add(ax, M::mul(M::acc(w[k]), M::acc(cp[3 * k])));
    ay = M::add(ay, M::mul(M::acc(w[k]), M::acc(cp[3 * k + 1])));
    az = M::add(az, M::mul(M::acc(w[k]), M::acc(cp[3 * k + 2])));
  }
  fx = M::out(ax);
  fy = M::out(ay);
  fz = M::out(az);
}

// v / |v|, or 0 for a (near-)zero vector (geom.safe_normalize)
__device__ __forceinline__ void safe_normalize(float& x, float& y, float& z) {
  const float n2 = x * x + y * y + z * z;
  const float eps = static_cast<float>(1e-30);
  const float inv = n2 < eps ? 0.0f : 1.0f / sqrtf(tmax(n2, eps));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// sum_k w_k * c_k over six terms, left to right, in M::Acc
template <class M>
__device__ __forceinline__ float sum6(typename M::Acc w0, float c0, typename M::Acc w1,
                                      float c1, typename M::Acc w2, float c2,
                                      typename M::Acc w3, float c3, typename M::Acc w4,
                                      float c4, typename M::Acc w5, float c5) {
  typename M::Acc s = M::mul(w0, M::acc(c0));
  s = M::add(s, M::mul(w1, M::acc(c1)));
  s = M::add(s, M::mul(w2, M::acc(c2)));
  s = M::add(s, M::mul(w3, M::acc(c3)));
  s = M::add(s, M::mul(w4, M::acc(c4)));
  s = M::add(s, M::mul(w5, M::acc(c5)));
  return M::out(s);
}

// unit normal from the two directional derivatives (bezier/patches.py
// patch_normal; reference/bezierTriangle.cpp:197-233): the six quadratic
// weights in f32, the three components' sums in M::Acc
template <class M, class Row>
__device__ __forceinline__ void patch_normal(const float (&cp)[32], const Row& row,
                                             float b0, float b1, float b2,
                                             float& nx, float& ny, float& nz) {
  const typename M::Acc b0_2 = M::acc(b0 * b0), b1_2 = M::acc(b1 * b1),
                        b2_2 = M::acc(b2 * b2);
  const typename M::Acc ab = M::acc(2.0f * b0 * b1);
  const typename M::Acc bc = M::acc(2.0f * b1 * b2);
  const typename M::Acc ac = M::acc(2.0f * b0 * b2);
  const float db0 = row[ROW_DB], db1 = row[ROW_DB + 1], db2 = row[ROW_DB + 2];
  float a[3], b[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float comp0 = sum6<M>(b0_2, cp[0 + x], ab, cp[9 + x], b1_2, cp[12 + x],
                                b2_2, cp[21 + x], ac, cp[24 + x], bc, cp[27 + x]);
    const float comp1 = sum6<M>(b1_2, cp[3 + x], b0_2, cp[9 + x], ab, cp[12 + x],
                                bc, cp[15 + x], b2_2, cp[18 + x], ac, cp[27 + x]);
    const float comp2 = sum6<M>(b2_2, cp[6 + x], b1_2, cp[15 + x], bc, cp[18 + x],
                                ac, cp[21 + x], b0_2, cp[24 + x], ab, cp[27 + x]);
    a[x] = comp0 - comp2;
    b[x] = db0 * comp0 + db1 * comp1 + db2 * comp2;
  }
  nx = a[1] * b[2] - a[2] * b[1];
  ny = a[2] * b[0] - a[0] * b[2];
  nz = a[0] * b[1] - a[1] * b[0];
  safe_normalize(nx, ny, nz);
}

// |plane distance of the ray point| - |plane distance of the surface point
// above its projection| (the secant bracket's residual)
template <class M, class Row>
__device__ __forceinline__ float surface_diff(const Row& row, const Ray& r,
                                              float t) {
  const float nx = row[ROW_PLANE], ny = row[ROW_PLANE + 1],
              nz = row[ROW_PLANE + 2], c = row[ROW_PLANE + 3];
  const float px = r.sx + t * r.dx, py = r.sy + t * r.dy, pz = r.sz + t * r.dz;
  const float pd = (px * nx + py * ny + pz * nz) - c;
  const float qx = px - nx * pd, qy = py - ny * pd, qz = pz - nz * pd;
  float b0, b1, b2;
  apply_mat3(row, qx, qy, qz, b0, b1, b2);
  b0 = clip(b0, -16.0f, 16.0f);
  b1 = clip(b1, -16.0f, 16.0f);
  b2 = clip(b2, -16.0f, 16.0f);
  float cp[32];
  load_net(row, cp);
  float fx, fy, fz;
  interpolate<M>(cp, b0, b1, b2, fx, fy, fz);
  const float sd = (fx * nx + fy * ny + fz * nz) - c;
  return fabsf(pd) - fabsf(sd);
}

// Gate-OFF candidate of one (ray, patch) pair in math mode M: returns
// code = what | (in_domain << 3) and writes the along-ray distance.  The
// distance is meaningful only where what == WHAT_INTERSECT.
template <class M, class Row>
__device__ __forceinline__ int candidate_code(const Row& row, const Ray& r,
                                              const Params& prm,
                                              float* dist_out) {
  const float nx = row[ROW_PLANE], ny = row[ROW_PLANE + 1],
              nz = row[ROW_PLANE + 2], c = row[ROW_PLANE + 3];
  const float h_in = row[ROW_H], h_out = row[ROW_H + 1];

  // ray x underlying plane (reference/bezierTriangle.cpp:124-126)
  float cos_inc = r.dx * nx + r.dy * ny + r.dz * nz;
  float dist0 = M::div(c - (nx * r.sx + ny * r.sy + nz * r.sz), cos_inc);
  bool valid = (fabsf(cos_inc) >= prm.ray_plane_eps) && (dist0 > 0.0f);
  valid = valid && (fabsf(dist0) > -h_in) && (fabsf(dist0) > h_out);

  float b0, b1, b2;
  apply_mat3(row, r.sx + dist0 * r.dx, r.sy + dist0 * r.dy, r.sz + dist0 * r.dz,
             b0, b1, b2);
  const int in_dom = (b0 >= 0.0f && b0 <= 1.0f && b1 >= 0.0f && b1 <= 1.0f &&
                      b2 >= 0.0f && b2 <= 1.0f) ? 1 : 0;
  *dist_out = 0.0f;
  // a pair that fails here ends as WHAT_NONE whatever the Newton loop does
  if (!valid) return WHAT_NONE | (in_dom << 3);

  // bracket along the ray (reference/bezierTriangle.cpp:132-135)
  const float d_in = M::div(h_in, cos_inc);
  const float d_out = M::div(h_out, cos_inc);
  const bool going = cos_inc > 0.0f;
  const float closer = dist0 + (going ? d_in : d_out);
  const float further = dist0 + (going ? d_out : d_in);

  // secant-style estimate with midpoint fallback (cpp:137-152)
  const float diff_closer = surface_diff<M>(row, r, closer);
  const float diff_further = surface_diff<M>(row, r, further);
  const float denom = diff_closer - diff_further;
  const float secant =
      M::div(diff_closer * further - diff_further * closer, denom);
  float middle = fabsf(denom) < prm.estimation_eps
                     ? (closer + further) / 2.0f
                     : secant;
  if (prm.clamp_secant) {
    middle = clip(middle, tmin(closer, further), tmax(closer, further));
  } else {
    middle = clip(middle, -1e7f, 1e7f);
  }

  // fixed-iteration Newton-like refinement (cpp:155-164)
  float pdx = nx, pdy = ny, pdz = nz;
  float distance = middle;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int it = 0; it < prm.iters; ++it) {
    distance = middle;
    const float px = r.sx + middle * r.dx, py = r.sy + middle * r.dy,
                pz = r.sz + middle * r.dz;
    const float t = M::div(c - (nx * px + ny * py + nz * pz),
                             pdx * nx + pdy * ny + pdz * nz);
    const float plx = px + t * pdx, ply = py + t * pdy, plz = pz + t * pdz;
    apply_mat3(row, plx, ply, plz, b0, b1, b2);
    b0 = clip(b0, -16.0f, 16.0f);
    b1 = clip(b1, -16.0f, 16.0f);
    b2 = clip(b2, -16.0f, 16.0f);
    float cp[32];
    load_net(row, cp);
    float nmx, nmy, nmz;
    patch_normal<M>(cp, row, b0, b1, b2, nmx, nmy, nmz);
    interpolate<M>(cp, b0, b1, b2, fx, fy, fz);
    float stx = fx - plx, sty = fy - ply, stz = fz - plz;
    const float st2 = stx * stx + sty * sty + stz * stz;
    safe_normalize(stx, sty, stz);
    // keep the previous direction when the step vanished (converged lane)
    if (st2 > 0.0f) {
      pdx = stx;
      pdy = sty;
      pdz = stz;
    }
    middle = clip(M::div((fx - r.sx) * nmx + (fy - r.sy) * nmy +
                               (fz - r.sz) * nmz,
                           r.dx * nmx + r.dy * nmy + r.dz * nmz),
                  -1e7f, 1e7f);
  }

  // acceptance (cpp:165-167): point close to the ray line AND beyond the slab
  const float rx = fx - r.sx, ry = fy - r.sy, rz = fz - r.sz;
  const float along = rx * r.dx + ry * r.dy + rz * r.dz;
  const float qx = rx - along * r.dx, qy = ry - along * r.dy,
              qz = rz - along * r.dz;
  const float ray_dist = sqrtf(qx * qx + qy * qy + qz * qz);
  const bool accept = (ray_dist <= prm.max_ray_dist) &&
                      (distance >= (further - closer) * prm.minimal_ray_distance);
  *dist_out = distance;
  if (!accept) return WHAT_NONE | (in_dom << 3);

  // domain classification against divider planes (cpp:169-184)
  int outside = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float4 dv = row.quad(ROW_DIV + 4 * j);
    const float dd = (fx * dv.x + fy * dv.y + fz * dv.z) - dv.w;
    outside += (dd < 0.0f ? 1 : 0) << j;
  }
  const int what = outside == 1 ? 0 : outside == 2 ? 1 : outside == 4 ? 2
                                                                      : WHAT_INTERSECT;
  return what | (in_dom << 3);
}

// per-patch bounding-sphere cull (cuda_sweep.sphere_hit_pairs)
template <class Row>
__device__ __forceinline__ bool patch_sphere_hit(const Row& row, const Ray& r) {
  const float4 s = row.quad(ROW_BSPHERE);
  const float relx = s.x - r.sx;
  const float rely = s.y - r.sy;
  const float relz = s.z - r.sz;
  const float t_ca = relx * r.dx + rely * r.dy + relz * r.dz;
  const float rel2 = relx * relx + rely * rely + relz * relz;
  const float r2 = s.w * s.w;
  return ((rel2 - t_ca * t_ca) <= r2) && ((t_ca >= 0.0f) || (rel2 <= r2));
}

// min distance, lowest patch id on ties
__device__ __forceinline__ void fold(float d, int q, float& best, int& best_id) {
  if (d < best || (d == best && q < best_id)) {
    best = d;
    best_id = q;
  }
}

}  // namespace

// every kernel library exports this, for the wrapper's error message
extern "C" const char* cbtr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
