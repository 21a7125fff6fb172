// The winner recompute for Hopper (sm_90a): a forward kernel and its own
// backward kernel, a thread a ray.
//
// What they replace: no Pallas kernel.  The JAX package's recompute
// (cbtr_tpu/ops/intersect.py:314-350) is XLA code that the compiler fuses
// into a few device passes a chunk, and jax.grad differentiates through its
// 4 unrolled Newton iterations.  Run as eager torch ops (the plain versions
// in cbtr_tpu_torch/ops/cuda_recompute.py) it is 1,084 device ops a call
// forward and 4,175 with its backward and a loss on it, against 4 and 53 on
// these kernels (NVIDIA H100 80GB HBM3, 700.00 W; harness/kernel_ab.py
// --recompute-only); here each direction is one launch.
//
// recompute_forward_kernel reads each ray's winning row straight from the
// packed [P, 60] table (BezierPatches.packed_f32: no [R, 60] gather is
// materialised), evaluates the gate-OFF candidate of
// intersect._candidates_core and writes the RayHit fields (any_hit masking
// included) and the gate-OFF `what`.  recompute_backward_kernel re-runs the
// forward in registers, keeps each Newton iteration's inputs (middle and
// projection direction: 4 floats an iteration), then sweeps back through
// the iterations, recomputing each one's intermediates from its inputs, and
// writes each ray's 60-column row gradient (the divider columns 0) and the
// gradient of its start and direction.  No atomics: the table's gradient is
// the fixed-order segment sum of the rows by winner id (segment_sum.cu), as
// before, so every path stays bit-reproducible between runs.
//
// Arithmetic: the plain versions' f32 expressions in their order, built
// without contraction, IEEE sqrt and division (cuda_sweep.NVCC_FLAGS).  The
// forward is intersect._candidates_core's; the backward is
// cuda_recompute.recompute_adjoint_reference's, function for function (the
// same names) and expression for expression, so the kernels are bit-equal to
// their plain versions on the card.  That reverse sweep takes each op back
// as torch's autograd does (its formulas, every non-smooth point as torch
// defines it, each gradient's terms added in the order autograd adds them,
// the last use first, and a broadcast operand's three terms summed in the
// order of the device's reduction: rsum3), so it is bit-equal to autograd of
// the twin on the CPU and, in the card's order, on the card.
//
// What bounds them on the H100: the forward its bytes, the backward its
// operations.  A ray reads 37 bytes forward (id, any_hit, win, ray) and 77
// backward (with the cotangents), and its row's 240 from the L2-resident
// table; it writes 56 bytes forward (the fields) or 264 backward (the row
// gradient and the ray's); the forward does 1,564 f32 operations, the
// backward 6,920 (the plain versions' arithmetic, counted by chip_smoke
// phase r).  Built without contraction, an add and a multiply are two
// instructions where an FMA would be one, and each IEEE division and square
// root a sequence, so the operations bound is out of reach by about 2x.
//
// The design.  A thread a ray, the row read through the read-only cache,
// one build of each kernel for every Newton count (Params::iters, 1 to
// MAX_ITERS).  The loops over iterations stay loops: unrolled, the code and
// its registers grew (the backward 217-226 registers, 2 blocks an SM) and
// ran up to 2x slower; a build for each count (a template on the count)
// measured under 1 % faster than the loops bounded at run time, too little
// for eight builds of each kernel.  So each
// iteration's inputs (middle and projection direction) go to the thread's
// column of a shared array sized for MAX_ITERS (SharedInputs), not to a
// stack, and the fields' cotangents enter the last iteration by a uniform
// branch.  The backward keeps its 48 row-gradient accumulators in shared
// memory too, a column a thread (SharedAcc), not in registers; that and
// __launch_bounds__ hold it to 128 registers, BWD_BLOCKS = 4 blocks (16
// warps) an SM where 168 registers allowed 3, for the warps that hide its
// long chains of dependent divisions and square roots.  ptxas spills a few
// words there; the spill-free build at 3 blocks measured slower.  After a
// __syncthreads() the block writes its rows from the shared array as one
// contiguous span of 16-byte quads, neighbouring threads on neighbouring
// quads (store_rows), where each thread stored its own 240-byte row.  The
// forward is held to 64 registers, 8 blocks an SM, and stores its fields
// itself; staging them through shared memory measured slower.  Every
// thread of a block computes, a spare one on the last ray, and branches
// only at its stores (forward_ray).  The backward's two phases share
// nothing but shared memory and the kernel's view of its parameters
// (tests/test_torch_recompute.py runs each phase as a loop over a block's
// threads on the host).  PERF.md §6 has the times of what lost.

#include "candidate.cuh"

namespace {

constexpr int N_COLS = 60;  // cuda_recompute.N_COLS
constexpr int N_GRAD = 48;  // the columns that carry a gradient
constexpr int COL_N = ROW_PLANE;
constexpr int COL_C = ROW_PLANE + 3;
constexpr int COL_M = ROW_BINV;
constexpr int COL_H_IN = ROW_H;
constexpr int COL_H_OUT = ROW_H + 1;
constexpr int COL_DB = ROW_DB;
constexpr int MAX_ITERS = 8;  // cuda_recompute._MAX_ITERS
constexpr float BARY_CLAMP = 16.0f;
constexpr float MIDDLE_CLAMP = 1e7f;

constexpr int FWD_THREADS = 128;
constexpr int FWD_BLOCKS = 8;  // blocks an SM the forward's launch bounds ask for
constexpr int BWD_THREADS = 128;
constexpr int BWD_BLOCKS = 4;  // and the backward's
// the shared arrays' column stride: one word of padding, so that the block
// store's reads (a warp across a few rows' columns) fall on distinct banks
constexpr int ACC_STRIDE = BWD_THREADS + 1;

struct Ray3 {
  float s[3], d[3];
};

// ---------------------------------------------------------------------------
// the forward, in pieces the backward recomputes
// ---------------------------------------------------------------------------

// geom.safe_div's denominator: |den| clamped to 1e-12, sign kept
__device__ __forceinline__ float safe_den(float den) {
  const float eps = static_cast<float>(1e-12);
  return fabsf(den) < eps ? (den < 0.0f ? -eps : eps) : den;
}

// geom.safe_normalize's factor: 1 / sqrt(n2), or 0 below 1e-30
__device__ __forceinline__ float inv_norm(float n2) {
  const float eps = static_cast<float>(1e-30);
  return n2 < eps ? 0.0f : 1.0f / sqrtf(tmax(n2, eps));
}

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <class Row>
__device__ __forceinline__ void plane_normal(const Row& row, float (&n)[3]) {
  n[0] = row[COL_N];
  n[1] = row[COL_N + 1];
  n[2] = row[COL_N + 2];
}

template <class Row>
__device__ __forceinline__ float cpv(const Row& row, int k, int x) {
  return row[3 * k + x];
}

template <class Row>
__device__ __forceinline__ float mat(const Row& row, int i, int j) {
  return row[COL_M + 3 * i + j];
}

// bary = M @ v, each row a left-to-right sum
template <class Row>
__device__ __forceinline__ void apply_mat(const Row& row, const float (&v)[3],
                                          float (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = mat(row, i, 0) * v[0] + mat(row, i, 1) * v[1] + mat(row, i, 2) * v[2];
}

__device__ __forceinline__ void clamp_bary(const float (&braw)[3], float (&b)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) b[i] = clip(braw[i], -BARY_CLAMP, BARY_CLAMP);
}

// the cubic Bernstein weights (bezier/patches.py _bernstein)
__device__ __forceinline__ void weights(const float (&b)[3], float (&w)[10]) {
  const float b0 = b[0], b1 = b[1], b2 = b[2];
  const float b0_2 = b0 * b0, b1_2 = b1 * b1, b2_2 = b2 * b2;
  w[0] = b0 * b0_2;
  w[1] = b1 * b1_2;
  w[2] = b2 * b2_2;
  w[3] = 3.0f * b1 * b0_2;
  w[4] = 3.0f * b0 * b1_2;
  w[5] = 3.0f * b2 * b1_2;
  w[6] = 3.0f * b1 * b2_2;
  w[7] = 3.0f * b0 * b2_2;
  w[8] = 3.0f * b2 * b0_2;
  w[9] = 6.0f * b0 * b1 * b2;
}

// the surface point at bary b (bezier/patches.py interpolate)
template <class Row>
__device__ __forceinline__ void interp(const Row& row, const float (&b)[3], float (&f)[3]) {
  float w[10];
  weights(b, w);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    float acc = w[0] * cpv(row, 0, x);
#pragma unroll
    for (int k = 1; k < 10; ++k) acc = acc + w[k] * cpv(row, k, x);
    f[x] = acc;
  }
}

struct Quadratics {
  float b0_2, b1_2, b2_2, ab, bc, ac;
};

__device__ __forceinline__ Quadratics quadratics(const float (&b)[3]) {
  return {b[0] * b[0], b[1] * b[1], b[2] * b[2], 2.0f * b[0] * b[1], 2.0f * b[1] * b[2],
          2.0f * b[0] * b[2]};
}

// patch_normal's intermediates (bezier/patches.py): the three quadratic
// components, A = comp0 - comp2, B = deriv_b . comps, v = A x B and the unit
// normal v * inv_norm(|v|^2)
struct NormalParts {
  float comp[3][3];  // [component][axis]
  float A[3], B[3], v[3], n2, inv, nm[3];
};

template <class Row>
__device__ __forceinline__ void normal_parts(const Row& row, const float (&b)[3],
                                             NormalParts& o) {
  const Quadratics q = quadratics(b);
  const float db0 = row[COL_DB], db1 = row[COL_DB + 1], db2 = row[COL_DB + 2];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float c0 = cpv(row, 0, x), c1 = cpv(row, 1, x), c2 = cpv(row, 2, x),
                c3 = cpv(row, 3, x), c4 = cpv(row, 4, x), c5 = cpv(row, 5, x),
                c6 = cpv(row, 6, x), c7 = cpv(row, 7, x), c8 = cpv(row, 8, x),
                c9 = cpv(row, 9, x);
    o.comp[0][x] = q.b0_2 * c0 + q.ab * c3 + q.b1_2 * c4 + q.b2_2 * c7 + q.ac * c8 + q.bc * c9;
    o.comp[1][x] = q.b1_2 * c1 + q.b0_2 * c3 + q.ab * c4 + q.bc * c5 + q.b2_2 * c6 + q.ac * c9;
    o.comp[2][x] = q.b2_2 * c2 + q.b1_2 * c5 + q.bc * c6 + q.ac * c7 + q.b0_2 * c8 + q.ab * c9;
    o.A[x] = o.comp[0][x] - o.comp[2][x];
    o.B[x] = db0 * o.comp[0][x] + db1 * o.comp[1][x] + db2 * o.comp[2][x];
  }
  o.v[0] = o.A[1] * o.B[2] - o.A[2] * o.B[1];
  o.v[1] = o.A[2] * o.B[0] - o.A[0] * o.B[2];
  o.v[2] = o.A[0] * o.B[1] - o.A[1] * o.B[0];
  o.n2 = dot3(o.v, o.v);
  o.inv = inv_norm(o.n2);
#pragma unroll
  for (int x = 0; x < 3; ++x) o.nm[x] = o.v[x] * o.inv;
}

// the secant bracket's residual at ray parameter t and its intermediates
struct SurfaceDiff {
  float p[3], pd, q[3], braw[3], b[3], f[3], sd, diff;
};

template <class Row>
__device__ __forceinline__ void surface_diff(const Row& row, const Ray3& r, float t,
                                             SurfaceDiff& o) {
  float n[3];
  plane_normal(row, n);
  const float c = row[COL_C];
#pragma unroll
  for (int x = 0; x < 3; ++x) o.p[x] = r.s[x] + t * r.d[x];
  o.pd = dot3(o.p, n) - c;
#pragma unroll
  for (int x = 0; x < 3; ++x) o.q[x] = o.p[x] - n[x] * o.pd;
  apply_mat(row, o.q, o.braw);
  clamp_bary(o.braw, o.b);
  interp(row, o.b, o.f);
  o.sd = dot3(o.f, n) - c;
  o.diff = fabsf(o.pd) - fabsf(o.sd);
}

// everything before the Newton loop: the ray x plane hit, its validity, the
// bracket [closer, further], the secant estimate and the first middle
struct Bracket {
  float cos_inc, ds0, dist0r;
  bool valid;
  float cosv, dsc, d_in, d_out;
  bool going;
  float closer, further, dc, df, denom, dsd, secant;
  bool fallback;
  float mraw, middle;
};

template <class Row>
__device__ __forceinline__ void bracket(const Row& row, const Ray3& r, const Params& prm,
                                        Bracket& o) {
  float n[3];
  plane_normal(row, n);
  const float c = row[COL_C], h_in = row[COL_H_IN], h_out = row[COL_H_OUT];
  o.cos_inc = dot3(r.d, n);
  o.ds0 = safe_den(o.cos_inc);
  o.dist0r = (c - dot3(n, r.s)) / o.ds0;
  bool valid = (fabsf(o.cos_inc) >= prm.ray_plane_eps) && (o.dist0r > 0.0f);
  o.valid = valid && (fabsf(o.dist0r) > -h_in) && (fabsf(o.dist0r) > h_out);
  const float dist0 = o.valid ? o.dist0r : 1.0f;
  o.cosv = o.valid ? o.cos_inc : 1.0f;
  o.dsc = safe_den(o.cosv);
  o.d_in = h_in / o.dsc;
  o.d_out = h_out / o.dsc;
  o.going = o.cosv > 0.0f;
  o.closer = dist0 + (o.going ? o.d_in : o.d_out);
  o.further = dist0 + (o.going ? o.d_out : o.d_in);
  SurfaceDiff sdc, sdf;
  surface_diff(row, r, o.closer, sdc);
  surface_diff(row, r, o.further, sdf);
  o.dc = sdc.diff;
  o.df = sdf.diff;
  o.denom = o.dc - o.df;
  o.dsd = safe_den(o.denom);
  o.secant = (o.dc * o.further - o.df * o.closer) / o.dsd;
  o.fallback = fabsf(o.denom) < prm.estimation_eps;
  o.mraw = o.fallback ? (o.closer + o.further) / 2.0f : o.secant;
  if (prm.clamp_secant) {
    o.middle = tmin(tmax(o.mraw, tmin(o.closer, o.further)), tmax(o.closer, o.further));
  } else {
    o.middle = clip(o.mraw, -MIDDLE_CLAMP, MIDDLE_CLAMP);
  }
}

// one Newton iteration from (middle m, projection direction pd)
struct Newton {
  float p[3], tnum, pdn, dst, t, pl[3], braw[3], b[3];
  NormalParts np;
  float f[3], step[3], st2, inv;
  bool moved;
  float rel[3], mnum, mden, dsm, q, m_next, pd_next[3];
};

template <class Row>
__device__ __forceinline__ void newton(const Row& row, const Ray3& r, float m,
                                       const float (&pd)[3], Newton& o) {
  float n[3];
  plane_normal(row, n);
  const float c = row[COL_C];
#pragma unroll
  for (int x = 0; x < 3; ++x) o.p[x] = r.s[x] + m * r.d[x];
  o.tnum = c - dot3(n, o.p);
  o.pdn = dot3(pd, n);
  o.dst = safe_den(o.pdn);
  o.t = o.tnum / o.dst;
#pragma unroll
  for (int x = 0; x < 3; ++x) o.pl[x] = o.p[x] + o.t * pd[x];
  apply_mat(row, o.pl, o.braw);
  clamp_bary(o.braw, o.b);
  normal_parts(row, o.b, o.np);
  interp(row, o.b, o.f);
#pragma unroll
  for (int x = 0; x < 3; ++x) o.step[x] = o.f[x] - o.pl[x];
  o.st2 = dot3(o.step, o.step);
  o.inv = inv_norm(o.st2);
  o.moved = o.st2 > 0.0f;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    o.pd_next[x] = o.moved ? o.step[x] * o.inv : pd[x];
    o.rel[x] = o.f[x] - r.s[x];
  }
  o.mnum = dot3(o.rel, o.np.nm);
  o.mden = dot3(r.d, o.np.nm);
  o.dsm = safe_den(o.mden);
  o.q = o.mnum / o.dsm;
  o.m_next = clip(o.q, -MIDDLE_CLAMP, MIDDLE_CLAMP);
}

// ---------------------------------------------------------------------------
// the reverse sweep (cuda_recompute.recompute_adjoint_reference)
// ---------------------------------------------------------------------------
//
// Each function adds into `acc`, the 48 row-gradient accumulators: a type
// indexed like an array of floats (SharedAcc's slots in shared memory), as
// the row is read through an accessor.

// the gradient autograd sums for the [R, 1] operand of a broadcast product
// with [R, 3]: its reduction over the three axes on the card adds the first
// and the third term, then the second (cuda_recompute._REDUCTION)
__device__ __forceinline__ float rsum3(float a, float b, float c) { return a + c + b; }

__device__ __forceinline__ float rdot(const float (&a)[3], const float (&b)[3]) {
  return rsum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// the gradient that reaches den of q = num / safe_den(den)
__device__ __forceinline__ float div_den_grad(float g, float quotient, float den, float ds) {
  return fabsf(den) < static_cast<float>(1e-12) ? 0.0f : -g * (quotient / ds);
}

// g * sign(x): abs's backward (0 at 0)
__device__ __forceinline__ float sign_grad(float g, float x) {
  return x > 0.0f ? g : (x < 0.0f ? -g : 0.0f);
}

// clamp(x, -bound, bound)'s backward: g on the closed interval
__device__ __forceinline__ float in_range_grad(float g, float x, float bound) {
  return (x >= -bound) && (x <= bound) ? g : 0.0f;
}

// the gradient that reaches n2 of inv = inv_norm(n2)
__device__ __forceinline__ float inv_norm_grad(float n2, float inv, float g_inv) {
  const float eps = static_cast<float>(1e-30);
  const float r = sqrtf(tmax(n2, eps));
  const float g_r = -g_inv * (inv * inv);
  return n2 < eps ? 0.0f : g_r / (2.0f * r);
}

// torch.minimum / maximum's backward to an operand: nothing where it lost,
// half at a tie, else all of g
__device__ __forceinline__ float split_grad(float g, bool lost, bool tie) {
  return lost ? 0.0f : (tie ? g * 0.5f : g);
}

// reverse of f = interp(row, b): adds into the control-net columns of acc
// and into g_b, the weights' products taken back the last one first
template <class Row, class Acc>
__device__ __forceinline__ void interp_bwd(const Row& row, const float (&b)[3],
                                           const float (&g_f)[3], Acc& acc,
                                           float (&g_b)[3]) {
  float w[10];
  weights(b, w);
#pragma unroll
  for (int k = 0; k < 10; ++k)
#pragma unroll
    for (int x = 0; x < 3; ++x) acc[3 * k + x] = acc[3 * k + x] + w[k] * g_f[x];
  float G[10];
#pragma unroll
  for (int k = 0; k < 10; ++k)
    G[k] = rsum3(g_f[0] * cpv(row, k, 0), g_f[1] * cpv(row, k, 1), g_f[2] * cpv(row, k, 2));
  const float b0 = b[0], b1 = b[1], b2 = b[2];
  const float b0_2 = b0 * b0, b1_2 = b1 * b1, b2_2 = b2 * b2;
  const float g_b0_2 = G[8] * (3.0f * b2) + G[3] * (3.0f * b1) + G[0] * b0;
  const float g_b1_2 = G[5] * (3.0f * b2) + G[4] * (3.0f * b0) + G[1] * b1;
  const float g_b2_2 = G[7] * (3.0f * b0) + G[6] * (3.0f * b1) + G[2] * b2;
  const float gb0 = G[9] * b2 * b1 * 6.0f + G[7] * b2_2 * 3.0f + G[4] * b1_2 * 3.0f +
                    G[0] * b0_2 + g_b0_2 * b0 + g_b0_2 * b0;
  const float gb1 = G[9] * b2 * (6.0f * b0) + G[6] * b2_2 * 3.0f + G[3] * b0_2 * 3.0f +
                    G[1] * b1_2 + g_b1_2 * b1 + g_b1_2 * b1;
  const float gb2 = G[9] * (6.0f * b0 * b1) + G[8] * b0_2 * 3.0f + G[5] * b1_2 * 3.0f +
                    G[2] * b2_2 + g_b2_2 * b2 + g_b2_2 * b2;
  g_b[0] = g_b[0] + gb0;
  g_b[1] = g_b[1] + gb1;
  g_b[2] = g_b[2] + gb2;
}

// reverse of the unit normal at bary b: adds into the control-net and
// deriv_b columns of acc and into g_b
template <class Row, class Acc>
__device__ __forceinline__ void normal_bwd(const Row& row, const float (&b)[3],
                                           const float (&g_nm)[3], Acc& acc,
                                           float (&g_b)[3]) {
  NormalParts o;
  normal_parts(row, b, o);
  const float db[3] = {row[COL_DB], row[COL_DB + 1], row[COL_DB + 2]};
  float g_v[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) g_v[x] = g_nm[x] * o.inv;
  const float g_n2 = inv_norm_grad(o.n2, o.inv, rdot(g_nm, o.v));
#pragma unroll
  for (int x = 0; x < 3; ++x) g_v[x] = g_v[x] + g_n2 * o.v[x] + g_n2 * o.v[x];
  const float g_A[3] = {g_v[2] * o.B[1] - g_v[1] * o.B[2], g_v[0] * o.B[2] - g_v[2] * o.B[0],
                        g_v[1] * o.B[0] - g_v[0] * o.B[1]};
  const float g_B[3] = {g_v[1] * o.A[2] - g_v[2] * o.A[1], g_v[2] * o.A[0] - g_v[0] * o.A[2],
                        g_v[0] * o.A[1] - g_v[1] * o.A[0]};
  float g_c[3][3];  // [component][axis]
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    g_c[0][x] = g_A[x] + db[0] * g_B[x];
    g_c[1][x] = db[1] * g_B[x];
    g_c[2][x] = db[2] * g_B[x] - g_A[x];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) acc[COL_DB + j] = acc[COL_DB + j] + rdot(g_B, o.comp[j]);
  // each control point's terms one by one, the last component's first
  const Quadratics q = quadratics(b);
  const int ks[3][6] = {{2, 5, 6, 7, 8, 9}, {1, 3, 4, 5, 6, 9}, {0, 3, 4, 7, 8, 9}};
  const float monos[3][6] = {{q.b2_2, q.b1_2, q.bc, q.ac, q.b0_2, q.ab},
                             {q.b1_2, q.b0_2, q.ab, q.bc, q.b2_2, q.ac},
                             {q.b0_2, q.ab, q.b1_2, q.b2_2, q.ac, q.bc}};
  const int comp_of[3] = {2, 1, 0};
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int t = 0; t < 6; ++t)
#pragma unroll
      for (int x = 0; x < 3; ++x)
        acc[3 * ks[u][t] + x] = acc[3 * ks[u][t] + x] + monos[u][t] * g_c[comp_of[u]][x];
  // the cotangent of a quadratic that multiplies control point k0 in comp0,
  // k1 in comp1 and k2 in comp2: each component's sum over the axes, added
  // last component first
  auto monomial = [&](int k0, int k1, int k2) {
    const float t0 = rsum3(g_c[0][0] * cpv(row, k0, 0), g_c[0][1] * cpv(row, k0, 1),
                           g_c[0][2] * cpv(row, k0, 2));
    const float t1 = rsum3(g_c[1][0] * cpv(row, k1, 0), g_c[1][1] * cpv(row, k1, 1),
                           g_c[1][2] * cpv(row, k1, 2));
    const float t2 = rsum3(g_c[2][0] * cpv(row, k2, 0), g_c[2][1] * cpv(row, k2, 1),
                           g_c[2][2] * cpv(row, k2, 2));
    return t2 + t1 + t0;
  };
  const float G_b0_2 = monomial(0, 3, 8), G_b1_2 = monomial(4, 1, 5),
              G_b2_2 = monomial(7, 6, 2);
  const float G_ab = monomial(3, 4, 9), G_bc = monomial(9, 5, 6), G_ac = monomial(8, 9, 7);
  // the quadratics taken back the last one first
  const float b0 = b[0], b1 = b[1], b2 = b[2];
  g_b[0] = g_b[0] + (G_ac * b2 * 2.0f + G_ab * b1 * 2.0f + G_b0_2 * b0 + G_b0_2 * b0);
  g_b[1] = g_b[1] + (G_bc * b2 * 2.0f + G_ab * (2.0f * b0) + G_b1_2 * b1 + G_b1_2 * b1);
  g_b[2] = g_b[2] + (G_ac * (2.0f * b0) + G_bc * (2.0f * b1) + G_b2_2 * b2 + G_b2_2 * b2);
}

// reverse of braw = M @ v: adds g_braw_i * v_j into M's columns of acc and
// M^T g_braw into g_v (from its first term when `fresh`), the last row of M
// first
template <class Row, class Acc>
__device__ __forceinline__ void add_bary_mat_grad(const Row& row, const float (&g_braw)[3],
                                                  const float (&v)[3], Acc& acc,
                                                  float (&g_v)[3], bool fresh) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      acc[COL_M + 3 * i + j] = acc[COL_M + 3 * i + j] + g_braw[i] * v[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float t2 = mat(row, 2, j) * g_braw[2];
    g_v[j] = fresh ? t2 : g_v[j] + t2;
    g_v[j] = g_v[j] + mat(row, 1, j) * g_braw[1];
    g_v[j] = g_v[j] + mat(row, 0, j) * g_braw[0];
  }
}

// reverse of diff = surface_diff(row, r, t) with cotangent g: adds into acc,
// gs and gd; returns the gradient of t
template <class Row, class Acc>
__device__ __forceinline__ float surface_diff_bwd(const Row& row, const Ray3& r, float t,
                                                  float g, Acc& acc,
                                                  float (&gs)[3], float (&gd)[3]) {
  float n[3];
  plane_normal(row, n);
  SurfaceDiff o;
  surface_diff(row, r, t, o);
  float g_pd = sign_grad(g, o.pd);
  const float g_sd = sign_grad(-g, o.sd);
  float g_f[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) g_f[x] = g_sd * n[x];
#pragma unroll
  for (int x = 0; x < 3; ++x) acc[COL_N + x] = acc[COL_N + x] + g_sd * o.f[x];
  acc[COL_C] = acc[COL_C] - g_sd;
  float g_b[3] = {0.0f, 0.0f, 0.0f};
  interp_bwd(row, o.b, g_f, acc, g_b);
  float g_braw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g_braw[i] = in_range_grad(g_b[i], o.braw[i], BARY_CLAMP);
  float g_q[3];
  add_bary_mat_grad(row, g_braw, o.q, acc, g_q, true);
  float g_p[3] = {g_q[0], g_q[1], g_q[2]};
#pragma unroll
  for (int x = 0; x < 3; ++x) acc[COL_N + x] = acc[COL_N + x] - g_q[x] * o.pd;
  g_pd = g_pd - rdot(g_q, n);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    g_p[x] = g_p[x] + g_pd * n[x];
    acc[COL_N + x] = acc[COL_N + x] + g_pd * o.p[x];
  }
  acc[COL_C] = acc[COL_C] - g_pd;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    gs[x] = gs[x] + g_p[x];
    gd[x] = gd[x] + g_p[x] * t;
  }
  return rdot(g_p, r.d);
}

// reverse of one Newton iteration from (m, pd), with the cotangents of its
// next middle g_mn, next direction g_pdn and of its surface point g_f,
// normal g_nm and bary g_b (updated in place): adds into acc, gs and gd;
// writes the gradients of m and pd
template <class Row, class Acc>
__device__ __forceinline__ void newton_bwd(const Row& row, const Ray3& r, float m,
                                           const float (&pd)[3], float g_mn,
                                           const float (&g_pdn)[3], float (&g_f)[3],
                                           float (&g_nm)[3], float (&g_b)[3],
                                           Acc& acc, float (&gs)[3],
                                           float (&gd)[3], float& g_m, float (&g_pd)[3]) {
  float n[3];
  plane_normal(row, n);
  Newton it;
  newton(row, r, m, pd, it);
  const float g_q = in_range_grad(g_mn, it.q, MIDDLE_CLAMP);
  const float g_mnum = g_q / it.dsm;
  const float g_mden = div_den_grad(g_q, it.q, it.mden, it.dsm);
  float g_rel[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) g_rel[x] = g_mnum * it.np.nm[x];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    gd[x] = gd[x] + g_mden * it.np.nm[x];
    g_nm[x] = g_nm[x] + g_mden * r.d[x];
    g_nm[x] = g_nm[x] + g_mnum * it.rel[x];
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    g_f[x] = g_f[x] + g_rel[x];
    gs[x] = gs[x] - g_rel[x];
  }
  float g_nd[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    g_nd[x] = it.moved ? g_pdn[x] : 0.0f;
    g_pd[x] = it.moved ? 0.0f : g_pdn[x];
  }
  float g_step[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) g_step[x] = g_nd[x] * it.inv;
  const float g_st2 = inv_norm_grad(it.st2, it.inv, rdot(g_nd, it.step));
#pragma unroll
  for (int x = 0; x < 3; ++x) g_step[x] = g_step[x] + g_st2 * it.step[x] + g_st2 * it.step[x];
#pragma unroll
  for (int x = 0; x < 3; ++x) g_f[x] = g_f[x] + g_step[x];
  float g_pl[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) g_pl[x] = -g_step[x];
  interp_bwd(row, it.b, g_f, acc, g_b);
  normal_bwd(row, it.b, g_nm, acc, g_b);
  float g_braw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g_braw[i] = in_range_grad(g_b[i], it.braw[i], BARY_CLAMP);
  add_bary_mat_grad(row, g_braw, it.pl, acc, g_pl, false);
  float g_p[3] = {g_pl[0], g_pl[1], g_pl[2]};
  const float g_t = rdot(g_pl, pd);
#pragma unroll
  for (int x = 0; x < 3; ++x) g_pd[x] = g_pd[x] + g_pl[x] * it.t;
  const float g_tnum = g_t / it.dst;
  const float g_pdn_dot = div_den_grad(g_t, it.t, it.pdn, it.dst);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    g_pd[x] = g_pd[x] + g_pdn_dot * n[x];
    acc[COL_N + x] = acc[COL_N + x] + g_pdn_dot * pd[x];
  }
  acc[COL_C] = acc[COL_C] + g_tnum;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    acc[COL_N + x] = acc[COL_N + x] - g_tnum * it.p[x];
    g_p[x] = g_p[x] - g_tnum * n[x];
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    gs[x] = gs[x] + g_p[x];
    gd[x] = gd[x] + g_p[x] * m;
  }
  g_m = rdot(g_p, r.d);
}

// reverse of bracket() and of the projection direction's start at the plane
// normal, with the cotangents of the first middle g_m0 and direction g_pd0
template <class Row, class Acc>
__device__ __forceinline__ void bracket_bwd(const Row& row, const Ray3& r, const Params& prm,
                                            const Bracket& br, float g_m0,
                                            const float (&g_pd0)[3], Acc& acc,
                                            float (&gs)[3], float (&gd)[3]) {
  float n[3];
  plane_normal(row, n);
#pragma unroll
  for (int x = 0; x < 3; ++x) acc[COL_N + x] = acc[COL_N + x] + g_pd0[x];
  const float closer = br.closer, further = br.further, mraw = br.mraw;
  float g_mraw, g_closer, g_further;
  if (prm.clamp_secant) {
    const float lo = tmin(closer, further), hi = tmax(closer, further);
    const float y = tmax(mraw, lo);
    // minimum(y, hi), then maximum(mraw, lo), then hi and lo of the bracket
    const float g_y = split_grad(g_m0, y > hi, y == hi);
    const float g_hi = split_grad(g_m0, hi > y, hi == y);
    g_mraw = split_grad(g_y, mraw < lo, mraw == lo);
    const float g_lo = split_grad(g_y, lo < mraw, lo == mraw);
    g_closer = split_grad(g_hi, closer < further, closer == further) +
               split_grad(g_lo, closer > further, closer == further);
    g_further = split_grad(g_hi, further < closer, further == closer) +
                split_grad(g_lo, further > closer, further == closer);
  } else {
    g_mraw = in_range_grad(g_m0, mraw, MIDDLE_CLAMP);
    g_closer = 0.0f;
    g_further = 0.0f;
  }
  const float g_mid = br.fallback ? g_mraw : 0.0f;
  const float g_sec = br.fallback ? 0.0f : g_mraw;
  g_closer = g_closer + g_mid * 0.5f;
  g_further = g_further + g_mid * 0.5f;
  const float g_secnum = g_sec / br.dsd;
  const float g_denom = div_den_grad(g_sec, br.secant, br.denom, br.dsd);
  float g_dc = g_secnum * further;
  g_further = g_further + g_secnum * br.dc;
  float g_df = -g_secnum * closer;
  g_closer = g_closer - g_secnum * br.df;
  g_dc = g_dc + g_denom;
  g_df = g_df - g_denom;
  g_further = g_further + surface_diff_bwd(row, r, further, g_df, acc, gs, gd);
  g_closer = g_closer + surface_diff_bwd(row, r, closer, g_dc, acc, gs, gd);
  const float g_dist0 = g_closer + g_further;
  const float g_din = br.going ? g_closer : g_further;
  const float g_dout = br.going ? g_further : g_closer;
  acc[COL_H_IN] = acc[COL_H_IN] + g_din / br.dsc;
  acc[COL_H_OUT] = acc[COL_H_OUT] + g_dout / br.dsc;
  const float g_cosv = fabsf(br.cosv) < static_cast<float>(1e-12)
                           ? 0.0f
                           : -g_dout * (br.d_out / br.dsc) + -g_din * (br.d_in / br.dsc);
  const float g_dist0r = br.valid ? g_dist0 : 0.0f;
  float g_cos = br.valid ? g_cosv : 0.0f;
  const float g_num0 = g_dist0r / br.ds0;
  g_cos = g_cos + div_den_grad(g_dist0r, br.dist0r, br.cos_inc, br.ds0);
  acc[COL_C] = acc[COL_C] + g_num0;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    acc[COL_N + x] = acc[COL_N + x] - g_num0 * r.s[x];
    gs[x] = gs[x] - g_num0 * n[x];
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    gd[x] = gd[x] + g_cos * n[x];
    acc[COL_N + x] = acc[COL_N + x] + g_cos * r.d[x];
  }
}

__device__ __forceinline__ Ray3 load_ray(const float* start, const float* direction, int r) {
  Ray3 ray;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    ray.s[x] = start[3 * r + x];
    ray.d[x] = direction[3 * r + x];
  }
  return ray;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

struct ForwardArgs {
  const float* table;
  const long long* idx;
  const float* start;
  const float* direction;
  const unsigned char* any_hit;
  const int* win;
  int P, R;
  Params prm;
  int* what;
  float* distance;
  float* point;
  float* normal;
  float* bary;
  float* cos_out;
  int* patch;
  int* what_w;
};

struct BackwardArgs {
  const float* table;
  const long long* idx;
  const float* start;
  const float* direction;
  const unsigned char* any_hit;
  const float* g_distance;
  const float* g_point;
  const float* g_normal;
  const float* g_bary;
  const float* g_cos;
  int P, R;
  Params prm;
  float* rows;
  float* g_start;
  float* g_direction;
};

// a thread's 48 row-gradient accumulators in the block's shared array,
// column-major: column j of thread t at j * ACC_STRIDE + t, so a warp's
// update of one column touches 32 consecutive words, one to a bank
struct SharedAcc {
  float* p;  // the array + threadIdx.x
  __device__ __forceinline__ float& operator[](int j) const { return p[j * ACC_STRIDE]; }
};

// each Newton iteration's inputs, (k, 0) the middle and (k, 1 + x) the
// projection direction, in the thread's column-major slot of the block's
// shared array, as SharedAcc
struct SharedInputs {
  float* p;  // the array + threadIdx.x
  __device__ __forceinline__ float& operator()(int k, int c) const {
    return p[(4 * k + c) * ACC_STRIDE];
  }
};

// the forward's Newton iterations from the bracket's middle: it holds the
// last one's intermediates, dist the middle it started from
__device__ __forceinline__ void forward_iterations(const GlobalRow& row, const Ray3& r,
                                                   const Params& prm, const Bracket& br,
                                                   Newton& it, float& dist) {
  float m = br.middle;
  float pd[3];
  plane_normal(row, pd);
  dist = m;
#pragma unroll 1
  for (int k = 0; k < prm.iters; ++k) {
    dist = m;
    newton(row, r, m, pd, it);
    m = it.m_next;
#pragma unroll
    for (int x = 0; x < 3; ++x) pd[x] = it.pd_next[x];
  }
}

// a thread's ray of the forward, every field straight to device memory (the
// scalar ones with neighbouring threads on neighbouring words).  Every
// thread computes (a spare thread of the last block on the last ray, a ray
// whose id lies outside the table on row 0) and branches only at its
// stores, so the arithmetic runs in converged code, where the compiler
// keeps uniform values (the loads' memory descriptor) in uniform registers;
// with early returns before it both kernels measured slower (PERF.md §6)
__device__ __forceinline__ void forward_ray(const ForwardArgs& a, int ray) {
  const int rr = ray < a.R ? ray : a.R - 1;
  const long long id = a.idx[rr];
  const bool bad = id < 0 || id >= a.P;
  const Ray3 r = load_ray(a.start, a.direction, rr);
  const GlobalRow row{a.table + (bad ? 0 : id) * N_COLS};

  Bracket br;
  bracket(row, r, a.prm, br);
  Newton it;
  float dist;
  forward_iterations(row, r, a.prm, br, it, dist);

  // acceptance (cpp:165-167): point close to the ray line AND beyond the slab
  float rel[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) rel[x] = it.f[x] - r.s[x];
  const float along = dot3(rel, r.d);
  float perp[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) perp[x] = rel[x] - along * r.d[x];
  const bool accept = (sqrtf(dot3(perp, perp)) <= a.prm.max_ray_dist) &&
                      (dist >= (br.further - br.closer) * a.prm.minimal_ray_distance);
  // domain classification against divider planes (cpp:169-184)
  int outside = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float4 dv = row.quad(ROW_DIV + 4 * j);
    const float dd = (it.f[0] * dv.x + it.f[1] * dv.y + it.f[2] * dv.z) - dv.w;
    outside += (dd < 0.0f ? 1 : 0) << j;
  }
  const int side = outside == 1 ? 0 : outside == 2 ? 1 : outside == 4 ? 2 : WHAT_INTERSECT;

  if (ray >= a.R) return;
  if (bad) {
    // an id outside the table reads nothing: every field is NaN or none
    a.what[ray] = a.what_w[ray] = WHAT_NONE;
    a.patch[ray] = -1;
    a.distance[ray] = a.cos_out[ray] = NAN;
#pragma unroll
    for (int x = 0; x < 3; ++x) a.point[3 * ray + x] = a.normal[3 * ray + x] =
        a.bary[3 * ray + x] = NAN;
    return;
  }
  a.what_w[ray] = (br.valid && accept) ? side : WHAT_NONE;
  const bool hit = a.any_hit[ray] != 0;
  a.what[ray] = hit ? WHAT_INTERSECT : WHAT_NONE;
  a.distance[ray] = hit ? dist : BIG_F;
  a.patch[ray] = hit ? a.win[ray] : -1;
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    a.point[3 * ray + x] = it.f[x];
    a.normal[3 * ray + x] = it.np.nm[x];
    a.bary[3 * ray + x] = it.b[x];
  }
  a.cos_out[ray] = dot3(r.d, it.np.nm);
}

// the kernels take their pointers as __restrict__ parameters (no output
// aliases an input) and gather them into one view
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS)
recompute_forward_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                         const float* __restrict__ start, const float* __restrict__ direction,
                         const unsigned char* __restrict__ any_hit,
                         const int* __restrict__ win, int P, int R, Params prm,
                         int* __restrict__ what, float* __restrict__ distance,
                         float* __restrict__ point, float* __restrict__ normal,
                         float* __restrict__ bary, float* __restrict__ cos_out,
                         int* __restrict__ patch, int* __restrict__ what_w) {
  const ForwardArgs a = {table, idx,    start,   direction, any_hit, win,   P,     R,
                         prm,   what,   distance, point,    normal,  bary,  cos_out, patch,
                         what_w};
  forward_ray(a, blockIdx.x * FWD_THREADS + threadIdx.x);
}

// the reverse sweep of one ray: re-runs the forward keeping each Newton
// iteration's inputs in `in`, then takes the iterations back the last one
// first and the bracket last, adding the row gradient into acc and the
// ray's into gs and gd
__device__ __forceinline__ void backward_ray(const BackwardArgs& a, int ray, const GlobalRow& row,
                                             const Ray3& r, SharedAcc& acc, SharedInputs& in,
                                             float (&gs)[3], float (&gd)[3]) {
  const int K = a.prm.iters;
  Bracket br;
  bracket(row, r, a.prm, br);
  float m = br.middle;
  float pd[3];
  plane_normal(row, pd);
  float nm_last[3];
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    in(k, 0) = m;
#pragma unroll
    for (int x = 0; x < 3; ++x) in(k, 1 + x) = pd[x];
    Newton it;
    newton(row, r, m, pd, it);
    m = it.m_next;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      pd[x] = it.pd_next[x];
      nm_last[x] = it.np.nm[x];
    }
  }

  const float gc = a.g_cos[ray];
  float g_nm_out[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) g_nm_out[x] = a.g_normal[3 * ray + x] + gc * r.d[x];
#pragma unroll
  for (int x = 0; x < 3; ++x) gd[x] = gd[x] + gc * nm_last[x];
  float g_m = 0.0f, g_pd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int k = K - 1; k >= 0; --k) {
    // the fields' cotangents enter at the last iteration
    const bool last = k == K - 1;
    float g_f[3], g_n[3], g_b[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      g_f[x] = last ? a.g_point[3 * ray + x] : 0.0f;
      g_n[x] = last ? g_nm_out[x] : 0.0f;
      g_b[x] = last ? a.g_bary[3 * ray + x] : 0.0f;
    }
    const float g_pdn[3] = {g_pd[0], g_pd[1], g_pd[2]};
    const float pd_k[3] = {in(k, 1), in(k, 2), in(k, 3)};
    newton_bwd(row, r, in(k, 0), pd_k, g_m, g_pdn, g_f, g_n, g_b, acc, gs, gd, g_m, g_pd);
    if (last) g_m = g_m + (a.any_hit[ray] != 0 ? a.g_distance[ray] : 0.0f);
  }
  bracket_bwd(row, r, a.prm, br, g_m, g_pd, acc, gs, gd);
}

// the backward kernel's first phase: this thread's ray (the last one for a
// spare thread), its row gradient left in the block's array and its ray
// gradients stored (none for a spare thread, NaN for a ray whose id lies
// outside the table), branching at the stores only, as forward_ray
__device__ __forceinline__ void backward_thread(const BackwardArgs& a, float* acc_s,
                                                float* in_s, unsigned char* bad_s) {
  const int t = threadIdx.x;
  const int ray = blockIdx.x * BWD_THREADS + t;
  const int rr = ray < a.R ? ray : a.R - 1;
  const long long id = a.idx[rr];
  const bool bad = id < 0 || id >= a.P;
  bad_s[t] = bad;
  const Ray3 r = load_ray(a.start, a.direction, rr);
  const GlobalRow row{a.table + (bad ? 0 : id) * N_COLS};
  SharedAcc acc{acc_s + t};
  SharedInputs in{in_s + t};
#pragma unroll
  for (int j = 0; j < N_GRAD; ++j) acc[j] = 0.0f;
  float gs[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
  backward_ray(a, rr, row, r, acc, in, gs, gd);
  if (ray >= a.R) return;
  if (bad) {
    // an id outside the table reads nothing: every gradient is NaN (its row
    // by store_rows)
#pragma unroll
    for (int x = 0; x < 3; ++x) a.g_start[3 * ray + x] = a.g_direction[3 * ray + x] = NAN;
    return;
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    a.g_start[3 * ray + x] = gs[x];
    a.g_direction[3 * ray + x] = gd[x];
  }
}

// the backward kernel's second phase: the block's rows as one contiguous
// span of quads, neighbouring threads on neighbouring quads: 48 gradient
// columns from the block's array and 12 zeros a row, NaN rows for ids
// outside the table, the last block's n < BWD_THREADS rows alone
__device__ __forceinline__ void store_rows(const BackwardArgs& a, const float* acc_s,
                                           const unsigned char* bad_s) {
  constexpr int QUADS = N_COLS / 4;
  const long long base = static_cast<long long>(blockIdx.x) * BWD_THREADS;
  const int n = a.R - base < BWD_THREADS ? static_cast<int>(a.R - base) : BWD_THREADS;
  float4* out = reinterpret_cast<float4*>(a.rows + base * N_COLS);
  for (int q = threadIdx.x; q < n * QUADS; q += BWD_THREADS) {
    const int i = q / QUADS, c = q - i * QUADS;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (bad_s[i]) {
      v = make_float4(NAN, NAN, NAN, NAN);
    } else if (c < N_GRAD / 4) {
      const float* col = acc_s + 4 * c * ACC_STRIDE + i;
      v = make_float4(col[0], col[ACC_STRIDE], col[2 * ACC_STRIDE], col[3 * ACC_STRIDE]);
    }
    out[q] = v;
  }
}

__global__ void __launch_bounds__(BWD_THREADS, BWD_BLOCKS)
recompute_backward_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                          const float* __restrict__ start,
                          const float* __restrict__ direction,
                          const unsigned char* __restrict__ any_hit,
                          const float* __restrict__ g_distance,
                          const float* __restrict__ g_point,
                          const float* __restrict__ g_normal,
                          const float* __restrict__ g_bary, const float* __restrict__ g_cos,
                          int P, int R, Params prm, float* __restrict__ rows,
                          float* __restrict__ g_start, float* __restrict__ g_direction) {
  __shared__ float acc_s[N_GRAD * ACC_STRIDE];
  __shared__ float in_s[4 * MAX_ITERS * ACC_STRIDE];
  __shared__ unsigned char bad_s[BWD_THREADS];
  const BackwardArgs a = {table,   idx,    start,  direction, any_hit, g_distance,
                          g_point, g_normal, g_bary, g_cos,   P,       R,
                          prm,     rows,   g_start, g_direction};
  backward_thread(a, acc_s, in_s, bad_s);
  __syncthreads();
  store_rows(a, acc_s, bad_s);
}

// registers, local bytes (stack frame and spills), static shared bytes,
// threads a block and blocks an SM of one kernel
template <class Kernel>
int kernel_attributes(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes fa{};
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = threads;
  out[4] = blocks;
  return static_cast<int>(err);
}

bool bad_config(int P, int R, int iters, const void* table, const void* rows) {
  return P <= 0 || R < 0 || iters < 1 || iters > MAX_ITERS ||
         reinterpret_cast<unsigned long long>(table) % 16 != 0 ||
         reinterpret_cast<unsigned long long>(rows) % 16 != 0;
}

}  // namespace

// The forward: the RayHit fields and the gate-OFF what of R rays on their
// winners' rows of the [P, 60] table.
extern "C" int cbtr_recompute(const void* table, const void* idx, const void* start,
                              const void* direction, const void* any_hit, const void* win,
                              void* what, void* distance, void* point, void* normal,
                              void* bary, void* cos_out, void* patch, void* what_w, int P,
                              int R, int iters, float ray_plane_eps, float estimation_eps,
                              float max_ray_dist, float minimal_ray_distance,
                              int clamp_secant, void* stream) {
  if (bad_config(P, R, iters, table, table)) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const Params prm = {ray_plane_eps, estimation_eps, max_ray_dist, minimal_ray_distance,
                      iters, clamp_secant};
  const int grid = (R + FWD_THREADS - 1) / FWD_THREADS;
  recompute_forward_kernel<<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const long long*>(idx),
      static_cast<const float*>(start), static_cast<const float*>(direction),
      static_cast<const unsigned char*>(any_hit), static_cast<const int*>(win), P, R, prm,
      static_cast<int*>(what), static_cast<float*>(distance), static_cast<float*>(point),
      static_cast<float*>(normal), static_cast<float*>(bary), static_cast<float*>(cos_out),
      static_cast<int*>(patch), static_cast<int*>(what_w));
  return static_cast<int>(cudaGetLastError());
}

// The backward: each ray's row gradient [R, 60] and its start and direction
// gradients [R, 3] from the cotangents of distance, point, normal, bary and
// cos_incidence.
extern "C" int cbtr_recompute_backward(const void* table, const void* idx, const void* start,
                                       const void* direction, const void* any_hit,
                                       const void* g_distance, const void* g_point,
                                       const void* g_normal, const void* g_bary,
                                       const void* g_cos, void* rows, void* g_start,
                                       void* g_direction, int P, int R, int iters,
                                       float ray_plane_eps, float estimation_eps,
                                       float max_ray_dist, float minimal_ray_distance,
                                       int clamp_secant, void* stream) {
  if (bad_config(P, R, iters, table, rows)) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const Params prm = {ray_plane_eps, estimation_eps, max_ray_dist, minimal_ray_distance,
                      iters, clamp_secant};
  const int grid = (R + BWD_THREADS - 1) / BWD_THREADS;
  recompute_backward_kernel<<<grid, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const long long*>(idx),
      static_cast<const float*>(start), static_cast<const float*>(direction),
      static_cast<const unsigned char*>(any_hit), static_cast<const float*>(g_distance),
      static_cast<const float*>(g_point), static_cast<const float*>(g_normal),
      static_cast<const float*>(g_bary), static_cast<const float*>(g_cos), P, R, prm,
      static_cast<float*>(rows), static_cast<float*>(g_start),
      static_cast<float*>(g_direction));
  return static_cast<int>(cudaGetLastError());
}

// The forward's (backward 0) or the backward kernel's registers, local bytes
// (stack frame and spills), static shared bytes, threads a block and the
// blocks an SM holds (out[0..4]).
extern "C" int cbtr_recompute_attributes(int backward, int* out) {
  return backward ? kernel_attributes(&recompute_backward_kernel, BWD_THREADS, out)
                  : kernel_attributes(&recompute_forward_kernel, FWD_THREADS, out);
}
