// Fused sweep + select for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the TPU kernel cbtr_tpu/ops/pallas_sweep.py::_sweep_select_kernel
// (launched by _sweep_select_call, public sweep_select_pallas).  For every
// ray it returns the winner of the reference's brute-force scan with one
// forward retry (reference/bezierMesh.cpp:206-227): the minimum-distance
// accepted candidate, lowest patch id on ties, or a miss.
//
// What bounds it on the H100: f32 arithmetic outside the tensor cores.  A
// pair that is evaluated costs about 1.7 kFLOP (the reference's own cost
// model, pallas_sweep.py:737: 1300 per 4 Newton iterations + 400), against
// 256 bytes of patch row that every ray of a tile shares, so it is
// compute-bound, not bandwidth-bound.  The design therefore spends its effort
// on evaluating fewer pairs and on moving no per-pair state:
//   * the (128-ray tile x 16-patch block) cull of the reference is kept: the
//     block loop visits only the tile's listed blocks, and a listed block is
//     skipped unless some (patch, ray) pair passes the per-patch sphere test
//     (__syncthreads_or);
//   * the padded patch table ([P_pad, 64] f32, 128 KiB at P_pad = 512) stays
//     L2-resident; each listed block (4 KiB) is staged into shared memory
//     and read by all 128 threads as broadcasts;
//   * nothing per pair goes to device memory: 8 bytes per ray come out.
//
// Layout: one CUDA block per 128-ray tile, one thread per ray.  The TPU
// kernel keeps per-pair (code, dist) scratch and resolves the follow-side
// retry with a one-hot vote matmul; [P_pad x 128] scratch does not fit
// shared memory, so this kernel computes the same candidate set in two
// passes instead:
//   pass 1  over the listed and gated blocks, each thread folds in its direct
//           hits (gate-ON cIntersect) and records in a per-thread bitmap the
//           patches q = neighbours[p, s] that a gate-ON cFollowSide_s result
//           of patch p votes for; the block marks which candidate blocks it
//           evaluated;
//   pass 2  each thread re-evaluates the gate-OFF candidate of every voted q
//           whose block was evaluated (few: rays that cross a patch border)
//           and folds it in if it is cIntersect.  That is the reference's
//           "voted AND its own gate-OFF result hits".
// Both passes call the same __noinline__ eval_candidate on the same row
// values, so a retry candidate's distance is bit-identical to the one pass 1
// would have seen.
//
// Arithmetic: eval_candidate evaluates the expressions of
// cbtr_tpu_torch/ops/intersect.py::_candidates_core in the same order.  With
// -fmad=false and IEEE sqrt/division (see cuda_sweep.NVCC_FLAGS) every
// operation rounds like the plain twin's separate torch ops, and 1/sqrt is
// written out where the TPU kernel used an approximate rsqrt.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_R = 128;
constexpr int N_ROWS = 64;

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

__device__ __forceinline__ float safe_div(float num, float den) {
  // constants go through double, as torch converts a Python float scalar
  const float eps = static_cast<float>(1e-12);
  const float den_safe = fabsf(den) < eps ? (den < 0.0f ? -eps : eps) : den;
  return num / den_safe;
}

// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? (a + b) : (a > b ? a : b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? (a + b) : (a < b ? a : b);
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}

// bary = M @ p, each row a left-to-right sum
__device__ __forceinline__ void apply_mat3(const float* m, float px, float py,
                                           float pz, float& b0, float& b1,
                                           float& b2) {
  b0 = m[0] * px + m[1] * py + m[2] * pz;
  b1 = m[3] * px + m[4] * py + m[5] * pz;
  b2 = m[6] * px + m[7] * py + m[8] * pz;
}

// cubic surface point: sum_k w_k * cp_k, k = 0..9 left to right
__device__ __forceinline__ void interpolate(const float* cp, float b0, float b1,
                                            float b2, float& fx, float& fy,
                                            float& fz) {
  const float b0_2 = b0 * b0, b1_2 = b1 * b1, b2_2 = b2 * b2;
  const float w[10] = {
      b0 * b0_2,        b1 * b1_2,        b2 * b2_2,
      3.0f * b1 * b0_2, 3.0f * b0 * b1_2, 3.0f * b2 * b1_2,
      3.0f * b1 * b2_2, 3.0f * b0 * b2_2, 3.0f * b2 * b0_2,
      6.0f * b0 * b1 * b2,
  };
  fx = w[0] * cp[0];
  fy = w[0] * cp[1];
  fz = w[0] * cp[2];
#pragma unroll
  for (int k = 1; k < 10; ++k) {
    fx = fx + w[k] * cp[3 * k];
    fy = fy + w[k] * cp[3 * k + 1];
    fz = fz + w[k] * cp[3 * k + 2];
  }
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

// unit normal from the two directional derivatives (bezier/patches.py
// patch_normal; reference/bezierTriangle.cpp:197-233)
__device__ __forceinline__ void patch_normal(const float* cp, const float* db,
                                             float b0, float b1, float b2,
                                             float& nx, float& ny, float& nz) {
  const float b0_2 = b0 * b0, b1_2 = b1 * b1, b2_2 = b2 * b2;
  const float ab = 2.0f * b0 * b1;
  const float bc = 2.0f * b1 * b2;
  const float ac = 2.0f * b0 * b2;
  float a[3], b[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float comp0 = b0_2 * cp[0 + x] + ab * cp[9 + x] + b1_2 * cp[12 + x] +
                        b2_2 * cp[21 + x] + ac * cp[24 + x] + bc * cp[27 + x];
    const float comp1 = b1_2 * cp[3 + x] + b0_2 * cp[9 + x] + ab * cp[12 + x] +
                        bc * cp[15 + x] + b2_2 * cp[18 + x] + ac * cp[27 + x];
    const float comp2 = b2_2 * cp[6 + x] + b1_2 * cp[15 + x] + bc * cp[18 + x] +
                        ac * cp[21 + x] + b0_2 * cp[24 + x] + ab * cp[27 + x];
    a[x] = comp0 - comp2;
    b[x] = db[0] * comp0 + db[1] * comp1 + db[2] * comp2;
  }
  nx = a[1] * b[2] - a[2] * b[1];
  ny = a[2] * b[0] - a[0] * b[2];
  nz = a[0] * b[1] - a[1] * b[0];
  safe_normalize(nx, ny, nz);
}

// |plane distance of the ray point| - |plane distance of the surface point
// above its projection| (the secant bracket's residual)
__device__ __forceinline__ float surface_diff(const float* row, const Ray& r,
                                              float t) {
  const float nx = row[ROW_PLANE], ny = row[ROW_PLANE + 1],
              nz = row[ROW_PLANE + 2], c = row[ROW_PLANE + 3];
  const float px = r.sx + t * r.dx, py = r.sy + t * r.dy, pz = r.sz + t * r.dz;
  const float pd = (px * nx + py * ny + pz * nz) - c;
  const float qx = px - nx * pd, qy = py - ny * pd, qz = pz - nz * pd;
  float b0, b1, b2;
  apply_mat3(row + ROW_BINV, qx, qy, qz, b0, b1, b2);
  b0 = clip(b0, -16.0f, 16.0f);
  b1 = clip(b1, -16.0f, 16.0f);
  b2 = clip(b2, -16.0f, 16.0f);
  float fx, fy, fz;
  interpolate(row, b0, b1, b2, fx, fy, fz);
  const float sd = (fx * nx + fy * ny + fz * nz) - c;
  return fabsf(pd) - fabsf(sd);
}

// Gate-OFF candidate of one (ray, patch) pair: returns
// code = what | (in_domain << 3) and writes the along-ray distance.  The
// distance is meaningful only where what == WHAT_INTERSECT.
__device__ __noinline__ int eval_candidate(const float* row, const Ray r,
                                           const Params prm, float* dist_out) {
  const float nx = row[ROW_PLANE], ny = row[ROW_PLANE + 1],
              nz = row[ROW_PLANE + 2], c = row[ROW_PLANE + 3];
  const float h_in = row[ROW_H], h_out = row[ROW_H + 1];
  const float* m = row + ROW_BINV;

  // ray x underlying plane (reference/bezierTriangle.cpp:124-126)
  float cos_inc = r.dx * nx + r.dy * ny + r.dz * nz;
  float dist0 = safe_div(c - (nx * r.sx + ny * r.sy + nz * r.sz), cos_inc);
  bool valid = (fabsf(cos_inc) >= prm.ray_plane_eps) && (dist0 > 0.0f);
  valid = valid && (fabsf(dist0) > -h_in) && (fabsf(dist0) > h_out);

  float b0, b1, b2;
  apply_mat3(m, r.sx + dist0 * r.dx, r.sy + dist0 * r.dy, r.sz + dist0 * r.dz,
             b0, b1, b2);
  const int in_dom = (b0 >= 0.0f && b0 <= 1.0f && b1 >= 0.0f && b1 <= 1.0f &&
                      b2 >= 0.0f && b2 <= 1.0f) ? 1 : 0;
  *dist_out = 0.0f;
  // a pair that fails here ends as WHAT_NONE whatever the Newton loop does
  if (!valid) return WHAT_NONE | (in_dom << 3);

  // bracket along the ray (reference/bezierTriangle.cpp:132-135)
  const float d_in = safe_div(h_in, cos_inc);
  const float d_out = safe_div(h_out, cos_inc);
  const bool going = cos_inc > 0.0f;
  const float closer = dist0 + (going ? d_in : d_out);
  const float further = dist0 + (going ? d_out : d_in);

  // secant-style estimate with midpoint fallback (cpp:137-152)
  const float diff_closer = surface_diff(row, r, closer);
  const float diff_further = surface_diff(row, r, further);
  const float denom = diff_closer - diff_further;
  const float secant =
      safe_div(diff_closer * further - diff_further * closer, denom);
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
    const float t = safe_div(c - (nx * px + ny * py + nz * pz),
                             pdx * nx + pdy * ny + pdz * nz);
    const float plx = px + t * pdx, ply = py + t * pdy, plz = pz + t * pdz;
    apply_mat3(m, plx, ply, plz, b0, b1, b2);
    b0 = clip(b0, -16.0f, 16.0f);
    b1 = clip(b1, -16.0f, 16.0f);
    b2 = clip(b2, -16.0f, 16.0f);
    float nmx, nmy, nmz;
    patch_normal(row, row + ROW_DB, b0, b1, b2, nmx, nmy, nmz);
    interpolate(row, b0, b1, b2, fx, fy, fz);
    float stx = fx - plx, sty = fy - ply, stz = fz - plz;
    const float st2 = stx * stx + sty * sty + stz * stz;
    safe_normalize(stx, sty, stz);
    // keep the previous direction when the step vanished (converged lane)
    if (st2 > 0.0f) {
      pdx = stx;
      pdy = sty;
      pdz = stz;
    }
    middle = clip(safe_div((fx - r.sx) * nmx + (fy - r.sy) * nmy +
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
    const float* dv = row + ROW_DIV + 4 * j;
    const float dd = (fx * dv[0] + fy * dv[1] + fz * dv[2]) - dv[3];
    outside += (dd < 0.0f ? 1 : 0) << j;
  }
  const int what = outside == 1 ? 0 : outside == 2 ? 1 : outside == 4 ? 2
                                                                      : WHAT_INTERSECT;
  return what | (in_dom << 3);
}

// per-patch bounding-sphere cull (cuda_sweep._sphere_hit_pairs)
__device__ __forceinline__ bool sphere_hit(const float* row, const Ray& r) {
  const float relx = row[ROW_BSPHERE] - r.sx;
  const float rely = row[ROW_BSPHERE + 1] - r.sy;
  const float relz = row[ROW_BSPHERE + 2] - r.sz;
  const float brad = row[ROW_BSPHERE + 3];
  const float t_ca = relx * r.dx + rely * r.dy + relz * r.dz;
  const float rel2 = relx * relx + rely * rely + relz * relz;
  const float r2 = brad * brad;
  return ((rel2 - t_ca * t_ca) <= r2) && ((t_ca >= 0.0f) || (rel2 <= r2));
}

// min distance, lowest patch id on ties
__device__ __forceinline__ void fold(float d, int q, float& best, int& best_id) {
  if (d < best || (d == best && q < best_id)) {
    best = d;
    best_id = q;
  }
}

// shared memory: stage [block_p x 64] f32 | block_ok [B] i32 |
// voted [P_pad / 32][TILE_R] u32 (word-major: thread-consecutive words, no
// bank conflicts)
__global__ void __launch_bounds__(TILE_R)
sweep_select_kernel(const int* __restrict__ counts, const int* __restrict__ lists,
                    const float* __restrict__ rays,
                    const float* __restrict__ patch_t,
                    const int* __restrict__ nb, float* __restrict__ dist_out,
                    int* __restrict__ idx_out, int T, int P, int P_pad,
                    int block_p, Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = P_pad / block_p;
  const int W = P_pad / 32;
  float* stage = reinterpret_cast<float*>(smem);
  int* block_ok = reinterpret_cast<int*>(stage + block_p * N_ROWS);
  unsigned* voted = reinterpret_cast<unsigned*>(block_ok + B);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int R_pad = T * TILE_R;
  const int ray = tile * TILE_R + tid;
  const Ray r = {rays[ray], rays[R_pad + ray], rays[2 * R_pad + ray],
                 rays[3 * R_pad + ray], rays[4 * R_pad + ray],
                 rays[5 * R_pad + ray]};

  for (int i = tid; i < B; i += TILE_R) block_ok[i] = 0;
  for (int w = 0; w < W; ++w) voted[w * TILE_R + tid] = 0u;

  float best = BIG_F;
  int best_id = 0;

  // ---- pass 1: listed blocks, sphere-gated per (tile x block) ----
  const int n_blocks = counts[tile];
  for (int k = 0; k < n_blocks; ++k) {
    const int blk = lists[k * T + tile];
    __syncthreads();  // the previous block's stage is no longer read
    const float* src = patch_t + static_cast<size_t>(blk) * block_p * N_ROWS;
    for (int i = tid; i < block_p * N_ROWS; i += TILE_R) stage[i] = src[i];
    __syncthreads();

    int any_hit = 0;
    for (int j = 0; j < block_p; ++j) any_hit |= sphere_hit(stage + j * N_ROWS, r);
    if (!__syncthreads_or(any_hit)) continue;
    if (tid == 0) block_ok[blk] = 1;

    for (int j = 0; j < block_p; ++j) {
      const int p = blk * block_p + j;
      if (p >= P) break;  // all-zero padding rows give no candidate
      float d;
      const int code = eval_candidate(stage + j * N_ROWS, r, prm, &d);
      const int what_on = (code >> 3) ? (code & 7) : WHAT_NONE;
      if (what_on == WHAT_INTERSECT) {
        fold(d, p, best, best_id);
      } else if (what_on < WHAT_NONE) {
        const int q = nb[3 * p + what_on];
        if (q >= 0) voted[(q >> 5) * TILE_R + tid] |= 1u << (q & 31);
      }
    }
  }
  __syncthreads();  // block_ok complete

  // ---- pass 2: voted neighbours, gate OFF, only where evaluated ----
  for (int w = 0; w < W; ++w) {
    unsigned bits = voted[w * TILE_R + tid];
    while (bits) {
      const int q = w * 32 + (__ffs(bits) - 1);
      bits &= bits - 1u;
      if (q >= P || !block_ok[q / block_p]) continue;
      float d;
      const int code =
          eval_candidate(patch_t + static_cast<size_t>(q) * N_ROWS, r, prm, &d);
      if ((code & 7) == WHAT_INTERSECT) fold(d, q, best, best_id);
    }
  }

  dist_out[ray] = best;
  idx_out[ray] = best_id;
}

}  // namespace

extern "C" int cbtr_sweep_select(const void* counts, const void* lists,
                                 const void* rays, const void* patch_t,
                                 const void* nb, void* dist_out, void* idx_out,
                                 int T, int P, int P_pad, int block_p, int iters,
                                 float ray_plane_eps, float estimation_eps,
                                 float max_ray_dist, float minimal_ray_distance,
                                 int clamp_secant, void* stream) {
  if (T <= 0) return 0;
  const Params prm = {ray_plane_eps, estimation_eps, max_ray_dist,
                      minimal_ray_distance, iters, clamp_secant};
  const size_t smem = sizeof(float) * block_p * N_ROWS +
                      sizeof(int) * (P_pad / block_p) +
                      sizeof(unsigned) * (P_pad / 32) * TILE_R;
  sweep_select_kernel<<<T, TILE_R, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(lists),
      static_cast<const float*>(rays), static_cast<const float*>(patch_t),
      static_cast<const int*>(nb), static_cast<float*>(dist_out),
      static_cast<int*>(idx_out), T, P, P_pad, block_p, prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbtr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
