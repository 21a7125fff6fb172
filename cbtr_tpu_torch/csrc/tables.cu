// The sweep kernels' tables for Hopper (sm_90a): the table kernel of the port.
//
// Builds, from the leaves of a BezierPatches, everything K1, K2 and K3 read
// about the patches: the row-major [P_pad, 64] patch table (the _ROW_* layout
// of cuda_sweep.py: control net, underlying plane, barycentric inverse,
// heights, derivative direction, divider planes, inflated bounding sphere),
// the [P_pad, 3] neighbour table (-1 on padding rows) and the [B, 12] block
// bounds (merged sphere and union AABB per block_p-patch block, radius -1 for
// an all-padding block).  It replaces no Pallas kernel: on the TPU these are
// the XLA functions of cbtr_tpu/ops/pallas_sweep.py (pack_patch_table,
// patch_spheres, _patch_boxes, _block_spheres_cr); in the port their plain
// versions (cuda_sweep.pack_patch_table, block_bounds and the neighbour fill)
// are about 90 small device ops a call, twice a train step, and took more host
// time than K1's own launches.
//
// What bounds it on the H100: the launch.  The work is elementwise: 60 floats
// read and 67 written per patch (128 KiB of table at P_pad = 512, 4 MiB at
// 16,256), ten square roots per patch and block_p per block.
//
// Layout: one CTA per 128 padded rows, a thread a row; then, after a
// barrier, a thread a block for the 128 / block_p blocks of those rows
// (P_pad is a multiple of 128 and block_p divides 128, so no block straddles
// two CTAs).  The per-patch centre, radius and box go from the first phase to
// the second through shared memory.
//
// Arithmetic: the plain versions' f32 expressions in their order, so that the
// tables are bit-equal to theirs (built without contraction, IEEE sqrt and
// division, see cuda_sweep.NVCC_FLAGS):
//   * centre = (cp_0 + cp_1 + ... + cp_9) / 10, summed left to right, a true
//     division;
//   * |v| = sqrt(x*x + y*y + z*z), summed left to right;
//   * radius = max_k |cp_k - centre| * 1.25 + 1e-5; the box is the control
//     net's, grown per axis by max(radius - max_k |cp_k - centre|, 0);
//   * block centre = the left-to-right sum of the real patches' centres (0
//     for a padding row) over their count (at least 1); block radius =
//     max over real patches of |c_p - c| + r_p; min and max are order-free.

#include "candidate.cuh"

namespace {

constexpr int ROWS_PER_CTA = 128;

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

// per-patch values the block phase reads, by row of the CTA
struct PatchBounds {
  float c[3][ROWS_PER_CTA];
  float r[ROWS_PER_CTA];
  float lo[3][ROWS_PER_CTA];
  float hi[3][ROWS_PER_CTA];
};

__global__ void __launch_bounds__(ROWS_PER_CTA)
tables_kernel(const float* __restrict__ control_points,  // [P, 10, 3]
              const float* __restrict__ underlying,      // [P, 4]
              const float* __restrict__ bary_inverse,    // [P, 3, 3]
              const float* __restrict__ heights,         // [P, 2]
              const float* __restrict__ deriv_b,         // [P, 3]
              const float* __restrict__ dividers,        // [P, 3, 4]
              const int* __restrict__ neighbours,        // [P, 3]
              float* __restrict__ patch_t,               // [P_pad, 64]
              float* __restrict__ bounds,                // [P_pad / block_p, 12]
              int* __restrict__ nb,                      // [P_pad, 3]
              int P, int block_p) {
  __shared__ PatchBounds s;
  const int tid = threadIdx.x;
  const int p = blockIdx.x * ROWS_PER_CTA + tid;

  // ---- a thread a row ----
  float row[N_ROWS];
#pragma unroll
  for (int i = 0; i < N_ROWS; ++i) row[i] = 0.0f;
  float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
  int nbr[3] = {-1, -1, -1};
  if (p < P) {
#pragma unroll
    for (int i = 0; i < 30; ++i) row[i] = __ldg(control_points + 30 * p + i);
#pragma unroll
    for (int i = 0; i < 4; ++i) row[ROW_PLANE + i] = __ldg(underlying + 4 * p + i);
#pragma unroll
    for (int i = 0; i < 9; ++i) row[ROW_BINV + i] = __ldg(bary_inverse + 9 * p + i);
#pragma unroll
    for (int i = 0; i < 2; ++i) row[ROW_H + i] = __ldg(heights + 2 * p + i);
#pragma unroll
    for (int i = 0; i < 3; ++i) row[ROW_DB + i] = __ldg(deriv_b + 3 * p + i);
#pragma unroll
    for (int i = 0; i < 12; ++i) row[ROW_DIV + i] = __ldg(dividers + 12 * p + i);
#pragma unroll
    for (int i = 0; i < 3; ++i) nbr[i] = __ldg(neighbours + 3 * p + i);

    float c[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      float sum = row[x];
#pragma unroll
      for (int k = 1; k < 10; ++k) sum = sum + row[3 * k + x];
      c[x] = sum / 10.0f;
    }
    float r_hull = norm3(row[0] - c[0], row[1] - c[1], row[2] - c[2]);
#pragma unroll
    for (int k = 1; k < 10; ++k)
      r_hull = tmax(r_hull, norm3(row[3 * k] - c[0], row[3 * k + 1] - c[1],
                                  row[3 * k + 2] - c[2]));
    // the constants go through double, as torch converts a Python scalar
    const float radius = r_hull * 1.25f + static_cast<float>(1e-5);
    const float slack = tmax(radius - r_hull, 0.0f);
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      float mn = row[x], mx = row[x];
#pragma unroll
      for (int k = 1; k < 10; ++k) {
        mn = tmin(mn, row[3 * k + x]);
        mx = tmax(mx, row[3 * k + x]);
      }
      lo[x] = mn - slack;
      hi[x] = mx + slack;
      row[ROW_BSPHERE + x] = c[x];
    }
    row[ROW_BSPHERE + 3] = radius;
  }
  float4* out = reinterpret_cast<float4*>(patch_t + static_cast<size_t>(p) * N_ROWS);
#pragma unroll
  for (int q = 0; q < N_ROWS / 4; ++q)
    out[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    nb[3 * static_cast<size_t>(p) + i] = nbr[i];
    s.c[i][tid] = row[ROW_BSPHERE + i];
    s.lo[i][tid] = lo[i];
    s.hi[i][tid] = hi[i];
  }
  s.r[tid] = row[ROW_BSPHERE + 3];
  __syncthreads();

  // ---- a thread a block ----
  if (tid >= ROWS_PER_CTA / block_p) return;
  const int first = tid * block_p;
  int count = 0;
  for (int j = 0; j < block_p; ++j) count += s.r[first + j] > 0.0f ? 1 : 0;
  const float denom = static_cast<float>(max(count, 1));
  float c[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    float sum = s.r[first] > 0.0f ? s.c[x][first] : 0.0f;
    for (int j = 1; j < block_p; ++j)
      sum = sum + (s.r[first + j] > 0.0f ? s.c[x][first + j] : 0.0f);
    c[x] = sum / denom;
  }
  const float inf = __int_as_float(0x7f800000);
  float radius = -1.0f;
  float blo[3] = {inf, inf, inf}, bhi[3] = {-inf, -inf, -inf};
  for (int j = 0; j < block_p; ++j) {
    const int i = first + j;
    if (!(s.r[i] > 0.0f)) continue;  // a padding row
    const float reach =
        norm3(s.c[0][i] - c[0], s.c[1][i] - c[1], s.c[2][i] - c[2]) + s.r[i];
    radius = tmax(radius, reach);
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      blo[x] = tmin(blo[x], s.lo[x][i]);
      bhi[x] = tmax(bhi[x], s.hi[x][i]);
    }
  }
  const int b = blockIdx.x * (ROWS_PER_CTA / block_p) + tid;
  float4* bout = reinterpret_cast<float4*>(bounds + static_cast<size_t>(b) * N_BOUNDS);
  bout[0] = make_float4(c[0], c[1], c[2], radius);
  bout[1] = make_float4(blo[0], blo[1], blo[2], bhi[0]);
  bout[2] = make_float4(bhi[1], bhi[2], 0.0f, 0.0f);
}

}  // namespace

extern "C" int cbtr_tables(const void* control_points, const void* underlying,
                           const void* bary_inverse, const void* heights,
                           const void* deriv_b, const void* dividers,
                           const void* neighbours, void* patch_t, void* bounds,
                           void* nb, int P, int P_pad, int block_p,
                           void* stream) {
  if (P_pad <= 0) return 0;
  if (P_pad % ROWS_PER_CTA != 0 || block_p <= 0 || ROWS_PER_CTA % block_p != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tables_kernel<<<P_pad / ROWS_PER_CTA, ROWS_PER_CTA, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(control_points),
      static_cast<const float*>(underlying),
      static_cast<const float*>(bary_inverse), static_cast<const float*>(heights),
      static_cast<const float*>(deriv_b), static_cast<const float*>(dividers),
      static_cast<const int*>(neighbours), static_cast<float*>(patch_t),
      static_cast<float*>(bounds), static_cast<int*>(nb), P, block_p);
  return static_cast<int>(cudaGetLastError());
}
