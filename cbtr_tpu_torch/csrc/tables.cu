// The sweep kernels' tables for Hopper (sm_90a): the table kernel and the
// ray-pack kernel of the port.
//
// tables_kernel builds, from the leaves of a BezierPatches, everything K1, K2
// and K3 read about the patches: the row-major [P_pad, 64] patch table (the
// _ROW_* layout of cuda_sweep.py: control net, underlying plane, barycentric
// inverse, heights, derivative direction, divider planes, inflated bounding
// sphere), the [P_pad, 3] neighbour table (-1 on padding rows, or every id
// clamped to [0, P) for K2), the [B, 12] block bounds (merged sphere and
// union AABB per block_p-patch block, radius -1 for an all-padding block) and
// the [P_pad, 8] per-patch boxes K1's per-pair test reads (lo xyz, hi xyz,
// two zeros; zero on padding rows), all four in one caller-given workspace
// at the byte offsets of its plan (cuda_tables._workspace_plan).  pack_rays_kernel writes the [8, R_pad] ray
// table K1-K3 read from [R, 3] starts and directions.  Neither replaces a
// Pallas kernel: on the TPU these are the XLA functions of
// cbtr_tpu/ops/pallas_sweep.py (pack_patch_table, patch_spheres,
// _patch_boxes, _block_spheres_cr) and the `rays.T` of its callers, fused by
// the compiler into the jitted step; in the port their plain versions
// (cuda_sweep.pack_patch_table, block_bounds, patch_box_table, the neighbour
// fill, pad_rays)
// are about 90 small device ops a table build and 5 a ray table.
//
// What bounds them on the H100: the launch.  The work is elementwise: 63
// words read and 75 written per patch (128 KiB of table at P_pad = 512, 4 MiB
// at 16,256), ten square roots per patch and block_p per block; 24 bytes read
// and 32 written per ray (14.7 MB at 262,144 rays: 4.4 us at 3.35 TB/s).  So
// the design is about the launches around them: the tables are built once a
// lens a trace (optics/lens.py) into one allocation, and a chunk's rays are
// packed by one launch.  Inside the table kernel the 256-byte rows go out
// through shared memory: each thread builds its row in registers and stores
// it to a padded shared tile, then the CTA writes its 128 rows as one
// contiguous 32 KiB run of float4s, consecutive threads on consecutive
// addresses (a warp storing one float4 of each of its 32 rows would touch 32
// lines 256 bytes apart).
//
// Layout: one CTA per 128 padded rows, a thread a row; then, after a
// barrier, the row store by the whole CTA and a thread a block for the
// 128 / block_p blocks of those rows (P_pad is a multiple of 128 and block_p
// divides 128, so no block straddles two CTAs).  The per-patch centre,
// radius and box go from the first phase to the block phase through shared
// memory.  pack_rays_kernel: a thread a ray, each of the 8 rows stored by
// the warp as 128 contiguous bytes.
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
// The ray table copies values: bit-equal to pad_rays by construction.

#include "candidate.cuh"

namespace {

constexpr int ROWS_PER_CTA = 128;
// a shared row's stride in floats: 16-byte aligned, and 8 threads storing a
// float4 each at one column land on 8 distinct 4-bank groups
constexpr int ROW_STRIDE = N_ROWS + 4;
constexpr int RAYS_PER_CTA = 256;

// the plan's fields (cuda_tables.PLAN_FIELDS, in order): the padded rows,
// the byte offsets of the four tables in the workspace, its least size
enum Field { P_PAD = 0, PATCH_T, BOUNDS, NB, BOXES, NBYTES, N_FIELDS };
constexpr int N_BOX = 8;  // cuda_sweep.patch_box_table's columns

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

// the CTA's rows, then the per-patch values the block phase reads
struct TablesShared {
  float rows[ROWS_PER_CTA * ROW_STRIDE];
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
              float* __restrict__ boxes,                 // [P_pad, 8]
              int P, int block_p, int clamp) {
  __shared__ __align__(16) TablesShared s;
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
  // K2 reads neighbour rows by id: every id, padding rows' too, clamped to
  // [0, P) as `Tensor.clamp(0, P - 1)` does
  if (clamp) {
#pragma unroll
    for (int i = 0; i < 3; ++i) nbr[i] = min(max(nbr[i], 0), P - 1);
  }
  float4* mine = reinterpret_cast<float4*>(s.rows + tid * ROW_STRIDE);
#pragma unroll
  for (int q = 0; q < N_ROWS / 4; ++q)
    mine[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    nb[3 * static_cast<size_t>(p) + i] = nbr[i];
    s.c[i][tid] = row[ROW_BSPHERE + i];
    s.lo[i][tid] = lo[i];
    s.hi[i][tid] = hi[i];
  }
  s.r[tid] = row[ROW_BSPHERE + 3];
  float4* box = reinterpret_cast<float4*>(boxes + static_cast<size_t>(p) * N_BOX);
  box[0] = make_float4(lo[0], lo[1], lo[2], hi[0]);
  box[1] = make_float4(hi[1], hi[2], 0.0f, 0.0f);
  __syncthreads();

  // ---- the CTA's rows, one contiguous run of float4s ----
  constexpr int QUADS = N_ROWS / 4;
  float4* out = reinterpret_cast<float4*>(
      patch_t + static_cast<size_t>(blockIdx.x) * ROWS_PER_CTA * N_ROWS);
#pragma unroll
  for (int j = 0; j < QUADS; ++j) {
    const int f = j * ROWS_PER_CTA + tid;
    out[f] = reinterpret_cast<const float4*>(s.rows + (f / QUADS) * ROW_STRIDE)[f % QUADS];
  }

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

__global__ void __launch_bounds__(RAYS_PER_CTA)
pack_rays_kernel(const float* __restrict__ start,      // [R, 3]
                 const float* __restrict__ direction,  // [R, 3]
                 float* __restrict__ rays_t,           // [8, R_pad]
                 int R, int R_pad) {
  const int r = blockIdx.x * RAYS_PER_CTA + threadIdx.x;
  if (r >= R_pad) return;
  // a padding ray: s = 0, d = (1, 0, 0); rows 6 and 7 are zero
  float v[6] = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  if (r < R) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = __ldg(start + 3 * static_cast<size_t>(r) + k);
      v[3 + k] = __ldg(direction + 3 * static_cast<size_t>(r) + k);
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) rays_t[static_cast<size_t>(k) * R_pad + r] = v[k];
  rays_t[6 * static_cast<size_t>(R_pad) + r] = 0.0f;
  rays_t[7 * static_cast<size_t>(R_pad) + r] = 0.0f;
}

}  // namespace

// One build of the tables into `workspace` (workspace_bytes long) at the
// offsets of `plan` (N_FIELDS values, cuda_tables._workspace_plan).
extern "C" int cbtr_tables(const void* control_points, const void* underlying,
                           const void* bary_inverse, const void* heights,
                           const void* deriv_b, const void* dividers,
                           const void* neighbours, void* workspace,
                           long long workspace_bytes, const long long* plan, int P,
                           int block_p, int clamp, void* stream) {
  const long long P_pad = plan[P_PAD];
  if (P <= 0 || P_pad < P || P_pad % ROWS_PER_CTA != 0 || block_p <= 0 ||
      ROWS_PER_CTA % block_p != 0 || plan[NBYTES] > workspace_bytes ||
      reinterpret_cast<unsigned long long>(workspace) % 16 != 0 || plan[PATCH_T] % 16 != 0 || plan[BOUNDS] % 16 != 0 || plan[NB] % 4 != 0 ||
      plan[BOXES] % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(workspace);
  tables_kernel<<<static_cast<int>(P_pad / ROWS_PER_CTA), ROWS_PER_CTA, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(control_points),
      static_cast<const float*>(underlying),
      static_cast<const float*>(bary_inverse), static_cast<const float*>(heights),
      static_cast<const float*>(deriv_b), static_cast<const float*>(dividers),
      static_cast<const int*>(neighbours),
      reinterpret_cast<float*>(base + plan[PATCH_T]),
      reinterpret_cast<float*>(base + plan[BOUNDS]),
      reinterpret_cast<int*>(base + plan[NB]), reinterpret_cast<float*>(base + plan[BOXES]),
      P, block_p, clamp);
  return static_cast<int>(cudaGetLastError());
}

// One [8, R_pad] ray table from [R, 3] starts and directions.
extern "C" int cbtr_pack_rays(const void* start, const void* direction, void* rays_t, int R,
                              int R_pad, void* stream) {
  if (R < 0 || R_pad < R || R_pad % TILE_R != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R_pad == 0) return 0;
  pack_rays_kernel<<<(R_pad + RAYS_PER_CTA - 1) / RAYS_PER_CTA, RAYS_PER_CTA, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(start), static_cast<const float*>(direction),
      static_cast<float*>(rays_t), R, R_pad);
  return static_cast<int>(cudaGetLastError());
}
