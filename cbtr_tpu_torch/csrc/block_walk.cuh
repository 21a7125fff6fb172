// The (128-ray tile x patch block) walk shared by K1 (sweep_select.cu), K2
// (winner.cu), both at blocks of 16 patches, and K3 (sweep_codes.cu) at 32
// (block_p is a run-time argument): each CTA culls the blocks for its own
// tile, then walks the listed blocks in ascending order with their rows
// double-buffered in shared memory.
//
// The cull replaces the host-side lists (cuda_sweep.tile_block_lists), which
// the TPU kernels took by scalar prefetch.  A block is listed for a tile when
// some ray of the tile hits its merged sphere and, with use_aabb, its union
// AABB, both from cuda_sweep.block_bounds.  block_hit evaluates the f32
// expressions of tile_block_lists in the same order (the sphere's rel, t_ca
// and rel2 left to right; the slab's d_safe at +-1e-30, one reciprocal per
// ray and axis, the NaN-propagating min/max of torch.minimum/maximum), so
// the tile's bitmap equals listed_blocks(tile_block_lists(...)) bit for bit
// (cuda_sweep.tile_bitmap_reference is the plain version).  Each warp ballots
// per block into its own word; the OR of the warps' words is the tile's
// bitmap (B bits: 128 bytes at B = 1016).  The test is about 40 flops a (ray,
// block) pair: 32 blocks a ray at P = 450, 1016 at P = 16,200, against about
// 27 kFLOP for every evaluated block.
//
// The staging: while block k's 16 rows are evaluated, block k+1's 4 KiB (K3:
// 32 rows, 8 KiB) are already in flight by cp.async (16 bytes a thread) into
// the other half of a double buffer.
//
// The split: a CTA runs SPLIT = 4 threads a ray (512 threads, one CTA and 16
// warps an SM at <= 128 registers), each on 4 of a block's 16 patches (K3: 8
// of 32).  A
// tile's listed blocks range from 0 to 17 of 32 at P = 450, and a tile's CTA
// runs them one after the other, so the tiles with the most blocks set the
// kernel's end; four threads a ray finish such a tile in a quarter of the
// time at the same warps an SM (K1 alone 1.74 -> 1.40 ms at 262,144 x 450,
// K2 4.31 -> 2.18 ms at split-6 256^2 against one thread a ray, PERF.md).
// The parts' winners are folded at the end (combine_parts); the fold is
// min distance, lowest id on ties, so the order does not matter.

#pragma once

#include "candidate.cuh"

namespace {

constexpr int BOUNDS_CHUNK = 128;   // blocks whose bounds are staged at once
// threads per ray: thread t works for ray t % TILE_R on the patches j of
// each block with j % SPLIT == t / TILE_R, and culls the blocks b with
// b % SPLIT == t / TILE_R
constexpr int SPLIT = 4;
constexpr int THREADS = TILE_R * SPLIT;
constexpr int N_WARPS = THREADS / 32;

// one slab reciprocal of a ray direction (cuda_sweep._ray_aabb_hit): a zero
// component becomes +-1e-30 so the slab arithmetic stays finite
__device__ __forceinline__ float slab_inv(float d) {
  const float tiny = static_cast<float>(1e-30);
  const float d_safe = fabsf(d) < tiny ? (d < 0.0f ? -tiny : tiny) : d;
  return 1.0f / d_safe;
}

struct SlabRay {
  float ix, iy, iz;
};

// is block `b` (its block_bounds row) listed by this ray?
__device__ __forceinline__ bool block_hit(const float* b, const Ray& r,
                                          const SlabRay& inv, bool use_aabb) {
  const float relx = b[0] - r.sx, rely = b[1] - r.sy, relz = b[2] - r.sz;
  const float t_ca = relx * r.dx + rely * r.dy + relz * r.dz;
  const float rel2 = relx * relx + rely * rely + relz * relz;
  const float r2 = b[3] * b[3];
  bool hit = ((rel2 - t_ca * t_ca) <= r2) && ((t_ca >= 0.0f) || (rel2 <= r2)) &&
             (b[3] >= 0.0f);  // all-padding blocks carry radius -1
  if (use_aabb) {
    const float t1x = (b[4] - r.sx) * inv.ix, t2x = (b[7] - r.sx) * inv.ix;
    const float t1y = (b[5] - r.sy) * inv.iy, t2y = (b[8] - r.sy) * inv.iy;
    const float t1z = (b[6] - r.sz) * inv.iz, t2z = (b[9] - r.sz) * inv.iz;
    const float t_near = tmax(tmax(tmin(t1x, t2x), tmin(t1y, t2y)), tmin(t1z, t2z));
    const float t_far = tmin(tmin(tmax(t1x, t2x), tmax(t1y, t2y)), tmax(t1z, t2z));
    hit = hit && (t_far >= 0.0f) && (t_near <= t_far);
  }
  return hit;
}

// The tile's listed blocks into tile_bits [WB] (bit b of word b/32), WB =
// ceil(B/32); returns their count.  sbounds holds BOUNDS_CHUNK rows of
// bounds, warp_bits [N_WARPS][WB].  Every thread of the CTA calls it; it
// ends with the bitmap visible to all.
__device__ int cull_tile(const float* __restrict__ bounds, int B, bool use_aabb,
                         const Ray& r, float* sbounds, unsigned* warp_bits,
                         unsigned* tile_bits) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = tid / TILE_R;
  const int WB = (B + 31) / 32;
  const SlabRay inv = {slab_inv(r.dx), slab_inv(r.dy), slab_inv(r.dz)};
  for (int c0 = 0; c0 < B; c0 += BOUNDS_CHUNK) {
    const int n = min(BOUNDS_CHUNK, B - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < n * N_BOUNDS; i += THREADS)
      sbounds[i] = bounds[static_cast<size_t>(c0) * N_BOUNDS + i];
    __syncthreads();
    for (int j = 0; j < n; j += 32) {
      const int m = min(32, n - j);
      unsigned word = 0u;
      // this warp's blocks of the 32: every SPLIT-th (chunks start at
      // multiples of 32, so i's residue is the block's)
      for (int i = part; i < m; i += SPLIT) {
        const bool hit = block_hit(sbounds + (j + i) * N_BOUNDS, r, inv, use_aabb);
        word |= (__any_sync(0xffffffffu, hit) ? 1u : 0u) << i;
      }
      if (lane == 0) warp_bits[warp * WB + (c0 + j) / 32] = word;
    }
  }
  __syncthreads();
  for (int w = tid; w < WB; w += THREADS) {
    unsigned word = 0u;
#pragma unroll
    for (int k = 0; k < N_WARPS; ++k) word |= warp_bits[k * WB + w];
    tile_bits[w] = word;
  }
  __syncthreads();
  int count = 0;
  for (int w = 0; w < WB; ++w) count += __popc(tile_bits[w]);
  return count;
}

// the lowest listed block >= from, or -1
__device__ __forceinline__ int next_block(const unsigned* bits, int WB, int from) {
  for (int w = from >> 5; w < WB; ++w) {
    unsigned word = bits[w];
    if (w == (from >> 5)) word &= ~0u << (from & 31);
    if (word) return (w << 5) + __ffs(word) - 1;
  }
  return -1;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest one has landed (in this thread's view)
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// start copying n_floats (a multiple of 4) from src to dst
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int n_floats) {
  for (int i = threadIdx.x * 4; i < n_floats; i += THREADS * 4)
    cp_async16(dst + i, src + i);
}

// fold the other parts' (best, best_id) of each ray into part 0's, through
// `scratch` (SPLIT - 1) * TILE_R * 8 bytes of shared memory no thread reads
// any more; every thread calls it
__device__ __forceinline__ void combine_parts(float& best, int& best_id, void* scratch) {
  float* d = static_cast<float*>(scratch);
  int* id = reinterpret_cast<int*>(d + (SPLIT - 1) * TILE_R);
  const int ray = threadIdx.x % TILE_R, part = threadIdx.x / TILE_R;
  if (part > 0) {
    d[(part - 1) * TILE_R + ray] = best;
    id[(part - 1) * TILE_R + ray] = best_id;
  }
  __syncthreads();
  if (part == 0) {
    for (int k = 0; k < SPLIT - 1; ++k) fold(d[k * TILE_R + ray], id[k * TILE_R + ray], best, best_id);
  }
}

// shared bytes of the walk: two staged blocks, a chunk of bounds, the warps'
// and the tile's bitmaps
__host__ __device__ inline size_t walk_smem_bytes(int block_p, int B) {
  const int WB = (B + 31) / 32;
  return sizeof(float) * (2 * block_p * N_ROWS + BOUNDS_CHUNK * N_BOUNDS) +
         sizeof(unsigned) * (N_WARPS + 1) * WB;
}

}  // namespace
