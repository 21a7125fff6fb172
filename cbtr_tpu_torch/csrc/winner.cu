// Per-ray winner for any patch count on Hopper (sm_90a): kernel K2 of the
// port.
//
// Replaces the TPU kernel cbtr_tpu/ops/pallas_sweep.py::_winner_kernel
// (launched by _winner_call, public sweep_winner_pallas), which the JAX
// package runs for every lens above _FUSED_MAX_P = 1024 patches.  For every
// ray it returns the winner of the reference's scan with one forward retry
// (reference/bezierMesh.cpp:206-227): the minimum-distance accepted
// candidate, lowest patch id on ties, or a miss.
//
// Candidate set (the TPU kernel's, pallas_sweep.py:1017-1103):
//   * blocks, cull and gate are K1's: the tile's listed 16-patch blocks, a
//     block evaluated whole when any (patch, ray) pair of block x tile
//     passes the per-patch sphere test;
//   * direct: patch p of an evaluated block with gate-ON cIntersect;
//   * retry: voter p of an evaluated block whose gate-ON result is
//     cFollowSide_s contributes q = neighbours[p, s] (clipped to [0, P) on
//     the host) when q's gate-OFF result is cIntersect AND the ray hits q's
//     own inflated sphere -- whether q's block was listed or gated for the
//     tile does not matter.  K1's rule differs (it accepts a voted q only
//     where q's block was evaluated).
//
// What bounds it on the H100: f32 arithmetic outside the tensor cores, as
// for K1 (about 1.7 kFLOP per evaluated pair against a 256-byte row that
// the tile's 128 rays share).  The design differs from K1's because P is
// unbounded: K1 keeps a P_pad-bit voted bitmap per ray (2 KiB per ray, 256
// KiB per block at P_pad 16,384: more than a block may use), so K2 keeps no
// per-ray state of size P and resolves each retry at the voter, at once:
//   * one CUDA block per 128-ray tile, four threads per ray (each on every
//     fourth patch of a block, block_walk.cuh), a running (best distance,
//     best id) in registers, the four folded at the end;
//   * each CTA culls the blocks for its own tile from the [B, 12] block
//     bounds (block_walk.cuh; B = 1016 at P = 16,200, its bitmap 128 bytes),
//     where the host built [B, T] lists before;
//   * the listed blocks' 16 rows (4 KiB) are double-buffered into shared
//     memory by cp.async, gated with __syncthreads_or and evaluated through
//     the inlined candidate_code<SharedRow>;
//   * a voting thread evaluates its q's row straight from device memory (the
//     whole [P_pad, 64] table is L2-resident: 4.2 MB at P = 16,200) through
//     candidate_code<GlobalRow>, so the retry's distance is bit-identical to
//     q's own sweep result.
// Voting threads diverge from the rest of their warp for one candidate;
// votes are rare (rays that cross a patch border).
//
// Kept as they are, on purpose, for K1's reasons (sweep_select.cu): the
// build without contraction and with IEEE sqrt/division (bit-equality with
// the twin is the check), no tensor cores, the tile and the block.
//
// MODE (a template parameter; the entry point dispatches, every other value
// is refused) is the sweep's arithmetic (candidate.cuh SweepMath: exact,
// config.fast_newton, config.bf16_sweep, both).  Mode 0 is the default
// build, op for op.
//
// Arithmetic: csrc/candidate.cuh (shared with K1 and K3).

#include "block_walk.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
winner_kernel(const float* __restrict__ rays, const float* __restrict__ patch_t,
              const float* __restrict__ bounds, const int* __restrict__ nb,
              float* __restrict__ dist_out, int* __restrict__ idx_out,
              int* __restrict__ counts_out, int* __restrict__ lists_out,
              int* __restrict__ pairs_out, int T, int P, int P_pad, int block_p,
              int use_aabb, Params prm) {
  using M = SweepMath<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = P_pad / block_p;
  const int WB = (B + 31) / 32;
  const int rows = block_p * N_ROWS;
  float* stage = reinterpret_cast<float*>(smem);   // [2][rows]
  float* sbounds = stage + 2 * rows;
  unsigned* warp_bits = reinterpret_cast<unsigned*>(sbounds + BOUNDS_CHUNK * N_BOUNDS);
  unsigned* tile_bits = warp_bits + N_WARPS * WB;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_ray = tid % TILE_R, part = tid / TILE_R;
  const int R_pad = T * TILE_R;
  const int ray = tile * TILE_R + lane_ray;
  const Ray r = {rays[ray], rays[R_pad + ray], rays[2 * R_pad + ray],
                 rays[3 * R_pad + ray], rays[4 * R_pad + ray],
                 rays[5 * R_pad + ray]};

  const int n_listed = cull_tile(bounds, B, use_aabb != 0, r, sbounds, warp_bits,
                                 tile_bits);
  if (tid == 0) counts_out[tile] = n_listed;

  float best = BIG_F;
  int best_id = 0;
  int pass1_patches = 0, retries = 0;

  int blk = next_block(tile_bits, WB, 0);
  if (blk >= 0) stage_rows(stage, patch_t + static_cast<size_t>(blk) * rows, rows);
  cp_async_commit();
  for (int k = 0, buf = 0; blk >= 0; ++k, buf ^= 1) {
    const int nxt = next_block(tile_bits, WB, blk + 1);
    // the other buffer was last read before the previous iteration's barrier
    if (nxt >= 0)
      stage_rows(stage + (buf ^ 1) * rows, patch_t + static_cast<size_t>(nxt) * rows,
                 rows);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();  // block k's rows have landed for every thread
    if (lists_out != nullptr && tid == 0) lists_out[static_cast<size_t>(k) * T + tile] = blk;
    const float* cur = stage + buf * rows;

    int any_hit = 0;
    for (int j = part; j < block_p; j += SPLIT)
      any_hit |= patch_sphere_hit(SharedRow{cur + j * N_ROWS}, r);
    if (__syncthreads_or(any_hit)) {
      if (tid == 0) pass1_patches += min(block_p, P - blk * block_p);
      for (int j = part; j < block_p; j += SPLIT) {
        const int p = blk * block_p + j;
        if (p >= P) break;  // all-zero padding rows give no candidate
        float d;
        const int code = candidate_code<M>(SharedRow{cur + j * N_ROWS}, r, prm, &d);
        const int what_on = (code >> 3) ? (code & 7) : WHAT_NONE;
        if (what_on == WHAT_INTERSECT) {
          fold(d, p, best, best_id);
        } else if (what_on < WHAT_NONE) {
          // retry at the voter: q's gate-OFF candidate, gated by q's sphere
          const int q = nb[3 * p + what_on];
          const GlobalRow row_q{patch_t + static_cast<size_t>(q) * N_ROWS};
          if (patch_sphere_hit(row_q, r)) {
            float d2;
            const int code2 = candidate_code<M>(row_q, r, prm, &d2);
            ++retries;
            if ((code2 & 7) == WHAT_INTERSECT) fold(d2, q, best, best_id);
          }
        }
      }
      __syncthreads();  // `cur` is no longer read: the next prefetch reuses it
    }
    blk = nxt;
  }

  combine_parts(best, best_id, stage);
  if (part == 0) {
    dist_out[ray] = best;
    idx_out[ray] = best_id;
  }
  if (pairs_out != nullptr) {
    // [T, 2]: pass-1 pairs of the tile, retries (the wrapper zeroes both)
    if (tid == 0) pairs_out[2 * tile] = pass1_patches * TILE_R;
    for (int off = 16; off > 0; off >>= 1) retries += __shfl_down_sync(0xffffffffu, retries, off);
    if ((tid & 31) == 0 && retries) atomicAdd(pairs_out + 2 * tile + 1, retries);
  }
}

}  // namespace

namespace {
// the instantiation of a mode, or nullptr for a mode out of range
using Kernel = decltype(&winner_kernel<0>);
Kernel kernel_of(int mode) {
  static const Kernel kernels[N_MODES] = {winner_kernel<0>, winner_kernel<1>,
                                          winner_kernel<2>, winner_kernel<3>};
  return mode >= 0 && mode < N_MODES ? kernels[mode] : nullptr;
}
}  // namespace

// CTAs of K2's instantiation `mode` an SM holds at this table size
// (registers and shared memory)
extern "C" int cbtr_winner_occupancy(int P_pad, int block_p, int mode) {
  const Kernel kernel = kernel_of(mode);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel, THREADS, walk_smem_bytes(block_p, P_pad / block_p));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// mode: the sweep's arithmetic (SweepMath); any other value is refused
// (cudaErrorInvalidValue)
extern "C" int cbtr_winner(const void* rays, const void* patch_t,
                           const void* bounds, const void* nb, void* dist_out,
                           void* idx_out, void* counts_out, void* lists_out,
                           void* pairs_out, int T, int P, int P_pad, int block_p,
                           int use_aabb, int iters, float ray_plane_eps,
                           float estimation_eps, float max_ray_dist,
                           float minimal_ray_distance, int clamp_secant, int mode,
                           void* stream) {
  const Kernel kernel = kernel_of(mode);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return 0;
  const Params prm = {ray_plane_eps, estimation_eps, max_ray_dist,
                      minimal_ray_distance, iters, clamp_secant};
  const size_t smem = walk_smem_bytes(block_p, P_pad / block_p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<T, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(patch_t),
      static_cast<const float*>(bounds), static_cast<const int*>(nb),
      static_cast<float*>(dist_out), static_cast<int*>(idx_out),
      static_cast<int*>(counts_out), static_cast<int*>(lists_out),
      static_cast<int*>(pairs_out), T, P, P_pad, block_p, use_aabb, prm);
  return static_cast<int>(cudaGetLastError());
}
