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
// on evaluating fewer pairs, on issuing few instructions that are not
// arithmetic, and on moving no per-pair state:
//   * the (128-ray tile x 16-patch block) cull of the reference is kept, and
//     each CTA computes it for its own tile from the [B, 12] block bounds
//     (block_walk.cuh): no host-side lists;
//   * a listed block is skipped unless some (patch, ray) pair passes the
//     per-patch sphere test (__syncthreads_or);
//   * the padded patch table ([P_pad, 64] f32, 128 KiB at P_pad = 512) stays
//     L2-resident; the listed blocks (4 KiB each) are double-buffered into
//     shared memory by cp.async, the next one in flight while the current
//     one is evaluated, and read by the tile's threads as broadcasts through
//     the inlined candidate_code<SharedRow>;
//   * four threads a ray (block_walk.cuh), so that the tiles with the most
//     listed blocks, which set the kernel's end, finish in a quarter of the
//     time;
//   * nothing per pair goes to device memory: 8 bytes per ray come out, plus
//     the tile's listed count (and, for checks only, its list and its pairs).
//
// Kept as they are, on purpose:
//   * -fmad=false with IEEE sqrt and division: every multiply-add issues as
//     two instructions, but the kernel is then bit-equal to its plain twin,
//     which is how every change to it is checked (a build with contraction
//     ran some 16 % faster and changed the winner of 0.15 % of the hit rays
//     at 262,144 x 450, 0.6 % at x 1800: PERF.md);
//   * no tensor cores: the work per pair is a 10-term cubic of width 3 in a
//     data-dependent Newton loop, not a matrix product;
//   * the 128-ray tile and the 16-patch block: they define the candidate set.
//
// Modes (template parameters; the entry point dispatches, every other value
// is refused): MODE, the sweep's arithmetic (candidate.cuh SweepMath: exact,
// config.fast_newton, config.bf16_sweep, both), and HALF, the JAX kernel's
// half_gate: each half of a listed block (block_p / 2 patches) passes its own
// sphere gate, and ok_bits marks halves, so a voted neighbour is retried only
// where its half was evaluated (an ungated half leaves its pairs WHAT_NONE in
// the JAX kernel's code scratch).  All off is the default build, op for op.
//
// Layout: one CUDA block per 128-ray tile, SPLIT = 4 threads per ray, each
// on every fourth patch of a block (block_walk.cuh).  The TPU
// kernel keeps per-pair (code, dist) scratch and resolves the follow-side
// retry with a one-hot vote matmul; [P_pad x 128] scratch does not fit
// shared memory, so this kernel computes the same candidate set in two
// passes instead:
//   pass 1  over the listed and gated blocks, each thread folds in its direct
//           hits (gate-ON cIntersect) and records in a per-ray bitmap the
//           patches q = neighbours[p, s] that a gate-ON cFollowSide_s result
//           of patch p votes for; the block marks which candidate blocks it
//           evaluated;
//   pass 2  each thread re-evaluates the gate-OFF candidate of every voted q
//           (q % SPLIT its part) whose block was evaluated (few: rays that
//           cross a patch border)
//           from q's row in device memory (candidate_code<GlobalRow>) and
//           folds it in if it is cIntersect.  That is the reference's
//           "voted AND its own gate-OFF result hits".
// Both passes inline the same candidate_code on the same row values, so a
// retry candidate's distance is bit-identical to the one pass 1 would have
// seen.
//
// Arithmetic: csrc/candidate.cuh (shared with K2 and K3).

#include "block_walk.cuh"

namespace {

// shared memory: the walk's buffers (block_walk.cuh) | ok_bits [WU] u32 (one
// bit an evaluated block, or half with HALF) | voted [P_pad / 32][TILE_R] u32
// (word-major: thread-consecutive words, no bank conflicts)
template <int MODE, bool HALF>
__global__ void __launch_bounds__(THREADS, 1)
sweep_select_kernel(const float* __restrict__ rays,
                    const float* __restrict__ patch_t,
                    const float* __restrict__ bounds,
                    const int* __restrict__ nb, float* __restrict__ dist_out,
                    int* __restrict__ idx_out, int* __restrict__ counts_out,
                    int* __restrict__ lists_out, int* __restrict__ pairs_out,
                    int T, int P, int P_pad, int block_p, int use_aabb,
                    Params prm) {
  using M = SweepMath<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = P_pad / block_p;
  const int WB = (B + 31) / 32;
  // the gate's unit: a block, or half of one
  const int unit = HALF ? block_p / 2 : block_p;
  const int WU = (P_pad / unit + 31) / 32;
  const int W = P_pad / 32;
  const int rows = block_p * N_ROWS;
  float* stage = reinterpret_cast<float*>(smem);   // [2][rows]
  float* sbounds = stage + 2 * rows;
  unsigned* warp_bits = reinterpret_cast<unsigned*>(sbounds + BOUNDS_CHUNK * N_BOUNDS);
  unsigned* tile_bits = warp_bits + N_WARPS * WB;
  unsigned* ok_bits = tile_bits + WB;              // evaluated units
  unsigned* voted = ok_bits + WU;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_ray = tid % TILE_R, part = tid / TILE_R;
  const int R_pad = T * TILE_R;
  const int ray = tile * TILE_R + lane_ray;
  const Ray r = {rays[ray], rays[R_pad + ray], rays[2 * R_pad + ray],
                 rays[3 * R_pad + ray], rays[4 * R_pad + ray],
                 rays[5 * R_pad + ray]};

  for (int i = tid; i < WU; i += THREADS) ok_bits[i] = 0u;
  for (int i = tid; i < W * TILE_R; i += THREADS) voted[i] = 0u;

  const int n_listed = cull_tile(bounds, B, use_aabb != 0, r, sbounds, warp_bits,
                                 tile_bits);
  if (tid == 0) counts_out[tile] = n_listed;

  float best = BIG_F;
  int best_id = 0;
  int pass1_patches = 0, retries = 0;

  // ---- pass 1: listed blocks, sphere-gated per (tile x block) ----
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

    // patches [u0, u0 + n) of the block behind one sphere gate: unit ub of
    // ok_bits, `real` of them not padding
    auto gate_and_evaluate = [&](int u0, int n, int ub, int real) {
      int any_hit = 0;
      for (int j = u0 + part; j < u0 + n; j += SPLIT)
        any_hit |= patch_sphere_hit(SharedRow{cur + j * N_ROWS}, r);
      if (__syncthreads_or(any_hit)) {
        if (tid == 0) {
          ok_bits[ub >> 5] |= 1u << (ub & 31);
          pass1_patches += real;
        }
        for (int j = u0 + part; j < u0 + n; j += SPLIT) {
          const int p = blk * block_p + j;
          if (p >= P) break;  // all-zero padding rows give no candidate
          float d;
          const int code = candidate_code<M>(SharedRow{cur + j * N_ROWS}, r, prm, &d);
          const int what_on = (code >> 3) ? (code & 7) : WHAT_NONE;
          if (what_on == WHAT_INTERSECT) {
            fold(d, p, best, best_id);
          } else if (what_on < WHAT_NONE) {
            const int q = nb[3 * p + what_on];
            // the ray's other parts vote into the same word
            if (q >= 0) atomicOr(voted + (q >> 5) * TILE_R + lane_ray, 1u << (q & 31));
          }
        }
        __syncthreads();  // `cur` is no longer read: the next prefetch reuses it
      }
    };
    if constexpr (HALF) {
      for (int h = 0; h < 2; ++h)
        gate_and_evaluate(h * unit, unit, 2 * blk + h,
                          max(0, min(unit, P - blk * block_p - h * unit)));
    } else {
      gate_and_evaluate(0, block_p, blk, min(block_p, P - blk * block_p));
    }
    blk = nxt;
  }
  __syncthreads();  // ok_bits complete

  // ---- pass 2: voted neighbours, gate OFF, only where evaluated ----
  for (int w = 0; w < W; ++w) {
    unsigned bits = voted[w * TILE_R + lane_ray];
    while (bits) {
      const int q = w * 32 + (__ffs(bits) - 1);
      bits &= bits - 1u;
      const int qb = q / unit;
      if (q % SPLIT != part) continue;  // another part of the ray retries q
      if (q >= P || !((ok_bits[qb >> 5] >> (qb & 31)) & 1u)) continue;
      float d;
      const int code = candidate_code<M>(
          GlobalRow{patch_t + static_cast<size_t>(q) * N_ROWS}, r, prm, &d);
      ++retries;
      if ((code & 7) == WHAT_INTERSECT) fold(d, q, best, best_id);
    }
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
size_t smem_bytes(int P_pad, int block_p, bool half) {
  const int B = P_pad / block_p;
  const int units = half ? 2 * B : B;
  return walk_smem_bytes(block_p, B) + sizeof(unsigned) * ((units + 31) / 32) +
         sizeof(unsigned) * (P_pad / 32) * TILE_R;
}

// the instantiation of (mode, half_gate), or nullptr for a mode out of range
using Kernel = decltype(&sweep_select_kernel<0, false>);
Kernel kernel_of(int mode, int half_gate) {
  static const Kernel kernels[2][N_MODES] = {
      {sweep_select_kernel<0, false>, sweep_select_kernel<1, false>,
       sweep_select_kernel<2, false>, sweep_select_kernel<3, false>},
      {sweep_select_kernel<0, true>, sweep_select_kernel<1, true>,
       sweep_select_kernel<2, true>, sweep_select_kernel<3, true>}};
  if (mode < 0 || mode >= N_MODES || (half_gate != 0 && half_gate != 1)) return nullptr;
  return kernels[half_gate][mode];
}
}  // namespace

// CTAs of K1's instantiation (mode, half_gate) an SM holds at this table
// size (registers and shared memory)
extern "C" int cbtr_sweep_select_occupancy(int P_pad, int block_p, int mode,
                                           int half_gate) {
  const Kernel kernel = kernel_of(mode, half_gate);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel, THREADS, smem_bytes(P_pad, block_p, half_gate != 0));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// mode: the sweep's arithmetic (SweepMath); half_gate: 0 or 1, at an even
// block_p; any other value is refused (cudaErrorInvalidValue)
extern "C" int cbtr_sweep_select(const void* rays, const void* patch_t,
                                 const void* bounds, const void* nb,
                                 void* dist_out, void* idx_out, void* counts_out,
                                 void* lists_out, void* pairs_out, int T, int P,
                                 int P_pad, int block_p, int use_aabb, int iters,
                                 float ray_plane_eps, float estimation_eps,
                                 float max_ray_dist, float minimal_ray_distance,
                                 int clamp_secant, int mode, int half_gate,
                                 void* stream) {
  const Kernel kernel = kernel_of(mode, half_gate);
  if (kernel == nullptr || (half_gate && block_p % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return 0;
  const Params prm = {ray_plane_eps, estimation_eps, max_ray_dist,
                      minimal_ray_distance, iters, clamp_secant};
  const size_t smem = smem_bytes(P_pad, block_p, half_gate != 0);
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
