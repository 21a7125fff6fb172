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
// Arithmetic: csrc/candidate.cuh (shared with K2).

#include "candidate.cuh"

namespace {

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
