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
//   * blocks, lists and gate are K1's: the tile's listed 16-patch blocks, a
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
//   * one CUDA block per 128-ray tile, one thread per ray, a running
//     (best distance, best id) in registers;
//   * each listed block's 16 rows (4 KiB) are staged into shared memory and
//     gated with __syncthreads_or;
//   * a voting thread evaluates its q's row straight from global memory
//     (the whole [P_pad, 64] table is L2-resident: 4.2 MB at P = 16,200)
//     through the same __noinline__ eval_candidate, so the retry's distance
//     is bit-identical to q's own sweep result;
//   * there is no patch chunking: the lists for every block sit in device
//     memory.
// Voting threads diverge from the rest of their warp for one candidate;
// votes are rare (rays that cross a patch border).
//
// Arithmetic: csrc/candidate.cuh (shared with K1).

#include "candidate.cuh"

namespace {

__global__ void __launch_bounds__(TILE_R)
winner_kernel(const int* __restrict__ counts, const int* __restrict__ lists,
              const float* __restrict__ rays, const float* __restrict__ patch_t,
              const int* __restrict__ nb, float* __restrict__ dist_out,
              int* __restrict__ idx_out, int T, int P, int block_p, Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int R_pad = T * TILE_R;
  const int ray = tile * TILE_R + tid;
  const Ray r = {rays[ray], rays[R_pad + ray], rays[2 * R_pad + ray],
                 rays[3 * R_pad + ray], rays[4 * R_pad + ray],
                 rays[5 * R_pad + ray]};

  float best = BIG_F;
  int best_id = 0;

  const int n_blocks = counts[tile];
  for (int k = 0; k < n_blocks; ++k) {
    const int blk = lists[static_cast<size_t>(k) * T + tile];
    __syncthreads();  // the previous block's stage is no longer read
    const float* src = patch_t + static_cast<size_t>(blk) * block_p * N_ROWS;
    for (int i = tid; i < block_p * N_ROWS; i += TILE_R) stage[i] = src[i];
    __syncthreads();

    int any_hit = 0;
    for (int j = 0; j < block_p; ++j) any_hit |= sphere_hit(stage + j * N_ROWS, r);
    if (!__syncthreads_or(any_hit)) continue;

    for (int j = 0; j < block_p; ++j) {
      const int p = blk * block_p + j;
      if (p >= P) break;  // all-zero padding rows give no candidate
      float d;
      const int code = eval_candidate(stage + j * N_ROWS, r, prm, &d);
      const int what_on = (code >> 3) ? (code & 7) : WHAT_NONE;
      if (what_on == WHAT_INTERSECT) {
        fold(d, p, best, best_id);
      } else if (what_on < WHAT_NONE) {
        // retry at the voter: q's gate-OFF candidate, gated by q's sphere
        const int q = nb[3 * p + what_on];
        const float* row_q = patch_t + static_cast<size_t>(q) * N_ROWS;
        if (sphere_hit(row_q, r)) {
          float d2;
          const int code2 = eval_candidate(row_q, r, prm, &d2);
          if ((code2 & 7) == WHAT_INTERSECT) fold(d2, q, best, best_id);
        }
      }
    }
  }

  dist_out[ray] = best;
  idx_out[ray] = best_id;
}

}  // namespace

extern "C" int cbtr_winner(const void* counts, const void* lists,
                           const void* rays, const void* patch_t, const void* nb,
                           void* dist_out, void* idx_out, int T, int P,
                           int block_p, int iters, float ray_plane_eps,
                           float estimation_eps, float max_ray_dist,
                           float minimal_ray_distance, int clamp_secant,
                           void* stream) {
  if (T <= 0) return 0;
  const Params prm = {ray_plane_eps, estimation_eps, max_ray_dist,
                      minimal_ray_distance, iters, clamp_secant};
  const size_t smem = sizeof(float) * block_p * N_ROWS;
  winner_kernel<<<T, TILE_R, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(lists),
      static_cast<const float*>(rays), static_cast<const float*>(patch_t),
      static_cast<const int*>(nb), static_cast<float*>(dist_out),
      static_cast<int*>(idx_out), T, P, block_p, prm);
  return static_cast<int>(cudaGetLastError());
}
