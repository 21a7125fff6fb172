// Per-pair sweep codes for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the TPU kernel cbtr_tpu/ops/pallas_sweep.py::_sweep_kernel_resident
// (launched by _sweep_call, public sweep_codes_pallas).  For every (ray,
// patch) pair of the tile's listed and sphere-gated 32-patch blocks it writes
// the gate-OFF candidate code what | (in_domain << 3) and the along-ray
// distance; every other pair keeps the (WHAT_NONE, 0) the wrapper filled in
// before the launch, as the TPU kernel fills its output block before its
// loop.  The staged pipeline then selects winners from these codes on the
// host side (intersect.select_candidates).
//
// What bounds it on the H100: the candidate arithmetic, not the output.  K3
// writes 8 bytes for every pair it evaluates into outputs of 8 bytes a pair
// (268 MB at 65,536 x 512 padded pairs, which the wrapper fills in 0.08 ms),
// but the kernel alone takes 0.97 ms at 65,536 x 450, and its evaluated
// pairs run K1's Newton loop (about 1.7 kFLOP a pair) at some 0.17 of the
// measured FMA peak (PERF.md).  The design keeps the stores coalesced and
// leaves the arithmetic to the cull:
//   * one CUDA block per 128-ray tile, one thread per ray (K1's layout);
//   * the block loop visits only the tile's listed blocks; each block's 32
//     rows (8 KiB) are staged in shared memory and the block is skipped
//     unless some (patch, ray) pair passes the per-patch sphere test
//     (__syncthreads_or);
//   * the output is patch-major [P_pad, R_pad], the TPU kernel's layout: for
//     each patch the 128 threads of a tile store 512 contiguous bytes.  A
//     ray-major [R, P] store from a thread per ray would stride by P and not
//     coalesce; the wrapper returns the transposed view.
//
// Arithmetic: csrc/candidate.cuh (shared with K1 and K2), so a pair's code
// and, where it is cIntersect, its distance are bit-identical to theirs and
// to the plain twin's.  Where the pair fails the plane or slab test,
// eval_candidate returns before the Newton loop and the distance is 0; the
// twin's dense sweep runs the loop on tame values there, so such distances
// differ (codes do not).

#include "candidate.cuh"

namespace {

__global__ void __launch_bounds__(TILE_R)
sweep_codes_kernel(const int* __restrict__ counts, const int* __restrict__ lists,
                   const float* __restrict__ rays,
                   const float* __restrict__ patch_t, int* __restrict__ code_out,
                   float* __restrict__ dist_out, int T, int P, int block_p,
                   Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int R_pad = T * TILE_R;
  const int ray = tile * TILE_R + tid;
  const Ray r = {rays[ray], rays[R_pad + ray], rays[2 * R_pad + ray],
                 rays[3 * R_pad + ray], rays[4 * R_pad + ray],
                 rays[5 * R_pad + ray]};

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
      if (p >= P) break;  // padding rows keep (WHAT_NONE, 0)
      float d;
      const int code = eval_candidate(stage + j * N_ROWS, r, prm, &d);
      const size_t at = static_cast<size_t>(p) * R_pad + ray;
      code_out[at] = code;
      dist_out[at] = d;
    }
  }
}

}  // namespace

extern "C" int cbtr_sweep_codes(const void* counts, const void* lists,
                                const void* rays, const void* patch_t,
                                void* code_out, void* dist_out, int T, int P,
                                int block_p, int iters,
                                float ray_plane_eps, float estimation_eps,
                                float max_ray_dist, float minimal_ray_distance,
                                int clamp_secant, void* stream) {
  if (T <= 0) return 0;
  const Params prm = {ray_plane_eps, estimation_eps, max_ray_dist,
                      minimal_ray_distance, iters, clamp_secant};
  const size_t smem = sizeof(float) * block_p * N_ROWS;
  sweep_codes_kernel<<<T, TILE_R, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(lists),
      static_cast<const float*>(rays), static_cast<const float*>(patch_t),
      static_cast<int*>(code_out), static_cast<float*>(dist_out), T, P,
      block_p, prm);
  return static_cast<int>(cudaGetLastError());
}
