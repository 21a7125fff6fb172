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
// and its evaluated pairs run K1's Newton loop (about 1.7 kFLOP a pair).  So
// the design is K1's and K2's (block_walk.cuh, here at blocks of 32 patches),
// with nothing left on the host but the tables:
//   * one CUDA block per 128-ray tile; each CTA culls the 32-patch blocks for
//     its own tile from the [B, 12] block bounds (cull_tile), where the host
//     built [B, T] lists with a dense test and a sort before;
//   * four threads a ray (SPLIT): thread t works for ray t % 128 on the
//     patches j of each block with j % 4 == t / 128, eight patches a thread,
//     so that the tiles with the most listed blocks, which set the kernel's
//     end, finish in a quarter of the time (65,536 rays are only 512 tiles
//     over 132 SMs);
//   * the listed blocks' 32 rows (8 KiB) are double-buffered into shared
//     memory by cp.async, the next one in flight while the current one is
//     evaluated;
//   * a listed block is skipped unless some (patch, ray) pair of block x tile
//     passes the per-patch sphere test: one __syncthreads_or over the whole
//     CTA.  That rule defines the output (a gate per pair would drop retry
//     candidates), so all four parts vote into one barrier;
//   * the evaluator is the inlined candidate_code<SharedRow>;
//   * the output is patch-major [P_pad, R_pad], the TPU kernel's layout: for
//     each patch the 128 threads of one part store 512 contiguous bytes of
//     each output.  A ray-major [R, P] store would stride by P and not
//     coalesce; the wrapper returns the transposed view.
//
// MODE (a template parameter; the entry point dispatches, every other value
// is refused) is the sweep's arithmetic (candidate.cuh SweepMath: exact,
// config.fast_newton, config.bf16_sweep, both); mode 0 is the default
// build, op for op.
//
// Arithmetic: csrc/candidate.cuh (shared with K1 and K2), so a pair's code
// and, where it is cIntersect, its distance are bit-identical to theirs and
// to the plain twin's.  Where the pair fails the plane or slab test,
// candidate_code returns before the Newton loop and the distance is 0; the
// twin's dense sweep runs the loop on tame values there, so such distances
// differ (codes do not).

#include "block_walk.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
sweep_codes_kernel(const float* __restrict__ rays,
                   const float* __restrict__ patch_t,
                   const float* __restrict__ bounds, int* __restrict__ code_out,
                   float* __restrict__ dist_out, int* __restrict__ counts_out,
                   int* __restrict__ lists_out, int* __restrict__ pairs_out,
                   int T, int P, int P_pad, int block_p, int use_aabb,
                   Params prm) {
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

  int evaluated_patches = 0;

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
      if (tid == 0) evaluated_patches += min(block_p, P - blk * block_p);
      for (int j = part; j < block_p; j += SPLIT) {
        const int p = blk * block_p + j;
        if (p >= P) break;  // padding rows keep (WHAT_NONE, 0)
        float d;
        const int code = candidate_code<M>(SharedRow{cur + j * N_ROWS}, r, prm, &d);
        const size_t at = static_cast<size_t>(p) * R_pad + ray;
        code_out[at] = code;
        dist_out[at] = d;
      }
      __syncthreads();  // `cur` is no longer read: the next prefetch reuses it
    }
    blk = nxt;
  }

  // [T]: the (ray, patch) pairs the tile evaluated
  if (pairs_out != nullptr && tid == 0) pairs_out[tile] = evaluated_patches * TILE_R;
}

}  // namespace

namespace {
// the instantiation of a mode, or nullptr for a mode out of range
using Kernel = decltype(&sweep_codes_kernel<0>);
Kernel kernel_of(int mode) {
  static const Kernel kernels[N_MODES] = {sweep_codes_kernel<0>, sweep_codes_kernel<1>,
                                          sweep_codes_kernel<2>, sweep_codes_kernel<3>};
  return mode >= 0 && mode < N_MODES ? kernels[mode] : nullptr;
}
}  // namespace

// mode: the sweep's arithmetic (SweepMath); any other value is refused
// (cudaErrorInvalidValue)
extern "C" int cbtr_sweep_codes(const void* rays, const void* patch_t,
                                const void* bounds, void* code_out,
                                void* dist_out, void* counts_out, void* lists_out,
                                void* pairs_out, int T, int P, int P_pad,
                                int block_p, int use_aabb, int iters,
                                float ray_plane_eps, float estimation_eps,
                                float max_ray_dist, float minimal_ray_distance,
                                int clamp_secant, int mode, void* stream) {
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
      static_cast<const float*>(bounds), static_cast<int*>(code_out),
      static_cast<float*>(dist_out), static_cast<int*>(counts_out),
      static_cast<int*>(lists_out), static_cast<int*>(pairs_out), T, P, P_pad,
      block_p, use_aabb, prm);
  return static_cast<int>(cudaGetLastError());
}
