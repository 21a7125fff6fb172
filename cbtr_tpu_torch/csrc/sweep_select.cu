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
// on evaluating fewer pairs, on keeping every thread busy with them, on
// issuing few instructions that are not arithmetic, and on moving no
// per-pair state to device memory.
//
// The candidate set is the JAX kernel's, defined per (128-ray tile x
// 16-patch block): a block is listed for the tile by its merged sphere and
// box (block_walk.cuh cull_tile, each CTA for its own tile), and a listed
// block, or half block with HALF, is gated open when some (patch, ray) pair
// of it passes the per-patch sphere test.  The gate's unit stays that
// coarse because it defines the retries (pass 2 below): a voted neighbour
// is retried only where its unit was gated open, and a retry is a gate-OFF
// candidate that can converge up to 66x the hull radius out
// (pallas_sweep.py:396), so no per-pair test may drop it.  Pass 1 is another
// matter.  A pass-1 pair contributes, as a direct hit or as a vote, only
// where its gate-ON code holds: the ray meets the patch's underlying plane
// at dist0 > 0 with barycentrics in [0, 1] (candidate.cuh valid and in_dom),
// i.e. the half-line crosses the flat triangle of the corners v0, v1, cp003
// (bezier/build.py:135-136).  The corners are control points, so that
// triangle lies in the control net's hull, inside the 1.25-inflated sphere
// and the slack-widened box of the patch.  A pass-1 pair whose ray misses
// either can never contribute, and pass 1 evaluates only the pairs that pass
// both (about a sixth of the gated units' pairs on a beam through the robot
// lens); skipping the rest changes no winner.
//
// The survivors of a gated block are few and scattered (about 350 of 2,048
// at a 4K beam), so spread over the walk's layout (block_walk.cuh: 4 threads
// a ray, each on every fourth patch, a barrier a block) the CTA would wait at
// every barrier for its busiest warp.  Pass 1 therefore compacts them:
//   * the tile's listed blocks go in batches of BATCH_ROWS patch rows; a
//     batch's rows ([P_pad, 64] f32 table, 4 KiB a block, L2-resident) are
//     copied into shared memory by cp.async while its pairs are tested;
//   * the list: each warp tests one patch of the batch against all 128 rays
//     (4 a lane, held in registers; the sphere from the row, the box from the
//     per-patch [P_pad, 8] box table, both through __ldg), ORs the sphere
//     ballots into the unit's ok_bits (the gate: set exactly where the unit
//     gate opens, even where no pair survives the box), and appends the
//     surviving pairs as one contiguous run a patch (one atomicAdd a warp and
//     patch) to a shared list of 16-bit (row slot, ray) entries, so 32
//     consecutive entries read one to three staged rows as broadcasts;
//   * the dealing: after one barrier the CTA's threads take the list in
//     rounds, one pair a thread, so every warp has the same work whatever
//     rays and patches the survivors fall on; a batch costs two barriers,
//     where the walk has one a block;
//   * two CTAs an SM: a CTA is K1_THREADS = 256 threads (two a ray) in 88 KiB
//     of shared memory at P_pad 512, so that one CTA's serial phases (the
//     cull, the list, a batch's last partial round, its barriers) overlap
//     the other's dealing (one CTA of 512 threads measured 6-10 % slower at
//     the 4K shapes: PERF.md);
//   * the fold: each ray's (best, best_id) lives in shared memory as one
//     64-bit key whose unsigned order is fold's (min distance, then lowest
//     id; fold_key), folded order-free by atomicMin; votes keep their
//     atomicOr into the per-ray `voted` bitmap.
// Nothing per pair goes to device memory: 8 bytes per ray come out, plus the
// tile's listed count (and, for checks only, its list and its pairs).
//
// Kept as they are, on purpose:
//   * -fmad=false with IEEE sqrt and division: every multiply-add issues as
//     two instructions, but the kernel is then bit-equal to its plain twin,
//     which is how every change to it is checked (a build with contraction
//     ran some 16 % faster and changed the winner of 0.15 % of the hit rays
//     at 262,144 x 450, 0.6 % at x 1800: PERF.md);
//   * no tensor cores: the work per pair is a 10-term cubic of width 3 in a
//     data-dependent Newton loop, not a matrix product;
//   * the 128-ray tile, the 16-patch block and the unit gate: they define
//     the candidate set.
//
// Modes (template parameters; the entry point dispatches, every other value
// is refused): MODE, the sweep's arithmetic (candidate.cuh SweepMath: exact,
// config.fast_newton, config.bf16_sweep, both), and HALF, the JAX kernel's
// half_gate: each half of a listed block (block_p / 2 patches) passes its own
// sphere gate, and ok_bits marks halves, so a voted neighbour is retried only
// where its half was gated open (an ungated half leaves its pairs WHAT_NONE
// in the JAX kernel's code scratch).  The per-pair test is the same in every
// mode and under HALF: it drops only pairs no gate can open.
//
// The TPU kernel keeps per-pair (code, dist) scratch and resolves the
// follow-side retry with a one-hot vote matmul; [P_pad x 128] scratch does
// not fit shared memory, so this kernel computes the same candidate set in
// two passes instead:
//   pass 1  the surviving pairs of the listed blocks (above): direct hits
//           (gate-ON cIntersect) are folded into the ray's key, and the
//           patches q = neighbours[p, s] that a gate-ON cFollowSide_s result
//           of patch p votes for are marked in the ray's bitmap; ok_bits
//           marks the gated units;
//   pass 2  K1_SPLIT = 2 threads a ray start from the ray's key, and each
//           re-evaluates the gate-OFF candidate of every voted q (q %
//           K1_SPLIT its part) whose unit was gated open (few: rays that
//           cross a patch border) from q's row in device memory
//           (candidate_code<GlobalRow>) and folds it in if it is cIntersect.
//           That is the reference's "voted AND its own gate-OFF result
//           hits".  The parts' winners are folded at the end
//           (block_walk.cuh combine_parts).
// Both passes inline the same candidate_code on the same row values, so a
// retry candidate's distance is bit-identical to the one pass 1 would have
// seen.
//
// The second refraction (optics/lens.py trace_through_lens) hands K1 a prior:
// which rays the first refraction left alive, and K1's first answer for
// every ray.  A dead ray leaves that refraction exactly as it entered it, so
// a tile none of whose 128 rays is alive holds the rays of the first search,
// bit for bit, and K1's answer for a tile is a function of its rays and the
// tables alone: such a tile writes the prior's answer for its rays and
// exits before it touches shared memory (most tiles of a beam or a fan: the
// rays that miss the lens).  A tile with any live ray runs in full, its dead
// rays included, since they take part in the tile's cull and unit gates,
// which decide the live rays' retries.
//
// Arithmetic: csrc/candidate.cuh (shared with K2 and K3); the tile's cull:
// csrc/block_walk.cuh (shared with K2 and K3).  What only K1 uses is here.

#include "block_walk.cuh"

namespace {

// pass 1's batch: patch rows staged and tested at once (8 blocks of 16),
// each staged row ROW_STRIDE floats apart (16-byte aligned; rows 4 banks
// apart, so the few rows a warp reads at once rarely share a bank)
constexpr int BATCH_ROWS = 128;
constexpr int ROW_STRIDE = N_ROWS + 4;
// a list entry: (row slot << RAY_BITS) | ray, 15 bits; the list holds every
// pair of a batch
constexpr int RAY_BITS = 7;
static_assert(TILE_R == 1 << RAY_BITS && BATCH_ROWS << RAY_BITS <= 1 << 16, "entries");
constexpr int LIST_CAP = BATCH_ROWS * TILE_R;
// the per-patch box table's columns (cuda_sweep.patch_box_table): lo xyz,
// hi xyz, two zeros
constexpr int N_BOX = 8;
// a ray in shared memory: sx, sy, sz, dx, dy, dz and its slab reciprocals
constexpr int N_SRAY = 9;
constexpr unsigned FULL = 0xffffffffu;
// the CTA: two threads a ray, two CTAs an SM (registers and shared memory)
constexpr int K1_THREADS = 2 * TILE_R;
constexpr int K1_SPLIT = K1_THREADS / TILE_R;
constexpr int K1_WARPS = K1_THREADS / 32;

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (distance, patch id) as one 64-bit key whose unsigned order is fold's: the
// distance's bits made monotone (a -0 taken as +0, as fold's == takes it,
// and flagged in bit 0 so that it comes back), then the id
__device__ __forceinline__ unsigned long long fold_key(float d, int q) {
  unsigned u = __float_as_uint(d);
  const unsigned neg_zero = u == 0x80000000u ? 1u : 0u;
  if (neg_zero) u = 0u;
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) |
         (static_cast<unsigned>(q) << 1) | neg_zero;
}

__device__ __forceinline__ void unfold_key(unsigned long long key, float& d, int& q) {
  const unsigned ord = static_cast<unsigned>(key >> 32);
  const unsigned low = static_cast<unsigned>(key);
  const unsigned u = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  d = (low & 1u) ? -0.0f : __uint_as_float(u);
  q = static_cast<int>(low >> 1);
}

// the ray of the tile's lane q from shared memory (rows of N_SRAY floats)
__device__ __forceinline__ Ray shared_ray(const float* sray, int q) {
  return {sray[q], sray[TILE_R + q], sray[2 * TILE_R + q],
          sray[3 * TILE_R + q], sray[4 * TILE_R + q], sray[5 * TILE_R + q]};
}

// does the ray meet a patch's box (a = lo xyz, hi x; b = hi y, hi z)?
// block_walk.cuh block_hit's slab test, on the patch's own box
// (cuda_sweep.box_hit_pairs is the plain version)
__device__ __forceinline__ bool patch_box_hit(const float4& a, const float4& b,
                                              const Ray& r, const SlabRay& inv) {
  const float t1x = (a.x - r.sx) * inv.ix, t2x = (a.w - r.sx) * inv.ix;
  const float t1y = (a.y - r.sy) * inv.iy, t2y = (b.x - r.sy) * inv.iy;
  const float t1z = (a.z - r.sz) * inv.iz, t2z = (b.y - r.sz) * inv.iz;
  const float t_near = tmax(tmax(tmin(t1x, t2x), tmin(t1y, t2y)), tmin(t1z, t2z));
  const float t_far = tmin(tmin(tmax(t1x, t2x), tmax(t1y, t2y)), tmax(t1z, t2z));
  return (t_far >= 0.0f) && (t_near <= t_far);
}

// A tile the first refraction left with no live ray: the prior's answer
// (padding rays past R read a miss) and a count of 0 blocks; true for such a
// tile, which then does nothing else.  Every thread of the CTA calls it.  Out
// of line, so that the kernel's registers stay as they are without a prior.
__device__ __noinline__ bool reused_prior(const bool* __restrict__ live,
                                          const int* __restrict__ prior_win,
                                          const float* __restrict__ prior_dist,
                                          float* __restrict__ dist_out,
                                          int* __restrict__ idx_out,
                                          int* __restrict__ counts_out,
                                          int* __restrict__ reuse_out, int R) {
  const bool first = threadIdx.x < TILE_R;
  const int ray = blockIdx.x * TILE_R + threadIdx.x % TILE_R;
  const bool any_live = __syncthreads_or(first && ray < R && live[ray]) != 0;
  if (reuse_out != nullptr && threadIdx.x == 0) {
    // (tiles that reused the prior, tiles launched with one)
    if (!any_live) atomicAdd(reuse_out, 1);
    atomicAdd(reuse_out + 1, 1);
  }
  if (any_live) return false;
  if (first) dist_out[ray] = ray < R ? prior_dist[ray] : BIG_F;
  else idx_out[ray] = ray < R ? prior_win[ray] : 0;
  if (threadIdx.x == 0) counts_out[blockIdx.x] = 0;
  return true;
}

// shared memory (smem_bytes): keys [TILE_R] u64 | stage [BATCH_ROWS]
// [ROW_STRIDE] f32 | sray [N_SRAY][TILE_R] f32 | the cull's bounds chunk |
// slot_patch [BATCH_ROWS] i32 | listed [B] i32 | n_list [2] i32 | the cull's
// warp and tile bitmaps | ok_bits [WU] u32 (one bit a gated block, or half
// with HALF) | voted [P_pad / 32][TILE_R] u32 (word-major: thread-consecutive
// words, no bank conflicts) | list [LIST_CAP] u16
template <int MODE, bool HALF>
__global__ void __launch_bounds__(K1_THREADS, 2)
sweep_select_kernel(const float* __restrict__ rays,
                    const float* __restrict__ patch_t,
                    const float* __restrict__ boxes,
                    const float* __restrict__ bounds,
                    const int* __restrict__ nb, const bool* __restrict__ live,
                    const int* __restrict__ prior_win,
                    const float* __restrict__ prior_dist, float* __restrict__ dist_out,
                    int* __restrict__ idx_out, int* __restrict__ counts_out,
                    int* __restrict__ lists_out, int* __restrict__ pairs_out,
                    int* __restrict__ reuse_out, int R, int T, int P, int P_pad,
                    int block_p, int use_aabb, Params prm) {
  using M = SweepMath<MODE>;

  if (live != nullptr && reused_prior(live, prior_win, prior_dist, dist_out, idx_out,
                                      counts_out, reuse_out, R))
    return;

  extern __shared__ __align__(16) unsigned char smem[];
  const int B = P_pad / block_p;
  const int WB = (B + 31) / 32;
  // the gate's unit: a block, or half of one
  const int unit = HALF ? block_p / 2 : block_p;
  const int WU = (P_pad / unit + 31) / 32;
  const int W = P_pad / 32;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* stage = reinterpret_cast<float*>(keys + TILE_R);
  float* sray = stage + BATCH_ROWS * ROW_STRIDE;
  float* sbounds = sray + N_SRAY * TILE_R;
  int* slot_patch = reinterpret_cast<int*>(sbounds + BOUNDS_CHUNK * N_BOUNDS);
  int* listed = slot_patch + BATCH_ROWS;
  int* n_list = listed + B;
  unsigned* warp_bits = reinterpret_cast<unsigned*>(n_list + 2);
  unsigned* tile_bits = warp_bits + K1_WARPS * WB;
  unsigned* ok_bits = tile_bits + WB;              // gated units
  unsigned* voted = ok_bits + WU;
  unsigned short* list = reinterpret_cast<unsigned short*>(voted + W * TILE_R);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lane_ray = tid % TILE_R, part = tid / TILE_R;
  const int R_pad = T * TILE_R;
  const int ray = tile * TILE_R + lane_ray;
  const Ray r = {rays[ray], rays[R_pad + ray], rays[2 * R_pad + ray],
                 rays[3 * R_pad + ray], rays[4 * R_pad + ray],
                 rays[5 * R_pad + ray]};

  if (part == 0) {
    const float v[N_SRAY] = {r.sx, r.sy, r.sz, r.dx, r.dy, r.dz,
                             slab_inv(r.dx), slab_inv(r.dy), slab_inv(r.dz)};
#pragma unroll
    for (int k = 0; k < N_SRAY; ++k) sray[k * TILE_R + lane_ray] = v[k];
    keys[lane_ray] = fold_key(BIG_F, 0);
  }
  for (int i = tid; i < WU; i += K1_THREADS) ok_bits[i] = 0u;
  for (int i = tid; i < W * TILE_R; i += K1_THREADS) voted[i] = 0u;
  if (tid < 2) n_list[tid] = 0;

  // (cull_tile starts and ends with a barrier: the writes above are seen)
  const int n_listed = cull_tile<K1_THREADS>(bounds, B, use_aabb != 0, r, sbounds,
                                             warp_bits, tile_bits);
  if (tid == 0) counts_out[tile] = n_listed;
  // listed[k]: the tile's k-th listed block, ascending
  for (int b = tid; b < B; b += K1_THREADS) {
    const unsigned word = tile_bits[b >> 5];
    if ((word >> (b & 31)) & 1u) {
      int k = __popc(word & ((1u << (b & 31)) - 1u));
      for (int w = 0; w < (b >> 5); ++w) k += __popc(tile_bits[w]);
      listed[k] = b;
      if (lists_out != nullptr) lists_out[static_cast<size_t>(k) * T + tile] = b;
    }
  }
  __syncthreads();

  // ---- pass 1: the listed blocks' pairs that pass the patch's sphere and
  // box, in batches of BATCH_ROWS rows, compacted onto the CTA's threads ----
  int pass1_pairs = 0, retries = 0;   // thread 0's, each thread's
  const int batch_blocks = BATCH_ROWS / block_p;
  for (int k0 = 0, batch = 0; k0 < n_listed; k0 += batch_blocks, ++batch) {
    const int n_rows = min(batch_blocks, n_listed - k0) * block_p;
    // the batch's rows, in flight while its pairs are tested
    constexpr int QUADS = N_ROWS / 4;
    for (int i = tid; i < n_rows * QUADS; i += K1_THREADS) {
      const int s = i / QUADS, c = i % QUADS;
      const int p = listed[k0 + s / block_p] * block_p + s % block_p;
      cp_async16(stage + s * ROW_STRIDE + 4 * c, patch_t + static_cast<size_t>(p) * N_ROWS + 4 * c);
      if (c == 0) slot_patch[s] = p;
    }
    cp_async_commit();

    // the list: warp `warp` tests row slots warp, warp + K1_WARPS, ... against
    // the tile's 128 rays (ray g * 32 + lane for g = 0..3, held in registers
    // for the batch's slots)
    int* count = n_list + (batch & 1);
    constexpr int GROUPS = TILE_R / 32;
    Ray rq[GROUPS];
    SlabRay inv[GROUPS];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int q = g * 32 + lane;
      rq[g] = shared_ray(sray, q);
      inv[g] = {sray[6 * TILE_R + q], sray[7 * TILE_R + q], sray[8 * TILE_R + q]};
    }
    for (int s = warp; s < n_rows; s += K1_WARPS) {
      const int p = listed[k0 + s / block_p] * block_p + s % block_p;
      const GlobalRow row{patch_t + static_cast<size_t>(p) * N_ROWS};
      const float4 a = __ldg(reinterpret_cast<const float4*>(boxes + static_cast<size_t>(p) * N_BOX));
      const float4 b = __ldg(reinterpret_cast<const float4*>(boxes + static_cast<size_t>(p) * N_BOX + 4));
      unsigned sphere_any = 0u, keep[GROUPS];
      int total = 0;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        // padding rows count toward the gate, as they always have, but give
        // no candidate
        const bool sphere = patch_sphere_hit(row, rq[g]);
        sphere_any |= __ballot_sync(FULL, sphere);
        keep[g] = __ballot_sync(FULL, sphere && p < P && patch_box_hit(a, b, rq[g], inv[g]));
        total += __popc(keep[g]);
      }
      if (sphere_any != 0u && lane == 0) {
        const int ub = p / unit;
        atomicOr(ok_bits + (ub >> 5), 1u << (ub & 31));
      }
      if (total > 0) {
        int base = 0;
        if (lane == 0) base = atomicAdd(count, total);
        base = __shfl_sync(FULL, base, 0);
        const unsigned below = (1u << lane) - 1u;
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          if ((keep[g] >> lane) & 1u)
            list[base + __popc(keep[g] & below)] =
                static_cast<unsigned short>((s << RAY_BITS) | (g * 32 + lane));
          base += __popc(keep[g]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the rows have landed, the list and ok_bits are whole

    // the dealing: pair i to thread i % K1_THREADS
    const int n = *count;
    if (tid == 0) {
      pass1_pairs += n;
      n_list[(batch + 1) & 1] = 0;  // the next batch's count, last read before this barrier
    }
    for (int i = tid; i < n; i += K1_THREADS) {
      const int e = list[i];
      const int s = e >> RAY_BITS, q = e & (TILE_R - 1);
      const int p = slot_patch[s];
      float d;
      const int code = candidate_code<M>(SharedRow{stage + s * ROW_STRIDE},
                                         shared_ray(sray, q), prm, &d);
      const int what_on = (code >> 3) ? (code & 7) : WHAT_NONE;
      if (what_on == WHAT_INTERSECT) {
        atomicMin(keys + q, fold_key(d, p));
      } else if (what_on < WHAT_NONE) {
        const int v = nb[3 * p + what_on];
        if (v >= 0) atomicOr(voted + (v >> 5) * TILE_R + q, 1u << (v & 31));
      }
    }
    __syncthreads();  // stage, list and keys are free for the next batch
  }

  // ---- pass 2: voted neighbours, gate OFF, only where gated open ----
  float best;
  int best_id;
  unfold_key(keys[lane_ray], best, best_id);
  for (int w = 0; w < W; ++w) {
    unsigned bits = voted[w * TILE_R + lane_ray];
    while (bits) {
      const int q = w * 32 + (__ffs(bits) - 1);
      bits &= bits - 1u;
      const int qb = q / unit;
      if (q % K1_SPLIT != part) continue;  // another part of the ray retries q
      if (q >= P || !((ok_bits[qb >> 5] >> (qb & 31)) & 1u)) continue;
      float d;
      const int code = candidate_code<M>(
          GlobalRow{patch_t + static_cast<size_t>(q) * N_ROWS}, r, prm, &d);
      ++retries;
      if ((code & 7) == WHAT_INTERSECT) fold(d, q, best, best_id);
    }
  }

  combine_parts<K1_THREADS>(best, best_id, stage);
  if (part == 0) {
    dist_out[ray] = best;
    idx_out[ray] = best_id;
  }
  if (pairs_out != nullptr) {
    // [T, 2]: pass-1 pairs of the tile, retries (the wrapper zeroes both)
    if (tid == 0) pairs_out[2 * tile] = pass1_pairs;
    for (int off = 16; off > 0; off >>= 1) retries += __shfl_down_sync(FULL, retries, off);
    if ((tid & 31) == 0 && retries) atomicAdd(pairs_out + 2 * tile + 1, retries);
  }
}

}  // namespace

namespace {
// the kernel's shared bytes: 88,240 at P_pad = 512, 96,600 at 1024 (block 16), so
// that two CTAs fit an SM
size_t smem_bytes(int P_pad, int block_p, bool half) {
  const int B = P_pad / block_p;
  const int WB = (B + 31) / 32;
  const int units = half ? 2 * B : B;
  return sizeof(unsigned long long) * TILE_R +
         sizeof(float) * (BATCH_ROWS * ROW_STRIDE + N_SRAY * TILE_R + BOUNDS_CHUNK * N_BOUNDS) +
         sizeof(int) * (BATCH_ROWS + B + 2) +
         sizeof(unsigned) * ((K1_WARPS + 1) * WB + (units + 31) / 32 + (P_pad / 32) * TILE_R) +
         sizeof(unsigned short) * LIST_CAP;
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

// the kernel's shared-memory limit raised to `smem` where it passes the
// default 48 KiB
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}
}  // namespace

// CTAs of K1's instantiation (mode, half_gate) an SM holds at this table
// size (registers and shared memory)
extern "C" int cbtr_sweep_select_occupancy(int P_pad, int block_p, int mode,
                                           int half_gate) {
  const Kernel kernel = kernel_of(mode, half_gate);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(P_pad, block_p, half_gate != 0);
  cudaError_t err = allow_smem(kernel, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, K1_THREADS, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// mode: the sweep's arithmetic (SweepMath); half_gate: 0 or 1, at an even
// block_p; any other value is refused (cudaErrorInvalidValue)
// boxes: the [P_pad, 8] per-patch box table (cuda_sweep.patch_box_table)
// live, prior_win, prior_dist: the prior of R rays (bool, i32, f32), or
// three nulls; reuse_out: null, or two ints the launch adds its reused and
// its prior-launched tiles to
extern "C" int cbtr_sweep_select(const void* rays, const void* patch_t,
                                 const void* boxes, const void* bounds, const void* nb,
                                 const void* live, const void* prior_win,
                                 const void* prior_dist, void* dist_out, void* idx_out,
                                 void* counts_out, void* lists_out, void* pairs_out,
                                 void* reuse_out, int R, int T, int P,
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
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<T, K1_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(patch_t),
      static_cast<const float*>(boxes), static_cast<const float*>(bounds), static_cast<const int*>(nb),
      static_cast<const bool*>(live), static_cast<const int*>(prior_win),
      static_cast<const float*>(prior_dist), static_cast<float*>(dist_out),
      static_cast<int*>(idx_out), static_cast<int*>(counts_out),
      static_cast<int*>(lists_out), static_cast<int*>(pairs_out),
      static_cast<int*>(reuse_out), R, T, P, P_pad, block_p, use_aabb, prm);
  return static_cast<int>(cudaGetLastError());
}
