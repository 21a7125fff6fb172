// Fixed-order segment sums for Hopper (sm_90a): the segment-sum kernel of the
// port.
//
// out[s, c] = sum of vals[r, c] over the rows r with ids[r] == s, added in an
// order that depends on the data only, never on thread scheduling.  It
// replaces no Pallas kernel: on the TPU these sums are the XLA scatter-adds
// behind `jnp.take`'s gradient (cbtr_tpu/ops/intersect.py:331, the
// recompute's [R, 60] row gather) and behind `img.at[...].add`
// (cbtr_tpu/render/render.py:95, the scatter splat), which XLA runs in a
// fixed order.  torch's `index_add_` adds with float atomics on the card, so
// its results move in their last bits from run to run.
//
// The order (ops/cuda_segment.py states it; its plain version repeats it):
// a segment's rows in ascending source index, summed as a GROUP-ary tree.
// Level 0 folds each run of GROUP consecutive rows of a segment from +0.0,
// left to right; level k folds each run of GROUP consecutive level-(k-1)
// partials of the segment the same way, until one value is left.  A segment
// of at most GROUP rows is thus the plain left fold of a sequential
// `index_add_`.  Ids outside [0, S) are dropped.
//
// One entry point, `cbtr_segment_sum`, enqueues every stage on the caller's
// stream into one workspace the wrapper sizes from (N, S, C) alone
// (`_workspace_plan`, whose byte offsets arrive as `plan`): nothing is read
// back to the host, and no torch op runs between the stages.
//
//  1. Grouping: a stable LSD radix sort of the keys (the id, or S for a
//     dropped row) on the bits = ceil(log2(S + 1)) the segment count needs,
//     in passes of at most 11 bits (2,048 buckets): one pass at 450 or 1,800
//     segments, two at 16,200 or 1024^2.  A pass is three kernels.
//     (a) `tile_histogram`: a block counts the digits of `subs` tiles of
//         TILE keys (more as N grows, up to 8), each tile in shared memory
//         (integer atomics, aggregated over a warp's equal digits by
//         __match_any_sync: the counts do not depend on order), and stores
//         each digit's counts of its tiles side by side: whole 32-byte
//         sectors, where one tile a block would write 4 scattered bytes.
//     (b) `scan_digits`: the exclusive prefix sums of the [digits x tiles]
//         counts, digit-major, so each tile has its first slot in each
//         bucket; a single-pass scan with decoupled look-back (each block
//         takes the next tile by a ticket, publishes its total, and one
//         warp adds its predecessors' published totals, 32 at a time, down
//         to the nearest published prefix: integer sums, the same in any
//         schedule).  In a one-pass sort tile 0's slot of digit s is
//         segment s's first row: the offsets come out of this scan.
//     (c) `tile_scatter`: one block a tile; each warp ranks its run of the
//         tile in source order (__match_any_sync, the __popc of the lower
//         lanes of equal digit, a per-warp running count), the warps' counts
//         are prefix-summed in warp order, and each key goes to its bucket's
//         slot: a stable scatter.
//     The payload is the row index as int32 (the wrapper raises at 2^31
//     rows), or, at C = 1, the f32 value itself, so the fold then reads
//     contiguous memory and needs no permutation.
//  2. Offsets and node bases on the device: after a multi-pass sort
//     `segment_bounds` finds each segment's first row in the sorted keys
//     (one thread a segment, empty ones too); then `scan_nodes` prefix-sums each
//     level's node counts ceil(count / GROUP^(k+1)) (taken while the level
//     below left a segment more than one value), computed from the offsets
//     as it reads them: one scan over [levels x (S + 1)].
//  3. The fold, one launch a level.  One thread folds one (node, column)
//     sequentially, in order (`fold_rows`; at C = 60 a warp's threads read
//     neighbouring columns of one row).  At C = 1, level 0, `fold_values`
//     stages the block's 256 nodes STAGE values at a time into shared memory
//     with coalesced cp.async copies (a node's values are contiguous in the
//     sorted payload), double-buffered, and each thread folds its node's
//     values from there.  The fold never reduces across threads inside a
//     node: a warp or tree reduction would change the order of the adds,
//     and with it the bits of every gradient and image.
//
// What bounds it on the H100: bytes, and at the main path's small shapes the
// launches.  Each sort pass reads its keys twice (histogram, scatter) and
// its payloads once and writes both once; the scatter's stores are 4-byte
// writes spread over up to 2,048 buckets, which cost a pass well above its
// bytes when the keys are spread evenly (a render's splat keys cluster, so
// there they cost less: PERF.md section 6 has both).  The digit counts are
// half the keys at 11 bits, stored as whole sectors; the fold reads each
// row once (240 contiguous bytes at C = 60, 4 bytes at C = 1) and the upper
// levels GROUP times fewer.  At 262,144 x 60 -> 450 the call is nine device
// ops, about 0.1 ms of device time.  Built with -fmad=false like the other
// kernels (the fold only adds, so nothing could contract anyway).

#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 256;                  // ops/cuda_segment.py GROUP
// the radix sort: ops/cuda_segment.py SORT_WARPS, SORT_ITEMS, TILE, MAX_SUBS
constexpr int SORT_THREADS = 256;
constexpr int WARPS = SORT_THREADS / 32;
constexpr int ITEMS = 16;                   // keys a lane ranks in a tile
constexpr int WARP_KEYS = 32 * ITEMS;       // a warp's run of the tile
constexpr int TILE = SORT_THREADS * ITEMS;  // 4,096 keys
constexpr int MAX_SUBS = 8;                 // tiles a histogram block counts
constexpr int MAX_DIGITS = 2048;            // 11 bits
// the scan: ops/cuda_segment.py SCAN_TILE
constexpr int SCAN_THREADS = 512;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_ITEMS = 16;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
// the folds
constexpr int THREADS = 256;
constexpr int UNROLL = 8;                   // loads in flight a thread; the adds stay in order
constexpr int STAGE = 16;                   // values of each node staged a round (C = 1)

// the fields of `plan` (ops/cuda_segment.py PLAN_FIELDS): byte offsets into
// the workspace, and the sizes they were made for
enum Field {
  F_PASSES, F_WIDTH0, F_TILES = F_WIDTH0 + 3, F_SUBS, F_LEVELS, F_NODES0,
  F_MEMSET = F_NODES0 + 4, F_TICKETS, F_STATUS0, F_SCAN_BLOCKS0 = F_STATUS0 + 4,
  F_COUNTS = F_SCAN_BLOCKS0 + 4, F_OFFSETS, F_NODE_BASES, F_KEYS0, F_PAYLOAD0, F_KEYS1,
  F_PAYLOAD1, F_SCRATCH0, F_SCRATCH1
};

// ---------------------------------------------------------------------------
// the radix sort

// where a pass reads: pass 0 the ids (and at C = 1 the values it carries),
// later passes the keys and payloads of the pass before
struct PassIn {
  const void* ids;
  const float* vals;  // nullptr: the payload is the row index
  const int* keys;
  const unsigned* payload;
};

template <typename IdT, bool FIRST>
__device__ __forceinline__ int load_key(const PassIn& in, long long i, int S) {
  if (FIRST) {
    const IdT id = __ldg(static_cast<const IdT*>(in.ids) + i);
    return (id >= 0 && id < static_cast<IdT>(S)) ? static_cast<int>(id) : S;
  }
  return __ldg(in.keys + i);
}

template <bool FIRST>
__device__ __forceinline__ unsigned load_payload(const PassIn& in, long long i) {
  if (FIRST)
    return in.vals != nullptr ? __float_as_uint(__ldg(in.vals + i)) : static_cast<unsigned>(i);
  return __ldg(in.payload + i);
}

// (a) counts[d * tiles + tile] = the keys of tile `tile` whose digit is d,
// for the `subs` tiles of this block: each tile's counts gathered in shared
// memory, then stored digit by digit as runs of `subs` neighbouring counts
template <typename IdT, bool FIRST>
__global__ void __launch_bounds__(SORT_THREADS)
tile_histogram(PassIn in, int N, int S, int shift, int width, int tiles, int subs,
               int* __restrict__ counts) {
  const int digits = 1 << width;
  __shared__ int hist[MAX_DIGITS];
  __shared__ unsigned short kept[MAX_DIGITS][MAX_SUBS];  // at most TILE
  const int lane = threadIdx.x & 31;
  const int first_tile = blockIdx.x * subs;
  const int mine = min(subs, tiles - first_tile);
  for (int j = 0; j < mine; ++j) {
    for (int d = threadIdx.x; d < digits; d += SORT_THREADS) hist[d] = 0;
    __syncthreads();
    const long long first = static_cast<long long>(first_tile + j) * TILE;
#pragma unroll 4
    for (int r = 0; r < ITEMS; ++r) {
      const long long i = first + r * SORT_THREADS + threadIdx.x;
      const int d = i < N ? (load_key<IdT, FIRST>(in, i, S) >> shift) & (digits - 1) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    for (int d = threadIdx.x; d < digits; d += SORT_THREADS)
      kept[d][j] = static_cast<unsigned short>(hist[d]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < digits * mine; e += SORT_THREADS) {
    const int d = e / mine, j = e - d * mine;
    counts[static_cast<long long>(d) * tiles + first_tile + j] = kept[d][j];
  }
}

// (c) every key of the tile to its slot: bases[d * tiles + tile] (the scanned
// counts) + the keys of digit d in the warps before + those before it in its
// warp's run, in source order
template <typename IdT, bool FIRST, bool KEYS_OUT>
__global__ void __launch_bounds__(SORT_THREADS)
tile_scatter(PassIn in, int N, int S, int shift, int width, int tiles,
             const int* __restrict__ bases, int* __restrict__ keys_out,
             unsigned* __restrict__ payload_out) {
  const int digits = 1 << width;
  __shared__ unsigned short warp_run[WARPS][MAX_DIGITS];  // at most TILE
  __shared__ int tile_base[MAX_DIGITS];
  for (int d = threadIdx.x; d < digits; d += SORT_THREADS) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) warp_run[w][d] = 0;
    tile_base[d] = bases[static_cast<long long>(d) * tiles + blockIdx.x];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long first = static_cast<long long>(blockIdx.x) * TILE + warp * WARP_KEYS;
  int key[ITEMS], rank[ITEMS];
  unsigned payload[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const long long i = first + r * 32 + lane;
    const bool ok = i < N;
    key[r] = ok ? load_key<IdT, FIRST>(in, i, S) : -1;
    payload[r] = ok ? load_payload<FIRST>(in, i) : 0u;
    const int d = ok ? (key[r] >> shift) & (digits - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = ok ? static_cast<int>(warp_run[warp][d]) : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1)
      warp_run[warp][d] = static_cast<unsigned short>(before + __popc(peers));
    __syncwarp();
    rank[r] = before + __popc(peers & lower);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < digits; d += SORT_THREADS) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_run[w][d];
      warp_run[w][d] = static_cast<unsigned short>(run);
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (key[r] < 0) continue;
    const int d = (key[r] >> shift) & (digits - 1);
    const int slot = tile_base[d] + warp_run[warp][d] + rank[r];
    if (KEYS_OUT) keys_out[slot] = key[r];
    payload_out[slot] = payload[r];
  }
}

// after a multi-pass sort: offsets[s] = the first slot whose key is >= s,
// one thread a segment (a binary search of the sorted keys: neighbouring
// segments take the same path down to its last steps, so the loads mostly
// hit the cache, and no thread's work depends on how the keys are spread)
__global__ void __launch_bounds__(THREADS)
segment_bounds(const int* __restrict__ keys, int N, int S, int* __restrict__ offsets) {
  const long long s = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (s > S) return;
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid) < s) lo = mid + 1; else hi = mid;
  }
  offsets[s] = lo;
}

// ---------------------------------------------------------------------------
// the scans: exclusive prefix sums in one pass, by decoupled look-back

struct ScanArgs {
  const int* in;                // scan_digits: the counts (may be `out`)
  int* out;
  long long n;
  unsigned long long* status;   // one a block, zeroed: flag << 32 | value
  int* ticket;                  // zeroed
  int* offsets;                 // scan_digits: tile 0 of digit s is offsets[s] (one pass)
  const int* seg_offsets;       // scan_nodes: the segments' first rows
  int tiles;
  int S;
};

constexpr unsigned long long AGGREGATE = 1ull << 32, PREFIX = 2ull << 32;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// scan_nodes' element k * (S + 1) + s: segment s's nodes at level k
__device__ __forceinline__ int level_nodes(const ScanArgs& a, long long i) {
  const int k = static_cast<int>(i / (a.S + 1));
  const int s = static_cast<int>(i - static_cast<long long>(k) * (a.S + 1));
  if (s == a.S) return 0;
  const long long n = __ldg(a.seg_offsets + s + 1) - __ldg(a.seg_offsets + s);
  long long below = 1;
  for (int j = 0; j < k; ++j) below *= GROUP;
  const long long span = below * GROUP;
  return n > (k == 0 ? 0 : below) ? static_cast<int>((n + span - 1) / span) : 0;
}

template <bool NODES>
__device__ __forceinline__ void scan_tile(const ScanArgs& a) {
  __shared__ int buf[SCAN_TILE + SCAN_TILE / 32];
  __shared__ int warp_sums[SCAN_WARPS];
  __shared__ int tile_sh, total_sh, before_sh;
  if (threadIdx.x == 0) tile_sh = atomicAdd(a.ticket, 1);
  __syncthreads();
  const int tile = tile_sh;
  const long long first = static_cast<long long>(tile) * SCAN_TILE;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int e = j * SCAN_THREADS + threadIdx.x;
    const long long i = first + e;
    buf[padded(e)] = i >= a.n ? 0 : NODES ? level_nodes(a, i) : a.in[i];
  }
  __syncthreads();
  int v[SCAN_ITEMS], sum = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    v[j] = buf[padded(threadIdx.x * SCAN_ITEMS + j)];
    sum += v[j];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inclusive = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inclusive, o);
    if (lane >= o) inclusive += t;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < SCAN_WARPS ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < SCAN_WARPS) warp_sums[lane] = wi - w;
    if (lane == SCAN_WARPS - 1) total_sh = wi;
  }
  __syncthreads();
  if (warp == 0) {
    // the look-back, a window of 32 predecessors at a time: wait until each
    // has published, add the totals down to the nearest published prefix
    const unsigned total = static_cast<unsigned>(total_sh);
    unsigned before = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(a.status, PREFIX | total);
    } else {
      if (lane == 0) atomicExch(a.status + tile, AGGREGATE | total);
      for (int j = tile - 1;; j -= 32) {
        const int at = j - lane;
        const volatile unsigned long long* word = a.status + (at < 0 ? 0 : at);
        unsigned long long s = at < 0 ? PREFIX : *word;
        while (__any_sync(0xffffffffu, (s >> 32) == 0))
          if ((s >> 32) == 0) s = *word;
        const unsigned prefixes = __ballot_sync(0xffffffffu, (s & PREFIX) != 0);
        const int stop = prefixes != 0 ? __ffs(prefixes) - 1 : 31;
        before += __reduce_add_sync(0xffffffffu, lane <= stop ? static_cast<unsigned>(s) : 0u);
        if (prefixes != 0) break;
      }
      if (lane == 0) atomicExch(a.status + tile, PREFIX | (before + total));
    }
    if (lane == 0) before_sh = static_cast<int>(before);
  }
  __syncthreads();
  int run = before_sh + warp_sums[warp] + inclusive - sum;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    buf[padded(threadIdx.x * SCAN_ITEMS + j)] = run;
    run += v[j];
  }
  __syncthreads();
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int e = j * SCAN_THREADS + threadIdx.x;
    const long long i = first + e;
    if (i >= a.n) break;
    const int x = buf[padded(e)];
    a.out[i] = x;
    if (!NODES && a.offsets != nullptr && i % a.tiles == 0 && i / a.tiles <= a.S)
      a.offsets[i / a.tiles] = x;
  }
}

// (b) the digit counts, digit-major
__global__ void __launch_bounds__(SCAN_THREADS) scan_digits(ScanArgs a) { scan_tile<false>(a); }

// the node bases: [levels x (S + 1)] prefix sums, each level's row read
// minus its first element
__global__ void __launch_bounds__(SCAN_THREADS) scan_nodes(ScanArgs a) { scan_tile<true>(a); }

// ---------------------------------------------------------------------------
// the fold

// the segment of `node`: the s with bases[s] <= node < bases[s + 1]
__device__ __forceinline__ int segment_of(const int* __restrict__ bases, int S, int node) {
  int lo = 0, hi = S;
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(bases + mid) <= node) lo = mid; else hi = mid;
  }
  return lo;
}

// one level of the tree: children -> nodes, one thread a (node, column).
// perm != nullptr at level 0 (child i of segment s is row perm[child_base[s]
// + i] of vals); nullptr above (child i is row child_base[s] + i of the
// previous level's partials, child_base and bases taken minus their [0])
__global__ void __launch_bounds__(THREADS)
fold_rows(const float* __restrict__ children, const int* __restrict__ perm,
          const int* __restrict__ child_base, const int* __restrict__ bases,
          float* __restrict__ partials, float* __restrict__ out, int S, int C) {
  const int b0 = __ldg(bases), c0 = __ldg(child_base);
  const long long item = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (item >= static_cast<long long>(__ldg(bases + S) - b0) * C) return;
  const int node = static_cast<int>(item / C);
  const int c = static_cast<int>(item - static_cast<long long>(node) * C);
  const int s = segment_of(bases, S, node + b0);
  const long long first = __ldg(child_base + s) - c0;
  const long long n = __ldg(child_base + s + 1) - __ldg(child_base + s);
  long long i = static_cast<long long>(node + b0 - __ldg(bases + s)) * GROUP;
  const long long end = min(i + GROUP, n);

  float acc = 0.0f;
  if (perm != nullptr) {
    for (; i + UNROLL <= end; i += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = __ldg(children + static_cast<long long>(__ldg(perm + first + i + u)) * C + c);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = acc + v[u];
    }
    for (; i < end; ++i)
      acc = acc + __ldg(children + static_cast<long long>(__ldg(perm + first + i)) * C + c);
  } else {
    for (; i + UNROLL <= end; i += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(children + (first + i + u) * C + c);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = acc + v[u];
    }
    for (; i < end; ++i) acc = acc + __ldg(children + (first + i) * C + c);
  }

  if (__ldg(bases + s + 1) - __ldg(bases + s) == 1)
    out[static_cast<long long>(s) * C + c] = acc;
  else
    partials[static_cast<long long>(node) * C + c] = acc;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// round q of fold_values' staging: values q * STAGE.. of each node into buf
__device__ __forceinline__ void stage_round(float (*buf)[STAGE + 1], const float* sorted,
                                            const int* node_first, const int* node_len,
                                            int q) {
#pragma unroll 4
  for (int k = 0; k < STAGE; ++k) {
    const int e = k * THREADS + threadIdx.x;
    const int t = e / STAGE, p = e % STAGE;
    if (q * STAGE + p < node_len[t])
      cp_async4(&buf[t][p], sorted + node_first[t] + q * STAGE + p);
  }
  cp_async_commit();
}

// level 0 at C = 1: a node's values are contiguous in the sorted payload.
// The block's THREADS nodes are staged STAGE values a node a round (lanes
// 0-15 and 16-31 of a warp copy 64 contiguous bytes of two nodes), the next
// round in flight while the threads fold this one, each its own node in
// order.  bases: level 0's node prefix sums (bases[0] == 0).
__global__ void __launch_bounds__(THREADS)
fold_values(const float* __restrict__ sorted, const int* __restrict__ offsets,
            const int* __restrict__ bases, float* __restrict__ partials,
            float* __restrict__ out, int S) {
  __shared__ float stage[2][THREADS][STAGE + 1];
  __shared__ int node_first[THREADS], node_len[THREADS];
  __shared__ int rounds_sh;
  const int nodes = __ldg(bases + S);
  const int node = blockIdx.x * THREADS + threadIdx.x;
  if (blockIdx.x * THREADS >= nodes) return;
  int s = 0, len = 0, lo = 0;
  if (node < nodes) {
    s = segment_of(bases, S, node);
    const int j = node - __ldg(bases + s);
    const int first = __ldg(offsets + s);
    lo = first + j * GROUP;
    len = min(GROUP, __ldg(offsets + s + 1) - lo);
  }
  node_first[threadIdx.x] = lo;
  node_len[threadIdx.x] = len;
  if (threadIdx.x == 0) rounds_sh = 0;
  __syncthreads();
  atomicMax(&rounds_sh, (len + STAGE - 1) / STAGE);
  __syncthreads();
  const int rounds = rounds_sh;

  float acc = 0.0f;
  stage_round(stage[0], sorted, node_first, node_len, 0);
  for (int q = 0; q < rounds; ++q) {
    if (q + 1 < rounds)
      stage_round(stage[(q + 1) & 1], sorted, node_first, node_len, q + 1);
    else
      cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();
    const int m = min(STAGE, len - q * STAGE);
    const float* row = stage[q & 1][threadIdx.x];
    for (int p = 0; p < m; ++p) acc = acc + row[p];
    __syncthreads();
  }
  if (node >= nodes) return;
  if (__ldg(bases + s + 1) - __ldg(bases + s) == 1)
    out[s] = acc;
  else
    partials[node] = acc;
}

#define CHECK_LAUNCH()                                    \
  do {                                                    \
    const cudaError_t err_ = cudaGetLastError();          \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

unsigned grid(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

// pass 0 reads the ids (IdT), later passes int32 keys
template <typename IdT, bool FIRST>
int sort_pass(const PassIn& in, int N, int S, int shift, int width, int tiles, int subs,
              int* counts, const ScanArgs& scan, long long scan_blocks, int* keys_out,
              unsigned* payload_out, cudaStream_t st) {
  tile_histogram<IdT, FIRST><<<(tiles + subs - 1) / subs, SORT_THREADS, 0, st>>>(
      in, N, S, shift, width, tiles, subs, counts);
  CHECK_LAUNCH();
  scan_digits<<<static_cast<unsigned>(scan_blocks), SCAN_THREADS, 0, st>>>(scan);
  CHECK_LAUNCH();
  if (keys_out != nullptr)
    tile_scatter<IdT, FIRST, true><<<tiles, SORT_THREADS, 0, st>>>(
        in, N, S, shift, width, tiles, counts, keys_out, payload_out);
  else
    tile_scatter<IdT, FIRST, false><<<tiles, SORT_THREADS, 0, st>>>(
        in, N, S, shift, width, tiles, counts, nullptr, payload_out);
  CHECK_LAUNCH();
  return 0;
}

}  // namespace

// One segment sum on `stream`: ids [N] (int32 or int64, id_bytes 4 or 8),
// vals [N, C] f32, out [S, C] f32 zeroed by the caller (an empty segment is
// never written), the workspace and the plan (Field) of ops/cuda_segment.py's
// `_workspace_plan(N, S, C)`.  Returns a CUDA error code.
extern "C" int cbtr_segment_sum(const void* ids, int id_bytes, const void* vals, void* out,
                                void* workspace, long long N, int S, int C,
                                const long long* plan, void* stream) {
  if (N <= 0 || S <= 0 || C <= 0) return 0;
  if (N > 0x7fffffffLL || S >= 0x7fffffff || (id_bytes != 4 && id_bytes != 8) ||
      plan[F_PASSES] < 1 || plan[F_PASSES] > 3 || plan[F_LEVELS] < 1 || plan[F_LEVELS] > 4 ||
      plan[F_SUBS] < 1 || plan[F_SUBS] > MAX_SUBS || plan[F_TILES] != (N + TILE - 1) / TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* ws = static_cast<char*>(workspace);
  const int n = static_cast<int>(N);
  const int passes = static_cast<int>(plan[F_PASSES]);
  const int tiles = static_cast<int>(plan[F_TILES]);
  const int subs = static_cast<int>(plan[F_SUBS]);
  const int levels = static_cast<int>(plan[F_LEVELS]);
  int* tickets = reinterpret_cast<int*>(ws + plan[F_TICKETS]);
  int* counts = reinterpret_cast<int*>(ws + plan[F_COUNTS]);
  int* offsets = reinterpret_cast<int*>(ws + plan[F_OFFSETS]);
  int* node_bases = reinterpret_cast<int*>(ws + plan[F_NODE_BASES]);
  int* keys[2] = {reinterpret_cast<int*>(ws + plan[F_KEYS0]),
                  reinterpret_cast<int*>(ws + plan[F_KEYS1])};
  unsigned* payload[2] = {reinterpret_cast<unsigned*>(ws + plan[F_PAYLOAD0]),
                          reinterpret_cast<unsigned*>(ws + plan[F_PAYLOAD1])};
  float* scratch[2] = {reinterpret_cast<float*>(ws + plan[F_SCRATCH0]),
                       reinterpret_cast<float*>(ws + plan[F_SCRATCH1])};
  const auto status = [&](int q) {
    return reinterpret_cast<unsigned long long*>(ws + plan[F_STATUS0 + q]);
  };

  const cudaError_t cleared = cudaMemsetAsync(ws, 0, plan[F_MEMSET], st);
  if (cleared != cudaSuccess) return static_cast<int>(cleared);

  // 1. the grouping
  int shift = 0;
  for (int p = 0; p < passes; ++p) {
    const int width = static_cast<int>(plan[F_WIDTH0 + p]);
    const int digits = 1 << width;
    PassIn in{ids, C == 1 ? static_cast<const float*>(vals) : nullptr, nullptr, nullptr};
    if (p > 0) in = PassIn{nullptr, nullptr, keys[(p - 1) % 2], payload[(p - 1) % 2]};
    const ScanArgs scan{counts, counts, static_cast<long long>(digits) * tiles, status(p),
                        tickets + p, passes == 1 ? offsets : nullptr, nullptr, tiles, S};
    int* keys_out = passes > 1 ? keys[p % 2] : nullptr;
    const long long blocks = plan[F_SCAN_BLOCKS0 + p];
    int rc;
    if (p > 0)
      rc = sort_pass<int, false>(in, n, S, shift, width, tiles, subs, counts, scan, blocks,
                                 keys_out, payload[p % 2], st);
    else if (id_bytes == 4)
      rc = sort_pass<int, true>(in, n, S, shift, width, tiles, subs, counts, scan, blocks,
                                keys_out, payload[0], st);
    else
      rc = sort_pass<long long, true>(in, n, S, shift, width, tiles, subs, counts, scan, blocks,
                                      keys_out, payload[0], st);
    if (rc != 0) return rc;
    shift += width;
  }
  const int last = (passes - 1) % 2;

  // 2. offsets and node bases
  if (passes > 1) {
    segment_bounds<<<grid(static_cast<long long>(S) + 1, THREADS), THREADS, 0, st>>>(
        keys[last], n, S, offsets);
    CHECK_LAUNCH();
  }
  const ScanArgs nodes{nullptr, node_bases, static_cast<long long>(levels) * (S + 1),
                       status(passes), tickets + passes, nullptr, offsets, 0, S};
  scan_nodes<<<static_cast<unsigned>(plan[F_SCAN_BLOCKS0 + passes]), SCAN_THREADS, 0, st>>>(
      nodes);
  CHECK_LAUNCH();

  // 3. the fold, a level a launch
  for (int k = 0; k < levels; ++k) {
    const long long max_nodes = plan[F_NODES0 + k];
    const int* row = node_bases + static_cast<long long>(k) * (S + 1);
    if (k == 0 && C == 1) {
      fold_values<<<grid(max_nodes, THREADS), THREADS, 0, st>>>(
          reinterpret_cast<const float*>(payload[last]), offsets, row, scratch[0],
          static_cast<float*>(out), S);
    } else {
      fold_rows<<<grid(max_nodes * C, THREADS), THREADS, 0, st>>>(
          k == 0 ? static_cast<const float*>(vals) : scratch[(k - 1) % 2],
          k == 0 ? reinterpret_cast<const int*>(payload[last]) : nullptr,
          k == 0 ? offsets : row - (S + 1), row, scratch[k % 2], static_cast<float*>(out), S,
          C);
    }
    CHECK_LAUNCH();
  }
  return 0;
}

extern "C" const char* cbtr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
