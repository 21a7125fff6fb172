// Fixed-order segment sums for Hopper (sm_90a): the segment-sum kernel of the
// port.
//
// out[s, c] = sum of vals[r, c] over the rows r with ids[r] == s, added in an
// order that depends on the data only, never on thread scheduling.  It
// replaces no Pallas kernel: on the TPU these sums are the XLA scatter-adds
// behind `jnp.take`'s gradient (cbtr_tpu/ops/intersect.py:331, the
// recompute's [R, 60] row gather) and behind `img.at[...].add`
// (cbtr_tpu/render/render.py:95, the scatter splat), which XLA runs in a
// fixed order.  In the port torch's `index_add_` did both with float atomics,
// so two gradients or two 4K images on the card differed in their last bits.
//
// The order (ops/cuda_segment.py states it; its plain version repeats it):
// a segment's rows in ascending source index (the wrapper's stable sort),
// summed as a GROUP-ary tree.  Level 0 folds each run of GROUP consecutive
// rows of a segment from +0.0, left to right; level k folds each run of GROUP
// consecutive level-(k-1) partials of the segment the same way, until one
// value is left.  A segment of at most GROUP rows is thus the plain left
// fold that a sequential `index_add_` performs.
//
// Layout: one launch a level, one thread a (node, column) item.  A node is
// one run of at most GROUP children of one segment, so no thread serialises
// on a long segment: the 900 k missed rays that gather patch 0 in a 4K chunk,
// or the tens of millions of dead rays that splat at the image centre, spread
// over thousands of nodes.  The wrapper gives each level the prefix sums of
// its nodes per segment (`bases`, [levels, S + 1]); a thread finds its
// segment by binary search there.  A node whose segment has one node at its
// level is the segment's result and goes to `out`; every other node writes
// its partial to the level's scratch buffer, which the next level reads.
// Integer offsets are 64-bit: N x C reaches 1e9 at 16.8 M rays x 60.
//
// What bounds it on the H100: bytes.  Each row is read once through the sort
// permutation (a gather: 240 contiguous bytes a row at C = 60, which the
// threads of a node read coalesced; 4 random bytes a row at C = 1), and the
// upper levels move GROUP times fewer.  Built with -fmad=false like the other
// kernels (it only adds, so nothing could contract anyway).

#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 256;       // ops/cuda_segment.py GROUP
constexpr int THREADS = 256;
constexpr int UNROLL = 8;        // loads in flight a thread; the adds stay in order

// the segment of node `node`: the s with bases[s] <= node < bases[s + 1]
__device__ __forceinline__ int segment_of(const long long* __restrict__ bases,
                                          int S, long long node) {
  int lo = 0, hi = S;  // bases[lo] <= node < bases[hi]
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(bases + mid) <= node) lo = mid; else hi = mid;
  }
  return lo;
}

// one level of the tree: children -> nodes.  perm != nullptr at level 0 (the
// children are rows of vals, child i of segment s is row perm[child_base[s] +
// i]); nullptr above (child i is row child_base[s] + i of the previous
// level's partials)
__global__ void __launch_bounds__(THREADS)
fold_level(const float* __restrict__ children, const long long* __restrict__ perm,
           const long long* __restrict__ child_base,  // [S + 1]
           const long long* __restrict__ bases,       // [S + 1]: nodes of this level
           float* __restrict__ partials, float* __restrict__ out, int S, int C) {
  const long long item = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long items = __ldg(bases + S) * C;
  if (item >= items) return;
  const long long node = item / C;
  const int c = static_cast<int>(item - node * C);
  const int s = segment_of(bases, S, node);
  const long long j = node - __ldg(bases + s);
  const long long first = __ldg(child_base + s);
  const long long n = __ldg(child_base + s + 1) - first;
  long long i = j * GROUP;
  const long long end = min(i + GROUP, n);

  float acc = 0.0f;
  if (perm != nullptr) {
    for (; i + UNROLL <= end; i += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = __ldg(children + __ldg(perm + first + i + u) * C + c);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = acc + v[u];
    }
    for (; i < end; ++i) acc = acc + __ldg(children + __ldg(perm + first + i) * C + c);
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
    partials[node * C + c] = acc;
}

}  // namespace

// Every level of one segment sum, in order, on `stream`.  vals [N, C] f32,
// perm [N] i64 (the rows grouped by segment, stably), offsets [S + 1] i64 (the
// segments' first positions in perm), bases [levels, S + 1] i64, scratch two
// buffers of scratch_items floats each, out [S, C] f32 zeroed by the caller
// (an empty segment is never written), max_nodes[levels] (host) an upper
// bound on each level's nodes.  Returns a CUDA error code.
extern "C" int cbtr_segment_sum(const void* vals, const void* perm, const void* offsets,
                                const void* bases, void* scratch_a, void* scratch_b,
                                void* out, int S, int C, int levels,
                                const long long* max_nodes, long long scratch_items,
                                void* stream) {
  if (S <= 0 || C <= 0 || levels <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* base = static_cast<const long long*>(bases);
  float* scratch[2] = {static_cast<float*>(scratch_a), static_cast<float*>(scratch_b)};
  for (int k = 0; k < levels; ++k) {
    const long long items = max_nodes[k] * C;
    if (k + 1 < levels && items > scratch_items)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (items + THREADS - 1) / THREADS;
    if (blocks <= 0) continue;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long* level_bases = base + static_cast<long long>(k) * (S + 1);
    fold_level<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
        k == 0 ? static_cast<const float*>(vals) : scratch[(k - 1) % 2],
        k == 0 ? static_cast<const long long*>(perm) : nullptr,
        k == 0 ? static_cast<const long long*>(offsets) : level_bases - (S + 1),
        level_bases, scratch[k % 2], static_cast<float*>(out), S, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* cbtr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
