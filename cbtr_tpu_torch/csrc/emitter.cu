// The point source's ray synthesis on Hopper (sm_90a): one launch makes
// every ray of `render/emitters.py::synthesize` from its global index.
//
// It replaces no Pallas kernel.  On the JAX package's side the same rays
// are jax.random's Threefry-2x32 (`fold_in`, then `uniform(key, (2,))`)
// and an XLA fusion of the bin lookup and the float tail
// (cbtr_tpu/render/emitters.py, `DeviceEmitter.rays_at`).  In the port they
// were about 165 masked int64 torch ops a hash, three hashes a ray, each a
// full pass over a 134-268 MB tensor, then a searchsorted, 7 gathers and
// some 20 float passes; the plain version is that torch code
// (`render/emitters.py::synthesize_reference`).
//
// What bounds it: the outputs, 28 B a ray (start and direction, three f32
// each, and the weight), 470 MB at 16,777,216 rays, 0.139 ms at 3.35 TB/s;
// next the integer pipe, about 3 x 75 uint32 operations a ray for the
// hashes.  So each ray lives in registers from its index to its stores:
// the hashes in uint32 (a rotation is one funnel shift, nothing is
// masked), the bin a binary search through the read-only cache over the
// bins' upper bounds (the rays are sorted by bin, so a warp's lanes take
// one path; the 84 KB of bounds stay in L1 and L2, not copied into 65,536
// blocks' shared memory), the float tail in the plain version's
// expressions and order (built with -fmad=false, IEEE sqrt and division:
// `cuda_sweep.NVCC_FLAGS`).  Only the rays are written: a block's 256
// directions are staged in shared memory and leave as 16-byte stores, the
// starts as 16-byte stores of the origin's repeating pattern, the weights
// one float a thread.
//
// The draws are jax.random's partitionable ones bit for bit: the key is
// (0, seed mod 2^32); fold_in hashes the counter pair (0, index mod 2^32)
// under it; the two draws hash (0, 0) and (0, 1) under that key, xor the
// two output words, and put the top 23 bits under the exponent of 1.0f,
// less 1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // rays a block, one a thread
constexpr unsigned kParity = 0x1BD11BDAu;

struct EmitterArgs {
  const long long* idx;     // [n] global ray indices, element stride idx_stride
  long long idx_stride;
  long long n;
  const long long* bounds;  // [num_bins] the bins' upper bounds (exclusive), ascending
  const long long* starts;  // [num_bins] each bin's first ray
  const long long* nb;      // [num_bins] rays in the bin
  const float* cos_a;       // [num_bins] cos of the belt's near edge
  const float* cos_b;       // [num_bins] cos of its far edge
  const float* turn0;       // [num_bins] the bin's first turn
  const float* turn_w;      // [num_bins] its turn's width
  const float* frac;        // [num_bins] its share of the hemisphere
  int num_bins;
  unsigned key0, key1;      // the key words (0, seed mod 2^32)
  float ox, oy, oz;         // the origin
  float n_rays;
  float* start;             // [n, 3]
  float* direction;         // [n, 3]
  float* weight;            // [n]
};

struct Words {
  unsigned x0, x1;
};

__device__ __forceinline__ unsigned rotl(unsigned x, unsigned r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, of the counter words (x0, x1) under (k0, k1)
__device__ __forceinline__ Words threefry2x32(unsigned k0, unsigned k1, unsigned x0,
                                              unsigned x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const unsigned rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][k]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
  return {x0, x1};
}

// jax.random.uniform's float of 32 random bits: in [0, 1)
__device__ __forceinline__ float unit_float(unsigned bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// searchsorted(bounds, id, right=True), clamped to the last bin
__device__ __forceinline__ int bin_of(const EmitterArgs& a, long long id) {
  int lo = 0, hi = a.num_bins;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a.bounds + mid) <= id) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < a.num_bins - 1 ? lo : a.num_bins - 1;
}

// the integer and random part of ray `id`: its two draws, its bin, its
// index in the bin and the bin's rays (at least 1), as f32
struct Draw {
  float u0, u1;
  int bin;
  float j, cnt;
};

__device__ __forceinline__ Draw draw(const EmitterArgs& a, long long id) {
  const Words key = threefry2x32(a.key0, a.key1, 0u, static_cast<unsigned>(id));
  const Words h0 = threefry2x32(key.x0, key.x1, 0u, 0u);
  const Words h1 = threefry2x32(key.x0, key.x1, 0u, 1u);
  const int p = bin_of(a, id);
  const long long count = __ldg(a.nb + p);
  return {unit_float(h0.x0 ^ h0.x1), unit_float(h1.x0 ^ h1.x1), p,
          static_cast<float>(id - __ldg(a.starts + p)),
          static_cast<float>(count < 1 ? 1 : count)};
}

// phase 1: thread t makes ray first + t, stages its direction in dir_s and
// writes its weight
__device__ __forceinline__ void make_ray(const EmitterArgs& a, long long first, int rays,
                                         float* dir_s) {
  const int t = threadIdx.x;
  if (t >= rays) return;
  const long long i = first + t;
  const Draw r = draw(a, __ldg(a.idx + i * a.idx_stride));

  // the plain version's expressions in its order
  const float ca = __ldg(a.cos_a + r.bin);
  const float cb = __ldg(a.cos_b + r.bin);
  const float s = (r.j + r.u0) / r.cnt;
  const float cosv = ca - s * (ca - cb);
  const float sinv = sqrtf(fmaxf(1.0f - cosv * cosv, 0.0f));
  const float turn = __ldg(a.turn0 + r.bin) + r.u1 * __ldg(a.turn_w + r.bin);
  const float dx = cosv;
  const float dy = sinv * cosf(turn);
  const float dz = sinv * sinf(turn);
  // torch.linalg.vector_norm of a row of three on the card adds the
  // squares as (x*x + z*z) + y*y (measured on the H100, torch 2.11)
  const float norm = sqrtf((dx * dx + dz * dz) + dy * dy);
  dir_s[3 * t] = dx / norm;
  dir_s[3 * t + 1] = dy / norm;
  dir_s[3 * t + 2] = dz / norm;
  a.weight[i] = __ldg(a.frac + r.bin) * a.n_rays / r.cnt;
}

// phase 2: the block's directions and starts, as 16-byte stores in a
// whole block (the outputs' 16-byte alignment checked by the entry point),
// one float at a time in a ragged last block
__device__ __forceinline__ void store_rays(const EmitterArgs& a, long long first, int rays,
                                           const float4* dir_s4) {
  const int t = threadIdx.x;
  float* dir = a.direction + 3 * first;
  float* start = a.start + 3 * first;
  if (rays == kThreads) {
    if (t < 3 * kThreads / 4) {
      reinterpret_cast<float4*>(dir)[t] = dir_s4[t];
      // float 4t of the block's starts is coordinate (4t) mod 3 = t mod 3
      const int r = t % 3;
      const float o0 = r == 0 ? a.ox : (r == 1 ? a.oy : a.oz);
      const float o1 = r == 0 ? a.oy : (r == 1 ? a.oz : a.ox);
      const float o2 = r == 0 ? a.oz : (r == 1 ? a.ox : a.oy);
      reinterpret_cast<float4*>(start)[t] = make_float4(o0, o1, o2, o0);
    }
    return;
  }
  const float* dir_s = reinterpret_cast<const float*>(dir_s4);
  for (int f = t; f < 3 * rays; f += kThreads) {
    const int c = f % 3;
    dir[f] = dir_s[f];
    start[f] = c == 0 ? a.ox : (c == 1 ? a.oy : a.oz);
  }
}

__global__ void __launch_bounds__(kThreads) emitter_kernel(const EmitterArgs a) {
  __shared__ float4 dir_s4[3 * kThreads / 4];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int rays = a.n - first < kThreads ? static_cast<int>(a.n - first) : kThreads;
  make_ray(a, first, rays, reinterpret_cast<float*>(dir_s4));
  __syncthreads();
  store_rays(a, first, rays, dir_s4);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// The rays at n global indices: start, direction [n, 3] and weight [n]
// f32, contiguous, the first two 16-byte aligned (cudaErrorInvalidValue
// otherwise).  Returns the launch's CUDA error code.
extern "C" int cbtr_emitter(const void* idx, long long idx_stride, long long n,
                            const void* bounds, const void* starts, const void* nb,
                            const void* cos_a, const void* cos_b, const void* turn0,
                            const void* turn_w, const void* frac, int num_bins,
                            unsigned key0, unsigned key1, float ox, float oy, float oz,
                            float n_rays, void* start, void* direction, void* weight,
                            void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (num_bins <= 0 || blocks > 0x7FFFFFFFLL || !aligned16(start) || !aligned16(direction))
    return static_cast<int>(cudaErrorInvalidValue);
  const EmitterArgs a{static_cast<const long long*>(idx), idx_stride, n,
                      static_cast<const long long*>(bounds),
                      static_cast<const long long*>(starts),
                      static_cast<const long long*>(nb),
                      static_cast<const float*>(cos_a), static_cast<const float*>(cos_b),
                      static_cast<const float*>(turn0), static_cast<const float*>(turn_w),
                      static_cast<const float*>(frac), num_bins, key0, key1, ox, oy, oz,
                      n_rays, static_cast<float*>(start), static_cast<float*>(direction),
                      static_cast<float*>(weight)};
  emitter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbtr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
