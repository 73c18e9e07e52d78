// Threefry-2x32 random draws, one launch a call: the port's rng.py on CUDA
// tensors (jax.random's threefry2x32 with jax_threefry_partitionable=True,
// as rng.py's plain version computes it in int64 PyTorch ops, ~170 of them
// a hash).  Not a port of a TPU kernel: the JAX package draws through
// jax.random, which XLA fuses.
//
// Keys are int64 words (the low 32 bits of each hold a key word), read
// from device memory where the caller passes a pointer, so that a replay of
// a captured graph reads the key its buffer holds then; a key that lives on
// the host travels by value (k1, k2, with a null pointer).  Every word is
// uint32 arithmetic in registers, every output bit-equal to the plain
// version:
//
// threefry_fold_in   out[i] = fold_in(key[i], data[i]) = threefry(key[i],
//                    (0, data[i])), over a broadcast shape of up to
//                    MAX_DIMS dimensions given by sizes and element strides
//                    (0 where an operand is broadcast), the data int32 or
//                    int64, or one value; out is [n, 2] int64, contiguous.
// threefry_uniform   out[i] = uniform bits of counter start + i under one
//                    key: jax.random.uniform(key, shape)'s flat draws from
//                    position start on, f32 in [0, 1).
// threefry_draw_lanes out[i, j] = uniform(fold_in(fold_in(key, site),
//                    sid[i]), (n,))[j]: shade.py's per-lane draws, each
//                    thread folding the one key with site again (a few
//                    dozen integer operations) rather than reading it.
//
// Each launcher records one launch on `stream` (a node of the graph it
// captures into), allocates nothing, and returns cudaGetLastError().  The
// first thread of each launch adds one to counts[entry] (fold_in 0,
// uniform 1, draw_lanes 2) when counts is not null: rng.counts() reads them.
//
// Bound: a hash is 5 x (4 x (add, funnel shift, xor) + 2 adds) + 3 = 73
// 32-bit integer instructions (x2's key word and round constant join in
// one IADD3, k1 ^ k2 ^ C is one LOP3); a launch reads and writes a few
// words a thread, so it is bound by its launch latency at the renderer's
// sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using tf::threefry;
using tf::unit;

constexpr int MAX_DIMS = 4;
constexpr int THREADS = 256;

struct Layout {
  long long size[MAX_DIMS];
  long long key[MAX_DIMS];
  long long data[MAX_DIMS];
};

__device__ __forceinline__ void load_key(const long long* key, long long at, long long word,
                                         uint32_t k1v, uint32_t k2v, uint32_t& k1,
                                         uint32_t& k2) {
  if (key != nullptr) {
    k1 = (uint32_t)key[at];
    k2 = (uint32_t)key[at + word];
  } else {
    k1 = k1v;
    k2 = k2v;
  }
}

__device__ __forceinline__ uint32_t load_word(const void* p, int is_64, long long at) {
  return is_64 ? (uint32_t)((const long long*)p)[at] : (uint32_t)((const int*)p)[at];
}

__device__ __forceinline__ void count_launch(unsigned long long* counts, int entry) {
  if (counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counts + entry, 1ull);
}

__device__ __forceinline__ long long thread_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__global__ void fold_in_kernel(const long long* key, long long key_word, uint32_t k1v,
                               uint32_t k2v, const void* data, int data_64, uint32_t data_v,
                               Layout layout, int ndim, long long n, long long* out,
                               unsigned long long* counts) {
  count_launch(counts, 0);
  const long long i = thread_index();
  if (i >= n) return;
  long long rest = i, at_key = 0, at_data = 0;
  for (int d = ndim - 1; d >= 0; --d) {
    const long long ix = rest % layout.size[d];
    rest /= layout.size[d];
    at_key += ix * layout.key[d];
    at_data += ix * layout.data[d];
  }
  uint32_t k1, k2;
  load_key(key, at_key, key_word, k1v, k2v, k1, k2);
  uint32_t x1 = 0u, x2 = data != nullptr ? load_word(data, data_64, at_data) : data_v;
  threefry(k1, k2, x1, x2);
  out[2 * i] = x1;
  out[2 * i + 1] = x2;
}

__global__ void uniform_kernel(const long long* key, long long key_word, uint32_t k1v,
                               uint32_t k2v, long long start, long long n, float* out,
                               unsigned long long* counts) {
  count_launch(counts, 1);
  const long long i = thread_index();
  if (i >= n) return;
  uint32_t k1, k2;
  load_key(key, 0, key_word, k1v, k2v, k1, k2);
  uint32_t x1 = 0u, x2 = (uint32_t)(start + i);
  threefry(k1, k2, x1, x2);
  out[i] = unit(x1 ^ x2);
}

__global__ void draw_lanes_kernel(const long long* key, long long key_word, uint32_t k1v,
                                  uint32_t k2v, uint32_t site, const void* sid, int sid_64,
                                  long long sid_stride, long long lanes, int n, float* out,
                                  unsigned long long* counts) {
  count_launch(counts, 2);
  const long long i = thread_index();
  if (i >= lanes) return;
  uint32_t k1, k2;
  load_key(key, 0, key_word, k1v, k2v, k1, k2);
  uint32_t l1, l2;
  tf::lane_key(k1, k2, site, load_word(sid, sid_64, i * sid_stride), l1, l2);
  for (int j = 0; j < n; ++j) out[i * n + j] = tf::lane_draw(l1, l2, (uint32_t)j);
}

unsigned int blocks(long long n) { return (unsigned int)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int threefry_fold_in(const long long* key, long long key_word, unsigned int k1,
                                unsigned int k2, const void* data, int data_64,
                                unsigned int data_v, int ndim, const long long* size,
                                const long long* key_stride, const long long* data_stride,
                                long long n, long long* out, unsigned long long* counts,
                                cudaStream_t stream) {
  if (ndim < 0 || ndim > MAX_DIMS) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;  // nothing to draw: no launch
  Layout layout = {};
  for (int d = 0; d < ndim; ++d) {
    layout.size[d] = size[d];
    layout.key[d] = key_stride[d];
    layout.data[d] = data_stride[d];
  }
  fold_in_kernel<<<blocks(n), THREADS, 0, stream>>>(key, key_word, k1, k2, data, data_64,
                                                    data_v, layout, ndim, n, out, counts);
  return cudaGetLastError();
}

extern "C" int threefry_uniform(const long long* key, long long key_word, unsigned int k1,
                                unsigned int k2, long long start, long long n, float* out,
                                unsigned long long* counts, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  uniform_kernel<<<blocks(n), THREADS, 0, stream>>>(key, key_word, k1, k2, start, n, out,
                                                    counts);
  return cudaGetLastError();
}

extern "C" int threefry_draw_lanes(const long long* key, long long key_word, unsigned int k1,
                                   unsigned int k2, unsigned int site, const void* sid,
                                   int sid_64, long long sid_stride, long long lanes, int n,
                                   float* out, unsigned long long* counts,
                                   cudaStream_t stream) {
  if (lanes <= 0) return cudaSuccess;
  draw_lanes_kernel<<<blocks(lanes), THREADS, 0, stream>>>(key, key_word, k1, k2, site, sid,
                                                           sid_64, sid_stride, lanes, n, out,
                                                           counts);
  return cudaGetLastError();
}
