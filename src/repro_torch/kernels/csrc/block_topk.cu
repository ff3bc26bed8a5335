// Per-block top-r by magnitude: for each block of 1024 elements, the r
// largest |x|, ties to the lower index, as signed values and block-local
// indices.
//
// Replaces: src/repro/kernels/block_topk.py, _kernel / block_topk_2d.
//
// The TPU kernel runs r unrolled (argmax, mask) sweeps over a VMEM block:
// O(r * 1024) work, which is cheap for small r and 1024 sweeps for the
// r = 1024 that BlockwiseEngine._plan gives every leaf with k >= 1024.  On
// Hopper the bound is memory: read the block once (4 KB) and write r values
// and r indices (8r bytes).  The work must stay near that whatever r is.
//
// Design: one CUDA block of 512 threads per 1024-element block.  Each
// element becomes one 64-bit key, (~|x| bits) << 32 | index, so that an
// ASCENDING sort orders by magnitude descending, then index ascending -- the
// argmax sweeps' order for every r at once.  A bitonic sort in shared memory
// (8 KB, 55 compare-exchange stages) orders the keys; the first r are
// written out.  |x| is the sign-cleared bit pattern, whose integer order is
// the float order for non-negative values and which maps -0 to +0.  The
// cost is independent of r.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kBlock = 1024;
constexpr int kThreads = kBlock / 2;

__global__ void block_topk_kernel(const float* __restrict__ x,
                                  float* __restrict__ vals,
                                  int32_t* __restrict__ idx, int r) {
  __shared__ unsigned long long keys[kBlock];
  const float* xb = x + (long long)blockIdx.x * kBlock;
  const int t = threadIdx.x;
  for (int i = t; i < kBlock; i += kThreads) {
    const unsigned mag = __float_as_uint(xb[i]) & 0x7fffffffu;
    keys[i] = ((unsigned long long)(~mag) << 32) | (unsigned)i;
  }
  __syncthreads();
  for (int size = 2; size <= kBlock; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      // thread t handles the pair (lo, lo + stride)
      const int lo = 2 * t - (t & (stride - 1));
      const int hi = lo + stride;
      const bool ascending = (lo & size) == 0;
      const unsigned long long a = keys[lo];
      const unsigned long long b = keys[hi];
      if ((a > b) == ascending) {
        keys[lo] = b;
        keys[hi] = a;
      }
      __syncthreads();
    }
  }
  const long long base = (long long)blockIdx.x * r;
  for (int j = t; j < r; j += kThreads) {
    const int li = (int)(keys[j] & 0xffffffffu);
    vals[base + j] = xb[li];
    idx[base + j] = li;
  }
}

extern "C" int block_topk(const void* x, void* vals, void* idx, long long nb,
                          int r, void* stream) {
  if (nb == 0) return 0;
  block_topk_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)vals, (int32_t*)idx, r);
  return (int)cudaGetLastError();
}
