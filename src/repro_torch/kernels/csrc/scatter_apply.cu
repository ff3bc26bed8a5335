// Sparse scatter-add in place: dense[idx[j]] += vals[j], duplicates summed
// in update order.
//
// Replaces: src/repro/kernels/scatter_apply.py, _kernel / scatter_apply_blocked.
//
// The TPU kernel buckets the updates by 2048-element block and streams the
// WHOLE arena through VMEM once per event: for the 10.5M-parameter model that
// is 2 x 42 MB of traffic to apply about 10.5K updates.  On Hopper a random
// word write costs one 32-byte sector, so the bound is the k updates
// themselves: read k indices, k permutation entries and k values, and read
// and write k target words (about 10.5K x 24 bytes, some 0.25 MB).  At that
// size the launch, not the memory, sets the time.
//
// Design: the wrapper sorts the indices with a STABLE library sort
// (torch.sort), as the JAX wrapper argsorts outside the Pallas body.  One
// thread per sorted update; the thread whose index differs from its
// predecessor's owns the run of equal indices, adds the run's values in
// their original order with __fadd_rn -- ((d + v0) + v1), the reference's
// order -- and stores once.  No float atomics, so the sum is deterministic.
// Indices outside [0, n) are dropped, as XLA's scatter drops them.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void scatter_add_sorted_kernel(float* __restrict__ dense, long long n,
                                          const int32_t* __restrict__ sidx,
                                          const int64_t* __restrict__ perm,
                                          const float* __restrict__ vals,
                                          long long k) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int32_t d = sidx[i];
  if (d < 0 || (long long)d >= n) return;
  if (i > 0 && sidx[i - 1] == d) return;  // not the first of its run
  float acc = dense[d];
  for (long long j = i; j < k && sidx[j] == d; ++j) {
    acc = __fadd_rn(acc, vals[perm[j]]);
  }
  dense[d] = acc;
}

extern "C" int scatter_add_sorted(void* dense, long long n, const void* sidx,
                                  const void* perm, const void* vals,
                                  long long k, void* stream) {
  if (k == 0) return 0;
  const int threads = 256;
  const long long blocks = (k + threads - 1) / threads;
  scatter_add_sorted_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (float*)dense, n, (const int32_t*)sidx, (const int64_t*)perm,
      (const float*)vals, k);
  return (int)cudaGetLastError();
}
