// Fused SAMomentum pass: uacc = m*u + lr*g; sent = |uacc| >= thr;
// out = sent ? uacc : 0; u_new = sent ? uacc : uacc / m.
//
// Replaces: src/repro/kernels/samomentum_kernel.py, _kernel /
// samomentum_fused_2d.
//
// Bound: memory.  It reads u and g and writes out and u_new, 16 bytes per
// element (75 MB for the 4.7M-element leaf), and does a few operations per
// element.  The TPU kernel needs the (rows % 256, 128) tiling; here one
// grid-stride loop runs over the flat tensor, with no padding, with each
// access coalesced across the warp.
//
// Rounding follows the reference as XLA compiles it on the CPU:
// m*u + lr*g is ONE fused multiply-add, fma(m, u, lr*g), and the division by
// the constant m is a multiply by its float32 reciprocal.  The explicit
// __fmaf_rn / __fmul_rn intrinsics fix those roundings, so nvcc has no
// freedom to contract or reorder (and no --use_fast_math is passed).  thr
// arrives as a device pointer, so the caller never syncs to read it.
//
// One threshold per row: the batched loop runs all B lanes of a leaf in
// one launch over the contiguous (B, n_row) block, and element i reads
// thr[i / n_row].  The single-row call passes n_row = n and one threshold.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void samomentum_kernel(const float* u, const float* g,
                                  const float* __restrict__ thr,
                                  float* __restrict__ out,
                                  float* __restrict__ unew, float m, float lr,
                                  float rcp_m, long long n, long long n_row) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float th = thr[i / n_row];
    const float uacc = __fmaf_rn(m, u[i], __fmul_rn(lr, g[i]));
    const bool sent = fabsf(uacc) >= th;
    out[i] = sent ? uacc : 0.0f;
    unew[i] = sent ? uacc : __fmul_rn(uacc, rcp_m);
  }
}

extern "C" int samomentum_fused(const void* u, const void* g, const void* thr,
                                void* out, void* unew, float m, float lr,
                                float rcp_m, long long n, long long n_row,
                                void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  samomentum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)g, (const float*)thr, (float*)out,
      (float*)unew, m, lr, rcp_m, n, n_row);
  return (int)cudaGetLastError();
}
