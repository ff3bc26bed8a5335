// Wire quantize and pack: kernels 5 and 6 of the port.
//
// Replaces: src/repro/kernels/wire_pack.py, _bf16_kernel / _int8_kernel /
// _tern_kernel via _codes_pallas (kernel 5, wire_codes), and
// _tern_pack_kernel via _pack_tern_pallas (kernel 6, tern_pack).
//
// Kernel 5 computes, per element of a message's (k,) f32 values, the wire
// code and the dequantized ("shipped") value, from per-segment scales that
// the caller reduced beforehand (one scale per parameter tensor):
//   bf16: the bit pattern of the value rounded to nearest even, and its f32;
//   int8: q = clip(rint(x / s), -127, 127) as int8, and q * s;
//   tern: (x > 0) - (x < 0) as int8, and that sign * s.
// The TPU kernel reads a materialized (k,) scale vector padded to (8, 128)
// tiles.  Here the block reads the segment ends (int64) and the n_seg
// scales into shared memory once and each thread finds its segment by
// binary search: 4 bytes per element fewer, and no padding.
//
// Kernel 6 packs four int8 sign codes into each byte, 2-bit two's
// complement fields, first code in the low bits (the codec's _pack_tern
// order); one thread per output byte, one 32-bit load for a full group of
// four, a zero-padded tail.
//
// Bound: bytes.  Kernel 5 reads 4 B and writes 4 B of dq and 1 B (int8,
// tern) or 2 B (bf16) of code per element; kernel 6 reads 4 B and writes
// 1 B per output byte.  At a message's k of about 10K both are launch-bound.
//
// Rounding: __fdiv_rn, rintf (round half to even), __fmul_rn and
// __float2bfloat16_rn fix each rounding, and the build passes no
// --use_fast_math, so the codes and values equal the plain PyTorch version's
// bit for bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Mode { kBf16 = 1, kInt8 = 2, kTern = 3 };

__global__ void wire_codes_kernel(const float* __restrict__ x, long long k,
                                  int mode, const float* __restrict__ scales,
                                  const long long* __restrict__ seg_end,
                                  int n_seg, void* __restrict__ codes,
                                  float* __restrict__ dq) {
  extern __shared__ unsigned char smem[];
  long long* ends = reinterpret_cast<long long*>(smem);
  float* sc = reinterpret_cast<float*>(ends + n_seg);
  if (mode != kBf16) {
    for (int j = threadIdx.x; j < n_seg; j += blockDim.x) {
      ends[j] = seg_end[j];
      sc[j] = scales[j];
    }
    __syncthreads();
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const float v = x[i];
  if (mode == kBf16) {
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    reinterpret_cast<uint16_t*>(codes)[i] = __bfloat16_as_ushort(b);
    dq[i] = __bfloat162float(b);
    return;
  }
  // the first segment whose end lies beyond i
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] > i) hi = mid; else lo = mid + 1;
  }
  const float s = sc[lo];
  float q;
  if (mode == kInt8) {
    q = rintf(__fdiv_rn(v, s));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
  } else {
    q = (float)((v > 0.0f) - (v < 0.0f));
  }
  reinterpret_cast<int8_t*>(codes)[i] = (int8_t)q;
  dq[i] = __fmul_rn(q, s);
}

__global__ void tern_pack_kernel(const int8_t* __restrict__ codes,
                                 long long k, uint8_t* __restrict__ out,
                                 long long n_out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const long long base = 4 * t;
  uint32_t w;
  if (base + 4 <= k) {
    w = reinterpret_cast<const uint32_t*>(codes)[t];
  } else {  // the tail: codes past k pack as 0
    w = 0;
    for (int j = 0; j < 4 && base + j < k; ++j) {
      w |= (uint32_t)(uint8_t)codes[base + j] << (8 * j);
    }
  }
  out[t] = (uint8_t)((w & 3u) | ((w >> 8) & 3u) << 2 | ((w >> 16) & 3u) << 4 |
                     ((w >> 24) & 3u) << 6);
}

}  // namespace

extern "C" int wire_codes(const void* x, long long k, int mode,
                          const void* scales, const void* seg_end, int n_seg,
                          void* codes, void* dq, void* stream) {
  if (k == 0) return 0;
  const size_t smem =
      mode == kBf16 ? 0 : (size_t)n_seg * (sizeof(long long) + sizeof(float));
  const long long blocks = (k + kThreads - 1) / kThreads;
  wire_codes_kernel<<<(unsigned)blocks, kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const float*)x, k, mode, (const float*)scales,
      (const long long*)seg_end, n_seg, codes, (float*)dq);
  return (int)cudaGetLastError();
}

extern "C" int tern_pack(const void* codes, long long k, void* out,
                         void* stream) {
  const long long n_out = (k + 3) / 4;
  if (n_out == 0) return 0;
  const long long blocks = (n_out + kThreads - 1) / kThreads;
  tern_pack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, k, (uint8_t*)out, n_out);
  return (int)cudaGetLastError();
}
