// Segmented wire quantize: kernels 5 and 6 of the port, in one kernel.
//
// Replaces: src/repro/kernels/wire_pack.py, _bf16_kernel / _int8_kernel /
// _tern_kernel via _codes_pallas (kernel 5) and _tern_pack_kernel via
// _pack_tern_pallas (kernel 6), together with the per-segment scale
// reductions that the reference's quantize_pack leaves to XLA.
//
// Input: a (B, k) f32 batch of messages with a row stride, and the messages'
// static segmentation (one segment per parameter tensor, its cumulative ends
// on the card).  Per (row, segment) it reduces the scale, and per element it
// writes the shipped (dequantized) value and, on request, the wire code:
//   int8: s = fma(max|v|, f32(1/127), f32(1e-12)), one rounding; a segment
//         holding a NaN gets a NaN scale (torch.amax propagates it);
//         q = clamp(rint(v / s), -127, 127), code q (0 for a NaN q), dq q*s;
//   tern: s = (sum |v|) / f32(max(nnz, 1)), nnz counting v != 0 (NaN
//         counts, +-0 do not); q = (v > 0) - (v < 0), dq q*s;
//   bf16: the value rounded to nearest even, code its 16 bits, dq its f32;
//   none: the frame tail only: the raw f32 bytes of v.
// Codes come per element (int8, bf16 bits; tern as int8 signs) or, for tern,
// packed four to a byte (2-bit two's complement, first code in the low bits,
// the row's tail padded with zero codes).  The frame encoder also asks for
// the message's int32 indices narrowed to 1, 2 or 4 bytes, so one launch
// writes a frame's whole value tail (scales, indices, codes) into one
// buffer, which crosses to the host in one copy.
//
// The tern sum's order depends on the segment's length alone, never on the
// grid, the card or the order in which blocks run.  The segment is cut into
// chunks of kChunk = 8192 elements; in a chunk, lane j of kLanes = 1024 adds
// |v| of chunk elements j, j + 1024, ..., j + 7168 left to right, starting
// from +0; a halving tree combines the lanes (lane l += lane l + h, h = 512,
// 256, ..., 1); the chunks' sums combine left to right in chunk order.
// kernels/wire_pack.py's tern_sum is the plain version of this order.
//
// Design.  One CTA of 256 threads per (row, segment, chunk): a thread holds
// up to nine float4 of its chunk in registers (16-byte loads at 16-byte
// addresses, scalar loads at the chunk's two ragged edges; thread t's four
// lanes are 4t - a .. 4t - a + 3 mod 1024, a being the chunk's misalignment
// in elements), reduces max, nnz and its lane sums, and after the block
// reduction writes dq and the codes from the same registers: x is read once.
// A message's segments fit one chunk (the largest at phase B's widths is
// 4,719 elements), so a message is one launch.  A segment longer than a
// chunk takes a first launch that writes each chunk's (sum, max, nnz),
// accumulating as its loads arrive (30-odd registers, so a 4.7M-element
// segment's 576 CTAs run in one wave); the second launch's CTAs combine
// their segment's partials (the sum in chunk order, from shared memory,
// sixteen loads ahead of each stretch of the chain of adds) before they
// load their chunk, which keeps the registers the chunk needs free during
// the combine.  An int8 code is the rint of the rounded
// quotient v / s; the kernel takes it from v * rcp(s), within 2^-16 of
// v / s, and divides only where that lies near a half-integer (or is NaN),
// so a denormal numerator seldom meets the division's slow path.
// Stores are 16, 8 or 4 bytes where the output's address allows, else
// element or byte stores (a frame tail's codes may start at any byte).
// Packed tern bytes are owned by the chunk holding their first code; their
// signs are read again from x (the block's own, cached loads), so a byte
// whose codes straddle two segments is written once, and no int8 sign code
// reaches device memory.
//
// Bound: bytes.  Per element x is read once and dq written once (4 + 4 B)
// plus the code (2 B bf16, 1 B int8, 0.25 B packed tern).
//
// Rounding: __fmaf_rn, __fdiv_rn, __frcp_rn, rintf (half to even),
// __fmul_rn and __float2bfloat16_rn fix each rounding, and the build passes no
// --use_fast_math, so the results equal the plain PyTorch version's bit for
// bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4 * kThreads;         // 1024 lanes of the tern sum
constexpr int kChunk = 8 * kLanes;           // 8192 elements per chunk
constexpr int kVecs = kChunk / kLanes + 1;   // float4 per thread, +1 for a misaligned head
enum Mode { kNone = 0, kBf16 = 1, kInt8 = 2, kTern = 3 };
enum CodeForm { kNoCodes = 0, kElementCodes = 1, kPackedCodes = 2 };

struct Args {
  const float* x;
  long long x_stride;             // elements between rows
  long long k;                    // elements per row
  const long long* seg_end;       // (n_seg,) cumulative segment ends
  const long long* chunk_start;   // (n_seg + 1,) cumulative chunk counts
  int n_seg;
  int n_work;                     // chunks per row
  float rcp127, eps;              // the int8 scale's constants
  float* scales;                  // (B, n_seg) or null
  float* dq;                      // (B, dq_stride) or null
  long long dq_stride;
  unsigned char* codes;           // row stride code_stride bytes, or null
  long long code_stride;
  int code_form;
  const int* idx;                 // (k,) message indices (B = 1), or null
  unsigned char* idx_out;         // narrowed to idx_width bytes
  int idx_width;
  float4* partial;                // (B, n_work): sum, max, nnz (bits), -
};

struct Work {
  int seg;
  long long seg_lo;      // row position of the segment's first element
  long long lo;          // row position of the chunk's first element
  long long len;         // elements in the chunk
  long long first;       // work index of the segment's first chunk
  long long n_chunks;
};

__device__ __forceinline__ Work find_work(const Args& a, long long w) {
  int lo = 0, hi = a.n_seg - 1;      // the segment whose chunks hold w
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.chunk_start[mid + 1] > w) hi = mid; else lo = mid + 1;
  }
  Work r;
  r.seg = lo;
  r.seg_lo = lo ? a.seg_end[lo - 1] : 0;
  r.first = a.chunk_start[lo];
  r.n_chunks = a.chunk_start[lo + 1] - r.first;
  const long long c = w - r.first;
  const long long seg_len = a.seg_end[lo] - r.seg_lo;
  r.lo = r.seg_lo + c * kChunk;
  const long long rest = seg_len - c * kChunk;
  r.len = rest < kChunk ? (rest > 0 ? rest : 0) : kChunk;
  return r;
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The chunk into registers: v[i][e] is chunk element 4 (t + 256 i) - a + e,
// 0 where that lies outside [0, len).
__device__ __forceinline__ void load_chunk(const float* base, long long len,
                                           int a, float (&v)[kVecs][4]) {
  const float4* ab = reinterpret_cast<const float4*>(
      reinterpret_cast<uintptr_t>(base) - 4 * a);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long p0 = 4LL * (threadIdx.x + kThreads * i) - a;
    if (p0 >= 0 && p0 + 3 < len) {
      const float4 t = ab[threadIdx.x + kThreads * i];
      v[i][0] = t.x; v[i][1] = t.y; v[i][2] = t.z; v[i][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long p = p0 + e;
        v[i][e] = (p >= 0 && p < len) ? base[p] : 0.0f;
      }
    }
  }
}

__device__ __forceinline__ bool valid(int i, int e, int a, long long len) {
  const long long p = 4LL * (threadIdx.x + kThreads * i) - a + e;
  return p >= 0 && p < len;
}

// Block-wide reductions of (max, nan flag, nnz); every thread gets them.
__device__ __forceinline__ void block_reduce(float& m, int& nan, int& nnz) {
  __shared__ float sm[kThreads / 32];
  __shared__ int sn[kThreads / 32], sc[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    nan |= __shfl_xor_sync(0xffffffffu, nan, o);
    nnz += __shfl_xor_sync(0xffffffffu, nnz, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) { sm[warp] = m; sn[warp] = nan; sc[warp] = nnz; }
  __syncthreads();
  m = sm[0]; nan = sn[0]; nnz = sc[0];
#pragma unroll
  for (int j = 1; j < kThreads / 32; ++j) {
    m = fmaxf(m, sm[j]); nan |= sn[j]; nnz += sc[j];
  }
  __syncthreads();
}

// The chunk's tern sum in the documented order (lanes, then the halving
// tree); the result is in lanes[0] for every thread.
__device__ __forceinline__ float lane_tree(float (&acc)[4], int a,
                                           float* lanes) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lanes[(4 * (int)threadIdx.x - a + e) & (kLanes - 1)] = acc[e];
  }
  __syncthreads();
#pragma unroll
  for (int h = kLanes / 2; h > 0; h >>= 1) {
    for (int l = threadIdx.x; l < h; l += kThreads) {
      lanes[l] = lanes[l] + lanes[l + h];
    }
    __syncthreads();
  }
  const float total = lanes[0];
  __syncthreads();
  return total;
}

// max |v| (NaN aside, flagged), nnz and the lane sums of the registers.
template <int MODE>
__device__ __forceinline__ float reduce_chunk(const float (&v)[kVecs][4],
                                              int a, long long len,
                                              float* lanes, float& m,
                                              int& nan, int& nnz) {
  m = 0.0f; nan = 0; nnz = 0;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!valid(i, e, a, len)) continue;
      const float av = fabsf(v[i][e]);
      if (MODE == kInt8) {
        nan |= isnan(av);
        m = fmaxf(m, av);
      } else {
        nnz += v[i][e] != 0.0f;
        acc[e] = acc[e] + av;
      }
    }
  }
  block_reduce(m, nan, nnz);
  return MODE == kTern ? lane_tree(acc, a, lanes) : 0.0f;
}

__device__ __forceinline__ float scale_of(int mode, float m, int nan,
                                          int nnz, float total,
                                          const Args& a) {
  if (mode == kInt8) {
    return __fmaf_rn(nan ? __int_as_float(0x7fc00000) : m, a.rcp127, a.eps);
  }
  if (mode == kTern) {
    return __fdiv_rn(total, __int2float_rn(nnz > 1 ? nnz : 1));
  }
  return 0.0f;
}

// A chunk's (max, nan, nnz, lane sums) straight from memory, the order of
// reduce_chunk's, holding no chunk (the first launch of a long segment).
template <int MODE>
__device__ __forceinline__ float reduce_stream(const float* base,
                                               long long len, int a,
                                               float* lanes, float& m,
                                               int& nan, int& nnz) {
  m = 0.0f; nan = 0; nnz = 0;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float4* ab = reinterpret_cast<const float4*>(
      reinterpret_cast<uintptr_t>(base) - 4 * a);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long p0 = 4LL * (threadIdx.x + kThreads * i) - a;
    float v[4];
    if (p0 >= 0 && p0 + 3 < len) {
      const float4 t = ab[threadIdx.x + kThreads * i];
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = (p0 + e >= 0 && p0 + e < len) ? base[p0 + e] : 0.0f;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float av = fabsf(v[e]);   // +0 outside the chunk
      if (MODE == kInt8) {
        nan |= isnan(av);
        m = fmaxf(m, av);
      } else {
        nnz += v[e] != 0.0f;
        acc[e] = acc[e] + av;
      }
    }
  }
  block_reduce(m, nan, nnz);
  return MODE == kTern ? lane_tree(acc, a, lanes) : 0.0f;
}

// Four elements' worth of one output (T of 1, 2 or 4 bytes) at dst: one
// 4, 8 or 16-byte store where all four are valid and dst allows it, else
// element stores, else (a frame tail's odd offsets) byte stores.
template <typename T, typename V>
__device__ __forceinline__ void put4(unsigned char* dst, const T (&val)[4],
                                     bool full, const bool (&ok)[4]) {
  if (full && aligned(dst, sizeof(V))) {
    union { T e[4]; V v; } u;
#pragma unroll
    for (int e = 0; e < 4; ++e) u.e[e] = val[e];
    *reinterpret_cast<V*>(dst) = u.v;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!ok[e]) continue;
    unsigned char* p = dst + e * sizeof(T);
    if (aligned(p, sizeof(T))) {
      *reinterpret_cast<T*>(p) = val[e];
    } else {
      union { T t; unsigned char b[sizeof(T)]; } u;
      u.t = val[e];
#pragma unroll
      for (int b = 0; b < (int)sizeof(T); ++b) p[b] = u.b[b];
    }
  }
}

// rint(v / s) with v / s rounded first (__fdiv_rn), from the product with
// r = __frcp_rn(s): where |v * r| <= 128 it lies within 2^-16 of v / s, so
// unless it is within 2^-14 of a half-integer both round to the same
// integer; there, beyond 128 and for a NaN the division decides.
__device__ __forceinline__ float int8_quotient(float v, float s, float r) {
  const float qa = __fmul_rn(v, r);
  const float off = fabsf(qa - floorf(qa) - 0.5f);
  if (off > 0x1p-14f && fabsf(qa) <= 128.0f) return rintf(qa);
  return rintf(__fdiv_rn(v, s));
}

template <int MODE, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
segment_quantize_kernel(Args args) {
  __shared__ float lanes[kLanes];
  const long long w = blockIdx.x;
  const int row = blockIdx.y;
  const Work wk = find_work(args, w);
  if (PARTIAL && wk.n_chunks == 1) return;   // reduced in the second pass
  const float* xrow = args.x + row * args.x_stride;
  const float* base = xrow + wk.lo;
  const int a = (int)((reinterpret_cast<uintptr_t>(base) >> 2) & 3);
  float v[kVecs][4];
  float s = 0.0f;
  if (MODE == kInt8 || MODE == kTern) {
    float m, total = 0.0f;
    int nan, nnz;
    if (PARTIAL) {
      total = reduce_stream<MODE>(base, wk.len, a, lanes, m, nan, nnz);
      if (threadIdx.x == 0) {
        args.partial[(long long)row * args.n_work + w] = make_float4(
            total, nan ? __int_as_float(0x7fc00000) : m,
            __int_as_float(nnz), 0.0f);
      }
      return;
    }
    if (wk.n_chunks == 1) {
      load_chunk(base, wk.len, a, v);
      total = reduce_chunk<MODE>(v, a, wk.len, lanes, m, nan, nnz);
    } else {
      // combine the segment's chunk partials before loading the chunk:
      // max and nnz in any order, the sum left to right in chunk order
      const float4* part =
          args.partial + (long long)row * args.n_work + wk.first;
      m = 0.0f; nan = 0; nnz = 0;
      for (long long c = threadIdx.x; c < wk.n_chunks; c += kThreads) {
        const float4 p = part[c];
        nan |= isnan(p.y);
        m = fmaxf(m, p.y);
        nnz += __float_as_int(p.z);
      }
      block_reduce(m, nan, nnz);
      if (MODE == kTern) {
        for (long long t0 = 0; t0 < wk.n_chunks; t0 += kLanes) {
          const int n = (int)(wk.n_chunks - t0 < kLanes ? wk.n_chunks - t0
                                                        : kLanes);
          for (int c = threadIdx.x; c < n; c += kThreads) {
            lanes[c] = part[t0 + c].x;
          }
          __syncthreads();
          if (threadIdx.x == 0) {
            int c = 0;
            if (t0 == 0) total = lanes[c++];
            // sixteen shared-memory loads in flight ahead of each stretch
            // of the chain of adds
            for (; c + 16 <= n; c += 16) {
              float b[16];
#pragma unroll
              for (int j = 0; j < 16; ++j) b[j] = lanes[c + j];
#pragma unroll
              for (int j = 0; j < 16; ++j) total = total + b[j];
            }
            for (; c < n; ++c) total = total + lanes[c];
          }
          __syncthreads();
        }
        if (threadIdx.x == 0) lanes[0] = total;
        __syncthreads();
        total = lanes[0];
      }
      load_chunk(base, wk.len, a, v);
    }
    s = scale_of(MODE, m, nan, nnz, total, args);
  } else {
    load_chunk(base, wk.len, a, v);
  }
  if (PARTIAL) return;                        // bf16 and none reduce nothing
  if (args.scales != nullptr && wk.lo == wk.seg_lo && threadIdx.x == 0) {
    args.scales[(long long)row * args.n_seg + wk.seg] = s;
  }

  const float r = __frcp_rn(s);
  float* dqrow = args.dq ? args.dq + row * args.dq_stride + wk.lo : nullptr;
  unsigned char* crow =
      args.codes ? args.codes + row * args.code_stride : nullptr;
  const bool element = crow != nullptr && args.code_form == kElementCodes;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const long long p0 = 4LL * (threadIdx.x + kThreads * i) - a;
    if (p0 + 3 < 0 || p0 >= wk.len) continue;
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) ok[e] = p0 + e >= 0 && p0 + e < wk.len;
    const bool full = ok[0] && ok[3];
    const long long q0 = wk.lo + p0;          // row position of element 0
    float d[4];
    if (MODE == kBf16) {
      uint16_t c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 b = __float2bfloat16_rn(v[i][e]);
        c[e] = __bfloat16_as_ushort(b);
        d[e] = __bfloat162float(b);
      }
      if (element) put4<uint16_t, uint2>(crow + 2 * q0, c, full, ok);
    } else if (MODE == kInt8 || MODE == kTern) {
      int8_t c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float q;
        if (MODE == kInt8) {
          q = int8_quotient(v[i][e], s, r);
          q = q > 127.0f ? 127.0f : q;       // NaN passes through
          q = q < -127.0f ? -127.0f : q;
          c[e] = isnan(q) ? (int8_t)0 : (int8_t)q;
        } else {
          q = (float)((v[i][e] > 0.0f) - (v[i][e] < 0.0f));
          c[e] = (int8_t)q;
        }
        d[e] = __fmul_rn(q, s);
      }
      if (element) put4<int8_t, uint32_t>(crow + q0, c, full, ok);
    } else {                                  // none: the raw f32 bytes
      uint32_t c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = __float_as_uint(v[i][e]);
      if (crow != nullptr) put4<uint32_t, uint4>(crow + 4 * q0, c, full, ok);
    }
    if (dqrow != nullptr && MODE != kNone) {
      uint32_t bits[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) bits[e] = __float_as_uint(d[e]);
      put4<uint32_t, uint4>(reinterpret_cast<unsigned char*>(dqrow + p0),
                            bits, full, ok);
    }
    if (args.idx != nullptr) {                // B = 1: the frame's indices
      int ix[4];
      const int* src = args.idx + q0;
      if (full && aligned(src, 16)) {
        const int4 t = *reinterpret_cast<const int4*>(src);
        ix[0] = t.x; ix[1] = t.y; ix[2] = t.z; ix[3] = t.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) ix[e] = ok[e] ? src[e] : 0;
      }
      unsigned char* dst = args.idx_out + (long long)args.idx_width * q0;
      if (args.idx_width == 1) {
        uint8_t n[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) n[e] = (uint8_t)ix[e];
        put4<uint8_t, uint32_t>(dst, n, full, ok);
      } else if (args.idx_width == 2) {
        uint16_t n[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) n[e] = (uint16_t)ix[e];
        put4<uint16_t, uint2>(dst, n, full, ok);
      } else {
        uint32_t n[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) n[e] = (uint32_t)ix[e];
        put4<uint32_t, uint4>(dst, n, full, ok);
      }
    }
  }

  if (MODE == kTern && crow != nullptr && args.code_form == kPackedCodes) {
    // the bytes whose first code lies in this chunk
    const long long b_lo = (wk.lo + 3) >> 2, b_hi = (wk.lo + wk.len + 3) >> 2;
    for (long long b = b_lo + threadIdx.x; b < b_hi; b += kThreads) {
      unsigned byte = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long q = 4 * b + e;
        if (q < args.k) {
          const float t = xrow[q];
          byte |= (unsigned)(((t > 0.0f) - (t < 0.0f)) & 3) << (2 * e);
        }
      }
      crow[b] = (unsigned char)byte;
    }
  }
}

template <int MODE>
cudaError_t launch(const Args& a, int rows, int multi, cudaStream_t stream) {
  const dim3 grid((unsigned)a.n_work, (unsigned)rows);
  if (multi) {
    segment_quantize_kernel<MODE, true><<<grid, kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  segment_quantize_kernel<MODE, false><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One segmented quantize of a (rows, k) batch; two launches when `multi`
// (a segment longer than a chunk: `partial` holds rows * n_work float4).
extern "C" int segment_quantize(
    const void* x, long long x_stride, int rows, long long k,
    const void* seg_end, const void* chunk_start, int n_seg, int n_work,
    int multi, int mode, float rcp127, float eps, void* scales, void* dq,
    long long dq_stride, void* codes, long long code_stride, int code_form,
    const void* idx, void* idx_out, int idx_width, void* partial,
    void* stream) {
  if (rows == 0 || n_work == 0) return 0;
  Args a;
  a.x = (const float*)x;
  a.x_stride = x_stride;
  a.k = k;
  a.seg_end = (const long long*)seg_end;
  a.chunk_start = (const long long*)chunk_start;
  a.n_seg = n_seg;
  a.n_work = n_work;
  a.rcp127 = rcp127;
  a.eps = eps;
  a.scales = (float*)scales;
  a.dq = (float*)dq;
  a.dq_stride = dq_stride;
  a.codes = (unsigned char*)codes;
  a.code_stride = code_stride;
  a.code_form = code_form;
  a.idx = (const int*)idx;
  a.idx_out = (unsigned char*)idx_out;
  a.idx_width = idx_width;
  a.partial = (float4*)partial;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (mode) {
    case kNone: err = launch<kNone>(a, rows, 0, s); break;
    case kBf16: err = launch<kBf16>(a, rows, 0, s); break;
    case kInt8: err = launch<kInt8>(a, rows, multi, s); break;
    case kTern: err = launch<kTern>(a, rows, multi, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
