// Per-block top-r by magnitude: for each block of 1024 elements, the r
// largest |x|, ties to the lower index, as signed values and block-local
// indices, in descending order of |x|.
//
// Replaces: src/repro/kernels/block_topk.py, _kernel / block_topk_2d.
//
// The TPU kernel runs r unrolled (argmax, mask) sweeps over a VMEM block:
// O(r * 1024) work, which is cheap for small r and 1024 sweeps for the
// r = 1024 that BlockwiseEngine._plan gives every leaf with k >= 1024.  On
// Hopper the bound is memory: read the block once (4 KB) and write r values
// and r indices (8r bytes).  The work must follow r and stay near that.
//
// |x| is the sign-cleared bit pattern, whose integer order is the float
// order for non-negative values (denormals included) and which maps -0 to
// +0.  The order wanted -- |x| descending, then index ascending -- is the
// ascending order of one 64-bit key per element,
//   (0x7fffffff - |x|) << 32 | index << 1 | sign,
// whose low bit carries the sign back (indices are distinct, so it never
// decides a comparison): a sorted key is decoded to value and index without
// reading x again.
//
// Design: one warp per block, several warps (blocks) per CTA, and no
// barrier wider than a warp.  Each lane loads 32 elements with eight 16-byte
// loads (element 128 q + 4 lane + c in register 4 q + c).  Two regimes by r,
// both exact:
//
// * r <= 64, select: find T, the r-th largest |x|, with warp reductions
//   (__reduce_max_sync, __reduce_add_sync) and no histogram: walk down the
//   exponents present from the largest until r elements lie at or above an
//   exponent's floor (one step for most blocks), then halve that interval
//   until the elements at or above its floor fit 64 candidate slots (128
//   for r > 32), or it is the single value T.  The candidates -- every |x|
//   at or above the floor, or, when many ties sit at T, every |x| > T plus
//   the lowest-index ties, picked from a 1024-bit mask by one popcount
//   scan -- go to shared memory and a register bitonic sort of 64 or 128
//   keys; the first r are the answer.  The work is a few passes over 32
//   registers per lane whatever r is.
// * r > 64, sort: the whole block is the answer's prefix.  Each lane sorts
//   its 32 keys in registers (a bitonic network, no shuffles); then five
//   rounds merge runs of 32, 64, ... 512 pairwise through a per-warp
//   shared-memory buffer.  In a round each lane makes 32 consecutive
//   outputs of its pair's merge: a binary search on the merge path finds
//   where they start, then 32 steps each take the smaller head, the heads
//   loaded a step ahead.  That is n log n comparisons where a bitonic
//   network of the block needs n log^2 n / 2 (55 stages).  The first r
//   positions go out row-major, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarpsPerCta = 4;
constexpr int kSelectMaxR = 64;
constexpr unsigned kFull = 0xffffffffu;

// block-local index of register j of this lane
__device__ __forceinline__ int elem(int j, int lane) {
  return 128 * (j >> 2) + 4 * lane + (j & 3);
}

__device__ __forceinline__ unsigned mag_of(unsigned bits) {
  return bits & 0x7fffffffu;
}

__device__ __forceinline__ unsigned long long make_key(unsigned bits, int i) {
  return ((unsigned long long)(0x7fffffffu - mag_of(bits)) << 32) |
         ((unsigned)i << 1) | (bits >> 31);
}

__device__ __forceinline__ void emit(unsigned long long key,
                                     float* __restrict__ vals,
                                     int32_t* __restrict__ idx, long long o) {
  const unsigned lo = (unsigned)key;
  const unsigned mag = 0x7fffffffu - (unsigned)(key >> 32);
  vals[o] = __uint_as_float(mag | (lo << 31));
  idx[o] = (int32_t)(lo >> 1);
}

__device__ __forceinline__ void load_block(const float* __restrict__ xb,
                                           unsigned (&bits)[32], int lane) {
  if ((reinterpret_cast<uintptr_t>(xb) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xb);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = __ldg(x4 + 32 * q + lane);
      bits[4 * q + 0] = __float_as_uint(v.x);
      bits[4 * q + 1] = __float_as_uint(v.y);
      bits[4 * q + 2] = __float_as_uint(v.z);
      bits[4 * q + 3] = __float_as_uint(v.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      bits[j] = __float_as_uint(__ldg(xb + elem(j, lane)));
  }
}

// Order the pair (a, b): ascending or descending.
__device__ __forceinline__ void order(unsigned long long& a,
                                      unsigned long long& b, bool ascending) {
  if ((a > b) == ascending) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }
}

// Ascending bitonic sort of the 32 * NREG keys (NREG = 2 or 4) at positions
// NREG * lane + j: strides below NREG pair a lane's own registers, the
// larger ones lanes (__shfl_xor_sync).
template <int NREG>
__device__ __forceinline__ void warp_bitonic_sort(unsigned long long (&k)[NREG],
                                                  int lane) {
  static_assert(NREG == 2 || NREG == 4, "NREG must be 2 or 4");
  constexpr int kLog = NREG == 2 ? 6 : 7;
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride < NREG) {  // partner in this lane's own registers
#pragma unroll
        for (int j = 0; j < NREG; ++j) {
          if (j & stride) continue;
          order(k[j], k[j | stride],
                size < NREG ? (j & size) == 0 : (lane & (size / NREG)) == 0);
        }
      } else {  // partner in lane ^ (stride / NREG), same register
        const bool lower = (lane & (stride / NREG)) == 0;
        const bool ascending = (lane & (size / NREG)) == 0;
#pragma unroll
        for (int j = 0; j < NREG; ++j) {
          const unsigned long long o =
              __shfl_xor_sync(kFull, k[j], stride / NREG);
          // the lower position keeps the smaller key when ascending
          if ((o < k[j]) == (lower == ascending)) k[j] = o;
        }
      }
    }
  }
}

// Ascending bitonic sort of a lane's own 32 keys, in registers.
__device__ __forceinline__ void lane_sort32(unsigned long long (&k)[32]) {
#pragma unroll
  for (int ls = 1; ls <= 5; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j & (1 << lt)) continue;
        order(k[j], k[j | (1 << lt)], (j & (1 << ls)) == 0);
      }
    }
  }
}

// A warp's 1024 keys in shared memory, entry p at p + p / 32: lane-major
// (32 lane + j) and row-major (32 j + lane) accesses meet no bank conflict.
__device__ __forceinline__ int slot(int p) { return p + (p >> 5); }

// One block through the sort regime (see the top of the file).
__device__ __forceinline__ void sort_block(const unsigned (&bits)[32], int lane,
                                           unsigned long long* buf,
                                           float* __restrict__ vals,
                                           int32_t* __restrict__ idx,
                                           long long base, int r) {
  unsigned long long key[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) key[j] = make_key(bits[j], elem(j, lane));
  lane_sort32(key);
#pragma unroll
  for (int j = 0; j < 32; ++j) buf[slot(32 * lane + j)] = key[j];
  __syncwarp();
#pragma unroll 1
  for (int k = 0; k < 5; ++k) {
    const int len = 32 << k;                      // run length
    const int first = (lane >> (k + 1)) * 2 * len;  // this pair's run A
    const int o = 32 * (lane & ((2 << k) - 1));   // outputs before this lane's
    // i = how many of the first o outputs come from A
    int lo_i = o > len ? o - len : 0, hi_i = o < len ? o : len;
    while (lo_i < hi_i) {
      const int mid = (lo_i + hi_i) >> 1;
      if (buf[slot(first + mid)] < buf[slot(first + len + o - 1 - mid)])
        lo_i = mid + 1;
      else
        hi_i = mid;
    }
    // the two heads and the entries behind them, loaded one step ahead so
    // a step waits on no load unless it takes one run's head twice running
    const unsigned long long* run_a = buf + slot(first);
    const unsigned long long* run_b = buf + slot(first + len);
    int i = lo_i, j = o - lo_i;
    unsigned long long a = i < len ? run_a[slot(i)] : ~0ull;
    unsigned long long b = j < len ? run_b[slot(j)] : ~0ull;
    unsigned long long a2 = i + 1 < len ? run_a[slot(i + 1)] : ~0ull;
    unsigned long long b2 = j + 1 < len ? run_b[slot(j + 1)] : ~0ull;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const bool take_a = a < b;
      key[t] = take_a ? a : b;
      i += take_a ? 1 : 0;
      j += take_a ? 0 : 1;
      const int n = (take_a ? i : j) + 1;
      const unsigned long long ahead =
          n < len ? (take_a ? run_a : run_b)[slot(n)] : ~0ull;
      a = take_a ? a2 : a;
      b = take_a ? b : b2;
      a2 = take_a ? ahead : a2;
      b2 = take_a ? b2 : ahead;
    }
    __syncwarp();  // every lane has read its heads before the round's writes
#pragma unroll
    for (int t = 0; t < 32; ++t) buf[slot(32 * lane + t)] = key[t];
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int e = 32 * j + lane;
    if (e < r) emit(buf[slot(e)], vals, idx, base + e);
  }
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
block_topk_sort_kernel(const float* __restrict__ x, float* __restrict__ vals,
                       int32_t* __restrict__ idx, long long nb, int r) {
  __shared__ unsigned long long buf_all[kWarpsPerCta][kBlock + 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarpsPerCta + w;
  if (b >= nb) return;
  unsigned bits[32];
  load_block(x + b * kBlock, bits, lane);
  sort_block(bits, lane, buf_all[w], vals, idx, b * r, r);
}

// This warp's count of elements with |x| >= x.
__device__ __forceinline__ unsigned count_at_least(const unsigned (&bits)[32],
                                                   unsigned x) {
  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) c += mag_of(bits[j]) >= x ? 1u : 0u;
  return __reduce_add_sync(kFull, c);
}

// One block through the select regime: NREG candidate keys per lane, so
// 32 NREG candidate slots in this warp's `cand`, and r <= 16 NREG.
template <int NREG>
__device__ __forceinline__ void select_block(const unsigned (&bits)[32],
                                             int lane,
                                             unsigned long long* cand,
                                             unsigned* ties, unsigned* ncand,
                                             float* __restrict__ vals,
                                             int32_t* __restrict__ idx,
                                             long long base, int r) {
  constexpr unsigned kCand = 32 * NREG;
  const unsigned rr = (unsigned)r;

  // 1. The exponent of T, the r-th largest |x|: walk down the exponents
  // present, from the largest, until r elements lie at or above one's floor.
  // Invariant from here on: count(|x| >= lo) = c_lo >= r > c_hi =
  // count(|x| >= hi).
  unsigned top = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) top = max(top, mag_of(bits[j]));
  unsigned lo = __reduce_max_sync(kFull, top) & 0x7f800000u;
  unsigned c_lo, c_hi = 0;
  for (;;) {
    unsigned c = 0, below = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned m = mag_of(bits[j]);
      c += m >= lo ? 1u : 0u;
      below = m < lo ? max(below, m) : below;
    }
    c_lo = __reduce_add_sync(kFull, c);
    if (c_lo >= rr) break;
    c_hi = c_lo;
    lo = __reduce_max_sync(kFull, below) & 0x7f800000u;
  }
  unsigned hi = lo + 0x00800000u;

  // 2. Too many candidates (|x| >= lo): halve [lo, hi) until they fit or
  // the interval is the single value T (lo itself first: a power of two,
  // zero or the all-equal block).
  if (c_lo > kCand) {
    const unsigned c_gt = count_at_least(bits, lo + 1);
    if (c_gt < rr) {
      hi = lo + 1;
      c_hi = c_gt;
    }
  }
  while (c_lo > kCand && hi - lo > 1) {
    const unsigned mid = lo + (hi - lo) / 2;
    const unsigned c = count_at_least(bits, mid);
    if (c >= rr) {
      lo = mid;
      c_lo = c;
    } else {
      hi = mid;
      c_hi = c;
    }
  }

  // 3. The candidates: every |x| >= lo when they fit.  Else lo is T, and
  // the r winners are every |x| > T plus the lowest-index r - c_hi ties at
  // T, picked from a 1024-bit mask by one popcount scan.
  const bool fits = c_lo <= kCand;
  if (!fits) {
    ties[lane] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (mag_of(bits[j]) == lo) {
        const int i = elem(j, lane);
        atomicOr(&ties[i >> 5], 1u << (i & 31));
      }
    }
    __syncwarp();
    unsigned word = ties[lane];
    const unsigned c = __popc(word);
    unsigned excl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, excl, o);
      if (lane >= o) excl += v;
    }
    excl -= c;
    const unsigned need = rr - c_hi;
    unsigned kept = 0;
    for (unsigned take = need > excl ? need - excl : 0; take > 0 && word;
         --take) {
      const unsigned low = word & (0u - word);
      kept |= low;
      word ^= low;
    }
    ties[lane] = kept;
  }
  if (lane == 0) *ncand = 0;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned m = mag_of(bits[j]);
    const int i = elem(j, lane);
    const bool take = fits ? m >= lo
                           : m > lo || (m == lo &&
                                        ((ties[i >> 5] >> (i & 31)) & 1u));
    if (take) cand[atomicAdd(ncand, 1u)] = make_key(bits[j], i);
  }
  __syncwarp();

  // 4. Sort the candidates; the first r are the answer.
  const unsigned n = fits ? c_lo : rr;
  unsigned long long key[NREG];
#pragma unroll
  for (int q = 0; q < NREG; ++q) {
    const unsigned e = NREG * lane + q;
    key[q] = e < n ? cand[e] : ~0ull;
  }
  warp_bitonic_sort<NREG>(key, lane);
#pragma unroll
  for (int q = 0; q < NREG; ++q) {
    const int e = NREG * lane + q;
    if (e < r) emit(key[q], vals, idx, base + e);
  }
}

template <int NREG>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
block_topk_select_kernel(const float* __restrict__ x, float* __restrict__ vals,
                         int32_t* __restrict__ idx, long long nb, int r) {
  __shared__ unsigned long long cand_all[kWarpsPerCta][32 * NREG];
  __shared__ unsigned ties_all[kWarpsPerCta][32];
  __shared__ unsigned ncand_all[kWarpsPerCta];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarpsPerCta + w;
  if (b >= nb) return;
  unsigned bits[32];
  load_block(x + b * kBlock, bits, lane);
  select_block<NREG>(bits, lane, cand_all[w], ties_all[w], &ncand_all[w],
                     vals, idx, b * r, r);
}

}  // namespace

extern "C" int block_topk(const void* x, void* vals, void* idx, long long nb,
                          int r, void* stream) {
  if (nb == 0) return 0;
  if (r < 1 || r > kBlock) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((nb + kWarpsPerCta - 1) / kWarpsPerCta);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  if (r <= 32) {
    block_topk_select_kernel<2><<<grid, kWarpsPerCta * 32, 0, s>>>(
        xf, (float*)vals, (int32_t*)idx, nb, r);
  } else if (r <= kSelectMaxR) {
    block_topk_select_kernel<4><<<grid, kWarpsPerCta * 32, 0, s>>>(
        xf, (float*)vals, (int32_t*)idx, nb, r);
  } else {
    block_topk_sort_kernel<<<grid, kWarpsPerCta * 32, 0, s>>>(
        xf, (float*)vals, (int32_t*)idx, nb, r);
  }
  return (int)cudaGetLastError();
}
