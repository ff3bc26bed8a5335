// Per-block top-r by magnitude: for each block of 1024 elements, the r
// largest |x|, ties to the lower index, as signed values and block-local
// indices, in descending order of |x|.  And, at the end of the file, the
// row regime: a row's exact top-k in one pass (row_topk), and the
// SAMomentum step around it in the same pass (samomentum_row_topk).
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

// ---------------------------------------------------------------------------
// The row regime: row_topk
//
// Replaces no TPU kernel.  It is the row-length regime of this file's block
// top-k together with its candidate combine (src/repro/kernels/ops.py,
// hierarchical_topk: block winners, then lax.top_k over them): for a row of
// at most kRowMax elements, the exact top-k by |x| of the whole row in one
// pass, with the same answer as the hierarchy at r >= k -- signed values and
// row-local indices, |x| descending, ties to the lower index, |x| the
// sign-cleared bit pattern (-0 ties +0, denormals by magnitude, NaN above
// inf).
//
// Why: the exchange's rows are short (4,096 to 8,192 elements) and its k
// large (5% of a row), where the hierarchy pads each row to whole groups of
// 8 blocks, fully sorts every block (r > kSelectMaxR) and then sorts some
// 40% of the row again as candidates.  The bound is 4n bytes read and 8k
// written a row; this kernel reads the row once and keeps it in registers.
//
// Design: one CTA a row (a row of at most 512 elements is one warp), 16
// elements a thread, loaded with 16-byte loads where the row allows
// (element 4 (T q + t) + c in register 4 q + c, T threads).  Padding past n
// reads as +0 at an index >= n: it can tie only with zeros, after every real
// one in index order, so it is never chosen (k <= n).
//
// 1. T, the k-th largest |x|, by a radix select over the 31 magnitude bits.
//    The exponent first: walk down the exponents present from the largest,
//    two exponents' floors a pass (block reductions of two counts and of
//    the largest |x| below them), usually one pass.  Then the 23 mantissa
//    bits in three digits (8, 8, 7): a shared histogram of the keys still
//    in the band [lo, hi) -- few, so the atomics rarely meet -- which every
//    warp scans for the digit itself (one barrier a pass).  Stop as soon as
//    count(|x| >= lo) is exactly k: usually after one or two digits.
// 2. Ties at T: if more than k lie at or above T, every |x| > T plus the
//    lowest-index k - count(> T) ties, picked from a bit mask of the row by
//    one block-wide scan of its words' popcounts.
// 3. The k winners as this file's 64-bit keys, compacted in any order into
//    dynamic shared memory, then put in order.  Up to 4 a thread: into 512
//    buckets by |x| (top - |x|, shifted to fit), a scan of the bucket
//    counts, each winner placed in its bucket's range and ranked there
//    against the few others -- O(k) work where a sorting network takes
//    O(k log^2 k).  A bucket of more than 32 (ties, few distinct values),
//    or more than 4 winners a thread, takes a bitonic network in shared
//    memory over P, the next power of two, instead.
//
// On an H100 the time goes to the dependent steps between barriers more
// than to the bytes: the rows' loads alone run near the bound, and the
// digit passes, the compaction and the ordering follow them; three CTAs an
// SM (40 registers, a few spilled) beat two (PERF.md, row 3).

constexpr int kRowMax = 8192;              // the longest row a CTA holds
constexpr int kRowPerThread = 16;          // elements a thread
constexpr int kRowThreads = kRowMax / kRowPerThread;
constexpr int kRowMinBlocks = 3;           // CTAs of kRowThreads an SM
constexpr int kKeysPerThread = 4;          // the bucket sort's winners
constexpr int kRowWords = kRowMax / 32;    // tie mask words
constexpr int kBuckets = 512;              // the winners' buckets
constexpr int kBucketLog = 9;
constexpr unsigned kBucketMax = 32;        // beyond it the bitonic sort

struct RowShared {
  unsigned hist[3][256];     // one histogram a mantissa digit
  unsigned ties[kRowWords];  // tie bits in index order
  alignas(16) unsigned bucket[kBuckets];   // winners a bucket, then starts
  unsigned red[2][3][32];    // [parity][sum, sum, max][warp]
  unsigned count;            // keys placed
  unsigned bmax;             // the fullest bucket
};

// Sums of `a` and `b` and max of `mx` over the CTA, returned in place.
// `parity` alternates the scratch so that one barrier a reduction suffices.
__device__ __forceinline__ void block_reduce(unsigned& a, unsigned& b,
                                             unsigned& mx, RowShared& sh,
                                             int& parity, int lane, int warp,
                                             int nwarps) {
  const unsigned sa = __reduce_add_sync(kFull, a);
  const unsigned sb = __reduce_add_sync(kFull, b);
  const unsigned m = __reduce_max_sync(kFull, mx);
  if (lane == 0) {
    sh.red[parity][0][warp] = sa;
    sh.red[parity][1][warp] = sb;
    sh.red[parity][2][warp] = m;
  }
  __syncthreads();
  const bool in = lane < nwarps;
  a = __reduce_add_sync(kFull, in ? sh.red[parity][0][lane] : 0u);
  b = __reduce_add_sync(kFull, in ? sh.red[parity][1][lane] : 0u);
  mx = __reduce_max_sync(kFull, in ? sh.red[parity][2][lane] : 0u);
  parity ^= 1;
}

// Ascending bitonic sort of P (a power of two) keys in shared memory.  A
// stage of stride s <= 32 pairs keys inside the 64 that one warp's 32
// consecutive pairs cover, so only a stage of stride >= 64, or one right
// after it, needs the whole CTA's barrier.
__device__ __forceinline__ void bitonic_sort_shared(unsigned long long* keys,
                                                    int P, int t,
                                                    int nthreads) {
  const int pairs = P >> 1;
  int prev = 0;
  for (int size = 2; size <= P; size <<= 1) {
    for (int s = size >> 1; s > 0; s >>= 1) {
      if (s >= 64 || prev >= 64)
        __syncthreads();
      else
        __syncwarp();
      for (int p = t; p < pairs; p += nthreads) {
        const int i = ((p & ~(s - 1)) << 1) | (p & (s - 1));
        unsigned long long a = keys[i], b = keys[i + s];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[i + s] = a;
        }
      }
      prev = s;
    }
  }
  __syncthreads();
}

// Element j of thread t's 16 in a row of T threads: 4 (T q + t) + c, with
// j = 4 q + c (16-byte loads cover a thread's four consecutive elements).
__device__ __forceinline__ int row_elem(int j, int t, int nthreads) {
  return 4 * (nthreads * (j >> 2) + t) + (j & 3);
}

// The two ends of the row core (row_select), as a policy: what a thread's
// 16 elements are, the answer for an all-zero row, and what is written
// back once each thread knows which of its elements won.

// row_topk: the row of x read, nothing written back.
struct TopkRow {
  const float* xr;

  __device__ __forceinline__ void load(unsigned (&bits)[kRowPerThread],
                                       int n, int t, int nthreads) const {
    if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0 && (n & 3) == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll
      for (int q = 0; q < kRowPerThread / 4; ++q) {
        const int e = row_elem(4 * q, t, nthreads);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < n) v = __ldg(x4 + (e >> 2));
        bits[4 * q + 0] = __float_as_uint(v.x);
        bits[4 * q + 1] = __float_as_uint(v.y);
        bits[4 * q + 2] = __float_as_uint(v.z);
        bits[4 * q + 3] = __float_as_uint(v.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowPerThread; ++j) {
        const int e = row_elem(j, t, nthreads);
        bits[j] = e < n ? __float_as_uint(__ldg(xr + e)) : 0u;
      }
    }
  }

  // an all-zero row: its first k elements, in index order
  __device__ __forceinline__ void zero_row(
      const unsigned (&)[kRowPerThread], float* __restrict__ vals,
      int32_t* __restrict__ idx, long long out, int, int k, int t,
      int nthreads) const {
    for (int e = t; e < k; e += nthreads) {
      vals[out + e] = xr[e];
      idx[out + e] = e;
    }
  }

  __device__ __forceinline__ void store(const unsigned (&)[kRowPerThread],
                                        unsigned, int, int, int) const {}
};

// samomentum_row_topk: the row's accumulated velocity
// uacc = fma(m, u, lr * g) formed in registers (samomentum.cu's
// AccumulateOp, bit for bit), and the rescaled velocity
// sent ? uacc : uacc * (1/m) written back over `out`'s row, which may be
// u's own (in place: a thread writes only the elements it read).
struct SAMomentumRow {
  const float* u;
  const float* __restrict__ g;
  float* out;
  float m, lr, rcp_m;

  // 16-byte loads and stores where the three rows allow them
  __device__ __forceinline__ bool wide(int n) const {
    const uintptr_t mix = reinterpret_cast<uintptr_t>(u) |
                          reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(out);
    return (mix & 15) == 0 && (n & 3) == 0;
  }

  __device__ __forceinline__ unsigned acc(float uu, float gg) const {
    return __float_as_uint(__fmaf_rn(m, uu, __fmul_rn(lr, gg)));
  }

  __device__ __forceinline__ void load(unsigned (&bits)[kRowPerThread],
                                       int n, int t, int nthreads) const {
    if (wide(n)) {
      const float4* u4 = reinterpret_cast<const float4*>(u);
      const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll
      for (int q = 0; q < kRowPerThread / 4; ++q) {
        const int e = row_elem(4 * q, t, nthreads);
        if (e < n) {
          const float4 a = u4[e >> 2], b = __ldg(g4 + (e >> 2));
          bits[4 * q + 0] = acc(a.x, b.x);
          bits[4 * q + 1] = acc(a.y, b.y);
          bits[4 * q + 2] = acc(a.z, b.z);
          bits[4 * q + 3] = acc(a.w, b.w);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) bits[4 * q + c] = 0u;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowPerThread; ++j) {
        const int e = row_elem(j, t, nthreads);
        bits[j] = e < n ? acc(u[e], __ldg(g + e)) : 0u;
      }
    }
  }

  __device__ __forceinline__ float rescaled(unsigned b, bool sent) const {
    const float x = __uint_as_float(b);
    return sent ? x : __fmul_rn(x, rcp_m);
  }

  __device__ __forceinline__ void store(const unsigned (&bits)[kRowPerThread],
                                        unsigned chosen, int n, int t,
                                        int nthreads) const {
    if (wide(n)) {
      float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
      for (int q = 0; q < kRowPerThread / 4; ++q) {
        const int e = row_elem(4 * q, t, nthreads);
        if (e < n) {
          o4[e >> 2] = make_float4(
              rescaled(bits[4 * q + 0], (chosen >> (4 * q + 0)) & 1u),
              rescaled(bits[4 * q + 1], (chosen >> (4 * q + 1)) & 1u),
              rescaled(bits[4 * q + 2], (chosen >> (4 * q + 2)) & 1u),
              rescaled(bits[4 * q + 3], (chosen >> (4 * q + 3)) & 1u));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowPerThread; ++j) {
        const int e = row_elem(j, t, nthreads);
        if (e < n) out[e] = rescaled(bits[j], (chosen >> j) & 1u);
      }
    }
  }

  // an all-zero row: its first k elements win, in index order, from the
  // registers (uacc is not in memory)
  __device__ __forceinline__ void zero_row(
      const unsigned (&bits)[kRowPerThread], float* __restrict__ vals,
      int32_t* __restrict__ idx, long long out_at, int n, int k, int t,
      int nthreads) const {
    unsigned chosen = 0;
#pragma unroll
    for (int j = 0; j < kRowPerThread; ++j) {
      const int e = row_elem(j, t, nthreads);
      if (e < k) {
        vals[out_at + e] = __uint_as_float(bits[j]);
        idx[out_at + e] = e;
        chosen |= 1u << j;
      }
    }
    store(bits, chosen, n, t, nthreads);
  }
};

// The row core: the exact top-k by |x| of one row (blockIdx.x) of n
// elements read through `io`, into vals and idx from `out` on; see above.
template <class Io>
__device__ __forceinline__ void row_select(const Io& io,
                                           unsigned long long* keys,
                                           RowShared& sh,
                                           float* __restrict__ vals,
                                           int32_t* __restrict__ idx,
                                           long long out, int n, int k,
                                           int P) {
  const int t = threadIdx.x, nthreads = blockDim.x;
  for (int i = t; i < 3 * 256; i += nthreads) (&sh.hist[0][0])[i] = 0u;
  for (int i = t; i < kRowWords; i += nthreads) sh.ties[i] = 0u;
  for (int i = t; i < kBuckets; i += nthreads) sh.bucket[i] = 0u;
  if (t == 0) sh.count = 0u;

  auto elem = [&](int j) { return row_elem(j, t, nthreads); };
  unsigned bits[kRowPerThread];
  io.load(bits, n, t, nthreads);
  const int lane = t & 31, warp = t >> 5, nwarps = nthreads >> 5;
  const unsigned kk = (unsigned)k;
  int parity = 0;
  unsigned top = 0, none = 0, none2 = 0;
#pragma unroll
  for (int j = 0; j < kRowPerThread; ++j) top = max(top, mag_of(bits[j]));
  block_reduce(none, none2, top, sh, parity, lane, warp, nwarps);
  if (top == 0) {  // an all-zero row: its first k elements, in index order
    io.zero_row(bits, vals, idx, out, n, k, t, nthreads);
    return;
  }

  // 1. T's exponent.  From here on count(|x| >= lo) = c_lo >= k > c_hi =
  // count(|x| >= hi), and [lo, hi) is the band still to resolve.  A pass
  // counts at two exponents' floors, lo and the one below it.
  unsigned lo = top & 0x7f800000u, c_hi = 0, c_lo;
  for (;;) {
    const unsigned lo2 = lo > 0 ? lo - 0x00800000u : 0u;
    unsigned c = 0, c2 = 0, below = 0;
#pragma unroll
    for (int j = 0; j < kRowPerThread; ++j) {
      const unsigned m = mag_of(bits[j]);
      c += m >= lo ? 1u : 0u;
      c2 += m >= lo2 ? 1u : 0u;
      below = m < lo2 ? max(below, m) : below;
    }
    block_reduce(c, c2, below, sh, parity, lane, warp, nwarps);
    if (c >= kk) {
      c_lo = c;
      break;
    }
    if (c2 >= kk) {
      c_hi = c;
      c_lo = c2;
      lo = lo2;
      break;
    }
    c_hi = c2;
    lo = below & 0x7f800000u;
  }
  unsigned hi = lo + 0x00800000u;

  // then the mantissa, one digit a pass, until exactly k lie at or above
  // lo.  Every warp reads the histogram and finds the digit itself: the
  // next pass fills another histogram, so one barrier a pass.
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (c_lo == kk) break;
    const int shift = p == 0 ? 15 : (p == 1 ? 7 : 0);
    unsigned* hist = sh.hist[p];
#pragma unroll
    for (int j = 0; j < kRowPerThread; ++j) {
      const unsigned m = mag_of(bits[j]);
      if (m >= lo && m < hi) atomicAdd(&hist[(m - lo) >> shift], 1u);
    }
    __syncthreads();
    // lane l holds bins 32 q + l; the chunk of 32 bins holding the digit
    // first (from the top), then the lane
    unsigned h[8], tot[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      h[q] = hist[32 * q + lane];
      tot[q] = __reduce_add_sync(kFull, h[q]);
    }
    unsigned acc = c_hi, v = 0;
    int chunk = 0;
#pragma unroll
    for (int q = 7; q >= 0; --q) {
      if (acc + tot[q] >= kk) {
        chunk = q;
        v = h[q];
        break;
      }
      acc += tot[q];
    }
    unsigned incl = v;   // this lane's bin and every higher one of the chunk
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_down_sync(kFull, incl, o);
      if (lane + o < 32) incl += u;
    }
    const int at = 31 - __clz(__ballot_sync(kFull, acc + incl >= kk));
    const unsigned at_incl = __shfl_sync(kFull, incl, at);
    c_hi = acc + at_incl - __shfl_sync(kFull, v, at);
    c_lo = acc + at_incl;
    lo += (unsigned)(32 * chunk + at) << shift;
    hi = lo + (1u << shift);
  }

  // 2. More than k at or above lo: lo is T, and the lowest-index k - c_hi
  // ties at T join every |x| > T.
  const bool tie = c_lo > kk;
  if (tie) {
#pragma unroll
    for (int j = 0; j < kRowPerThread; ++j) {
      if (mag_of(bits[j]) == lo) {
        const int i = elem(j);
        atomicOr(&sh.ties[i >> 5], 1u << (i & 31));
      }
    }
    __syncthreads();
    const int nwords = nthreads * kRowPerThread / 32;
    unsigned word = t < nwords ? sh.ties[t] : 0u;
    const unsigned c = __popc(word);
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sh.red[parity][0][warp] = incl;
    __syncthreads();
    const unsigned before = __reduce_add_sync(
        kFull, lane < warp ? sh.red[parity][0][lane] : 0u);
    parity ^= 1;
    const unsigned excl = before + incl - c, need = kk - c_hi;
    unsigned take = need > excl ? min(need - excl, c) : 0u, kept = 0;
    for (; take > 0; --take) {
      const unsigned low = word & (0u - word);
      kept |= low;
      word ^= low;
    }
    if (t < nwords) sh.ties[t] = kept;
    __syncthreads();
  }

  // 3. The k winners' keys into shared memory, in any order, then sorted
  unsigned chosen = 0, cnt = 0;
#pragma unroll
  for (int j = 0; j < kRowPerThread; ++j) {
    const unsigned m = mag_of(bits[j]);
    const int i = elem(j);
    const bool take = tie ? m > lo || (m == lo &&
                                       ((sh.ties[i >> 5] >> (i & 31)) & 1u))
                          : m >= lo;
    chosen |= take ? 1u << j : 0u;
    cnt += take ? 1u : 0u;
  }
  unsigned incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  unsigned base = 0;
  if (lane == 31 && incl > 0) base = atomicAdd(&sh.count, incl);
  unsigned pos = __shfl_sync(kFull, base, 31) + incl - cnt;
#pragma unroll
  for (int j = 0; j < kRowPerThread; ++j)
    if ((chosen >> j) & 1u) keys[pos++] = make_key(bits[j], elem(j));
  io.store(bits, chosen, n, t, nthreads);
  __syncthreads();
  if (k <= kKeysPerThread * nthreads) {
    // up to kKeysPerThread winners a thread (e = t + q T), into buckets by
    // |x|, the largest first: bucket (top - |x|) >> sh_b of [0, kBuckets),
    // every winner lying in [lo, top]
    const unsigned w = 32 - __clz(top - lo);
    const unsigned sh_b = w > kBucketLog ? w - kBucketLog : 0;
    unsigned long long key[kKeysPerThread];
    unsigned b[kKeysPerThread], slot[kKeysPerThread];
#pragma unroll
    for (int q = 0; q < kKeysPerThread; ++q) {
      const int e = t + q * nthreads;
      key[q] = e < k ? keys[e] : ~0ull;
      b[q] = (top - (0x7fffffffu - (unsigned)(key[q] >> 32))) >> sh_b;
      slot[q] = e < k ? atomicAdd(&sh.bucket[b[q]], 1u) : 0u;
    }
    __syncthreads();
    if (warp == 0) {   // each bucket's start: an exclusive scan in place
      constexpr int kPer = kBuckets / 32;
      uint4* mine = reinterpret_cast<uint4*>(sh.bucket) + lane * (kPer / 4);
      unsigned c[kPer], sum = 0, most = 0;
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const uint4 v = mine[q];
        c[4 * q] = v.x;
        c[4 * q + 1] = v.y;
        c[4 * q + 2] = v.z;
        c[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        sum += c[q];
        most = max(most, c[q]);
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      unsigned run = incl - sum;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const unsigned cq = c[q];
        c[q] = run;
        run += cq;
      }
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q)
        mine[q] = make_uint4(c[4 * q], c[4 * q + 1], c[4 * q + 2],
                             c[4 * q + 3]);
      most = __reduce_max_sync(kFull, most);
      if (lane == 0) sh.bmax = most;
    }
    __syncthreads();
    if (sh.bmax <= kBucketMax) {
      // place each winner in its bucket's range, then rank it there
      unsigned long long* placed = keys + P;
#pragma unroll
      for (int q = 0; q < kKeysPerThread; ++q)
        if (t + q * nthreads < k) placed[sh.bucket[b[q]] + slot[q]] = key[q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kKeysPerThread; ++q) {
        if (t + q * nthreads >= k) continue;
        const unsigned start = sh.bucket[b[q]];
        const unsigned end = b[q] + 1 < kBuckets ? sh.bucket[b[q] + 1] : kk;
        unsigned r = 0;
        for (unsigned e = start; e < end; ++e)
          r += placed[e] < key[q] ? 1u : 0u;
        emit(key[q], vals, idx, out + start + r);
      }
      return;
    }
  }
  for (int e = k + t; e < P; e += nthreads) keys[e] = ~0ull;
  __syncthreads();
  bitonic_sort_shared(keys, P, t, nthreads);
  for (int e = t; e < k; e += nthreads) emit(keys[e], vals, idx, out + e);
}

// One CTA a row of x (blockIdx.x), rows ld elements apart; see above.
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
row_topk_kernel(const float* __restrict__ x, long long ld,
                float* __restrict__ vals, int32_t* __restrict__ idx, int n,
                int k, int P) {
  extern __shared__ unsigned long long keys[];   // P or 2P slots
  __shared__ RowShared sh;
  const long long row = blockIdx.x;
  row_select(TopkRow{x + row * ld}, keys, sh, vals, idx, row * k, n, k, P);
}

// ---------------------------------------------------------------------------
// The row regime of the SAMomentum step: samomentum_row_topk
//
// Replaces no TPU kernel.  It is the allgather exchange's row-wise
// SAMomentum step (src/repro/core/engine.py, samomentum_step_rows: the
// velocity accumulate, the top-k of each row, the support mask and the
// rescale by it) for rows of at most kRowMax elements, in one pass: where
// that chain reads and writes the velocity five times (the accumulate's
// u, g and uacc; the top-k's uacc; the mask; the multiply; the select),
// about 38 bytes an element, this kernel reads u and g once and writes
// the new velocity once, 12 bytes an element, besides k values and
// indices a row.
//
// Design: row_topk's core (row_select) with another load and store.  The
// load forms uacc = fma(m, u, lr * g) in registers with row 4a's rounding;
// the selection runs on those bits as row_topk runs on x, so vals and idx
// are row_topk's of uacc.  Each thread then knows which of its elements
// won (|x| > T, or a tie at T whose bit the tie mask kept) and writes
// sent ? uacc : uacc * (1/m) over the row -- the chain's rescale by the
// support mask, bit for bit -- with 16-byte stores where the rows allow.
// u may be the output (in place): each element is read and written by the
// one thread that holds it.

__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
samomentum_row_topk_kernel(const float* u, long long ldu,
                           const float* __restrict__ g, long long ldg,
                           float* unew, long long ldo, float lr,
                           float m, float rcp_m,
                           float* __restrict__ vals,
                           int32_t* __restrict__ idx, int n, int k, int P) {
  extern __shared__ unsigned long long keys[];   // P or 2P slots
  __shared__ RowShared sh;
  const long long row = blockIdx.x;
  const SAMomentumRow io{u + row * ldu, g + row * ldg, unew + row * ldo, m,
                         lr, rcp_m};
  row_select(io, keys, sh, vals, idx, row * k, n, k, P);
}

// The rows' launch: P, the power of two at or above k; a warp for every
// 512 elements of a row; the winners' keys, and the buckets' second buffer
// where they run, in dynamic shared memory -- the kernel's limit raised
// once past the 32 KB it may take without.
struct RowLaunch {
  int P, threads;
  size_t dyn;
};

template <class Kernel>
int row_launch(Kernel kernel, bool& wide, int n, int k, RowLaunch& l) {
  l.P = 1;
  while (l.P < k) l.P <<= 1;
  constexpr int kWarpElems = 32 * kRowPerThread;
  l.threads = 32 * ((n + kWarpElems - 1) / kWarpElems);
  l.dyn = sizeof(unsigned long long) * (size_t)l.P *
          (k <= kKeysPerThread * l.threads ? 2 : 1);
  if (l.dyn > 32768 && !wide) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(unsigned long long) * kRowMax));
    if (e != cudaSuccess) return (int)e;
    wide = true;
  }
  return 0;
}

bool row_shape_ok(long long S, int n, int k) {
  return n >= 1 && n <= kRowMax && k >= 1 && k <= n && S <= 0x7fffffffLL;
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

// Each row of (S, n) float32, rows ld elements apart: its exact top-k by
// |x| into vals (S, k) float32 and idx (S, k) int32, one CTA a row.
extern "C" int row_topk(const void* x, long long ld, void* vals, void* idx,
                        long long S, int n, int k, void* stream) {
  if (S == 0) return 0;
  if (!row_shape_ok(S, n, k)) return (int)cudaErrorInvalidValue;
  static bool wide = false;
  RowLaunch l;
  const int rc = row_launch(row_topk_kernel, wide, n, k, l);
  if (rc != 0) return rc;
  row_topk_kernel<<<(unsigned)S, l.threads, l.dyn, (cudaStream_t)stream>>>(
      (const float*)x, ld, (float*)vals, (int32_t*)idx, n, k, l.P);
  return (int)cudaGetLastError();
}

// The row-wise SAMomentum step of (S, n) float32 rows: u and g rows ldu and
// ldg elements apart; the top-k of uacc = m u + lr g into vals and idx as
// row_topk's, and the rescaled velocity into unew's rows, ldo apart (unew
// may be u).
extern "C" int samomentum_row_topk(const void* u, long long ldu,
                                   const void* g, long long ldg, void* unew,
                                   long long ldo, float lr, float m,
                                   float rcp_m, void* vals, void* idx,
                                   long long S, int n, int k, void* stream) {
  if (S == 0) return 0;
  if (!row_shape_ok(S, n, k)) return (int)cudaErrorInvalidValue;
  static bool wide = false;
  RowLaunch l;
  const int rc = row_launch(samomentum_row_topk_kernel, wide, n, k, l);
  if (rc != 0) return rc;
  samomentum_row_topk_kernel<<<(unsigned)S, l.threads, l.dyn,
                               (cudaStream_t)stream>>>(
      (const float*)u, ldu, (const float*)g, ldg, (float*)unew, ldo, lr, m,
      rcp_m, (float*)vals, (int32_t*)idx, n, k, l.P);
  return (int)cudaGetLastError();
}
