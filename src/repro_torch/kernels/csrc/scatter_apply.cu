// Sparse scatter-adds in place, duplicates summed in update order:
//   scatter_add       dense[idx[j]] += vals[j] on a flat arena, and
//   scatter_add_rows  dense2d[rows[b], idx[b, j]] += vals[b, j] for every
//                     lane b of a (B, k) batch, the rows pairwise distinct.
//
// Replaces: src/repro/kernels/scatter_apply.py, _kernel /
// scatter_apply_blocked (the flat one) and _rows_kernel /
// scatter_apply_blocked_rows (the multi-row one).
//
// The TPU kernels bucket the updates by 2048-element block and stream WHOLE
// rows through VMEM once per event: for the 10.5M-parameter model that is
// 2 x 42 MB of traffic per row to apply about 10.5K updates.  On Hopper a
// random word write costs one 32-byte sector, so the bound is the updates
// themselves: per lane, read k indices and k values, and read and write k
// target words (about 10.5K x 16 bytes, some 0.17 MB).  At that size the
// launch and the host work around it, not the memory, set the time: the
// design is ONE launch for all lanes, with no library sort, no permutation
// and no allocation.
//
// Design: a range partition per lane.  The grid is (P, B): CTA c of lane b
// owns the words [c*w, (c+1)*w) of that lane's row, w = ceil(n / P), so no
// two CTAs ever write one word (the rows are distinct) and there are no
// float atomics.  P = max(1, SMs / B) per lane: the grid is one wave, one
// CTA per SM (512 threads at 128 registers fill an SM's register file), so
// a lane of a batch has fewer CTAs, each with a larger share of its k.
// Each CTA streams all k indices of its lane in tiles of 12,288 positions
// (24 coalesced loads per thread, all in flight at once, the next tile's
// during this tile's work; after the first CTA they come from L2: 42 KB,
// one tile, at k = 10,514).  It keeps the updates that fall in its range
// IN POSITION ORDER: a warp ballot per sub-tile, then one warp scans the
// 384 (sub-tile, warp) counts into offsets.  A kept update becomes the
// 64-bit key (index << 32 | slot) in shared memory, its position beside
// it.  A round of at most kCap kept updates is then put in key order --
// each key's rank by counting when the round has at most one per thread
// (about 80 at phase B's message: no sort), else by a bitonic sort in
// shared memory -- so equal indices stay in slot order, which is update
// order.  The values and the old target words load meanwhile.  The first
// key of each run adds the run's values to the old word in order with
// __fadd_rn -- ((d + v0) + v1), the reference's order -- and stores once.
// A CTA whose share exceeds kCap (all k on one index, or all in one range)
// works in rounds of kCap kept updates in position order, each applied in
// full before the next, so the order holds across rounds.  Zero updates are
// applied, not skipped: (-0 + v) + 0 turns a -0 sum into +0.  Indices outside
// [0, n) fall in no CTA's range and are dropped, as XLA's scatter drops them.
//
// Lanes: the flat call is one lane on row 0.  The row ids travel in the
// launch's own parameters (a table of up to kMaxLanes ids, larger batches in
// several launches), or not at all for the identity rows 0..B-1 (the
// blockwise support repair): no device copy of them, no host sync.  Or they
// lie in device memory (int64, one per lane), where a CUDA graph's replay
// finds the row that this event's worker id names: each CTA reads its
// lane's id, and a lane whose id is outside [0, n_rows) writes nothing.
//
// Cost: P * k index reads from L2 per lane and one round per kCap kept
// updates per CTA; made for the sparse updates of DGS (k << n).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 24;                   // indices per thread per tile
constexpr int kTile = kThreads * kUnroll;     // positions per tile
constexpr int kScan = kUnroll * kWarps / 32;  // counts per lane of the scan
constexpr int kCap = 2048;                    // kept updates per round
constexpr int kPerThread = kCap / kThreads;
constexpr int kMaxLanes = 512;                // row ids per launch

// Target rows of the lanes: lane b writes row b ...
struct Identity {
  __device__ long long operator()(int lane) const { return lane; }
};

// ... or row row[b], the ids passed by value in the launch ...
struct RowTable {
  int32_t row[kMaxLanes];
  __device__ long long operator()(int lane) const { return row[lane]; }
};

// ... or row row[b] read from device memory; -1 (no row) when it is out of
// range.
struct DeviceRows {
  const long long* row;
  long long n_rows;
  __device__ long long operator()(int lane) const {
    const long long r = row[lane];
    return r >= 0 && r < n_rows ? r : -1;
  }
};

// Bitonic sort of keys[0, m) ascending in shared memory, padded to a power
// of two.
__device__ void sort_keys(unsigned long long* keys, int m) {
  const int t = threadIdx.x;
  int mp = 1;
  while (mp < m) mp <<= 1;
  for (int i = m + t; i < mp; i += kThreads) keys[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= mp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < mp / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const unsigned long long a = keys[lo];
        const unsigned long long b = keys[hi];
        if ((a > b) == ascending) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Apply one round of m kept updates: keys[s] = (index << 32 | s), pos[s]
// its position.  Each key's rank in (index, slot) order -- by counting
// when there is a key per thread, else by a sort -- places its index, value
// and old target word in sorted order, their loads in flight meanwhile;
// then the first of each run adds the run's values in order and stores
// once.  The sorted index and old word reuse the keys' storage.
__device__ void apply_round(float* __restrict__ dense,
                            const float* __restrict__ vals,
                            unsigned long long* keys, const int* pos,
                            float* sv, int m) {
  const int t = threadIdx.x;
  int rank[kPerThread];
  unsigned d[kPerThread];
  float v[kPerThread], old[kPerThread];
  int mine = 0;  // keys this thread places
  if (m <= kThreads) {
    if (t < m) {
      const unsigned long long key = keys[t];
      d[0] = (unsigned)(key >> 32);
      v[0] = vals[pos[t]];
      old[0] = dense[d[0]];
      int r = 0;
      for (int u = 0; u < m; ++u) r += keys[u] < key ? 1 : 0;
      rank[0] = r;
      mine = 1;
    }
  } else {
    sort_keys(keys, m);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int s = t + i * kThreads;
      if (s < m) {
        const unsigned long long key = keys[s];
        d[i] = (unsigned)(key >> 32);
        v[i] = vals[pos[key & 0xffffffffu]];
        old[i] = dense[d[i]];
        rank[i] = s;
        mine = i + 1;
      }
    }
  }
  __syncthreads();  // every key is read before its storage is reused
  unsigned* sd = reinterpret_cast<unsigned*>(keys);
  float* sw = reinterpret_cast<float*>(keys) + kCap;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (i < mine) {
      sd[rank[i]] = d[i];
      sv[rank[i]] = v[i];
      sw[rank[i]] = old[i];
    }
  }
  __syncthreads();
  for (int s = t; s < m; s += kThreads) {
    const unsigned di = sd[s];
    if (s > 0 && sd[s - 1] == di) continue;  // not the first of its run
    float acc = sw[s];
    for (int j = s; j < m && sd[j] == di; ++j) acc = __fadd_rn(acc, sv[j]);
    dense[di] = acc;
  }
  __syncthreads();
}

// One lane per blockIdx.y: lane b's k updates (idx and vals at b * k) go
// to row rows(b) of dense, n words long.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(float* __restrict__ dense, long long n, long long w,
                   const int32_t* __restrict__ idx,
                   const float* __restrict__ vals, int k, Rows rows) {
  const long long row = rows(blockIdx.y);
  if (row < 0) return;  // the whole CTA: a lane with no row writes nothing
  dense += row * n;
  idx += (long long)blockIdx.y * k;
  vals += (long long)blockIdx.y * k;
  __shared__ unsigned long long keys[kCap];
  __shared__ int pos[kCap];
  __shared__ float sv[kCap];
  // per tile (two buffers, by tile parity): the kept count of each
  // (sub-tile, warp), then its offset, then the tile's total
  __shared__ int count_buf[2][kUnroll * kWarps + 1];
  const long long lo = (long long)blockIdx.x * w;
  const long long hi = lo + w < n ? lo + w : n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1;
  int fill = 0;  // kept updates in the current round
  int next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = u * kThreads + t;
    next[u] = p < k ? idx[p] : -1;
  }
  for (int base = 0, tile = 0; base < k; base += kTile, ++tile) {
    int* counts = count_buf[tile & 1];
    int d[kUnroll];
    bool keep[kUnroll];
    unsigned ballot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      d[u] = next[u];
      const int p = base + kTile + u * kThreads + t;
      if (p < k) next[u] = idx[p];  // the next tile's loads, in flight now
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      keep[u] = base + u * kThreads + t < k && d[u] >= lo && d[u] < hi;
      ballot[u] = __ballot_sync(0xffffffffu, keep[u]);
      if (lane == 0) counts[u * kWarps + warp] = __popc(ballot[u]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the counts in position order
      int c[kScan], sum = 0;
#pragma unroll
      for (int i = 0; i < kScan; ++i) {
        c[i] = counts[kScan * lane + i];
        sum += c[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int run = incl - sum;
#pragma unroll
      for (int i = 0; i < kScan; ++i) {
        counts[kScan * lane + i] = run;
        run += c[i];
      }
      if (lane == 31) counts[kUnroll * kWarps] = incl;
    }
    __syncthreads();
    int q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      q[u] = counts[u * kWarps + warp] + __popc(ballot[u] & below);
    }
    const int total = counts[kUnroll * kWarps];
    // place this tile's kept updates, the q-th at slot fill + q, applying
    // every full round before the rest of the tile
    for (int done = 0;;) {
      const int take = total - done < kCap - fill ? total - done : kCap - fill;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (keep[u] && q[u] >= done && q[u] < done + take) {
          const int slot = fill + q[u] - done;
          keys[slot] =
              ((unsigned long long)(unsigned)d[u] << 32) | (unsigned)slot;
          pos[slot] = base + u * kThreads + t;
        }
      }
      fill += take;
      done += take;
      if (fill < kCap) break;
      __syncthreads();
      apply_round(dense, vals, keys, pos, sv, kCap);
      fill = 0;
      if (done == total) break;
    }
  }
  if (fill > 0) {
    __syncthreads();
    apply_round(dense, vals, keys, pos, sv, fill);
  }
}

// the current device's SM count, asked once per device
cudaError_t sm_count(int* sms) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int count = cached[dev].load(std::memory_order_relaxed);
  if (count == 0) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev].store(count, std::memory_order_relaxed);
  }
  *sms = count;
  return cudaSuccess;
}

// Launch lanes [0, lanes) of a batch: P CTAs per lane over its n words,
// one wave in all while there are fewer lanes than SMs.
template <class Rows>
cudaError_t launch(float* dense, long long n, const int32_t* idx,
                   const float* vals, int k, int lanes, const Rows& rows,
                   cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  long long parts = sms / lanes;
  if (parts < 1) parts = 1;
  if (parts > n) parts = n;
  const long long w = (n + parts - 1) / parts;
  const dim3 grid((unsigned)((n + w - 1) / w), (unsigned)lanes);
  scatter_add_kernel<Rows><<<grid, kThreads, 0, stream>>>(dense, n, w, idx,
                                                          vals, k, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int scatter_add(void* dense, long long n, const void* idx,
                           const void* vals, long long k, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  if (k > 0x7fffffffLL - 2 * kTile) return (int)cudaErrorInvalidValue;
  return (int)launch((float*)dense, n, (const int32_t*)idx,
                     (const float*)vals, (int)k, 1, Identity{},
                     (cudaStream_t)stream);
}

// rows: b host row ids, pairwise distinct (the wrapper checks); or, when
// rows is null, rows_dev: b int64 row ids in device memory, pairwise
// distinct by the caller's contract, ids outside [0, n_rows) dropped; or,
// when both are null, the rows 0..b-1.  One launch per kMaxLanes lanes.
extern "C" int scatter_add_rows(void* dense, long long n, const int32_t* rows,
                                const long long* rows_dev, long long n_rows,
                                long long b, const void* idx,
                                const void* vals, long long k, void* stream) {
  if (k <= 0 || n <= 0 || b <= 0) return 0;
  if (k > 0x7fffffffLL - 2 * kTile) return (int)cudaErrorInvalidValue;
  for (long long b0 = 0; b0 < b; b0 += kMaxLanes) {
    const int lanes = (int)(b - b0 < kMaxLanes ? b - b0 : kMaxLanes);
    const int32_t* ii = (const int32_t*)idx + b0 * k;
    const float* vv = (const float*)vals + b0 * k;
    cudaError_t err;
    if (rows != nullptr) {
      RowTable table;
      for (int i = 0; i < lanes; ++i) table.row[i] = rows[b0 + i];
      err = launch((float*)dense, n, ii, vv, (int)k, lanes, table,
                   (cudaStream_t)stream);
    } else if (rows_dev != nullptr) {
      err = launch((float*)dense, n, ii, vv, (int)k, lanes,
                   DeviceRows{rows_dev + b0, n_rows}, (cudaStream_t)stream);
    } else {
      err = launch((float*)dense + b0 * n, n, ii, vv, (int)k, lanes,
                   Identity{}, (cudaStream_t)stream);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
