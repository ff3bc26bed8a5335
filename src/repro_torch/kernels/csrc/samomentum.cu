// The SAMomentum worker step's elementwise passes, row by row over (B, n)
// blocks, in float32 with the reference's roundings:
//
//   samomentum_fused       uacc = m*u + lr*g; sent = |uacc| >= thr;
//                          out = sent ? uacc : 0; u_new = sent ? uacc : uacc/m
//   samomentum_accumulate  uacc = m*u + lr*g      (the first line alone)
//   fma_rows               r = a*b + c            (one rounding)
//
// Replaces: src/repro/kernels/samomentum_kernel.py, _kernel /
// samomentum_fused_2d.  The accumulate and the fma are the fused
// multiply-adds that XLA compiles around that kernel in the reference's
// blockwise step (src/repro/core/engine.py: the velocity accumulate, and the
// repair's u_new + extra * (1/m - 1)); the port's plain versions emulate
// them in float64 (repro_torch/arith.py), here they are __fmaf_rn.
//
// Rounding follows the reference as XLA compiles it on the CPU:
// m*u + lr*g is ONE fused multiply-add, fma(m, u, lr*g), and the division by
// the constant m is a multiply by its float32 reciprocal.  The explicit
// __fmaf_rn / __fmul_rn intrinsics fix those roundings, so nvcc has no
// freedom to contract or reorder (and no --use_fast_math is passed).
//
// Bound: memory.  Each pass reads its full operands once and writes its
// outputs once: 12 bytes per element for all three as the blockwise step
// calls them (the fused pass on (uacc, uacc) reads one array).  Design, one
// kernel template for the three:
// * a (chunk, row) grid: CTA (c, b) maps kChunk elements of row b, so no
//   thread divides to find its row;
// * every operand is a Python float, one value per row read from a device
//   pointer (the batched loop's (B, 1) learning rates, a row's threshold;
//   never read by the host), or a full (B, n) view with unit column stride
//   and any row stride (the leaf views of the (B, total) arena); outputs
//   are contiguous (B, n);
// * loads and stores are as wide as the row's operands allow: 16 bytes
//   where every full operand and output of the row lies at the same offset
//   modulo 16 bytes, 8 where modulo 8, else 4 (a (B, 10) bias block, or a
//   leaf view that starts 8 bytes off against its contiguous output), with
//   the few elements before the first aligned address and after the last
//   whole vector done one by one;
// * each thread issues all its loads before it computes (16 elements in
//   flight a thread), and the outputs are streaming stores (__stcs);
// * one read where u and g are one tensor (the fused pass on (uacc, uacc)).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements of a row per CTA

enum Kind : int { kScalar = 0, kRow = 1, kFull = 2, kSameAsFirst = 3 };

struct Operand {
  const float* p;
  long long stride;  // row stride in elements (kRow, kFull)
  float value;       // kScalar
  int kind;
};

template <int W>
struct alignas(4 * W) Vec {
  float v[W];
};

template <int W>
__device__ __forceinline__ Vec<W> load(const float* p) {
  return *reinterpret_cast<const Vec<W>*>(p);
}

template <int W>
__device__ __forceinline__ void store(float* p, const Vec<W>& x) {
  if constexpr (W == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x.v[0], x.v[1], x.v[2],
                                                     x.v[3]));
  } else if constexpr (W == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x.v[0], x.v[1]));
  } else {
    __stcs(p, x.v[0]);
  }
}

template <int NIn, int NOut>
struct Args {
  Operand in[NIn];
  float* out[NOut];
  long long n;  // row length
};

// thr per row; u full, g full or u itself.
struct FusedOp {
  static constexpr int kIn = 3, kOut = 2;
  float m, lr, rcp_m;
  __device__ void operator()(const float (&x)[kIn], float (&y)[kOut]) const {
    const float uacc = __fmaf_rn(m, x[0], __fmul_rn(lr, x[1]));
    const bool sent = fabsf(uacc) >= x[2];
    y[0] = sent ? uacc : 0.0f;
    y[1] = sent ? uacc : __fmul_rn(uacc, rcp_m);
  }
};

// u, g full; lr a float or one per row.
struct AccumulateOp {
  static constexpr int kIn = 3, kOut = 1;
  float m;
  __device__ void operator()(const float (&x)[kIn], float (&y)[kOut]) const {
    y[0] = __fmaf_rn(m, x[0], __fmul_rn(x[2], x[1]));
  }
};

struct FmaOp {
  static constexpr int kIn = 3, kOut = 1;
  __device__ void operator()(const float (&x)[kIn], float (&y)[kOut]) const {
    y[0] = __fmaf_rn(x[0], x[1], x[2]);
  }
};

// One lane's operands: row pointers, and the per-row values.
template <class Op>
struct Row {
  const float* in[Op::kIn];
  float val[Op::kIn];
  int kind[Op::kIn];
  float* out[Op::kOut];
};

template <class Op>
__device__ __forceinline__ void inputs(const Row<Op>& r, long long i,
                                       float (&x)[Op::kIn]) {
#pragma unroll
  for (int j = 0; j < Op::kIn; ++j) {
    x[j] = r.kind[j] == kFull ? r.in[j][i]
           : r.kind[j] == kSameAsFirst ? x[0] : r.val[j];
  }
}

template <class Op>
__device__ __forceinline__ void one(const Op& op, const Row<Op>& r,
                                    long long i) {
  float x[Op::kIn], y[Op::kOut];
  inputs(r, i, x);
  op(x, y);
#pragma unroll
  for (int j = 0; j < Op::kOut; ++j) __stcs(r.out[j] + i, y[j]);
}

// Vectors [v0, v1) of W elements, vector v at element h + v * W: every
// thread loads its U vectors of each full operand, then computes, then
// stores.
template <int W, class Op>
__device__ __forceinline__ void vectors(const Op& op, const Row<Op>& r,
                                        long long h, long long v0,
                                        long long v1) {
  constexpr int U = kChunk / (W * kThreads);
  float x[U][W][Op::kIn];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long v = v0 + u * kThreads + threadIdx.x;
    if (v < v1) {
#pragma unroll
      for (int j = 0; j < Op::kIn; ++j) {
        if (r.kind[j] == kFull) {
          const Vec<W> t = load<W>(r.in[j] + h + v * W);
#pragma unroll
          for (int e = 0; e < W; ++e) x[u][e][j] = t.v[e];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long v = v0 + u * kThreads + threadIdx.x;
    if (v < v1) {
      Vec<W> y[Op::kOut];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float xe[Op::kIn], ye[Op::kOut];
#pragma unroll
        for (int j = 0; j < Op::kIn; ++j) {
          xe[j] = r.kind[j] == kFull ? x[u][e][j]
                  : r.kind[j] == kSameAsFirst ? xe[0] : r.val[j];
        }
        op(xe, ye);
#pragma unroll
        for (int j = 0; j < Op::kOut; ++j) y[j].v[e] = ye[j];
      }
#pragma unroll
      for (int j = 0; j < Op::kOut; ++j) store<W>(r.out[j] + h + v * W, y[j]);
    }
  }
}

template <int W, class Op>
__device__ __forceinline__ void row_part(const Op& op, const Row<Op>& r,
                                         long long n) {
  // h elements one by one up to the first address aligned to W floats
  const uintptr_t a = reinterpret_cast<uintptr_t>(r.out[0]);
  long long h = (long long)(((4 * W) - (a & (4 * W - 1))) & (4 * W - 1)) / 4;
  if (h > n) h = n;
  const long long nv = (n - h) / W;
  const long long per = kChunk / W;
  const long long v0 = (long long)blockIdx.x * per;
  if (v0 < nv) {
    vectors<W>(op, r, h, v0, v0 + per < nv ? v0 + per : nv);
  }
  if (blockIdx.x == 0) {
    const long long t = threadIdx.x;
    const long long tail = h + nv * W;
    if (t < h) one(op, r, t);
    if (tail + t < n) one(op, r, tail + t);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
rowmap_kernel(Op op, Args<Op::kIn, Op::kOut> args) {
  const long long b = blockIdx.y;
  const long long n = args.n;
  Row<Op> r;
  uintptr_t mix = 0;  // bits in which the full operands' addresses differ
  const uintptr_t ref = reinterpret_cast<uintptr_t>(args.out[0] + b * n);
#pragma unroll
  for (int j = 0; j < Op::kOut; ++j) {
    r.out[j] = args.out[j] + b * n;
    mix |= reinterpret_cast<uintptr_t>(r.out[j]) ^ ref;
  }
#pragma unroll
  for (int j = 0; j < Op::kIn; ++j) {
    const Operand& o = args.in[j];
    r.kind[j] = o.kind;
    r.in[j] = o.p + b * o.stride;
    r.val[j] = o.kind == kRow ? o.p[b * o.stride] : o.value;
    if (o.kind == kFull) mix |= reinterpret_cast<uintptr_t>(r.in[j]) ^ ref;
  }
  if ((mix & 15) == 0) {
    row_part<4>(op, r, n);
  } else if ((mix & 7) == 0) {
    row_part<2>(op, r, n);
  } else {
    row_part<1>(op, r, n);
  }
}

// gridDim.y holds at most 65,535 rows: a taller block (a vocabulary's
// rows) runs in slabs of that many, one launch a slab, each operand's
// pointer moved to the slab's first row.
constexpr long long kMaxRows = 65535;

template <class Op>
int launch(const Op& op, const Args<Op::kIn, Op::kOut>& args, long long b,
           void* stream) {
  if (b <= 0 || args.n <= 0) return 0;
  for (long long b0 = 0; b0 < b; b0 += kMaxRows) {
    Args<Op::kIn, Op::kOut> slab = args;
    for (int j = 0; j < Op::kOut; ++j) slab.out[j] = args.out[j] + b0 * args.n;
    for (int j = 0; j < Op::kIn; ++j) {
      if (args.in[j].kind == kFull || args.in[j].kind == kRow) {
        slab.in[j].p = args.in[j].p + b0 * args.in[j].stride;
      }
    }
    const long long rows = b - b0 < kMaxRows ? b - b0 : kMaxRows;
    const dim3 grid((unsigned)((args.n + kChunk - 1) / kChunk),
                    (unsigned)rows);
    rowmap_kernel<Op><<<grid, kThreads, 0, (cudaStream_t)stream>>>(op, slab);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

Operand full(const void* p, long long stride) {
  return Operand{(const float*)p, stride, 0.0f, kFull};
}

}  // namespace

// u, g: contiguous (b, n) (g == u is read once); thr: b floats on the
// device; out, unew: contiguous (b, n).
extern "C" int samomentum_fused(const void* u, const void* g, const void* thr,
                                void* out, void* unew, float m, float lr,
                                float rcp_m, long long b, long long n,
                                void* stream) {
  Args<3, 2> args{{full(u, n),
                   g == u ? Operand{nullptr, 0, 0.0f, kSameAsFirst}
                          : full(g, n),
                   Operand{(const float*)thr, 1, 0.0f, kRow}},
                  {(float*)out, (float*)unew}, n};
  return launch(FusedOp{m, lr, rcp_m}, args, b, stream);
}

// lr_p null: lr is the float lr; else one per row, at lr_p[row * lr_stride].
extern "C" int samomentum_accumulate(const void* u, long long su,
                                     const void* g, long long sg,
                                     const void* lr_p, long long lr_stride,
                                     float lr, void* out, float m,
                                     long long b, long long n, void* stream) {
  const Operand lr_op = lr_p == nullptr
      ? Operand{nullptr, 0, lr, kScalar}
      : Operand{(const float*)lr_p, lr_stride, 0.0f, kRow};
  Args<3, 1> args{{full(u, su), full(g, sg), lr_op}, {(float*)out}, n};
  return launch(AccumulateOp{m}, args, b, stream);
}

// Each operand: pointer, row stride, value, kind (0 float, 1 one per row,
// 2 full).
extern "C" int fma_rows(const void* a, long long sa, float va, int ka,
                        const void* bb, long long sb, float vb, int kb,
                        const void* c, long long sc, float vc, int kc,
                        void* out, long long b, long long n, void* stream) {
  if ((unsigned)ka > kFull || (unsigned)kb > kFull || (unsigned)kc > kFull) {
    return (int)cudaErrorInvalidValue;
  }
  Args<3, 1> args{{Operand{(const float*)a, sa, va, ka},
                   Operand{(const float*)bb, sb, vb, kb},
                   Operand{(const float*)c, sc, vc, kc}},
                  {(float*)out}, n};
  return launch(FmaOp{}, args, b, stream);
}
