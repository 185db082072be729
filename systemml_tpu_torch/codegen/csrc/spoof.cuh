// Spoof (fused-operator) kernels for Hopper (sm_90a): the hand-written
// skeletons of the cell, row, multi-aggregate and outer-product
// templates. A generated source per plan (codegen/build.py: plan_source)
// includes this header, defines one functor `Plan` whose body is the
// plan's expression (codegen/cplan.py: emit_cuda), and exports an
// extern "C" launcher that instantiates the template's skeleton below
// with it, for float and double.
//
// Replaces systemml_tpu/codegen/kernels.py::cell_kernel (line 124: the
// elementwise arm, pallas_call at :149, and the full-sum arm, :183),
// ::row_kernel (line 199, pallas_call at :225: each row reduced under sum,
// min or max), ::multiagg_kernel (line 242, pallas_call at :296: one plan
// reduced under several full aggregates) and ::outer_sum_kernel (line
// 419, pallas_call at :458: sum(f(X, U %*% t(V))) without the (m, n)
// product). Mosaic compiled each plan for the TPU; a CUDA kernel cannot
// interpret a Python plan tree, so the plan is compiled in as a functor.
//
// Bound: bytes. A plan does a few operations per element on leaves that
// are read once: the least time is the bytes of the distinct leaf tensors
// plus the output over the H100 SXM's 3.35 TB/s. L2SVM's line-search plan,
// 10 leaves over 3 distinct (2,000,000, 1) fp32 vectors and a 0-d scalar,
// moves 24 MB: >= 7.2 us. MultiLogReg's row plan on (2,000,000, 5) plus
// (2,000,000, 1) and the (2,000,000, 1) output moves 56 MB: >= 16.7 us.
//
// Design, and what it does about that bound:
// - Leaves are descriptors {ptr, rs, cs}: element (r, c) of a leaf is
//   ptr[r * rs + c * cs]. (m, n) has (ld, 1), (m, 1) has (stride, 0),
//   (1, n) has (0, 1), (1, 1) and 0-d tensors (0, 0); any strided view
//   reads in place. A leaf whose ptr is null is a host number, passed by
//   value in `scal`. So one source per plan serves every layout and
//   dtype, and is built when the program is compiled.
// - Every leaf read goes through the read-only cache (__ldg): a tensor
//   that the plan names twice (L2SVM reads Y, Xw, Xd twice) is fetched
//   from device memory once and from cache after.
// - Grid-stride loops over a grid of at most 8 blocks of 256 threads per
//   SM; the ragged edge is the loop bound, nothing is padded or copied.
// - Cell sum: per-thread partials in double, a fixed tree in shared
//   memory, one partial per block; a second kernel sums the partials in a
//   fixed order. No float atomics: two launches give the same bits. The
//   double accumulator also keeps an fp32 sum over 2e6 elements within
//   1e-7 of the fp64 sum (the TPU kernel sums in the input's dtype).
// - Row: one thread per row when n <= 32 (MultiLogReg's n = 5: the
//   thread reads its row's 20 bytes, a warp 640 contiguous bytes), one
//   warp per row otherwise with a butterfly shuffle reduction. The plan's
//   value is evaluated at every (r, c) of the main leaf's (m, n), which is
//   the JAX kernel's broadcast to (tile, n) before the reduction.
// - min and max propagate NaN, as jnp.minimum/jnp.maximum; no fminf/fmaxf.
// - Multi-aggregate: the cell walk of cell_sum, each cell's value reduced
//   into one accumulator per aggregate (sum, min or max, any order, at
//   most kMaxAggs), in double, each starting at its neutral element (0,
//   +inf, -inf); the block's partials go to one (blocks, n_aggs) buffer,
//   and a second kernel combines each column in block order under its own
//   combiner. The walk carries (row, column) from step to step: no 64-bit
//   division per cell. Bound: bytes, as the cell sum (the V-shaped
//   ratings summary, 764M fp32 cells read once: >= 0.913 ms).
// - Outer product: a block takes kOuterRows rows of X and kThreads
//   columns; its U rows sit in shared memory (zero-padded to the rank
//   bucket RB in 4..32, so each row is a few 16-byte broadcast reads), each
//   thread keeps its column's V row in registers, forms uv = sum_k
//   U[i,k] V[j,k] in a fixed k order by FMA (true fp32, or fp64; the
//   padding adds exact zeros), reads X[i,j] coalesced along the row,
//   evaluates the plan on (X, uv) and sums in double. Per-block partials
//   are summed in block order by sum_partials. Bound: bytes of X when the
//   rank is small (ALS-CG-ml10m, 71,567 x 10,681 fp32, rank 10: X's
//   3.058 GB take >= 0.913 ms, its 1.53e10 FLOP >= 0.23 ms at 67 TFLOP/s).
// Simple and right first: no TMA, no cp.async, no vector loads of leaves.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace spoof {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;

struct Leaf {
  const void* ptr;  // null: a host number, in Args::scal
  long long rs, cs;
};

template <typename T>
struct Args {
  Leaf leaf[kMaxLeaves];
  T scal[kMaxLeaves];
};

template <typename T>
__device__ __forceinline__ T leaf(const Args<T>& a, int i, long long r,
                                  long long c) {
  const T* p = static_cast<const T*>(a.leaf[i].ptr);
  return p ? __ldg(p + r * a.leaf[i].rs + c * a.leaf[i].cs) : a.scal[i];
}

// the operators of codegen/cplan.py (CELL_BINARY, CELL_UNARY)
namespace ops {
template <typename T> __device__ __forceinline__ T op_add(T a, T b) { return a + b; }
template <typename T> __device__ __forceinline__ T op_sub(T a, T b) { return a - b; }
template <typename T> __device__ __forceinline__ T op_mul(T a, T b) { return a * b; }
template <typename T> __device__ __forceinline__ T op_div(T a, T b) { return a / b; }
template <typename T> __device__ __forceinline__ T op_pow(T a, T b) { return pow(a, b); }
template <typename T> __device__ __forceinline__ T op_sq(T a) { return a * a; }
// NaN in either operand gives NaN (a + b carries it), as jnp.minimum
template <typename T> __device__ __forceinline__ T op_min(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
template <typename T> __device__ __forceinline__ T op_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T> __device__ __forceinline__ T op_eq(T a, T b) { return a == b ? T(1) : T(0); }
template <typename T> __device__ __forceinline__ T op_ne(T a, T b) { return a != b ? T(1) : T(0); }
template <typename T> __device__ __forceinline__ T op_lt(T a, T b) { return a < b ? T(1) : T(0); }
template <typename T> __device__ __forceinline__ T op_le(T a, T b) { return a <= b ? T(1) : T(0); }
template <typename T> __device__ __forceinline__ T op_gt(T a, T b) { return a > b ? T(1) : T(0); }
template <typename T> __device__ __forceinline__ T op_ge(T a, T b) { return a >= b ? T(1) : T(0); }
template <typename T> __device__ __forceinline__ T op_neg(T a) { return -a; }
template <typename T> __device__ __forceinline__ T op_abs(T a) { return fabs(a); }
template <typename T> __device__ __forceinline__ T op_exp(T a) { return exp(a); }
template <typename T> __device__ __forceinline__ T op_log(T a) { return log(a); }
template <typename T> __device__ __forceinline__ T op_sqrt(T a) { return sqrt(a); }
// sign(0) is 0 and sign(NaN) NaN, as jnp.sign
template <typename T> __device__ __forceinline__ T op_sign(T a) {
  return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a);
}
template <typename T> __device__ __forceinline__ T op_sin(T a) { return sin(a); }
template <typename T> __device__ __forceinline__ T op_cos(T a) { return cos(a); }
template <typename T> __device__ __forceinline__ T op_tan(T a) { return tan(a); }
template <typename T> __device__ __forceinline__ T op_tanh(T a) { return tanh(a); }
template <typename T> __device__ __forceinline__ T op_sigmoid(T a) { return T(1) / (T(1) + exp(-a)); }
template <typename T> __device__ __forceinline__ T op_floor(T a) { return floor(a); }
template <typename T> __device__ __forceinline__ T op_ceil(T a) { return ceil(a); }
template <typename T> __device__ __forceinline__ T op_round(T a) { return floor(a + T(0.5)); }
template <typename T> __device__ __forceinline__ T op_sprop(T a) { return a * (T(1) - a); }
}  // namespace ops

// ---- cell template -------------------------------------------------------

// out (m, n) contiguous = plan at every (r, c)
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cell_map(const __grid_constant__ Args<T> a, long long m, long long n,
         T* __restrict__ out) {
  const P plan{};
  const long long total = m * n;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += step) {
    long long r = i, c = 0;
    if (n != 1) {
      r = i / n;
      c = i - r * n;
    }
    out[i] = plan(a, r, c);
  }
}

// fixed-order tree over the block's kThreads values in s; returns the sum
// in thread 0
__device__ __forceinline__ double block_sum(double* s, double v) {
  const int tid = threadIdx.x;
  s[tid] = v;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) s[tid] += s[tid + w];
    __syncthreads();
  }
  return s[0];
}

// partial[block] = sum of the plan over the block's grid-stride share
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cell_sum(const __grid_constant__ Args<T> a, long long m, long long n,
         double* __restrict__ partial) {
  __shared__ double s[kThreads];
  const P plan{};
  const long long total = m * n;
  const long long step = (long long)gridDim.x * kThreads;
  double acc = 0.0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += step) {
    long long r = i, c = 0;
    if (n != 1) {
      r = i / n;
      c = i - r * n;
    }
    acc += (double)plan(a, r, c);
  }
  const double b = block_sum(s, acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = b;
}

// out[0] = the partials summed in a fixed order (one block)
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_partials(const double* __restrict__ partial, int blocks,
             T* __restrict__ out) {
  __shared__ double s[kThreads];
  double acc = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) acc += partial[b];
  const double t = block_sum(s, acc);
  if (threadIdx.x == 0) out[0] = (T)t;
}

// ---- row template --------------------------------------------------------

enum RowAgg { kSum = 0, kMin = 1, kMax = 2 };

template <typename T, int AGG>
struct RowAcc;

template <typename T>
struct RowAcc<T, kSum> {
  double v = 0.0;
  __device__ __forceinline__ void add(T x) { v += (double)x; }
  __device__ __forceinline__ T get() const { return (T)v; }
  __device__ __forceinline__ void shfl_xor(int off) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
};

template <typename T, int AGG>
struct RowMinMax {
  T v;
  bool any = false;
  __device__ __forceinline__ void add(T x) {
    v = any ? (AGG == kMin ? ops::op_min(v, x) : ops::op_max(v, x)) : x;
    any = true;
  }
  __device__ __forceinline__ T get() const { return v; }
  __device__ __forceinline__ void shfl_xor(int off) {
    const T o = __shfl_xor_sync(0xffffffffu, v, off);
    const bool oany = __shfl_xor_sync(0xffffffffu, (int)any, off) != 0;
    if (oany) add(o);
  }
};

template <typename T> struct RowAcc<T, kMin> : RowMinMax<T, kMin> {};
template <typename T> struct RowAcc<T, kMax> : RowMinMax<T, kMax> {};

// n <= 32: one thread per row
template <typename T, typename P, int AGG>
__global__ void __launch_bounds__(kThreads)
row_thread(const __grid_constant__ Args<T> a, long long m, long long n,
           T* __restrict__ out) {
  const P plan{};
  const long long step = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < m;
       r += step) {
    RowAcc<T, AGG> acc;
    for (long long c = 0; c < n; ++c) acc.add(plan(a, r, c));
    out[r] = acc.get();
  }
}

// n > 32: one warp per row, lanes strided over the columns
template <typename T, typename P, int AGG>
__global__ void __launch_bounds__(kThreads)
row_warp(const __grid_constant__ Args<T> a, long long m, long long n,
         T* __restrict__ out) {
  const P plan{};
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long r = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       r < m; r += warps) {
    RowAcc<T, AGG> acc;
    for (long long c = lane; c < n; c += 32) acc.add(plan(a, r, c));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc.shfl_xor(off);
    if (lane == 0) out[r] = acc.get();
  }
}

// ---- multi-aggregate template ----------------------------------------------

constexpr int kMaxAggs = 8;

struct Aggs {
  int n;                // aggregates, 1..kMaxAggs
  int code[kMaxAggs];   // RowAgg: kSum, kMin, kMax
};

__device__ __forceinline__ double agg_neutral(int code) {
  return code == kSum ? 0.0 : (code == kMin ? CUDART_INF : -CUDART_INF);
}

__device__ __forceinline__ double agg_combine(int code, double a, double b) {
  return code == kSum ? a + b
                      : (code == kMin ? ops::op_min(a, b) : ops::op_max(a, b));
}

// fixed-order tree over the block's kThreads values under `code`'s
// combiner; every thread gets the result, and s may be reused after it
__device__ __forceinline__ double block_reduce(double* s, double v, int code) {
  const int tid = threadIdx.x;
  s[tid] = v;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) s[tid] = agg_combine(code, s[tid], s[tid + w]);
    __syncthreads();
  }
  const double r = s[0];
  __syncthreads();
  return r;
}

// partial[block * n_aggs + k] = aggregate k of the plan over the block's
// grid-stride share of the (m, n) cells
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
multiagg(const __grid_constant__ Args<T> a, const Aggs g, long long m,
         long long n, double* __restrict__ partial) {
  __shared__ double s[kThreads];
  const P plan{};
  double acc[kMaxAggs];
#pragma unroll
  for (int k = 0; k < kMaxAggs; ++k)
    acc[k] = agg_neutral(k < g.n ? g.code[k] : kSum);
  const long long total = m * n;
  const long long step = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < total) {
    long long r = i / n, c = i - r * n;
    const long long step_r = step / n, step_c = step - step_r * n;
    for (; i < total; i += step) {
      const double x = (double)plan(a, r, c);
#pragma unroll
      for (int k = 0; k < kMaxAggs; ++k)
        if (k < g.n) acc[k] = agg_combine(g.code[k], acc[k], x);
      r += step_r;
      c += step_c;
      if (c >= n) {
        c -= n;
        ++r;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxAggs; ++k) {
    if (k < g.n) {
      const double b = block_reduce(s, acc[k], g.code[k]);
      if (threadIdx.x == 0) partial[(long long)blockIdx.x * g.n + k] = b;
    }
  }
}

// out[k] = column k of the (blocks, n_aggs) partials combined in block
// order under aggregate k's combiner (one block)
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_partials(const double* __restrict__ partial, int blocks, const Aggs g,
                 T* __restrict__ out) {
  __shared__ double s[kThreads];
  for (int k = 0; k < g.n; ++k) {
    const int code = g.code[k];
    double acc = agg_neutral(code);
    for (int b = threadIdx.x; b < blocks; b += kThreads)
      acc = agg_combine(code, acc, partial[(long long)b * g.n + k]);
    const double t = block_reduce(s, acc, code);
    if (threadIdx.x == 0) out[k] = (T)t;
  }
}

// ---- outer-product template --------------------------------------------------

constexpr int kOuterRows = 64;
constexpr int kOuterMaxRank = 32;

template <typename T>
__device__ __forceinline__ T fma_t(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_t<float>(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
template <>
__device__ __forceinline__ double fma_t<double>(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// partial[blockIdx.y * gridDim.x + blockIdx.x] = sum over the block's row
// tiles (kOuterRows rows each, grid-stride over blockIdx.y) and its
// kThreads columns of plan(X, uv), uv = U[i, :] . V[j, :] over the rank r
// (RB >= r, a multiple of 4)
template <typename T, typename P, int RB>
__global__ void __launch_bounds__(kThreads)
outer_sum(const __grid_constant__ Args<T> a, const Leaf u, const Leaf v,
          long long m, long long n, int r, double* __restrict__ partial) {
  __shared__ __align__(16) T su[kOuterRows][RB];
  __shared__ double s[kThreads];
  const P plan{};
  const T* up = static_cast<const T*>(u.ptr);
  const T* vp = static_cast<const T*>(v.ptr);
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < n;
  T vr[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k)
    vr[k] = (live && k < r) ? __ldg(vp + c * v.rs + k * v.cs) : T(0);
  const long long tiles = (m + kOuterRows - 1) / kOuterRows;
  double acc = 0.0;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long row0 = tile * kOuterRows;
    const int rows = (int)(m - row0 < kOuterRows ? m - row0 : kOuterRows);
    __syncthreads();  // the previous tile's readers are done with su
    for (int e = threadIdx.x; e < kOuterRows * RB; e += kThreads) {
      const int i = e / RB, k = e - i * RB;
      su[i][k] = (i < rows && k < r)
                     ? __ldg(up + (row0 + i) * u.rs + k * u.cs) : T(0);
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int i = 0; i < rows; ++i) {
        T uv = T(0);
#pragma unroll
        for (int k = 0; k < RB; ++k) uv = fma_t(su[i][k], vr[k], uv);
        acc += (double)plan(a, row0 + i, c, uv);
      }
    }
  }
  const double b = block_sum(s, acc);
  if (threadIdx.x == 0)
    partial[(long long)blockIdx.y * gridDim.x + blockIdx.x] = b;
}

// ---- host side -----------------------------------------------------------

template <typename T>
inline int fill_args(Args<T>* a, const void* const* ptrs, const long long* rs,
                     const long long* cs, const double* scal, int n_leaves) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_leaves; ++i) {
    a->leaf[i] = Leaf{ptrs[i], rs[i], cs[i]};
    a->scal[i] = (T)scal[i];
  }
  for (int i = n_leaves; i < kMaxLeaves; ++i) {
    a->leaf[i] = Leaf{nullptr, 0, 0};
    a->scal[i] = T(0);
  }
  return 0;
}

// agg 0: out (m, n) elementwise; agg 1: out (1,) the full sum, partial
// holds `grid` doubles
template <typename T, typename P>
int launch_cell(int agg, const void* const* ptrs, const long long* rs,
                const long long* cs, const double* scal, int n_leaves,
                long long m, long long n, void* out, void* partial, int grid,
                cudaStream_t stream) {
  Args<T> a;
  const int e = fill_args(&a, ptrs, rs, cs, scal, n_leaves);
  if (e) return e;
  if (grid < 1 || m < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (agg == 0) {
    cell_map<T, P><<<grid, kThreads, 0, stream>>>(a, m, n, static_cast<T*>(out));
  } else {
    cell_sum<T, P><<<grid, kThreads, 0, stream>>>(a, m, n,
                                                  static_cast<double*>(partial));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials<T><<<1, kThreads, 0, stream>>>(
        static_cast<const double*>(partial), grid, static_cast<T*>(out));
  }
  return (int)cudaGetLastError();
}

// row_agg 0/1/2 = sum/min/max; out (m, 1) contiguous
template <typename T, typename P>
int launch_row(int row_agg, const void* const* ptrs, const long long* rs,
               const long long* cs, const double* scal, int n_leaves,
               long long m, long long n, void* out, int grid,
               cudaStream_t stream) {
  Args<T> a;
  const int e = fill_args(&a, ptrs, rs, cs, scal, n_leaves);
  if (e) return e;
  // a row of no cells: its sum is 0, its min and max have no value
  if (grid < 1 || m < 0 || n < 0 || (n == 0 && row_agg != kSum))
    return (int)cudaErrorInvalidValue;
  T* o = static_cast<T*>(out);
  const bool narrow = n <= 32;
  switch (row_agg) {
    case kSum:
      if (narrow) row_thread<T, P, kSum><<<grid, kThreads, 0, stream>>>(a, m, n, o);
      else row_warp<T, P, kSum><<<grid, kThreads, 0, stream>>>(a, m, n, o);
      break;
    case kMin:
      if (narrow) row_thread<T, P, kMin><<<grid, kThreads, 0, stream>>>(a, m, n, o);
      else row_warp<T, P, kMin><<<grid, kThreads, 0, stream>>>(a, m, n, o);
      break;
    case kMax:
      if (narrow) row_thread<T, P, kMax><<<grid, kThreads, 0, stream>>>(a, m, n, o);
      else row_warp<T, P, kMax><<<grid, kThreads, 0, stream>>>(a, m, n, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// aggs[0..n_aggs) in RowAgg codes; out (n_aggs,) contiguous; partial
// holds grid * n_aggs doubles
template <typename T, typename P>
int launch_multiagg(const void* const* ptrs, const long long* rs,
                    const long long* cs, const double* scal, int n_leaves,
                    long long m, long long n, int n_aggs, const int* aggs,
                    void* out, void* partial, int grid, cudaStream_t stream) {
  Args<T> a;
  const int e = fill_args(&a, ptrs, rs, cs, scal, n_leaves);
  if (e) return e;
  // min and max of no cells have no value
  if (grid < 1 || m < 0 || n < 0 || n_aggs < 1 || n_aggs > kMaxAggs)
    return (int)cudaErrorInvalidValue;
  Aggs g;
  g.n = n_aggs;
  for (int k = 0; k < kMaxAggs; ++k) {
    g.code[k] = k < n_aggs ? aggs[k] : kSum;
    if (g.code[k] < kSum || g.code[k] > kMax ||
        (m * n == 0 && g.code[k] != kSum))
      return (int)cudaErrorInvalidValue;
  }
  multiagg<T, P><<<grid, kThreads, 0, stream>>>(a, g, m, n,
                                                static_cast<double*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_partials<T><<<1, kThreads, 0, stream>>>(
      static_cast<const double*>(partial), grid, g, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// out (1,) = the plan summed over X's (m, n); U (m, r) and V (n, r) as
// leaves {ptr, rs, cs} of the main dtype; partial holds grid_x * grid_y
// doubles
template <typename T, typename P>
int launch_outer(const void* const* ptrs, const long long* rs,
                 const long long* cs, const double* scal, int n_leaves,
                 long long m, long long n, int r, const void* u, long long urs,
                 long long ucs, const void* v, long long vrs, long long vcs,
                 void* out, void* partial, int grid_x, int grid_y,
                 cudaStream_t stream) {
  Args<T> a;
  const int e = fill_args(&a, ptrs, rs, cs, scal, n_leaves);
  if (e) return e;
  if (grid_x < 1 || grid_y < 1 || grid_y > 65535 || m < 0 || n < 0 ||
      r < 0 || r > kOuterMaxRank)
    return (int)cudaErrorInvalidValue;
  const Leaf lu{u, urs, ucs}, lv{v, vrs, vcs};
  const dim3 grid(grid_x, grid_y);
  double* p = static_cast<double*>(partial);
  if (r <= 4)
    outer_sum<T, P, 4><<<grid, kThreads, 0, stream>>>(a, lu, lv, m, n, r, p);
  else if (r <= 8)
    outer_sum<T, P, 8><<<grid, kThreads, 0, stream>>>(a, lu, lv, m, n, r, p);
  else if (r <= 16)
    outer_sum<T, P, 16><<<grid, kThreads, 0, stream>>>(a, lu, lv, m, n, r, p);
  else
    outer_sum<T, P, 32><<<grid, kThreads, 0, stream>>>(a, lu, lv, m, n, r, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<T><<<1, kThreads, 0, stream>>>(p, grid_x * grid_y,
                                              static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace spoof

// The extern "C" launchers of one plan's source. dtype 0 = float, 1 =
// double; pointers, strides and host numbers per leaf in the order of the
// plan's input names; returns a cudaError_t.
#define SPOOF_CELL_LAUNCHER(PLAN)                                              \
  extern "C" int smtorch_spoof_cell(                                           \
      int dtype, int agg, const void* const* ptrs, const long long* rs,        \
      const long long* cs, const double* scal, int n_leaves, long long m,      \
      long long n, void* out, void* partial, int grid, void* stream) {         \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    if (dtype == 0)                                                            \
      return spoof::launch_cell<float, PLAN>(agg, ptrs, rs, cs, scal,          \
                                             n_leaves, m, n, out, partial,     \
                                             grid, s);                         \
    if (dtype == 1)                                                            \
      return spoof::launch_cell<double, PLAN>(agg, ptrs, rs, cs, scal,         \
                                              n_leaves, m, n, out, partial,    \
                                              grid, s);                        \
    return (int)cudaErrorInvalidValue;                                         \
  }

#define SPOOF_ROW_LAUNCHER(PLAN)                                               \
  extern "C" int smtorch_spoof_row(                                            \
      int dtype, int row_agg, const void* const* ptrs, const long long* rs,    \
      const long long* cs, const double* scal, int n_leaves, long long m,      \
      long long n, void* out, int grid, void* stream) {                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    if (dtype == 0)                                                            \
      return spoof::launch_row<float, PLAN>(row_agg, ptrs, rs, cs, scal,       \
                                            n_leaves, m, n, out, grid, s);     \
    if (dtype == 1)                                                            \
      return spoof::launch_row<double, PLAN>(row_agg, ptrs, rs, cs, scal,      \
                                             n_leaves, m, n, out, grid, s);    \
    return (int)cudaErrorInvalidValue;                                         \
  }

#define SPOOF_MULTIAGG_LAUNCHER(PLAN)                                          \
  extern "C" int smtorch_spoof_multiagg(                                       \
      int dtype, const void* const* ptrs, const long long* rs,                 \
      const long long* cs, const double* scal, int n_leaves, long long m,      \
      long long n, int n_aggs, const int* aggs, void* out, void* partial,      \
      int grid, void* stream) {                                                \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    if (dtype == 0)                                                            \
      return spoof::launch_multiagg<float, PLAN>(ptrs, rs, cs, scal,           \
                                                 n_leaves, m, n, n_aggs, aggs, \
                                                 out, partial, grid, s);       \
    if (dtype == 1)                                                            \
      return spoof::launch_multiagg<double, PLAN>(ptrs, rs, cs, scal,          \
                                                  n_leaves, m, n, n_aggs,      \
                                                  aggs, out, partial, grid,    \
                                                  s);                          \
    return (int)cudaErrorInvalidValue;                                         \
  }

#define SPOOF_OUTER_LAUNCHER(PLAN)                                             \
  extern "C" int smtorch_spoof_outer(                                          \
      int dtype, const void* const* ptrs, const long long* rs,                 \
      const long long* cs, const double* scal, int n_leaves, long long m,      \
      long long n, int r, const void* u, long long urs, long long ucs,         \
      const void* v, long long vrs, long long vcs, void* out, void* partial,   \
      int grid_x, int grid_y, void* stream) {                                  \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    if (dtype == 0)                                                            \
      return spoof::launch_outer<float, PLAN>(                                 \
          ptrs, rs, cs, scal, n_leaves, m, n, r, u, urs, ucs, v, vrs, vcs,     \
          out, partial, grid_x, grid_y, s);                                    \
    if (dtype == 1)                                                            \
      return spoof::launch_outer<double, PLAN>(                                \
          ptrs, rs, cs, scal, n_leaves, m, n, r, u, urs, ucs, v, vrs, vcs,     \
          out, partial, grid_x, grid_y, s);                                    \
    return (int)cudaErrorInvalidValue;                                         \
  }
