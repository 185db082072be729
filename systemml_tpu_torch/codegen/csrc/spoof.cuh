// Spoof (fused-operator) kernels for Hopper (sm_90a): the hand-written
// skeletons of the cell and row templates. A generated source per plan
// (codegen/build.py: plan_source) includes this header, defines one
// functor `Plan` whose body is the plan's expression (codegen/cplan.py:
// emit_cuda), and exports extern "C" launchers that instantiate the
// skeletons below with it, for float and double.
//
// Replaces systemml_tpu/codegen/kernels.py::cell_kernel (line 124: the
// elementwise arm, pallas_call at :149, and the full-sum arm, :183) and
// ::row_kernel (line 199, pallas_call at :225: each row reduced under sum,
// min or max). Mosaic compiled each plan for the TPU; a CUDA kernel cannot
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
// Simple and right first: no TMA, no cp.async, no vector loads.

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
