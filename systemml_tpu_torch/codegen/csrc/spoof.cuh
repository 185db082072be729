// Spoof (fused-operator) kernels for Hopper (sm_90a): the hand-written
// skeletons of the cell, row, multi-aggregate and outer-product
// templates. A generated source per plan (codegen/build.py: plan_source)
// includes this header, defines one functor `Plan` (its leaves' kinds,
// its scalar-only subtrees and its per-cell expression, from
// codegen/cplan.py: hoist and emit_cuda), and exports an extern "C"
// launcher that instantiates the template's skeletons below with it, for
// float and double.
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
// moves 24 MB: >= 7.2 us. The ratings summary's plan over V (71,567 x
// 10,681 fp32, read once) moves 3.058 GB: >= 0.913 ms. MultiLogReg's row
// plan on (2,000,000, 5) plus (2,000,000, 1) and the (2,000,000, 1) output
// moves 56 MB: >= 16.7 us.
//
// Design, and what it does about that bound:
// - The functor knows each leaf's kind (Plan::kind): read at every cell,
//   a scalar, or an alias of an earlier leaf (the same tensor named
//   twice). Every maximal subtree over scalars only (the summary's
//   sum(V) / sum(V != 0)) is computed once per thread, before the walk
//   (Plan::hoist), with the same operations and rounding.
// - + - * round as IEEE operations (__fadd_rn and kin): nvcc does not
//   contract them into FMAs, so a cell's value is the plain version's for
//   them, hoisted or not.
// - Two walks, chosen per launch on the host from shapes, strides and
//   alignment (codegen/kernels.py): the flat walk, when every cell leaf
//   is the main leaf's (m, n), contiguous and 16-byte aligned, and every
//   alias holds, walks a flat index: each thread loads 16 bytes per
//   distinct leaf (float4 / double2) twice before it uses the first, an
//   alias copies its target's registers, and a ragged tail of fewer than
//   one vector takes scalar loads. The general walk reads every leaf as a
//   descriptor {ptr, row stride, column stride} (element (r, c) at
//   ptr[r * rs + c * cs]: (m, n), (m, 1), (1, n), strided views), carrying
//   (row, column) from step to step: no division per cell.
// - One full-reduction skeleton (reduce_flat / reduce_general) serves the
//   cell template's sum and the multi-aggregate template: the aggregates
//   are a template pack (Aggs<kSum, kMin, ...>), so there is no per-cell
//   switch; sums go to a double accumulator (a vector's cells are added in
//   T first: one conversion per vector), min and max stay in T (exact)
//   and propagate NaN, as jnp.minimum/jnp.maximum.
// - One launch per reduction: each block reduces its threads in a fixed
//   shuffle tree and writes its partials; after __threadfence() and an
//   atomic ticket, the last block combines the partials in block order
//   and resets the ticket. No float atomics: two launches give the same
//   bits. The wrapper keeps the partials and the ticket per device and
//   stream. The grid is persistent: SMs x resident blocks (the occupancy
//   query), or fewer when the work is smaller.
// - Row: one thread per row when n <= 32 (MultiLogReg's n = 5: the
//   thread reads its row's 20 bytes, a warp 640 contiguous bytes), one
//   warp per row otherwise with a butterfly shuffle reduction. The plan's
//   value is evaluated at every (r, c) of the main leaf's (m, n), which is
//   the JAX kernel's broadcast to (tile, n) before the reduction.
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
//   A rank above 32 (the largest bucket) takes outer_sum_wide, a product
//   tiled as a GEMM's: a block per 128 x 128 tile of cells, a thread per
//   8 x 8 of them, whose dot products stay in registers while the rank is
//   walked in slabs of 16 (the tile's U and V rows staged rank-major in
//   shared memory: 16 shared loads for 64 FMAs a rank step), in the same
//   k order as above. X is read once. At rank 100 the bound is
//   operations: ALS-CG-ml10m's 1.53e11 FLOP take >= 2.28 ms at 67 TFLOP/s
//   fp32, against 0.913 ms for X's bytes.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace spoof {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 64;

// Plan::kind(i): leaf i is read at every cell, is a scalar (read once per
// thread, in Plan::hoist), is the outer template's per-cell uv, or (>= 0)
// aliases that earlier leaf
constexpr int kCellLeaf = -1;
constexpr int kScalarLeaf = -2;
constexpr int kUVLeaf = -3;

struct Leaf {
  const void* ptr;  // null: a host number, in Args::scal
  long long rs, cs;
};

template <typename T>
struct Args {
  Leaf leaf[kMaxLeaves];
  T scal[kMaxLeaves];
};

// element (r, c) of leaf i through its descriptor
template <typename T>
__device__ __forceinline__ T leaf(const Args<T>& a, int i, long long r,
                                  long long c) {
  const T* p = static_cast<const T*>(a.leaf[i].ptr);
  return p ? __ldg(p + r * a.leaf[i].rs + c * a.leaf[i].cs) : a.scal[i];
}

// a scalar leaf: a host number, or one element on the device
template <typename T>
__device__ __forceinline__ T scalar(const Args<T>& a, int i) {
  const T* p = static_cast<const T*>(a.leaf[i].ptr);
  return p ? __ldg(p) : a.scal[i];
}

// IEEE-rounded + - *, never contracted into an FMA
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// the operators of codegen/cplan.py (CELL_BINARY, CELL_UNARY)
namespace ops {
template <typename T> __device__ __forceinline__ T op_add(T a, T b) { return add_rn(a, b); }
template <typename T> __device__ __forceinline__ T op_sub(T a, T b) { return sub_rn(a, b); }
template <typename T> __device__ __forceinline__ T op_mul(T a, T b) { return mul_rn(a, b); }
// a product by a 0/1 mask of the same block (hops.hop.mask_operand): +0 at
// a masked cell whatever the other operand holds, as the JAX package's
// select(pred, other, 0)
template <typename T> __device__ __forceinline__ T op_mask_mul(T m, T b) { return m != T(0) ? b : T(0); }
template <typename T> __device__ __forceinline__ T op_div(T a, T b) { return a / b; }
template <typename T> __device__ __forceinline__ T op_pow(T a, T b) { return pow(a, b); }
template <typename T> __device__ __forceinline__ T op_sq(T a) { return mul_rn(a, a); }
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
template <typename T> __device__ __forceinline__ T op_sigmoid(T a) { return T(1) / add_rn(T(1), exp(-a)); }
template <typename T> __device__ __forceinline__ T op_floor(T a) { return floor(a); }
template <typename T> __device__ __forceinline__ T op_ceil(T a) { return ceil(a); }
template <typename T> __device__ __forceinline__ T op_round(T a) { return floor(add_rn(a, T(0.5))); }
template <typename T> __device__ __forceinline__ T op_sprop(T a) { return mul_rn(a, sub_rn(T(1), a)); }
}  // namespace ops

// ---- evaluating a plan -----------------------------------------------------

// 16-byte vectors of T
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using V = float4;
  static constexpr int kW = 4;
  static __device__ __forceinline__ float get(const float4& x, int e) {
    return e == 0 ? x.x : (e == 1 ? x.y : (e == 2 ? x.z : x.w));
  }
  static __device__ __forceinline__ float4 make(const float* y) {
    return make_float4(y[0], y[1], y[2], y[3]);
  }
};
template <>
struct Vec<double> {
  using V = double2;
  static constexpr int kW = 2;
  static __device__ __forceinline__ double get(const double2& x, int e) {
    return e == 0 ? x.x : x.y;
  }
  static __device__ __forceinline__ double2 make(const double* y) {
    return make_double2(y[0], y[1]);
  }
};

template <typename P>
struct Slots {
  static constexpr int kLeaves = P::kLeaves > 0 ? P::kLeaves : 1;
  static constexpr int kHoisted = P::kHoisted > 0 ? P::kHoisted : 1;
};

// the plan at (r, c), every non-scalar leaf read through its descriptor
// (aliases too: this walk assumes nothing of the layouts); uv is the
// outer template's per-cell value
template <typename T, typename P>
__device__ __forceinline__ T eval_at(const P& plan, const Args<T>& a,
                                     const T* h, long long r, long long c,
                                     T uv = T(0)) {
  T v[Slots<P>::kLeaves];
#pragma unroll
  for (int i = 0; i < P::kLeaves; ++i) {
    if (P::kind(i) == kUVLeaf) v[i] = uv;
    else if (P::kind(i) != kScalarLeaf) v[i] = leaf(a, i, r, c);
  }
  return plan(v, h);
}

// the flat walk's loads: vector j of every cell leaf (an alias is read
// from its target's registers)
template <typename T, typename P>
__device__ __forceinline__ void load_vec(const Args<T>& a, long long j,
                                         typename Vec<T>::V* x) {
  using V = typename Vec<T>::V;
#pragma unroll
  for (int i = 0; i < P::kLeaves; ++i)
    if (P::kind(i) == kCellLeaf)
      x[i] = __ldg(static_cast<const V*>(a.leaf[i].ptr) + j);
}

// the plan at the kW cells of the vectors x
template <typename T, typename P>
__device__ __forceinline__ void eval_vec(const P& plan, const T* h,
                                         const typename Vec<T>::V* x, T* y) {
#pragma unroll
  for (int e = 0; e < Vec<T>::kW; ++e) {
    T v[Slots<P>::kLeaves];
#pragma unroll
    for (int i = 0; i < P::kLeaves; ++i) {
      if (P::kind(i) == kCellLeaf) v[i] = Vec<T>::get(x[i], e);
      else if (P::kind(i) >= 0) v[i] = Vec<T>::get(x[P::kind(i)], e);
    }
    y[e] = plan(v, h);
  }
}

// the plan at flat cell k by scalar loads (the flat walk's ragged tail)
template <typename T, typename P>
__device__ __forceinline__ T eval_flat(const P& plan, const Args<T>& a,
                                       const T* h, long long k) {
  T v[Slots<P>::kLeaves];
#pragma unroll
  for (int i = 0; i < P::kLeaves; ++i)
    if (P::kind(i) == kCellLeaf)
      v[i] = __ldg(static_cast<const T*>(a.leaf[i].ptr) + k);
#pragma unroll
  for (int i = 0; i < P::kLeaves; ++i)
    if (P::kind(i) >= 0) v[i] = v[P::kind(i)];
  return plan(v, h);
}

// ---- the two walks -------------------------------------------------------------

// The flat walk over `total` cells: each thread takes vectors t, t + step,
// ... two at a time (both vectors' loads issued before the first is used),
// then at most one cell of the ragged tail. on_vec(j, y) gets vector j's
// kW values, on_cell(k, v) cell k's.
template <typename T, typename P, typename OnVec, typename OnCell>
__device__ __forceinline__ void walk_flat(const P& plan, const Args<T>& a,
                                          const T* h, long long total,
                                          OnVec on_vec, OnCell on_cell) {
  using V = typename Vec<T>::V;
  constexpr int W = Vec<T>::kW;
  const long long nvec = total / W;
  const long long step = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long j = t; j < nvec; j += 2 * step) {
    const long long j2 = j + step;
    const bool two = j2 < nvec;
    V x0[Slots<P>::kLeaves], x1[Slots<P>::kLeaves];
    load_vec<T, P>(a, j, x0);
    if (two) load_vec<T, P>(a, j2, x1);
    T y[W];
    eval_vec<T, P>(plan, h, x0, y);
    on_vec(j, y);
    if (two) {
      eval_vec<T, P>(plan, h, x1, y);
      on_vec(j2, y);
    }
  }
  if (t < total - nvec * W)
    on_cell(nvec * W + t, eval_flat<T, P>(plan, a, h, nvec * W + t));
}

// The general walk over the (m, n) cells, grid-stride, carrying (row,
// column) from step to step: no division per cell. on_cell(i, v) gets
// flat cell i's value.
template <typename T, typename P, typename OnCell>
__device__ __forceinline__ void walk_general(const P& plan, const Args<T>& a,
                                             const T* h, long long m,
                                             long long n, OnCell on_cell) {
  const long long total = m * n;
  const long long step = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  long long r = i / n, c = i - r * n;
  const long long step_r = step / n, step_c = step - step_r * n;
  for (; i < total; i += step) {
    on_cell(i, eval_at<T, P>(plan, a, h, r, c));
    r += step_r;
    c += step_c;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

// ---- cell template: elementwise ----------------------------------------------

// out (m, n) contiguous = plan at every cell; the flat walk
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
map_flat(const __grid_constant__ Args<T> a, long long total,
         T* __restrict__ out) {
  const P plan{};
  T h[Slots<P>::kHoisted];
  plan.hoist(a, h);
  typename Vec<T>::V* ov = reinterpret_cast<typename Vec<T>::V*>(out);
  walk_flat<T, P>(plan, a, h, total,
                  [&](long long j, const T* y) { ov[j] = Vec<T>::make(y); },
                  [&](long long k, T v) { out[k] = v; });
}

// the general walk
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
map_general(const __grid_constant__ Args<T> a, long long m, long long n,
            T* __restrict__ out) {
  const P plan{};
  T h[Slots<P>::kHoisted];
  plan.hoist(a, h);
  walk_general<T, P>(plan, a, h, m, n,
                     [&](long long i, T v) { out[i] = v; });
}

// ---- full reductions: the cell template's sum and the multi-aggregate ------

enum RowAgg { kSum = 0, kMin = 1, kMax = 2 };

// the aggregates of a reduction, in output order (repeats allowed)
template <int... C>
struct Aggs {
  static constexpr int kN = sizeof...(C);
  static constexpr bool kHasSum = ((C == kSum) || ...);
  static constexpr bool kHasMin = ((C == kMin) || ...);
  static constexpr bool kHasMax = ((C == kMax) || ...);
  static constexpr bool kValid = ((C >= kSum && C <= kMax) && ...);
  __host__ __device__ static constexpr int code(int k) {
    constexpr int c[] = {C...};
    return c[k];
  }
};

// min and max that give NaN when either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ double min_nan(double a, double b) { return ops::op_min(a, b); }
__device__ __forceinline__ double max_nan(double a, double b) { return ops::op_max(a, b); }

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

// one accumulator per kind of aggregate the pack holds: a double sum, a
// min and a max in T
template <typename T, typename R>
struct Acc {
  double s;
  T lo, hi;
  __device__ __forceinline__ void reset() {
    s = 0.0;
    lo = pos_inf<T>();
    hi = -pos_inf<T>();
  }
  __device__ __forceinline__ void merge(double os, T olo, T ohi) {
    if (R::kHasSum) s += os;
    if (R::kHasMin) lo = min_nan(lo, olo);
    if (R::kHasMax) hi = max_nan(hi, ohi);
  }
  __device__ __forceinline__ void add(T x) { merge((double)x, x, x); }
  // W cells: added in T in a fixed order, then one conversion
  template <int W>
  __device__ __forceinline__ void add_vec(const T* y) {
    T t = y[0], mn = y[0], mx = y[0];
#pragma unroll
    for (int e = 1; e < W; ++e) {
      if (R::kHasSum) t = add_rn(t, y[e]);
      if (R::kHasMin) mn = min_nan(mn, y[e]);
      if (R::kHasMax) mx = max_nan(mx, y[e]);
    }
    merge((double)t, mn, mx);
  }
  // a fixed shuffle tree: lane 0 ends with its warp's values combined
  __device__ __forceinline__ void warp_reduce() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      double os = 0.0;
      T olo = lo, ohi = hi;
      if (R::kHasSum) os = __shfl_down_sync(0xffffffffu, s, off);
      if (R::kHasMin) olo = __shfl_down_sync(0xffffffffu, lo, off);
      if (R::kHasMax) ohi = __shfl_down_sync(0xffffffffu, hi, off);
      merge(os, olo, ohi);
    }
  }
};

// the block's accumulators combined (warp tree, then warps in order); the
// block's partials written; the last block to finish combines every
// block's partials in block order into out[0 .. R::kN) and resets the
// ticket. partial holds 3 doubles (sum, min, max) per block.
template <typename T, typename R>
__device__ __forceinline__ void finish(Acc<T, R> acc,
                                       double* __restrict__ partial,
                                       unsigned int* __restrict__ ticket,
                                       T* __restrict__ out) {
  __shared__ double ws[kWarps][3];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc.warp_reduce();
  if (lane == 0) {
    ws[warp][0] = acc.s;
    ws[warp][1] = (double)acc.lo;
    ws[warp][2] = (double)acc.hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc<T, R> b;
    b.reset();
    for (int w = 0; w < kWarps; ++w) b.merge(ws[w][0], (T)ws[w][1], (T)ws[w][2]);
    double* p = partial + 3 * (long long)blockIdx.x;
    p[0] = b.s;
    p[1] = (double)b.lo;
    p[2] = (double)b.hi;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  Acc<T, R> t;
  t.reset();
  // four loads in flight per thread, then merged in block order
  for (int b0 = threadIdx.x; b0 < (int)gridDim.x; b0 += 4 * kThreads) {
    double q[4][3];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int b = b0 + u * kThreads;
      if (b < (int)gridDim.x) {
#pragma unroll
        for (int k = 0; k < 3; ++k) q[u][k] = __ldcg(partial + 3 * b + k);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (b0 + u * kThreads < (int)gridDim.x)
        t.merge(q[u][0], (T)q[u][1], (T)q[u][2]);
  }
  t.warp_reduce();
  if (lane == 0) {
    ws[warp][0] = t.s;
    ws[warp][1] = (double)t.lo;
    ws[warp][2] = (double)t.hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc<T, R> f;
    f.reset();
    for (int w = 0; w < kWarps; ++w) f.merge(ws[w][0], (T)ws[w][1], (T)ws[w][2]);
#pragma unroll
    for (int k = 0; k < R::kN; ++k)
      out[k] = R::code(k) == kSum ? (T)f.s : (R::code(k) == kMin ? f.lo : f.hi);
    *ticket = 0u;
  }
}

// out[k] = aggregate k of the plan over the (m, n) cells; the flat walk
template <typename T, typename P, typename R>
__global__ void __launch_bounds__(kThreads)
reduce_flat(const __grid_constant__ Args<T> a, long long total,
            double* __restrict__ partial, unsigned int* __restrict__ ticket,
            T* __restrict__ out) {
  const P plan{};
  T h[Slots<P>::kHoisted];
  plan.hoist(a, h);
  Acc<T, R> acc;
  acc.reset();
  walk_flat<T, P>(
      plan, a, h, total,
      [&](long long, const T* y) { acc.template add_vec<Vec<T>::kW>(y); },
      [&](long long, T v) { acc.add(v); });
  finish<T, R>(acc, partial, ticket, out);
}

// the general walk
template <typename T, typename P, typename R>
__global__ void __launch_bounds__(kThreads)
reduce_general(const __grid_constant__ Args<T> a, long long m, long long n,
               double* __restrict__ partial, unsigned int* __restrict__ ticket,
               T* __restrict__ out) {
  const P plan{};
  T h[Slots<P>::kHoisted];
  plan.hoist(a, h);
  Acc<T, R> acc;
  acc.reset();
  walk_general<T, P>(plan, a, h, m, n,
                     [&](long long, T v) { acc.add(v); });
  finish<T, R>(acc, partial, ticket, out);
}

// ---- row template --------------------------------------------------------

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
  T h[Slots<P>::kHoisted];
  plan.hoist(a, h);
  const long long step = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < m;
       r += step) {
    RowAcc<T, AGG> acc;
    for (long long c = 0; c < n; ++c) acc.add(eval_at<T, P>(plan, a, h, r, c));
    out[r] = acc.get();
  }
}

// n > 32: one warp per row, lanes strided over the columns
template <typename T, typename P, int AGG>
__global__ void __launch_bounds__(kThreads)
row_warp(const __grid_constant__ Args<T> a, long long m, long long n,
         T* __restrict__ out) {
  const P plan{};
  T h[Slots<P>::kHoisted];
  plan.hoist(a, h);
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long r = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       r < m; r += warps) {
    RowAcc<T, AGG> acc;
    for (long long c = lane; c < n; c += 32) acc.add(eval_at<T, P>(plan, a, h, r, c));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc.shfl_xor(off);
    if (lane == 0) out[r] = acc.get();
  }
}

// ---- outer-product template --------------------------------------------------

constexpr int kOuterRows = 64;
constexpr int kOuterBucketRank = 32;  // the largest rank bucket of outer_sum
// outer_sum_wide: rows and columns of X a block takes, a thread's rows
// and columns (16 x 16 threads), ranks per slab
constexpr int kWideTile = 128;
constexpr int kMicro = 8;
constexpr int kRankSlab = 16;

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
  T h[Slots<P>::kHoisted];
  plan.hoist(a, h);
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
        acc += (double)eval_at<T, P>(plan, a, h, row0 + i, c, uv);
      }
    }
  }
  const double b = block_sum(s, acc);
  if (threadIdx.x == 0)
    partial[(long long)blockIdx.y * gridDim.x + blockIdx.x] = b;
}

// As outer_sum, for any rank: a block takes a kWideTile x kWideTile tile of
// X's cells (its columns blockIdx.x, its row tiles grid-stride over
// blockIdx.y), a thread kMicro x kMicro of them (rows 8 ty .., columns
// 8 tx ..), whose uv stay in registers while the rank is walked in slabs
// of kRankSlab: the slab of the tile's U rows and V rows is staged rank-
// major in shared memory (rows padded by 4: the staging writes spread
// over the banks), and each rank step is 2 x kMicro shared loads for
// kMicro^2 FMAs, in the same k order as outer_sum.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
outer_sum_wide(const __grid_constant__ Args<T> a, const Leaf u, const Leaf v,
               long long m, long long n, int r, double* __restrict__ partial) {
  __shared__ __align__(16) T us[kRankSlab][kWideTile + 4];
  __shared__ __align__(16) T vs[kRankSlab][kWideTile + 4];
  __shared__ double s[kThreads];
  const P plan{};
  T h[Slots<P>::kHoisted];
  plan.hoist(a, h);
  const T* up = static_cast<const T*>(u.ptr);
  const T* vp = static_cast<const T*>(v.ptr);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long c0 = (long long)blockIdx.x * kWideTile;
  const long long tiles = (m + kWideTile - 1) / kWideTile;
  double acc = 0.0;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long row0 = tile * kWideTile;
    T uv[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) uv[i][j] = T(0);
    for (int k0 = 0; k0 < r; k0 += kRankSlab) {
      __syncthreads();  // the previous slab's readers are done
      // element e: rank k = e % kRankSlab of row (column) i = e / kRankSlab:
      // a warp reads two rows' slabs, contiguous where the rank is
#pragma unroll 4
      for (int e = threadIdx.x; e < kRankSlab * kWideTile; e += kThreads) {
        const int i = e / kRankSlab, k = e - i * kRankSlab;
        const bool kin = k0 + k < r;
        us[k][i] = (kin && row0 + i < m)
                       ? __ldg(up + (row0 + i) * u.rs + (k0 + k) * u.cs)
                       : T(0);
        vs[k][i] = (kin && c0 + i < n)
                       ? __ldg(vp + (c0 + i) * v.rs + (k0 + k) * v.cs)
                       : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kRankSlab; ++k) {
        T ur[kMicro], vr[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          ur[i] = us[k][kMicro * ty + i];
          vr[i] = vs[k][kMicro * tx + i];
        }
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            uv[i][j] = fma_t(ur[i], vr[j], uv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const long long row = row0 + kMicro * ty + i;
      if (row >= m) break;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const long long c = c0 + kMicro * tx + j;
        if (c < n) acc += (double)eval_at<T, P>(plan, a, h, row, c, uv[i][j]);
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

template <typename K>
inline int occupancy(K kernel, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            kThreads, 0);
}

// walk 0: flat, 1: general; out (m, n) contiguous
template <typename T, typename P>
int launch_map(int walk, const void* const* ptrs, const long long* rs,
               const long long* cs, const double* scal, int n_leaves,
               long long m, long long n, void* out, int grid,
               cudaStream_t stream) {
  Args<T> a;
  const int e = fill_args(&a, ptrs, rs, cs, scal, n_leaves);
  if (e) return e;
  if (grid < 1 || m < 0 || n < 0 || n_leaves != P::kLeaves)
    return (int)cudaErrorInvalidValue;
  T* o = static_cast<T*>(out);
  if (walk == 0) map_flat<T, P><<<grid, kThreads, 0, stream>>>(a, m * n, o);
  else if (walk == 1) map_general<T, P><<<grid, kThreads, 0, stream>>>(a, m, n, o);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int map_occupancy(int walk, int* blocks) {
  return walk == 0 ? occupancy(map_flat<T, P>, blocks)
                   : occupancy(map_general<T, P>, blocks);
}

// out (R::kN,) contiguous; partial holds 3 doubles per block of the grid;
// ticket is 0 before the launch and after it
template <typename T, typename P, typename R>
int launch_reduce(int walk, const void* const* ptrs, const long long* rs,
                  const long long* cs, const double* scal, int n_leaves,
                  long long m, long long n, int n_aggs, void* out,
                  void* partial, void* ticket, int grid, cudaStream_t stream) {
  static_assert(R::kN >= 1 && R::kValid, "aggregates are sum, min, max");
  Args<T> a;
  const int e = fill_args(&a, ptrs, rs, cs, scal, n_leaves);
  if (e) return e;
  // min and max of no cells have no value
  if (grid < 1 || m < 0 || n < 0 || n_aggs != R::kN ||
      n_leaves != P::kLeaves || (m * n == 0 && (R::kHasMin || R::kHasMax)))
    return (int)cudaErrorInvalidValue;
  T* o = static_cast<T*>(out);
  double* p = static_cast<double*>(partial);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  if (walk == 0)
    reduce_flat<T, P, R><<<grid, kThreads, 0, stream>>>(a, m * n, p, tk, o);
  else if (walk == 1)
    reduce_general<T, P, R><<<grid, kThreads, 0, stream>>>(a, m, n, p, tk, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T, typename P, typename R>
int reduce_occupancy(int walk, int* blocks) {
  return walk == 0 ? occupancy(reduce_flat<T, P, R>, blocks)
                   : occupancy(reduce_general<T, P, R>, blocks);
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
  if (grid < 1 || m < 0 || n < 0 || n_leaves != P::kLeaves ||
      (n == 0 && row_agg != kSum))
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
      r < 0 || n_leaves != P::kLeaves)
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
  else if (r <= kOuterBucketRank)
    outer_sum<T, P, 32><<<grid, kThreads, 0, stream>>>(a, lu, lv, m, n, r, p);
  else
    outer_sum_wide<T, P><<<grid, kThreads, 0, stream>>>(a, lu, lv, m, n, r, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<T><<<1, kThreads, 0, stream>>>(p, grid_x * grid_y,
                                              static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace spoof

// The extern "C" launchers of one plan's source. dtype 0 = float, 1 =
// double; walk 0 = flat, 1 = general; pointers, strides and host numbers
// per leaf in the order of the plan's input names; each returns a
// cudaError_t. The *_occupancy functions give the blocks of kThreads of
// one kernel that an SM holds.
#define SPOOF_CELL_LAUNCHER(PLAN)                                              \
  extern "C" int smtorch_spoof_cell(                                           \
      int dtype, int agg, int walk, const void* const* ptrs,                   \
      const long long* rs, const long long* cs, const double* scal,            \
      int n_leaves, long long m, long long n, void* out, void* partial,        \
      void* ticket, int grid, void* stream) {                                  \
    using Sum = spoof::Aggs<spoof::kSum>;                                      \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    if (dtype == 0)                                                            \
      return agg == 0 ? spoof::launch_map<float, PLAN>(                        \
                            walk, ptrs, rs, cs, scal, n_leaves, m, n, out,     \
                            grid, s)                                           \
                      : spoof::launch_reduce<float, PLAN, Sum>(                \
                            walk, ptrs, rs, cs, scal, n_leaves, m, n, 1, out,  \
                            partial, ticket, grid, s);                         \
    if (dtype == 1)                                                            \
      return agg == 0 ? spoof::launch_map<double, PLAN>(                       \
                            walk, ptrs, rs, cs, scal, n_leaves, m, n, out,     \
                            grid, s)                                           \
                      : spoof::launch_reduce<double, PLAN, Sum>(               \
                            walk, ptrs, rs, cs, scal, n_leaves, m, n, 1, out,  \
                            partial, ticket, grid, s);                         \
    return (int)cudaErrorInvalidValue;                                         \
  }                                                                            \
  extern "C" int smtorch_spoof_cell_occupancy(int dtype, int agg, int walk,    \
                                              int* blocks) {                   \
    using Sum = spoof::Aggs<spoof::kSum>;                                      \
    if (dtype == 0)                                                            \
      return agg == 0 ? spoof::map_occupancy<float, PLAN>(walk, blocks)        \
                      : spoof::reduce_occupancy<float, PLAN, Sum>(walk,        \
                                                                  blocks);     \
    if (dtype == 1)                                                            \
      return agg == 0 ? spoof::map_occupancy<double, PLAN>(walk, blocks)       \
                      : spoof::reduce_occupancy<double, PLAN, Sum>(walk,       \
                                                                   blocks);    \
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

// the aggregates follow the plan: spoof::kSum, kMin, kMax, in output order
#define SPOOF_MULTIAGG_LAUNCHER(PLAN, ...)                                     \
  extern "C" int smtorch_spoof_multiagg(                                       \
      int dtype, int walk, const void* const* ptrs, const long long* rs,       \
      const long long* cs, const double* scal, int n_leaves, long long m,      \
      long long n, int n_aggs, void* out, void* partial, void* ticket,         \
      int grid, void* stream) {                                                \
    using R = spoof::Aggs<__VA_ARGS__>;                                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
    if (dtype == 0)                                                            \
      return spoof::launch_reduce<float, PLAN, R>(                             \
          walk, ptrs, rs, cs, scal, n_leaves, m, n, n_aggs, out, partial,      \
          ticket, grid, s);                                                    \
    if (dtype == 1)                                                            \
      return spoof::launch_reduce<double, PLAN, R>(                            \
          walk, ptrs, rs, cs, scal, n_leaves, m, n, n_aggs, out, partial,      \
          ticket, grid, s);                                                    \
    return (int)cudaErrorInvalidValue;                                         \
  }                                                                            \
  extern "C" int smtorch_spoof_multiagg_occupancy(int dtype, int walk,         \
                                                  int* blocks) {               \
    using R = spoof::Aggs<__VA_ARGS__>;                                        \
    if (dtype == 0) return spoof::reduce_occupancy<float, PLAN, R>(walk, blocks); \
    if (dtype == 1) return spoof::reduce_occupancy<double, PLAN, R>(walk, blocks); \
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
