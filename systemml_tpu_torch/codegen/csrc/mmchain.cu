// mmchain for Hopper (sm_90a): t(X) %*% (w? * (X %*% v) -? y) in ONE pass
// over X.
//
// Replaces systemml_tpu/codegen/kernels.py::mmchain_kernel (the Pallas
// kernel of the LinearRegCG loop body q = t(X) %*% (X %*% p) + reg * p).
// ctype 0 = XtXv   t(X) %*% (X %*% v)
// ctype 1 = XtwXv  t(X) %*% (w * (X %*% v))
// ctype 2 = XtXvy  t(X) %*% ((X %*% v) - y)
//
// Bound: bytes. Each element of X is read from device memory once; the
// operations are 4*m*k fp32 FMAs-worth. At 2,000,000 x 1,000 fp32 that is
// 8.0 GB (>= 2.39 ms at the H100 SXM's 3.35 TB/s) against 8e9 operations
// (0.12 ms at 67 TFLOP/s fp32), so the kernel lives or dies by how close it
// keeps the memory system to its rate.
//
// Design:
// - A block of 256 threads owns a contiguous range of rows. It walks the
//   range in chunks of 8 rows: the chunk is copied into shared memory with
//   16-byte loads (4-byte loads when k, the row stride or X's address does
//   not allow them), zero-filled past the end of the range. That is the
//   ragged edge masked in the kernel: X is never padded or copied. Rows
//   may lie ldx >= k floats apart, so a column slice X[, a:b] of a wider
//   matrix is read in place.
// - Warp r forms xv[r] = X[r, :] . v for chunk row r (one warp per row,
//   lanes strided over k, a shuffle reduction), applies w or y, and zeroes
//   rows past the end of the range.
// - Every thread owns the columns j = tid + 256 * a of k and accumulates
//   X_chunk^T . xv for them in registers, from the same on-chip copy of the
//   chunk. So X is read once, and the chain's product runs from shared
//   memory.
// - Blocks run in parallel and in no order, so nothing is carried across
//   them: each block writes its (k, c) partial to a scratch buffer, and a
//   second kernel sums the partials in block order. No float atomics: two
//   launches on the same inputs give bit-identical output.
// - True fp32 products on the CUDA cores (FFMA, no TF32): at least as
//   precise as the TPU kernel's bf16x3 split, so its `precise` flag has
//   nothing to switch here.
// Limits: 128 <= k <= 2048 (8 accumulator columns per thread), c <= 8.
// cp.async double buffering, TMA and a persistent grid are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;            // chunk rows: one per warp
constexpr int kMaxK = 2048;
constexpr int kCols = kMaxK / kThreads;  // k columns per thread

size_t smem_bytes(int k, int c) {
  // chunk of X, v transposed, xv of the chunk
  return sizeof(float) * ((size_t)kRows * k + (size_t)c * k + (size_t)kRows * c);
}

// Copies chunk rows r0 .. r0 + kRows - 1 of X (rows ldx elements apart, k
// elements each; an element is a float or a float4) into dst, k elements
// per row, and zero-fills the rows at or past `left`. kFlat: ldx == k, the
// chunk is one contiguous span (a separate instantiation, so that the
// strided walk's registers do not cost the contiguous case occupancy).
template <bool kFlat, typename T>
__device__ __forceinline__ void load_chunk(T* __restrict__ dst,
                                           const T* __restrict__ x,
                                           long long ldx, int k, long long r0,
                                           long long left) {
  const int tid = threadIdx.x;
  const int n = kRows * k;
  const int nv = (int)(left < kRows ? left : kRows) * k;
  const T zero = {};
  if constexpr (kFlat) {
    const T* src = x + r0 * ldx;
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) {
      dst[i] = i < nv ? __ldg(src + i) : zero;
    }
  } else {
    // element i is X[r0 + row, col] with i = row * k + col; (row, col)
    // steps with i, so there is no division per element
    const int step_r = kThreads / k, step_c = kThreads % k;
    int row = tid / k, col = tid % k;
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) {
      dst[i] = i < nv ? __ldg(x + (r0 + row) * ldx + col) : zero;
      row += step_r;
      col += step_c;
      if (col >= k) { col -= k; ++row; }
    }
  }
}

template <int C, bool kFlat>
__global__ void __launch_bounds__(kThreads)
mmchain_partial(const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ w, float* __restrict__ partial,
                long long m, long long ldx, int k, int ctype, int w_cols,
                long long rows_per_block, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // kRows x k
  float* vt = xs + kRows * k;     // C x k (v transposed: conflict-free reads)
  float* xvs = vt + C * k;        // kRows x C

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < k * C; i += kThreads) {
    vt[(i % C) * k + i / C] = v[i];
  }

  float acc[kCols][C];
#pragma unroll
  for (int a = 0; a < kCols; ++a)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) acc[a][cc] = 0.f;

  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > m) r_end = m;

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    const long long left = r_end - r0;
    __syncthreads();  // the previous chunk is consumed; vt is written
    if (vec) {
      load_chunk<kFlat>(reinterpret_cast<float4*>(xs),
                 reinterpret_cast<const float4*>(x), ldx >> 2, k >> 2, r0,
                 left);
    } else {
      load_chunk<kFlat>(xs, x, ldx, k, r0, left);
    }
    __syncthreads();

    {  // xv for chunk row `warp`
      float s[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) s[cc] = 0.f;
      const float* xr = xs + warp * k;
      for (int j = lane; j < k; j += 32) {
        const float xj = xr[j];
#pragma unroll
        for (int cc = 0; cc < C; ++cc) s[cc] = fmaf(xj, vt[cc * k + j], s[cc]);
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s[cc] += __shfl_xor_sync(0xffffffffu, s[cc], off);
        }
      }
      if (lane == 0) {
        const long long row = r0 + warp;
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          float val = 0.f;
          if (row < r_end) {
            val = s[cc];
            if (ctype != 0) {
              const float wv = w[row * w_cols + (w_cols == 1 ? 0 : cc)];
              val = ctype == 1 ? val * wv : val - wv;
            }
          }
          xvs[warp * C + cc] = val;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float xv[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) xv[cc] = xvs[r * C + cc];
      const float* xr = xs + r * k;
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        const int j = tid + a * kThreads;
        if (j < k) {
          const float xj = xr[j];
#pragma unroll
          for (int cc = 0; cc < C; ++cc) acc[a][cc] = fmaf(xj, xv[cc], acc[a][cc]);
        }
      }
    }
  }

  float* out = partial + (long long)blockIdx.x * k * C;
#pragma unroll
  for (int a = 0; a < kCols; ++a) {
    const int j = tid + a * kThreads;
    if (j < k) {
#pragma unroll
      for (int cc = 0; cc < C; ++cc) out[j * C + cc] = acc[a][cc];
    }
  }
}

// out[e] = sum over blocks b, in block order, of partial[b][e]
__global__ void mmchain_reduce(const float* __restrict__ partial,
                               float* __restrict__ out, int n, int blocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * n + e];
  out[e] = s;
}

template <typename Kernel>
cudaError_t occupancy_of(Kernel kernel, int k, int c, int* blocks_per_sm) {
  // the limit is raised to what the largest k needs, so that a launch at
  // any k of this instantiation finds it high enough
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxK, c));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kThreads, smem_bytes(k, c));
}

template <int C>
cudaError_t occupancy(int k, int flat, int* blocks_per_sm) {
  return flat ? occupancy_of(mmchain_partial<C, true>, k, C, blocks_per_sm)
              : occupancy_of(mmchain_partial<C, false>, k, C, blocks_per_sm);
}

template <int C>
void launch_partial(const float* x, const float* v, const float* w,
                    float* partial, long long m, long long ldx, int k,
                    int ctype, int w_cols, int grid, cudaStream_t stream) {
  long long per = (m + grid - 1) / grid;
  per = (per + kRows - 1) / kRows * kRows;
  const int vec = (k % 4 == 0) && (ldx % 4 == 0) && ((uintptr_t)x % 16 == 0);
  auto kernel = ldx == k ? mmchain_partial<C, true> : mmchain_partial<C, false>;
  kernel<<<grid, kThreads, smem_bytes(k, C), stream>>>(
      x, v, w, partial, m, ldx, k, ctype, w_cols, per, vec);
}

}  // namespace

extern "C" {

// Rows of X per chunk: the wrapper sizes the grid with it.
int smtorch_mmchain_chunk_rows() { return kRows; }

// Resident blocks per SM of the partial kernel for (k, c) and rows that
// are contiguous (flat: ldx == k) or not; also raises its dynamic
// shared-memory limit. Returns a cudaError_t.
int smtorch_mmchain_blocks_per_sm(int k, int c, int flat, int* blocks_per_sm) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 1: return (int)occupancy<1>(k, flat, blocks_per_sm);
    case 2: return (int)occupancy<2>(k, flat, blocks_per_sm);
    case 3: return (int)occupancy<3>(k, flat, blocks_per_sm);
    case 4: return (int)occupancy<4>(k, flat, blocks_per_sm);
    case 5: return (int)occupancy<5>(k, flat, blocks_per_sm);
    case 6: return (int)occupancy<6>(k, flat, blocks_per_sm);
    case 7: return (int)occupancy<7>(k, flat, blocks_per_sm);
    case 8: return (int)occupancy<8>(k, flat, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x (m, k) with rows ldx >= k floats apart (a column or row slice of a
// wider matrix); v (k, c), w (m, w_cols) or null, partial (grid, k, c)
// scratch and out (k, c) contiguous; all fp32 on the current device.
// Launches on `stream` and returns cudaGetLastError().
int smtorch_mmchain(const void* x, const void* v, const void* w, void* partial,
                    void* out, long long m, long long ldx, int k, int c,
                    int ctype, int w_cols, int grid, void* stream) {
  if (k < 1 || k > kMaxK || c < 1 || c > 8 || grid < 1 || m < 0 || ldx < k)
    return (int)cudaErrorInvalidValue;
  if (ctype != 0 && w == nullptr) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch_partial<1>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); break;
    case 2: launch_partial<2>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); break;
    case 3: launch_partial<3>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); break;
    case 4: launch_partial<4>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); break;
    case 5: launch_partial<5>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); break;
    case 6: launch_partial<6>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); break;
    case 7: launch_partial<7>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); break;
    case 8: launch_partial<8>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = k * c;
  mmchain_reduce<<<(n + 255) / 256, 256, 0, s>>>(pf, static_cast<float*>(out), n, grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
