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
// That kernel (mmchain_partial) takes k <= 2048: 8 accumulator columns per
// thread. A wider X takes mmchain_wide, a thread-block cluster per range
// of rows (Hopper's distributed shared memory):
// - the cluster's S <= 8 blocks split k into slabs of ks <= 2048 columns,
//   one each. Each block copies its slab of the 8-row chunk into its own
//   shared memory, as above, and forms the partial dots of the chunk's
//   rows over its slab;
// - after a cluster barrier every block reads the S partial dots of each
//   row from its peers' shared memory and adds them in rank order, so
//   every block holds the same xv, then accumulates X_slab^T . xv for its
//   own columns in registers from its on-chip slab. X is read from device
//   memory once, as in the kernel above;
// - past k = 8 * 2048 = 16,384 one cluster cannot hold every column: the
//   columns go to P passes of S * ks columns (grid dimension y), each
//   cluster accumulating one pass's columns. A block still needs the whole
//   row's dot, so it adds the columns of its slab index in every other
//   pass, read from device memory (or L2, where the P clusters of a row
//   range run together): X is read P times.
// The partials (clusters, k, c) are summed in cluster order as above.
// cp.async double buffering, TMA and a persistent grid are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;            // chunk rows: one per warp
constexpr int kMaxK = 2048;
constexpr int kCols = kMaxK / kThreads;  // k columns per thread

constexpr int kMaxCluster = 8;          // the portable cluster size

size_t smem_bytes(int k, int c) {
  // chunk of X, v transposed, xv of the chunk
  return sizeof(float) * ((size_t)kRows * k + (size_t)c * k + (size_t)kRows * c);
}

// mmchain_wide: the block's slab of the chunk, two buffers of partial dots,
// xv of the chunk
size_t wide_smem_bytes(int ks, int c) {
  return sizeof(float) * ((size_t)kRows * ks + (size_t)3 * kRows * c);
}

// The wide kernel's split of k: P passes of S blocks of ks columns (ks a
// multiple of 32, at most kMaxK; P * S * ks >= k).
struct WideShape {
  int passes, blocks, ks;
};

WideShape wide_shape(int k) {
  const int per_pass = kMaxCluster * kMaxK;
  const int p = (k + per_pass - 1) / per_pass;
  const int s = (k + p * kMaxK - 1) / (p * kMaxK);
  int ks = (k + p * s - 1) / (p * s);
  ks = (ks + 31) / 32 * 32;
  return {p, s, ks};
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

// Copies columns 0 .. width - 1 of chunk rows r0 .. r0 + kRows - 1 of X
// (x points at the slab's first column; an element is a float or a
// float4) into dst, ks elements per row, zero past `width` and at or past
// `left` rows.
template <typename T>
__device__ __forceinline__ void load_slab(T* __restrict__ dst,
                                          const T* __restrict__ x,
                                          long long ldx, int ks, int width,
                                          long long r0, long long left) {
  const int tid = threadIdx.x;
  const int n = kRows * ks;
  const T zero = {};
  const int step_r = kThreads / ks, step_c = kThreads % ks;
  int row = tid / ks, col = tid % ks;
#pragma unroll 4
  for (int i = tid; i < n; i += kThreads) {
    dst[i] = row < left && col < width ? __ldg(x + (r0 + row) * ldx + col)
                                       : zero;
    row += step_r;
    col += step_c;
    if (col >= ks) { col -= ks; ++row; }
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

// A cluster of S blocks (cluster dimension (S, 1, 1)) per range of rows;
// block s of the cluster in pass p = blockIdx.y accumulates columns
// j0 = p S ks + s ks .. j0 + ks - 1 of k, and adds to each row's dot the
// columns of slab s in every pass. partial (clusters, k, C).
template <int C>
__global__ void __launch_bounds__(kThreads)
mmchain_wide(const float* __restrict__ x, const float* __restrict__ v,
             const float* __restrict__ w, float* __restrict__ partial,
             long long m, long long ldx, int k, int ctype, int w_cols,
             long long rows_per_cluster, int ks, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // kRows x ks: the block's slab
  float* dots = xs + kRows * ks;      // 2 x kRows x C partial dots
  float* xvs = dots + 2 * kRows * C;  // kRows x C

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int s = (int)cluster.block_rank();
  const long long cl = blockIdx.x / S;
  const int p = blockIdx.y, passes = gridDim.y;
  const int span = S * ks;  // the columns of a pass
  const int j0 = p * span + s * ks;
  const int width = k - j0 < 0 ? 0 : (k - j0 < ks ? k - j0 : ks);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float acc[kCols][C];
#pragma unroll
  for (int a = 0; a < kCols; ++a)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) acc[a][cc] = 0.f;

  const long long r_begin = cl * rows_per_cluster;
  long long r_end = r_begin + rows_per_cluster;
  if (r_end > m) r_end = m;

  int buf = 0;
  for (long long r0 = r_begin; r0 < r_end; r0 += kRows, buf ^= 1) {
    const long long left = r_end - r0;
    __syncthreads();  // the previous chunk's slab and xv are consumed
    if (vec) {
      load_slab(reinterpret_cast<float4*>(xs),
                reinterpret_cast<const float4*>(x + j0), ldx >> 2, ks >> 2,
                width >> 2, r0, left);
    } else {
      load_slab(xs, x + j0, ldx, ks, width, r0, left);
    }
    __syncthreads();

    {  // row `warp`'s dot over slab s of every pass
      float d[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) d[cc] = 0.f;
      const float* xr = xs + warp * ks;
      for (int j = lane; j < width; j += 32) {
        const float xj = xr[j];
        const float* vj = v + (long long)(j0 + j) * C;
#pragma unroll
        for (int cc = 0; cc < C; ++cc) d[cc] = fmaf(xj, __ldg(vj + cc), d[cc]);
      }
      const long long row = r0 + warp;
      if (passes > 1 && row < r_end) {
        const float* xg = x + row * ldx;
        for (int q = 0; q < passes; ++q) {
          if (q == p) continue;
          const int c0 = q * span + s * ks;
          const int c1 = k < c0 + ks ? k : c0 + ks;
          for (int j = c0 + lane; j < c1; j += 32) {
            const float xj = __ldg(xg + j);
            const float* vj = v + (long long)j * C;
#pragma unroll
            for (int cc = 0; cc < C; ++cc)
              d[cc] = fmaf(xj, __ldg(vj + cc), d[cc]);
          }
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          d[cc] += __shfl_xor_sync(0xffffffffu, d[cc], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) dots[(buf * kRows + warp) * C + cc] = d[cc];
      }
    }
    // every block's dots of this chunk are written; a block writes the
    // other buffer next, and this one again only after the next barrier,
    // which its peers reach after reading this one
    cluster.sync();
    if (tid < kRows * C) {
      const int r = tid / C, cc = tid - r * C;
      float sum = 0.f;
      for (int t = 0; t < S; ++t) {
        const float* peer = cluster.map_shared_rank(dots, t);
        sum += peer[(buf * kRows + r) * C + cc];
      }
      const long long row = r0 + r;
      float val = 0.f;
      if (row < r_end) {
        val = sum;
        if (ctype != 0) {
          const float wv = w[row * w_cols + (w_cols == 1 ? 0 : cc)];
          val = ctype == 1 ? val * wv : val - wv;
        }
      }
      xvs[r * C + cc] = val;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float xv[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) xv[cc] = xvs[r * C + cc];
      const float* xr = xs + r * ks;
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        const int j = tid + a * kThreads;
        if (j < width) {
          const float xj = xr[j];
#pragma unroll
          for (int cc = 0; cc < C; ++cc) acc[a][cc] = fmaf(xj, xv[cc], acc[a][cc]);
        }
      }
    }
  }
  // no block leaves while a peer may still read its dots
  cluster.sync();

  float* out = partial + (cl * k + j0) * C;
#pragma unroll
  for (int a = 0; a < kCols; ++a) {
    const int j = tid + a * kThreads;
    if (j < width) {
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

template <int C>
cudaLaunchConfig_t wide_config(int k, int clusters, int passes,
                               cudaLaunchAttribute* attr,
                               cudaStream_t stream) {
  const WideShape ws = wide_shape(k);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ws.blocks * clusters, passes, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = wide_smem_bytes(ws.ks, C);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ws.blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the wide kernel resident on the device at once, for (k, C);
// also raises its dynamic shared-memory limit.
template <int C>
cudaError_t wide_clusters(int k, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      mmchain_wide<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wide_smem_bytes(kMaxK, C));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config<C>(k, 1, 1, &attr, 0);
  return cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(mmchain_wide<C>), &cfg);
}

template <int C>
cudaError_t launch_wide(const float* x, const float* v, const float* w,
                        float* partial, long long m, long long ldx, int k,
                        int ctype, int w_cols, int clusters,
                        cudaStream_t stream) {
  const WideShape ws = wide_shape(k);
  long long per = (m + clusters - 1) / clusters;
  per = (per + kRows - 1) / kRows * kRows;
  const int vec = (k % 4 == 0) && (ldx % 4 == 0) && ((uintptr_t)x % 16 == 0);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wide_config<C>(k, clusters, ws.passes, &attr, stream);
  return cudaLaunchKernelEx(&cfg, mmchain_wide<C>, x, v, w, partial, m, ldx,
                            k, ctype, w_cols, per, ws.ks, vec);
}

}  // namespace

extern "C" {

// Rows of X per chunk: the wrapper sizes the grid with it.
int smtorch_mmchain_chunk_rows() { return kRows; }

// The widest k of mmchain_partial; a wider k takes mmchain_wide.
int smtorch_mmchain_narrow_max_k() { return kMaxK; }

// mmchain_wide at (k, c): its blocks per cluster and passes, and the
// clusters resident on the device at once (raising its dynamic
// shared-memory limit). Returns a cudaError_t.
int smtorch_mmchain_wide_plan(int k, int c, int* blocks, int* passes,
                              int* clusters) {
  if (k <= kMaxK) return (int)cudaErrorInvalidValue;
  const WideShape ws = wide_shape(k);
  *blocks = ws.blocks;
  *passes = ws.passes;
  switch (c) {
    case 1: return (int)wide_clusters<1>(k, clusters);
    case 2: return (int)wide_clusters<2>(k, clusters);
    case 3: return (int)wide_clusters<3>(k, clusters);
    case 4: return (int)wide_clusters<4>(k, clusters);
    case 5: return (int)wide_clusters<5>(k, clusters);
    case 6: return (int)wide_clusters<6>(k, clusters);
    case 7: return (int)wide_clusters<7>(k, clusters);
    case 8: return (int)wide_clusters<8>(k, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// grid: blocks of mmchain_partial for k <= 2048, else clusters of
// mmchain_wide per pass (smtorch_mmchain_wide_plan). Launches on `stream`
// and returns cudaGetLastError().
int smtorch_mmchain(const void* x, const void* v, const void* w, void* partial,
                    void* out, long long m, long long ldx, int k, int c,
                    int ctype, int w_cols, int grid, void* stream) {
  if (k < 1 || c < 1 || c > 8 || grid < 1 || m < 0 || ldx < k)
    return (int)cudaErrorInvalidValue;
  if (ctype != 0 && w == nullptr) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) {
    cudaError_t e = cudaErrorInvalidValue;
    switch (c) {
#define SMTORCH_WIDE(C)                                                     \
  case C:                                                                   \
    e = launch_wide<C>(xf, vf, wf, pf, m, ldx, k, ctype, w_cols, grid, s); \
    break;
      SMTORCH_WIDE(1)
      SMTORCH_WIDE(2)
      SMTORCH_WIDE(3)
      SMTORCH_WIDE(4)
      SMTORCH_WIDE(5)
      SMTORCH_WIDE(6)
      SMTORCH_WIDE(7)
      SMTORCH_WIDE(8)
#undef SMTORCH_WIDE
    }
    if (e != cudaSuccess) return (int)e;
  } else switch (c) {
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
