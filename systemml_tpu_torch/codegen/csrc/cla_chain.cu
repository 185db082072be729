// Compressed mmchain (kernel K6) for Hopper (sm_90a): the pass over the rows
// of t(X) %*% (w? * (X %*% v) -? y) with X compressed into G column groups
// whose rows are uint8 dictionary codes.
//
// Replaces systemml_tpu/compress/device.py::_chain_kernel_call (its
// pallas_call at line 563), which tpu_mmchain / _tpu_mmchain_impl drive. As
// there, the value table and the output assembly stay outside the kernel,
// as torch ops (systemml_tpu_torch/compress/device.py chain_mmchain):
//   sv[j, g, :]    = dict_g[j, :] @ v[cols_g, :]         (dmax, G, k)
//   out[cols_g, :] = dict_g^T @ part[:, g, :]
// The kernel computes, for ctype 0 = XtXv, 1 = XtwXv, 2 = XtXvy:
//   xv[r]         = sum over g of sv[code_g[r], g, :]
//   z[r]          = xv[r], w[r] * xv[r] or xv[r] - y[r]
//   part[j, g, :] = sum of z[r] over the rows r with code_g[r] == j
//
// Bound: bytes. The codes are read once, G * n bytes, plus w or y; the
// table and the histograms are small. At the Census shape (2,458,285 x 68,
// k = 1) that is 167 MB: 0.050 ms at the H100 SXM's 3.35 TB/s. The
// operations, a lookup and an add per row and group and a histogram add,
// are about 2 * G * n * k: 0.005 ms at 67 TFLOP/s.
//
// Design (a simple one; closing the gap to the bound is later work):
// - The TPU kernel built one-hot masks per dictionary slot and contracted
//   them on its matrix unit, because a TPU gathers badly. A gather from
//   shared memory costs little on the card: the table sits in shared memory
//   and each row looks its G entries up. No masks, and no padding of rows
//   (the ragged last tile is masked by its row count) or of groups.
// - A group's code row starts 16 bytes aligned (the caller's layout rounds
//   the row stride up to a multiple of 16, ldc), so that a tile's codes
//   arrive by 16-byte loads: byte loads, one 32-byte sector per warp
//   instruction, kept too few bytes in flight and read the codes at about
//   a tenth of the card's rate.
// - A fixed grid of a few blocks per SM; block b walks the row tiles b,
//   b + grid, ... in order. Per tile of kTile rows:
//   1. the block copies the tile's codes of every group into shared memory
//      with 16-byte loads;
//   2. a thread per row looks its G entries up in the table, sums xv,
//      applies w or y and writes z to shared memory;
//   3. each (group, column of v) pair is split over S = kTile / pairs row
//      slices (1 when there are kTile pairs or more), so that most threads
//      work: a thread adds the z of the rows of its slice, in row order,
//      to its own histogram slot of each row's code, in shared memory.
// - At the end a block sums its S slices in slice order and writes its
//   (dmax, G, k) histograms; a second kernel sums the blocks' histograms
//   in block order (a warp per entry, lanes over blocks, a fixed shuffle
//   tree). No float atomics: two launches on the same inputs give
//   bit-identical output.
// - Every sum is in double, also for fp32 inputs: a slot of the Census
//   shape gathers about 300,000 rows, and fp32 sums would lose digits.
// Limits: dmax <= 8, k <= 8, and a block's shared memory, smem_bytes below,
// within the card's 227 KB. The codes must be < dmax (the caller's layout
// builds them so).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;           // rows per tile = threads per block
constexpr int kCodeStride = kTile + 4;  // a group's codes in shared memory:
                                        // the padding spreads the groups of
                                        // one warp over the banks
constexpr int kMaxDict = 8;
constexpr int kMaxK = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB

int slices_of(int pairs) { return pairs >= kTile ? 1 : kTile / pairs; }

size_t smem_bytes(int dmax, int groups, int k) {
  // table and slice histograms, the tile's z (doubles), the tile's codes
  const size_t pairs = (size_t)groups * k;
  return sizeof(double) * ((size_t)dmax * pairs * (1 + slices_of((int)pairs)) +
                           (size_t)kTile * k) +
         (size_t)groups * kCodeStride;
}

template <typename T>
__global__ void __launch_bounds__(kTile)
cla_chain_partial(const uint8_t* __restrict__ codes, long long ldc,
                  const T* __restrict__ sv, const T* __restrict__ w,
                  double* __restrict__ partial, long long n, int groups,
                  int dmax, int k, int ctype, int w_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pairs = groups * k;
  const int e = dmax * pairs;
  const int slices = pairs >= kTile ? 1 : kTile / pairs;
  double* sv_s = reinterpret_cast<double*>(smem);  // (dmax, G, k)
  double* hist_s = sv_s + e;                       // (slices, dmax, G, k)
  double* z_s = hist_s + slices * e;               // kTile x k
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(z_s + kTile * k);  // G rows

  const int tid = threadIdx.x;
  for (int i = tid; i < e; i += kTile) sv_s[i] = (double)sv[i];
  for (int i = tid; i < slices * e; i += kTile) hist_s[i] = 0.0;

  constexpr int kChunks = kTile / 16;  // 16-byte chunks of a tile's codes
  const long long tiles = (n + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * kTile;
    const int rows = (int)(n - r0 < kTile ? n - r0 : kTile);
    __syncthreads();  // the previous tile is consumed; the table is loaded
    for (int i = tid; i < groups * kChunks; i += kTile) {
      const int g = i / kChunks, ch = i - g * kChunks;
      const long long off = r0 + 16 * ch;
      if (off < ldc) {  // the row's allocation ends at ldc
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            codes + (long long)g * ldc + off));
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(codes_s + g * kCodeStride + 16 * ch);
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    }
    __syncthreads();
    if (tid < rows) {
      const long long row = r0 + tid;
      double xv[kMaxK];
#pragma unroll
      for (int c = 0; c < kMaxK; ++c) xv[c] = 0.0;
#pragma unroll 4
      for (int g = 0; g < groups; ++g) {
        const int j = codes_s[g * kCodeStride + tid];
        const double* s = sv_s + (j * groups + g) * k;
#pragma unroll
        for (int c = 0; c < kMaxK; ++c) {
          if (c < k) xv[c] += s[c];
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxK; ++c) {
        if (c < k) {
          double z = xv[c];
          if (ctype != 0) {
            const double wv = (double)w[row * w_cols + (w_cols == 1 ? 0 : c)];
            z = ctype == 1 ? z * wv : z - wv;
          }
          z_s[tid * k + c] = z;
        }
      }
    }
    __syncthreads();
    for (int q = tid; q < slices * pairs; q += kTile) {
      const int sl = q / pairs, p = q - sl * pairs;
      const int g = p / k, c = p - g * k;
      const uint8_t* cg = codes_s + g * kCodeStride;
      double* h = hist_s + sl * e + p;
      for (int r = sl; r < rows; r += slices) {
        h[cg[r] * pairs] += z_s[r * k + c];
      }
    }
  }
  __syncthreads();
  double* out = partial + (long long)blockIdx.x * e;
  for (int i = tid; i < e; i += kTile) {
    double s = 0.0;
    for (int sl = 0; sl < slices; ++sl) s += hist_s[sl * e + i];
    out[i] = s;
  }
}

// out[i] = sum over blocks b of partial[b][i]: a warp per entry, lane l
// summing blocks l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void cla_chain_reduce(const double* __restrict__ partial,
                                 double* __restrict__ out, int e, int blocks) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= e) return;  // the whole warp: i is the same on every lane
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32) s += partial[(long long)b * e + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (lane == 0) out[i] = s;
}

template <typename T>
cudaError_t launch_partial(const uint8_t* codes, long long ldc, const void* sv,
                           const void* w, double* partial, long long n,
                           int groups, int dmax, int k, int ctype, int w_cols,
                           int grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cla_chain_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cla_chain_partial<T><<<grid, kTile, smem, stream>>>(
      codes, ldc, static_cast<const T*>(sv), static_cast<const T*>(w), partial,
      n, groups, dmax, k, ctype, w_cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes (groups, n) uint8, rows ldc bytes apart, ldc >= n a multiple of 16
// and codes 16-byte aligned (a row is read in 16-byte chunks up to ldc);
// sv (dmax, groups, k) of dtype 0 = fp32, 1 = fp64;
// w (n, w_cols) of the same dtype, w_cols 1 or k, or null for ctype 0;
// partial (grid, dmax, groups, k) double scratch; out (dmax, groups, k)
// double. All contiguous on the current device. Launches on `stream` and
// returns a cudaError_t: the first launch's error, else the second's.
int smtorch_cla_chain(const void* codes, long long ldc, const void* sv,
                      const void* w, void* partial, void* out, long long n,
                      int groups, int dmax, int k, int ctype, int w_cols,
                      int dtype, int grid, void* stream) {
  if (n < 0 || groups < 1 || dmax < 1 || dmax > kMaxDict || k < 1 ||
      k > kMaxK || ctype < 0 || ctype > 2 || grid < 1 ||
      (dtype != 0 && dtype != 1) || ldc < n || ldc % 16 != 0 ||
      (uintptr_t)codes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (ctype != 0 && (w == nullptr || (w_cols != 1 && w_cols != k)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dmax, groups, k);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  double* pf = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_partial<float>(c, ldc, sv, w, pf, n, groups, dmax,
                                         k, ctype, w_cols, grid, smem, s)
                 : launch_partial<double>(c, ldc, sv, w, pf, n, groups, dmax,
                                          k, ctype, w_cols, grid, smem, s);
  if (err != cudaSuccess) return (int)err;
  const int e = dmax * groups * k;
  cla_chain_reduce<<<(e + 7) / 8, 256, 0, s>>>(  // 8 warps a block
      pf, static_cast<double*>(out), e, grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
