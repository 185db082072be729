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
// k = 1) that is 167 MB: 0.050 ms at the H100 SXM's 3.35 TB/s. At that rate
// the card issues about 9 lane-instructions per (row, group) pair, and the
// shared-memory pipe a little more than one access per pair, so the design
// counts both per pair.
//
// fp32 (cla_chain_f32, the main path's): a persistent grid, one block per
// SM, 512 threads for k <= 2 and 256 for wider v. Tiles of T rows (T =
// 1024, smaller only when G is large; tile_f32) are dealt in turn, tile i
// of block b at rows (i grid + b) T, for as many full rounds as n holds;
// the rows left are split equally over the blocks in 64-row blocks, one
// ragged tile each, so that the blocks end together:
// - Codes arrive asynchronously: two stages of (G, T) codes in shared
//   memory, filled by 16-byte cp.async copies, a warp per group row (the
//   caller's layout starts every row 16 bytes aligned, ldc); the next
//   tile's codes are in flight while this one computes. A ragged tile's
//   codes are copied up to its last row rounded to 16; its rows from there
//   to the end of their 64-row block are set to code 0 and z 0, and the
//   64-row blocks past them are not touched, so padding and other tiles'
//   rows are never counted.
// - Phase A, lanes over rows: a thread takes 2 rows (4 for k > 2), reads
//   their codes of each group as one 16-bit (32-bit) word, and looks them
//   up in the value table, kept in shared memory in fp32 in 256-byte
//   blocks. A code's byte offset in its block fits a byte, so one byte
//   permute (PRMT) of the scaled code word under the block's address forms
//   a lookup's address. For k = 1 a block holds a pair of groups, entry
//   j0 + 8 j1 = sv[j0, 2p] + sv[j1, 2p + 1]: one permute, load and add per
//   two (row, group) pairs. xv sums in a fixed order, in fp32; then z.
// - Phase B, an exact integer histogram, lanes over groups: the tile's
//   largest |z| (per column of v) sets a power-of-two scale, z is rounded
//   to an int32 of 32 - log2(T) bits, and a warp takes a 64-row block of
//   the tile: its lane 8 q + u adds rows 16 q .. 16 q + 15 of the block
//   into the slots of group 8 c + u, for each chunk c of 8 groups, with
//   shared-memory integer atomics (red.shared.add.s32). The 4 row quarters
//   keep 4 copies of a slot in adjacent words (each copy takes T / 4 rows,
//   so it stays below 2^30) and the 8 groups of a chunk 8 such quadruples,
//   so the 32 lanes of a warp hit 32 banks whatever their codes; a code's
//   slot is 256 bytes (times k / 2 for k > 2) from the next, and the
//   histogram is aligned so that one permute puts the code under byte 1
//   of the lane's address. Integer addition is associative: the order of the
//   atomics does not change the result, and no float atomics are used.
//   With 64 rows a warp in both phases (a full tile of 1024, k <= 2) a
//   warp reads only the z it computed, and needs no block barrier before
//   phase B. A ragged tile's phase B walks only its 64-row blocks with
//   rows in them.
// - At the end of the tile each slot's 4 copies are added in 64 bits and
//   scaled back into its fp64 accumulator in shared memory (one owner
//   thread per slot) and reset.
// - A tile whose z holds NaN or +-Inf cannot be scaled: it sums, instead,
//   each slot's z in row order in double (its owner thread), so that part
//   holds NaN and +-Inf in the slots where chain_plain has them.
// Rounding: z is rounded to a multiple of 2^(E - 21) at T = 1024, 2^E <=
// the tile's largest |z| < 2^(E + 1): at most 2^-22 of that |z| a row (the
// fp32 z itself carries 2^-24 of its own). A slot whose rows all carry z
// far below their tile's largest keeps fewer relative digits than the
// normwise error shows. xv sums in fp32, as the JAX package's kernel; the
// slots accumulate in double. Tiles whose largest |z| is below 2^-100 lose
// bits (the scale is capped so that it stays a normal float).
// What bounds it: the copies, then phase B's shared-memory writes (one
// warp-wide write per 32 (row, group) pairs; plain stores cost as much as
// the atomics), with phase A's lookups mostly hidden behind them.
// `python3 chip_smoke.py --phases` times the kernel with and without the
// atomics, and the copies alone (K6_PROBE below).
//
// fp64 (cla_chain_f64): exact in double, a thread per row; each (group,
// column of v) pair is split over S = 256 / pairs row slices (1 when there
// are 256 pairs or more) that add z in row order to their own histogram
// slot in shared memory. Not on the main path.
//
// Many groups (fp32 past about 112 groups of 8 codes, fp64 past about 168):
// when a block of the kernel above cannot hold every group's table,
// histograms and codes in its 227 KB (smem_f32_at / smem_f64 below), the
// groups go to slabs instead, in two kernels:
// - cla_chain_z: z of every row, a thread per 16 rows for k = 1 (a 16-byte
//   word of each group's codes; 4 rows, a 32-bit word, for wider v),
//   summing the table's entries over the groups in group order in the
//   table's type (fp32 as the kernel above, fp64 in double), into a (n, k)
//   scratch of that type; the table sits in shared memory, group-major,
//   where it fits (else it is read from L2). The codes are read once;
// - cla_chain_slab: a grid of (row ranges, slabs of groups); a block holds
//   its slab's histograms in shared memory as cla_chain_f64 does (row
//   slices adding z in row order, in double; a code's row of pairs padded
//   to 16 doubles, so that the lanes' read-modify-writes fall in
//   different banks whatever the codes) and takes its row range's
//   tiles of 256 rows: the slab's codes and the tile's z, read again (the
//   codes once more in all, z once per slab). Slabs are as large as fit
//   a sixth of an SM's shared memory (six blocks per SM), and balanced.
// Bound as above: the codes once, G * n bytes; this path reads them twice
// and z (n k values) S + 1 times.
//
// All end alike: per-block fp64 histograms, summed by cla_chain_reduce in
// block order (a warp per entry, lanes over blocks, a fixed shuffle tree).
// Two launches on the same inputs give bit-identical output.
//
// Limits: dmax <= 8 (the JAX package's kernel's), k <= 8 (the caller runs
// a wider v 8 columns at a time); any number of groups. The codes must be
// < dmax (the caller's layout builds them so).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDict = 8;
constexpr int kMaxK = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB
constexpr int kMaxDevices = 64;

// ---- fp32 ------------------------------------------------------------------

// Rows per thread in phase A and threads per block: 2 rows (a 16-bit word
// of codes per group) and 512 threads for k <= 2, 4 rows (a 32-bit word)
// and 256 threads, within 128 registers, for wider v. A tile is at most
// 1024 rows.
__host__ __device__ constexpr int rows_of(int k) { return k <= 2 ? 2 : 4; }
__host__ __device__ constexpr int threads_of(int k) {
  return 1024 / rows_of(k);
}
constexpr int kStages = 2;  // tiles of codes in shared memory

int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// A block's shared memory at T rows per tile: the alignment slack, the
// table (8 / kp groups of 32 kp bytes in each 256-byte block; for k = 1 a
// pair of groups, 64 entries, in each), the code ring (each group's row of
// a stage padded by 16 bytes), the tile's z, the int32 histogram (a chunk
// of 8 groups takes 8 code slots of 128 max(kp, 2) bytes) aligned to a
// chunk's bytes, the fp64 accumulators, the per-warp maxima.
size_t smem_f32_at(int tile, int dmax, int groups, int k) {
  const size_t warps = threads_of(k) / 32;
  const size_t kp = pow2_at_least(k), chunks = (groups + 7) / 8;
  const size_t per_block = k == 1 ? 2 : 8 / kp;
  const size_t chunk_bytes = 1024 * (kp < 2 ? 2 : kp);
  return 256 + 256 * ((groups + per_block - 1) / per_block) +
         (size_t)kStages * groups * (tile + 16) + 4 * kp * tile +
         chunk_bytes * (chunks + 1) + 8 * (size_t)dmax * groups * k +
         4 * warps * kp;
}

// The largest tile of 1024, 512, ..., 64 rows whose block fits; 0 if none.
int tile_f32(int dmax, int groups, int k) {
  for (int t = 1024; t >= 64; t >>= 1)
    if (smem_f32_at(t, dmax, groups, k) <= kMaxSmem) return t;
  return 0;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 lds_v4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float2 lds_v2f(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float4 lds_v4f(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// chip_smoke.py --phases builds this file also with K6_PROBE = 1 (phase
// B's atomics left out), 2 (plain stores in their place) and 3 (each
// tile's codes copied and nothing else; in the slab path, cla_chain_z
// streams the codes without the table and cla_chain_slab copies each
// tile's codes and z without the histogram): wrong results, timed to show
// where the kernel's time goes. 0 is the kernel.
#ifndef K6_PROBE
#define K6_PROBE 0
#endif

__device__ __forceinline__ void red_add(uint32_t a, int v) {
#if K6_PROBE == 1
  asm volatile("" ::"r"(a), "r"(v) : "memory");
#elif K6_PROBE == 2
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
#else
  asm volatile("red.shared.add.s32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
#endif
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// all but the newest N groups of copies are in
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// acc[c] += the table's K values at shared address a
template <int K>
__device__ __forceinline__ void add_entry(float (&acc)[K], uint32_t a) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int c = 0; c < K; c += 4) {
      const float4 v = lds_v4f(a + 4 * c);
      acc[c] += v.x;
      acc[c + 1] += v.y;
      acc[c + 2] += v.z;
      acc[c + 3] += v.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int c = 0; c < K; c += 2) {
      const float2 v = lds_v2f(a + 4 * c);
      acc[c] += v.x;
      acc[c + 1] += v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] += lds_f32(a + 4 * c);
  }
}

template <int K>
__global__ void __launch_bounds__(threads_of(K), 1)
cla_chain_f32(const uint8_t* __restrict__ codes, long long ldc,
              const float* __restrict__ sv, const float* __restrict__ w,
              double* __restrict__ partial, long long n, int groups, int dmax,
              int ctype, int w_cols, int lg_tile) {
  constexpr int KP = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : 8;
  // the histogram: per chunk of 8 groups, 8 code slots of kSlot bytes, a
  // column's 32 words at 128 c in a slot; a code's slot starts at
  // j * kSlot = (j * kCodeScale) << 8
  constexpr int kCodeScale = KP <= 2 ? 1 : KP / 2;
  constexpr uint32_t kSlot = 256u * kCodeScale, kChunkBytes = 8 * kSlot;
  // the table: groups of 32 KP bytes, kPerBlock to a 256-byte block
  constexpr int kPerBlock = 8 / KP;
  constexpr uint32_t kScale = 4 * K;  // a code's byte offset in its group
  constexpr int kRows = rows_of(K), kThreads = threads_of(K);
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = groups, T = 1 << lg_tile, TS = T + 16;
  const int chunks = (G + 7) >> 3;  // phase B's groups of 8
  const int e = dmax * G * K;
  // |z| scaled below 2^qbits: a slot's word takes T / 4 rows of a tile
  // (phase B), below 2^30 in all, and the flush adds its 4 words in 64 bits
  const int qbits = 32 - lg_tile;

  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t pad = (256u - (s0 & 255u)) & 255u;
  unsigned char* base = smem + pad;
  const uint32_t tbl_s = s0 + pad;  // 256-aligned
  // k = 1: a 256-byte block per pair of groups (the fill below)
  const int tbl_blocks =
      K == 1 ? (G + 1) / 2 : (G + kPerBlock - 1) / kPerBlock;
  const uint32_t ring_s = tbl_s + 256u * tbl_blocks;
  const uint32_t zbuf_s = ring_s + (uint32_t)(kStages * G * TS);
  // aligned to a chunk's bytes: no chunk's byte 1 + 7 kCodeScale carries
  const uint32_t hist_s =
      (zbuf_s + 4u * KP * T + kChunkBytes - 1) & ~(kChunkBytes - 1);
  const int hist_words = chunks * kChunkBytes / 4;
  unsigned char* ring = base + 256 * (size_t)tbl_blocks;
  int* zbuf = reinterpret_cast<int*>(ring + (size_t)kStages * G * TS);
  int* hist = reinterpret_cast<int*>(smem + (hist_s - s0));
  double* acc = reinterpret_cast<double*>(hist + hist_words);
  unsigned* red = reinterpret_cast<unsigned*>(acc + e);

  // The block's tiles: `rounds` full rounds of T-row tiles dealt in turn
  // (tile i of block b at rows (i grid + b) T, so that the blocks read
  // neighbouring rows at a time), then an equal share of the rows left, in
  // 64-row blocks, as one ragged tile, so that the blocks end together.
  const long long rounds = n / ((long long)gridDim.x << lg_tile);
  const long long last0 = (rounds * gridDim.x) << lg_tile;
  const long long per =
      ((n - last0 + 63) / 64 + gridDim.x - 1) / gridDim.x * 64;  // <= T
  const long long mine0 = last0 + blockIdx.x * per;
  const int tiles = (int)rounds + (mine0 < n ? 1 : 0);
  auto tile_at = [&](int t, long long& r0) {  // its first row; its rows
    if (t < rounds) {
      r0 = ((long long)t * gridDim.x + blockIdx.x) << lg_tile;
      return T;
    }
    r0 = mine0;
    return (int)(n - r0 < per ? n - r0 : per);
  };
  // a warp per group's row of the tile, 16 bytes a lane per copy, up to
  // its last row rounded to 16 (within ldc)
  auto issue = [&](int t, int stage) {
    long long r0;
    const int upto = (tile_at(t, r0) + 15) & ~15;
    const uint32_t dst = ring_s + (uint32_t)(stage * G * TS);
    for (int g = warp; g < G; g += kWarps) {
      const uint8_t* src = codes + g * ldc + r0;
      for (int ch = 16 * lane; ch < upto; ch += 512)
        cp_async16(dst + g * TS + ch, src + ch);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) issue(s, s);
    cp_async_commit();
  }

  float* tbl = reinterpret_cast<float*>(base);
  for (int i = tid; i < tbl_blocks * 64; i += kThreads) {
    if constexpr (K == 1) {
      // groups 2p and 2p + 1 with codes j0 and j1 at 64 p + j0 + 8 j1: one
      // lookup adds both (a last odd group pairs with code 0 of none)
      const int g = 2 * (i >> 6), j0 = i & 7, j1 = (i >> 3) & 7;
      tbl[i] = (j0 < dmax ? sv[j0 * G + g] : 0.f) +
               (j1 < dmax && g + 1 < G ? sv[j1 * G + g + 1] : 0.f);
    } else {
      const int g = (i >> 6) * kPerBlock + (i & 63) / (8 * KP);
      const int o = (i & 63) % (8 * KP);  // j * K + c
      tbl[i] = g < G && o < dmax * K ? sv[((o / K) * G + g) * K + o % K]
                                     : 0.f;
    }
  }
  for (int i = tid; i < hist_words; i += kThreads) hist[i] = 0;
  // slot s = (j G + g) K + c of the output: its 4 words in the histogram;
  // a thread's slots, computed once when it owns at most kOwn
  auto hist_at = [&](int s) {
    const int c = s % K, jg = s / K, g = jg % G, j = jg / G;
    return ((g >> 3) * 8 + j) * (int)(kSlot / 4) + c * 32 + 4 * (g & 7);
  };
  constexpr int kOwn = 2;
  int own_at[kOwn], own_c[kOwn];
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    const int s = tid + m * kThreads;
    own_at[m] = s < e ? hist_at(s) : -1;
    own_c[m] = s % K;
  }
  for (int i = tid; i < e; i += kThreads) acc[i] = 0.0;

  for (int t = 0, stage = 0; t < tiles;
       ++t, stage = stage == kStages - 1 ? 0 : stage + 1) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile's codes are in; the last tile is done
    const int ahead = t + kStages - 1;
    if (ahead < tiles)  // into the stage the last tile used
      issue(ahead, stage == 0 ? kStages - 1 : stage - 1);
    cp_async_commit();
    if constexpr (K6_PROBE == 3) continue;
    long long r0;
    const int rows = tile_at(t, r0);
    const int nb = (rows + 63) >> 6;  // 64-row blocks with rows in them
    const uint32_t cs = ring_s + (uint32_t)(stage * G * TS);
    unsigned char* cg = ring + (size_t)stage * G * TS;
    if (rows < 64 * nb) {  // the ragged tile: its rows past n or past its
      const int pad = 64 * nb - rows;  // share, to 64 n_b, count as code 0
      for (int i = tid; i < G * pad; i += kThreads) {
        const int g = i / pad;
        cg[g * TS + rows + (i - g * pad)] = 0;
      }
      __syncthreads();  // before phase A reads these bytes' words
    }

    // ---- phase A: z of rows kRows tid .. kRows tid + kRows - 1
    float z[kRows][K];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < K; ++c) z[i][c] = 0.f;
    const int q0 = kRows * tid;
    if (q0 < rows) {
      float wv[kRows][K];
      if (ctype != 0) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < K; ++c)
            wv[i][c] = q0 + i < rows
                           ? w[(r0 + q0 + i) * w_cols + (w_cols == 1 ? 0 : c)]
                           : 0.f;
      }
      // The rows' codes of group g in one word; each byte becomes the
      // entry's offset in its 256-byte block, code * 4K + (g % kPerBlock)
      // * 32 KP <= 252 (no carry into the next row's byte), and a permute
      // puts it under the block's address.
      auto lookup = [&](uint32_t ca, uint32_t ga, uint32_t off) {
        const uint32_t wd =
            (kRows == 4 ? lds_u32(ca) : lds_u16(ca)) * kScale +
            off * 0x01010101u;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          add_entry<K>(z[i], __byte_perm(wd, ga, 0x7650 + i));
      };
      uint32_t ca = cs + q0, ga = tbl_s;
      int g = 0;
      if constexpr (K == 1) {
        // a pair of groups a lookup: the byte 4 (j0 + 8 j1) <= 252
        auto pair = [&](uint32_t w0, uint32_t w1) {
          const uint32_t wd = (w0 + w1 * 8) * 4;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            z[i][0] += lds_f32(__byte_perm(wd, ga, 0x7650 + i));
        };
        auto codes_at = [&](uint32_t a) {
          return kRows == 4 ? lds_u32(a) : lds_u16(a);
        };
#pragma unroll 4
        for (; g + 2 <= G; g += 2, ca += 2 * TS, ga += 256)
          pair(codes_at(ca), codes_at(ca + TS));
        if (g < G) pair(codes_at(ca), 0);
      } else {
        for (; g + kPerBlock <= G; g += kPerBlock, ga += 256) {
#pragma unroll
          for (int u = 0; u < kPerBlock; ++u, ca += TS)
            lookup(ca, ga, 32 * KP * u);
        }
        for (int u = 0; g < G; ++g, ++u, ca += TS) lookup(ca, ga, 32 * KP * u);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < K; ++c) {
          float v = z[i][c];
          if (ctype == 1) v *= wv[i][c];
          if (ctype == 2) v -= wv[i][c];
          z[i][c] = q0 + i < rows ? v : 0.f;
        }
    }
    // the tile's largest |z| per column (its bits: NaN and Inf above all)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      unsigned m = 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const unsigned b = __float_as_uint(fabsf(z[i][c]));
        m = b > m ? b : m;
      }
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) red[warp * KP + c] = m;
    }
    __syncthreads();
    int ex[K];
    bool finite = true;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const unsigned m = __reduce_max_sync(
          0xffffffffu, lane < kWarps ? red[lane * KP + c] : 0u);
      finite = finite && m < 0x7f800000u;
      // |z| < 2^(ex - 126); the scale 2^(qbits + 126 - ex) stays normal
      const int b = (int)(m >> 23);
      ex[c] = b > qbits ? b : qbits;
    }
    if (q0 < T) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        int v[kRows];
        const float s = __uint_as_float((uint32_t)(qbits + 253 - ex[c]) << 23);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          v[i] = finite ? __float2int_rn(z[i][c] * s) : __float_as_int(z[i][c]);
        if constexpr (kRows == 4)
          *reinterpret_cast<int4*>(zbuf + c * T + q0) =
              make_int4(v[0], v[1], v[2], v[3]);
        else
          *reinterpret_cast<int2*>(zbuf + c * T + q0) = make_int2(v[0], v[1]);
      }
    }
    // With 64 rows a warp in both phases, phase B reads only the z its own
    // warp wrote (rows 64 w .. 64 w + 63); else, and for a tile of NaN or
    // Inf, any warp's.
    if (finite && kRows == 2 && nb == kWarps)
      __syncwarp();
    else
      __syncthreads();

    if (finite) {
      // ---- phase B: a warp takes a 64-row block of the tile (and a
      // slice of the group chunks when the tile has fewer blocks than
      // warps); lane l adds rows 16 (l / 8) .. + 15 of the block into the
      // slots of group 8 c + l % 8 for each chunk c of its slice. For
      // k <= 2 the lane's z stay in registers across the chunks.
      constexpr int kZ = K <= 2 ? K : 1;
      const int blocks = nb;
      const int slices = blocks >= kWarps ? 1 : kWarps / blocks;
      const int u = lane & 7, rq = lane >> 3;
      for (int it = warp; it < blocks * slices; it += kWarps) {
        const int rb = it % blocks, sl = it / blocks;
        const int r0b = 64 * rb + 16 * rq;  // the lane's first row
        uint4 zr[kZ][4];
        if constexpr (K <= 2) {
#pragma unroll
          for (int c = 0; c < K; ++c)
#pragma unroll
            for (int wi = 0; wi < 4; ++wi)
              zr[c][wi] = lds_v4(zbuf_s + 4u * (c * T + r0b + 4 * wi));
        }
        for (int chunk = sl; chunk < chunks; chunk += slices) {
          const int g = (chunk << 3) + u;
          if (g >= G) continue;
          const uint4 cw = lds_v4(cs + g * TS + r0b);
          // the lane's word of code 0's slot; its byte 1 (b1, no carry
          // past 255 with the code added, by the alignment) goes into
          // each code's byte, so that one permute of the code word forms
          // the slot's address
          const uint32_t hb = hist_s + chunk * kChunkBytes + 4 * (4 * u + rq);
          const uint32_t b1 = ((hb >> 8) & 0xffu) * 0x01010101u;
          const uint32_t words[4] = {cw.x * kCodeScale + b1,
                                     cw.y * kCodeScale + b1,
                                     cw.z * kCodeScale + b1,
                                     cw.w * kCodeScale + b1};
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
            uint4 zq[K];
#pragma unroll
            for (int c = 0; c < K; ++c) {
              if constexpr (K <= 2)
                zq[c] = zr[c][wi];
              else
                zq[c] = lds_v4(zbuf_s + 4u * (c * T + r0b + 4 * wi));
            }
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const uint32_t a = __byte_perm(words[wi], hb, 0x7604 + 16 * b);
#pragma unroll
              for (int c = 0; c < K; ++c)
                red_add(a + 128 * c, (int)(b == 0   ? zq[c].x
                                           : b == 1 ? zq[c].y
                                           : b == 2 ? zq[c].z
                                                    : zq[c].w));
            }
          }
        }
      }
      __syncthreads();
      // ---- scale each slot's 4 words back into its fp64 accumulator,
      // and reset them
      auto flush = [&](int s, int at, int c) {
        int4& h = *reinterpret_cast<int4*>(hist + at);
        const double inv = __longlong_as_double(
            (long long)(ex[c] - 126 - qbits + 1023) << 52);
        acc[s] += (double)((long long)h.x + h.y + h.z + h.w) * inv;
        h = make_int4(0, 0, 0, 0);
      };
      if (e <= kOwn * kThreads) {
#pragma unroll
        for (int m = 0; m < kOwn; ++m)
          if (own_at[m] >= 0) flush(tid + m * kThreads, own_at[m], own_c[m]);
      } else {
        for (int s = tid; s < e; s += kThreads) flush(s, hist_at(s), s % K);
      }
    } else {
      // ---- a tile with NaN or Inf: each slot's z in row order, in double
      const float* zf = reinterpret_cast<const float*>(zbuf);
      for (int s = tid; s < e; s += kThreads) {
        const int c = s % K, jg = s / K, g = jg % G, j = jg / G;
        const unsigned char* cr = cg + (size_t)g * TS;
        double sum = 0.0;
        for (int r = 0; r < rows; ++r)
          if (cr[r] == j) sum += (double)zf[c * T + r];
        acc[s] += sum;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  double* out = partial + (long long)blockIdx.x * e;
  for (int i = tid; i < e; i += kThreads) out[i] = acc[i];
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device: a runtime call only when a launch needs more than the last one
// set there.
template <typename F>
cudaError_t allow_smem(F kernel, size_t smem, int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= (int)smem) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = (int)smem;
  return err;
}

template <int K>
cudaError_t launch_f32(const uint8_t* codes, long long ldc, const void* sv,
                       const void* w, double* partial, long long n,
                       int groups, int dmax, int ctype, int w_cols, int grid,
                       cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  const int tile = tile_f32(dmax, groups, K);
  const size_t smem = smem_f32_at(tile, dmax, groups, K);
  int lg = 0;
  while ((1 << lg) < tile) ++lg;
  cudaError_t err = allow_smem(cla_chain_f32<K>, smem, allowed);
  if (err != cudaSuccess) return err;
  cla_chain_f32<K><<<grid, threads_of(K), smem, stream>>>(
      codes, ldc, static_cast<const float*>(sv), static_cast<const float*>(w),
      partial, n, groups, dmax, ctype, w_cols, lg);
  return cudaGetLastError();
}

// ---- fp64 ------------------------------------------------------------------

constexpr int kTile64 = 256;              // rows per tile = threads per block
constexpr int kCodeStride64 = kTile64 + 4;  // a group's codes in shared
                                            // memory: the padding spreads the
                                            // groups of one warp over banks

int slices_of(int pairs) { return pairs >= kTile64 ? 1 : kTile64 / pairs; }

size_t smem_f64(int dmax, int groups, int k) {
  // table and slice histograms, the tile's z, the tile's codes
  const size_t pairs = (size_t)groups * k;
  return sizeof(double) * ((size_t)dmax * pairs * (1 + slices_of((int)pairs)) +
                           (size_t)kTile64 * k) +
         (size_t)groups * kCodeStride64;
}

__global__ void __launch_bounds__(kTile64)
cla_chain_f64(const uint8_t* __restrict__ codes, long long ldc,
              const double* __restrict__ sv, const double* __restrict__ w,
              double* __restrict__ partial, long long n, int groups, int dmax,
              int k, int ctype, int w_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pairs = groups * k;
  const int e = dmax * pairs;
  const int slices = pairs >= kTile64 ? 1 : kTile64 / pairs;
  double* sv_s = reinterpret_cast<double*>(smem);  // (dmax, G, k)
  double* hist_s = sv_s + e;                       // (slices, dmax, G, k)
  double* z_s = hist_s + slices * e;               // kTile64 x k
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(z_s + kTile64 * k);

  const int tid = threadIdx.x;
  for (int i = tid; i < e; i += kTile64) sv_s[i] = sv[i];
  for (int i = tid; i < slices * e; i += kTile64) hist_s[i] = 0.0;

  constexpr int kChunks = kTile64 / 16;  // 16-byte chunks of a tile's codes
  const long long tiles = (n + kTile64 - 1) / kTile64;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * kTile64;
    const int rows = (int)(n - r0 < kTile64 ? n - r0 : kTile64);
    __syncthreads();  // the previous tile is consumed; the table is loaded
    for (int i = tid; i < groups * kChunks; i += kTile64) {
      const int g = i / kChunks, ch = i - g * kChunks;
      const long long off = r0 + 16 * ch;
      if (off < ldc) {  // the row's allocation ends at ldc
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            codes + (long long)g * ldc + off));
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(codes_s + g * kCodeStride64 + 16 * ch);
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
        const int j = codes_s[g * kCodeStride64 + tid];
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
            const double wv = w[row * w_cols + (w_cols == 1 ? 0 : c)];
            z = ctype == 1 ? z * wv : z - wv;
          }
          z_s[tid * k + c] = z;
        }
      }
    }
    __syncthreads();
    for (int q = tid; q < slices * pairs; q += kTile64) {
      const int sl = q / pairs, p = q - sl * pairs;
      const int g = p / k, c = p - g * k;
      const uint8_t* cg = codes_s + g * kCodeStride64;
      double* h = hist_s + sl * e + p;
      for (int r = sl; r < rows; r += slices) {
        h[cg[r] * pairs] += z_s[r * k + c];
      }
    }
  }
  __syncthreads();
  double* out = partial + (long long)blockIdx.x * e;
  for (int i = tid; i < e; i += kTile64) {
    double s = 0.0;
    for (int sl = 0; sl < slices; ++sl) s += hist_s[sl * e + i];
    out[i] = s;
  }
}

// ---- many groups: z, then slabs of groups ----------------------------------

// a slab block's shared memory: six blocks per SM (of its 228 KB, less the
// 1 KB each block reserves), so that many blocks' row slices (each a chain
// of dependent shared-memory adds) run at once
constexpr size_t kSlabSmem = (233472 - 6 * 1024) / 6;

// z (n, k) of T: a thread per kR rows (16 for k = 1, a 16-byte word of
// each group's codes; else 4, a 32-bit word), the groups in order
// (grid-stride). kShared: the table copied into shared memory group-major,
// (g, j, c), so that a group's entries sit together; else read from sv as
// it is, (j, g, c). kK: the columns of v the registers hold (k <= kK).
template <typename T, bool kShared, int kR, int kK>
__global__ void __launch_bounds__(256)
cla_chain_z(const uint8_t* __restrict__ codes, long long ldc,
            const T* __restrict__ sv, const T* __restrict__ w,
            T* __restrict__ z, long long n, int groups, int dmax, int k,
            int ctype, int w_cols) {
  static_assert(kR == 4 || kR == 16, "a 32-bit or a 16-byte code word");
  extern __shared__ __align__(16) unsigned char smem[];
  const T* tbl = sv;
  long long sj = (long long)groups * k, sg = k;
  if constexpr (kShared) {
    T* t = reinterpret_cast<T*>(smem);
    const int e = dmax * groups * k;
    for (int i = threadIdx.x; i < e; i += blockDim.x) {
      const int c = i % k, gj = i / k, j = gj % dmax, g = gj / dmax;
      t[i] = sv[((long long)j * groups + g) * k + c];
    }
    __syncthreads();
    tbl = t;
    sj = k;
    sg = (long long)dmax * k;
  }
  const long long units = (n + kR - 1) / kR;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < units; q += (long long)gridDim.x * blockDim.x) {
    const long long r0 = kR * q;
    T xv[kR][kK];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int c = 0; c < kK; ++c) xv[i][c] = T(0);
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      // r0 + kR - 1 < ldc: ldc >= n is a multiple of 16, r0 < n a
      // multiple of kR
      const uint8_t* src = codes + (long long)g * ldc + r0;
      uint32_t word[kR / 4];
      if constexpr (kR == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        word[0] = v.x;
        word[1] = v.y;
        word[2] = v.z;
        word[3] = v.w;
      } else {
        word[0] = __ldg(reinterpret_cast<const uint32_t*>(src));
      }
      if constexpr (K6_PROBE == 3) {  // the codes streamed alone
#pragma unroll
        for (int i = 0; i < kR / 4; ++i) xv[i][0] += (T)word[i];
        continue;
      }
      const T* tg = tbl + g * sg;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const T* e = tg + ((word[i / 4] >> (8 * (i % 4))) & 0xffu) * sj;
#pragma unroll
        for (int c = 0; c < kK; ++c)
          if (c < k) xv[i][c] += e[c];
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const long long row = r0 + i;
      if (row >= n) break;
#pragma unroll
      for (int c = 0; c < kK; ++c) {
        if (c < k) {
          T v = xv[i][c];
          if (ctype != 0) {
            const T wv = w[row * w_cols + (w_cols == 1 ? 0 : c)];
            v = ctype == 1 ? v * wv : v - wv;
          }
          z[row * k + c] = v;
        }
      }
    }
  }
}

// Launches cla_chain_z<T, kShared, kR, kK> on a persistent grid: the
// blocks resident at once, at most one per 256 units of kR rows.
template <typename T, bool kShared, int kR, int kK>
cudaError_t launch_z(const uint8_t* codes, long long ldc, const T* sv,
                     const T* w, T* z, long long n, int groups, int dmax,
                     int k, int ctype, int w_cols, size_t tbl,
                     cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  auto kernel = cla_chain_z<T, kShared, kR, kK>;
  const size_t smem = kShared ? tbl : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem(kernel, smem, allowed);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256,
                                                        smem);
  if (err != cudaSuccess) return err;
  const long long units = (n + kR - 1) / kR;
  long long grid = (long long)(per_sm < 1 ? 1 : per_sm) * sms;
  if ((units + 255) / 256 < grid) grid = (units + 255) / 256;
  if (grid < 1) grid = 1;
  kernel<<<(int)grid, 256, smem, stream>>>(codes, ldc, sv, w, z, n, groups,
                                           dmax, k, ctype, w_cols);
  return cudaGetLastError();
}

int slab_slices(int pairs) { return pairs >= kTile64 ? 1 : kTile64 / pairs; }

// A code's row of a slab histogram: the slab's (group, column) pairs,
// padded to a multiple of 16 doubles, so that 16 lanes on consecutive
// pairs hit 16 different bank pairs whatever their codes.
__host__ __device__ constexpr int slab_pitch(int pairs) {
  return (pairs + 15) & ~15;
}

// A slab block's shared memory at `gs` groups: its row slices'
// histograms and the tile's z in double, the tile's codes.
size_t smem_slab(int dmax, int gs, int k) {
  return sizeof(double) * ((size_t)slab_slices(gs * k) * dmax *
                               slab_pitch(gs * k) +
                           (size_t)kTile64 * k) +
         (size_t)gs * kCodeStride64;
}

// Groups per slab: the largest count that fits kSlabSmem, then balanced
// over the slabs that count needs; 0 if not even one group fits.
int slab_groups(int dmax, int groups, int k) {
  int best = 0;
  for (int gs = groups; gs >= 1; --gs)
    if (smem_slab(dmax, gs, k) <= kSlabSmem) {
      best = gs;
      break;
    }
  if (!best) return 0;
  const int slabs = (groups + best - 1) / best;
  const int even = (groups + slabs - 1) / slabs;
  return smem_slab(dmax, even, k) <= kSlabSmem ? even : best;
}

// Block (b, s): groups s gs .. of the slab, rows of tiles b, b + gridDim.x,
// ...; partial (gridDim.x, dmax, groups, k), the slab's groups of row b.
template <typename T>
__global__ void __launch_bounds__(kTile64)
cla_chain_slab(const uint8_t* __restrict__ codes, long long ldc,
               const T* __restrict__ z, double* __restrict__ partial,
               long long n, int groups, int gs_max, int slices, int dmax,
               int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g0 = blockIdx.y * gs_max;
  const int gs = groups - g0 < gs_max ? groups - g0 : gs_max;
  const int pairs = gs * k;
  const int e = dmax * pairs;
  const int pitch = slab_pitch(pairs), ep = dmax * pitch;
  // (slices, dmax, pitch): pair p of code j in slice sl at sl ep + j pitch + p
  double* hist_s = reinterpret_cast<double*>(smem);
  double* z_s = hist_s + (size_t)slices * dmax * slab_pitch(gs_max * k);
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(z_s + kTile64 * k);

  const int tid = threadIdx.x;
  for (int i = tid; i < slices * ep; i += kTile64) hist_s[i] = 0.0;

  constexpr int kChunks = kTile64 / 16;
  const long long tiles = (n + kTile64 - 1) / kTile64;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * kTile64;
    const int rows = (int)(n - r0 < kTile64 ? n - r0 : kTile64);
    __syncthreads();  // the previous tile is consumed; hist_s is zero
    for (int i = tid; i < gs * kChunks; i += kTile64) {
      const int g = i / kChunks, ch = i - g * kChunks;
      const long long off = r0 + 16 * ch;
      if (off < ldc) {  // the row's allocation ends at ldc
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            codes + (long long)(g0 + g) * ldc + off));
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(codes_s + g * kCodeStride64 + 16 * ch);
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    }
    for (int i = tid; i < rows * k; i += kTile64)
      z_s[i] = (double)z[r0 * k + i];
    __syncthreads();
    if constexpr (K6_PROBE == 3) continue;
    for (int q = tid; q < slices * pairs; q += kTile64) {
      const int sl = q / pairs, p = q - sl * pairs;
      const int g = p / k, c = p - g * k;
      const uint8_t* cg = codes_s + g * kCodeStride64;
      double* h = hist_s + sl * ep + p;
      for (int r = sl; r < rows; r += slices) h[cg[r] * pitch] += z_s[r * k + c];
    }
  }
  __syncthreads();
  double* out = partial + (long long)blockIdx.x * dmax * groups * k;
  for (int i = tid; i < e; i += kTile64) {
    const int j = i / pairs, p = i - j * pairs;
    double s = 0.0;
    for (int sl = 0; sl < slices; ++sl) s += hist_s[sl * ep + j * pitch + p];
    out[((long long)j * groups + g0) * k + p] = s;
  }
}

template <typename T>
cudaError_t launch_slabs(const uint8_t* codes, long long ldc, const void* sv,
                         const void* w, void* z, double* partial, long long n,
                         int groups, int dmax, int k, int ctype, int w_cols,
                         int grid, cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  const int gs = slab_groups(dmax, groups, k);
  if (!gs || z == nullptr) return cudaErrorInvalidValue;
  // z of every row, the table in shared memory where it fits
  const size_t tbl = sizeof(T) * (size_t)dmax * groups * k;
  T* zt = static_cast<T*>(z);
  const T* svt = static_cast<const T*>(sv);
  const T* wt = static_cast<const T*>(w);
  cudaError_t err;
  if (tbl <= kMaxSmem)
    err = k == 1 ? launch_z<T, true, 16, 1>(codes, ldc, svt, wt, zt, n, groups,
                                            dmax, k, ctype, w_cols, tbl,
                                            stream)
                 : launch_z<T, true, 4, kMaxK>(codes, ldc, svt, wt, zt, n,
                                               groups, dmax, k, ctype, w_cols,
                                               tbl, stream);
  else
    err = k == 1 ? launch_z<T, false, 16, 1>(codes, ldc, svt, wt, zt, n,
                                             groups, dmax, k, ctype, w_cols,
                                             tbl, stream)
                 : launch_z<T, false, 4, kMaxK>(codes, ldc, svt, wt, zt, n,
                                                groups, dmax, k, ctype, w_cols,
                                                tbl, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_slab(dmax, gs, k);
  err = allow_smem(cla_chain_slab<T>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 g(grid, (groups + gs - 1) / gs);
  cla_chain_slab<T><<<g, kTile64, smem, stream>>>(
      codes, ldc, zt, partial, n, groups, gs, slab_slices(gs * k), dmax, k);
  return cudaGetLastError();
}

// ---- both ------------------------------------------------------------------

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

// A block's shared memory for (dmax, groups, k, dtype) in the one-kernel
// path; 0 if the shape is outside the limits or no block fits (the slabs
// take it then).
size_t smem_bytes(int dmax, int groups, int k, int dtype) {
  if (groups < 1 || dmax < 1 || dmax > kMaxDict || k < 1 || k > kMaxK)
    return 0;
  if (dtype == 1) {
    const size_t s = smem_f64(dmax, groups, k);
    return s <= kMaxSmem ? s : 0;
  }
  const int tile = tile_f32(dmax, groups, k);
  return tile ? smem_f32_at(tile, dmax, groups, k) : 0;
}

}  // namespace

extern "C" {

// How the kernel takes (dmax, groups, k, dtype) (dtype 0 = fp32, 1 =
// fp64): the shared memory of a block, its rows per tile, and the slabs of
// groups (0: the one-kernel path, every group in a block); 0, 0 and 0 when
// the kernel does not take the shape (dmax or k past 8).
long long smtorch_cla_chain_smem(int dmax, int groups, int k, int dtype,
                                 int* tile, int* slabs) {
  *tile = 0;
  *slabs = 0;
  if ((dtype != 0 && dtype != 1) || groups < 1 || dmax < 1 ||
      dmax > kMaxDict || k < 1 || k > kMaxK)
    return 0;
  const size_t s = smem_bytes(dmax, groups, k, dtype);
  if (s) {
    *tile = dtype == 1 ? kTile64 : tile_f32(dmax, groups, k);
    return (long long)s;
  }
  const int gs = slab_groups(dmax, groups, k);
  if (!gs) return 0;
  *tile = kTile64;
  *slabs = (groups + gs - 1) / gs;
  return (long long)smem_slab(dmax, gs, k);
}

// codes (groups, n) uint8, rows ldc bytes apart, ldc >= n a multiple of 16
// and codes 16-byte aligned (a row is read in 16-byte chunks up to ldc);
// sv (dmax, groups, k) of dtype 0 = fp32, 1 = fp64;
// w (n, w_cols) of the same dtype, w_cols 1 or k, or null for ctype 0;
// partial (grid, dmax, groups, k) double scratch; out (dmax, groups, k)
// double; z (n, k) of the dtype, scratch of the slab path (null when
// smtorch_cla_chain_smem gives no slabs), whose grid is the row ranges.
// All contiguous on the current device. Launches on `stream` and returns a
// cudaError_t: the first failing launch's error.
int smtorch_cla_chain(const void* codes, long long ldc, const void* sv,
                      const void* w, void* partial, void* out, void* z,
                      long long n, int groups, int dmax, int k, int ctype,
                      int w_cols, int dtype, int grid, void* stream) {
  int tile = 0, slabs = 0;
  if (n < 0 || ctype < 0 || ctype > 2 || grid < 1 ||
      (dtype != 0 && dtype != 1) || ldc < n || ldc % 16 != 0 ||
      (uintptr_t)codes % 16 != 0 ||
      !smtorch_cla_chain_smem(dmax, groups, k, dtype, &tile, &slabs))
    return (int)cudaErrorInvalidValue;
  if (ctype != 0 && (w == nullptr || (w_cols != 1 && w_cols != k)))
    return (int)cudaErrorInvalidValue;
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  double* pf = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (slabs) {
    err = dtype == 1 ? launch_slabs<double>(c, ldc, sv, w, z, pf, n, groups,
                                            dmax, k, ctype, w_cols, grid, s)
                     : launch_slabs<float>(c, ldc, sv, w, z, pf, n, groups,
                                           dmax, k, ctype, w_cols, grid, s);
  } else if (dtype == 1) {
    static int allowed[kMaxDevices] = {};
    const size_t smem = smem_f64(dmax, groups, k);
    err = allow_smem(cla_chain_f64, smem, allowed);
    if (err == cudaSuccess) {
      cla_chain_f64<<<grid, kTile64, smem, s>>>(
          c, ldc, static_cast<const double*>(sv),
          static_cast<const double*>(w), pf, n, groups, dmax, k, ctype, w_cols);
      err = cudaGetLastError();
    }
  } else {
    switch (k) {
#define SMTORCH_K(K)                                                     \
  case K:                                                                \
    err = launch_f32<K>(c, ldc, sv, w, pf, n, groups, dmax, ctype, w_cols, \
                        grid, s);                                        \
    break;
      SMTORCH_K(1)
      SMTORCH_K(2)
      SMTORCH_K(3)
      SMTORCH_K(4)
      SMTORCH_K(5)
      SMTORCH_K(6)
      SMTORCH_K(7)
      SMTORCH_K(8)
#undef SMTORCH_K
      default:
        err = cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int e = dmax * groups * k;
  cla_chain_reduce<<<(e + 7) / 8, 256, 0, s>>>(  // 8 warps a block
      pf, static_cast<double*>(out), e, grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
