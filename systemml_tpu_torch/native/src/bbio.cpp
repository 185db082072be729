// Copied from systemml_tpu/native/src/bbio.cpp for the PyTorch port (host code:
// binary-block IO, host CSR and the text parsers; built with g++ -fopenmp
// by systemml_tpu_torch/native/__init__.py into systemml_tpu_torch/_build/).
//
// Binary-block matrix IO: a flat tiled file format whose tiles are
// independently addressable, so reads and writes fan out over OpenMP
// threads with pread/pwrite — the TPU-native redesign of the reference's
// parallel binary-block readers/writers (runtime/io/ReaderBinaryBlock
// Parallel.java, WriterBinaryBlockParallel.java over HDFS SequenceFiles).
//
// Layout: 48-byte header (SmtpuBBHeader), then
//   dense:  tiles in row-major grid order, each tile row-major contiguous;
//   CSR:    indptr[rows+1] int64, indices[nnz] int64, data[nnz] dtype.
// Tile offsets are closed-form from the header, which is what makes the
// per-tile IO embarrassingly parallel (no record framing to scan).

#include "smtpu.h"

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint64_t dtype_size(uint32_t dtype) { return dtype == 0 ? 4 : 8; }

struct Tile {
  uint64_t r0, c0, h, w;     // position and shape in the full matrix
  uint64_t elem_off;         // element offset of the tile payload
};

// Enumerate tiles in row-major grid order with element offsets.
std::vector<Tile> tile_plan(uint64_t rows, uint64_t cols, uint32_t bs) {
  std::vector<Tile> tiles;
  if (bs == 0 || (bs >= rows && bs >= cols)) {
    tiles.push_back({0, 0, rows, cols, 0});
    return tiles;
  }
  uint64_t off = 0;
  for (uint64_t r0 = 0; r0 < rows; r0 += bs)
    for (uint64_t c0 = 0; c0 < cols; c0 += bs) {
      uint64_t h = rows - r0 < bs ? rows - r0 : bs;
      uint64_t w = cols - c0 < bs ? cols - c0 : bs;
      tiles.push_back({r0, c0, h, w, off});
      off += h * w;
    }
  return tiles;
}

// Full pread/pwrite loops (short transfers are legal for regular files
// only on signals, but loop anyway).
bool pwrite_all(int fd, const char* buf, uint64_t len, uint64_t off) {
  while (len) {
    ssize_t n = pwrite(fd, buf, len, (off_t)off);
    if (n <= 0) return false;
    buf += n; off += (uint64_t)n; len -= (uint64_t)n;
  }
  return true;
}

bool pread_all(int fd, char* buf, uint64_t len, uint64_t off) {
  while (len) {
    ssize_t n = pread(fd, buf, len, (off_t)off);
    if (n <= 0) return false;
    buf += n; off += (uint64_t)n; len -= (uint64_t)n;
  }
  return true;
}

int read_header_fd(int fd, SmtpuBBHeader* h) {
  if (!pread_all(fd, (char*)h, sizeof(*h), 0)) return -EIO;
  if (h->magic != SMTPU_BB_MAGIC || h->version != SMTPU_BB_VERSION)
    return -EINVAL;
  return 0;
}

}  // namespace

extern "C" {

int smtpu_bb_write_dense(const char* path, const void* data, uint64_t rows,
                         uint64_t cols, uint32_t blocksize, uint32_t dtype) {
  const uint64_t es = dtype_size(dtype);
  SmtpuBBHeader h{SMTPU_BB_MAGIC, SMTPU_BB_VERSION, rows, cols, blocksize,
                  dtype, 0, 0, rows * cols};
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  if (!pwrite_all(fd, (const char*)&h, sizeof(h), 0)) { close(fd); return -EIO; }
  // size the file up front so parallel pwrites never race on extension
  if (ftruncate(fd, (off_t)(sizeof(h) + rows * cols * es)) != 0) {
    close(fd); return -errno;
  }
  auto tiles = tile_plan(rows, cols, blocksize);
  const char* src = (const char*)data;
  int err = 0;
#pragma omp parallel for schedule(dynamic)
  for (int64_t t = 0; t < (int64_t)tiles.size(); ++t) {
    if (err) continue;
    const Tile& tl = tiles[t];
    // gather the tile's rows from the row-major source into one buffer,
    // then a single positioned write
    std::vector<char> buf(tl.h * tl.w * es);
    for (uint64_t i = 0; i < tl.h; ++i)
      memcpy(buf.data() + i * tl.w * es,
             src + ((tl.r0 + i) * cols + tl.c0) * es, tl.w * es);
    if (!pwrite_all(fd, buf.data(), buf.size(),
                    sizeof(h) + tl.elem_off * es))
#pragma omp atomic write
      err = EIO;
  }
  close(fd);
  return -err;
}

int smtpu_bb_read_header(const char* path, uint64_t* rows, uint64_t* cols,
                         uint32_t* blocksize, uint32_t* dtype,
                         uint32_t* storage, uint64_t* nnz) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  SmtpuBBHeader h;
  int rc = read_header_fd(fd, &h);
  close(fd);
  if (rc) return rc;
  *rows = h.rows; *cols = h.cols; *blocksize = h.blocksize;
  *dtype = h.dtype; *storage = h.storage; *nnz = h.nnz;
  return 0;
}

int smtpu_bb_read_dense(const char* path, void* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  SmtpuBBHeader h;
  int rc = read_header_fd(fd, &h);
  if (rc || h.storage != 0) { close(fd); return rc ? rc : -EINVAL; }
  const uint64_t es = dtype_size(h.dtype);
  auto tiles = tile_plan(h.rows, h.cols, h.blocksize);
  char* dst = (char*)out;
  int err = 0;
#pragma omp parallel for schedule(dynamic)
  for (int64_t t = 0; t < (int64_t)tiles.size(); ++t) {
    if (err) continue;
    const Tile& tl = tiles[t];
    std::vector<char> buf(tl.h * tl.w * es);
    if (!pread_all(fd, buf.data(), buf.size(),
                   sizeof(h) + tl.elem_off * es)) {
#pragma omp atomic write
      err = EIO;
      continue;
    }
    for (uint64_t i = 0; i < tl.h; ++i)
      memcpy(dst + ((tl.r0 + i) * h.cols + tl.c0) * es,
             buf.data() + i * tl.w * es, tl.w * es);
  }
  close(fd);
  return -err;
}

int smtpu_bb_write_csr(const char* path, const int64_t* indptr,
                       const int64_t* indices, const void* data,
                       uint64_t rows, uint64_t cols, uint64_t nnz,
                       uint32_t dtype) {
  const uint64_t es = dtype_size(dtype);
  SmtpuBBHeader h{SMTPU_BB_MAGIC, SMTPU_BB_VERSION, rows, cols, 0, dtype,
                  1, 0, nnz};
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  uint64_t off = 0;
  bool ok = pwrite_all(fd, (const char*)&h, sizeof(h), off);
  off += sizeof(h);
  ok = ok && pwrite_all(fd, (const char*)indptr, (rows + 1) * 8, off);
  off += (rows + 1) * 8;
  ok = ok && pwrite_all(fd, (const char*)indices, nnz * 8, off);
  off += nnz * 8;
  ok = ok && pwrite_all(fd, (const char*)data, nnz * es, off);
  close(fd);
  return ok ? 0 : -EIO;
}

int smtpu_bb_read_csr(const char* path, int64_t* indptr, int64_t* indices,
                      void* data) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  SmtpuBBHeader h;
  int rc = read_header_fd(fd, &h);
  if (rc || h.storage != 1) { close(fd); return rc ? rc : -EINVAL; }
  const uint64_t es = dtype_size(h.dtype);
  uint64_t off = sizeof(h);
  bool ok = pread_all(fd, (char*)indptr, (h.rows + 1) * 8, off);
  off += (h.rows + 1) * 8;
  ok = ok && pread_all(fd, (char*)indices, h.nnz * 8, off);
  off += h.nnz * 8;
  ok = ok && pread_all(fd, (char*)data, h.nnz * es, off);
  close(fd);
  return ok ? 0 : -EIO;
}

int smtpu_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

int smtpu_abi_version() { return 1; }

}  // extern "C"
