// Copied from systemml_tpu/native/src/smtpu.h for the PyTorch port (host code:
// binary-block IO, host CSR and the text parsers; built with g++ -fopenmp
// by systemml_tpu_torch/native/__init__.py into systemml_tpu_torch/_build/).
//
// smtpu native runtime library — shared declarations.
//
// TPU-native analog of the reference's native CPU library
// (src/main/cpp/systemml.cpp JNI exports, libmatrixmult.cpp,
// libmatrixdnn.cpp): host-side data-plane kernels that sit AROUND the
// XLA compute path — parallel binary-block IO, CSR construction /
// multiplication, and parallel text parsing.  Compute on tensors stays
// in XLA/Pallas; this library owns the host runtime work the reference
// did in C++ (and Java threads), exported with a plain C ABI consumed
// from Python via ctypes.
#ifndef SMTPU_H
#define SMTPU_H

#include <cstdint>

// binary-block on-disk header (48 bytes, little-endian).  The format is
// the TPU-native redesign of the reference's binary-block SequenceFiles
// (runtime/io/ReaderBinaryBlock/WriterBinaryBlock): a flat file of
// independently addressable tiles so reads and writes parallelize with
// pread/pwrite instead of a record stream.
struct SmtpuBBHeader {
  uint32_t magic;      // 0x53424d42 "BMBS" little-endian spelling of SMBB
  uint32_t version;    // 1
  uint64_t rows;
  uint64_t cols;
  uint32_t blocksize;  // tile side; 0 => whole matrix is one tile
  uint32_t dtype;      // 0 = float32, 1 = float64
  uint32_t storage;    // 0 = dense blocked, 1 = CSR
  uint32_t reserved;
  uint64_t nnz;        // CSR: stored values; dense: rows*cols
};

constexpr uint32_t SMTPU_BB_MAGIC = 0x53424d42u;
constexpr uint32_t SMTPU_BB_VERSION = 1u;

extern "C" {

// ---- binary-block IO (bbio.cpp) ----
int smtpu_bb_write_dense(const char* path, const void* data, uint64_t rows,
                         uint64_t cols, uint32_t blocksize, uint32_t dtype);
int smtpu_bb_read_header(const char* path, uint64_t* rows, uint64_t* cols,
                         uint32_t* blocksize, uint32_t* dtype,
                         uint32_t* storage, uint64_t* nnz);
int smtpu_bb_read_dense(const char* path, void* out);
int smtpu_bb_write_csr(const char* path, const int64_t* indptr,
                       const int64_t* indices, const void* data,
                       uint64_t rows, uint64_t cols, uint64_t nnz,
                       uint32_t dtype);
int smtpu_bb_read_csr(const char* path, int64_t* indptr, int64_t* indices,
                      void* data);

// ---- CSR kernels (csr.cpp) ----
int64_t smtpu_csr_count_f32(const float* a, int64_t rows, int64_t cols);
int64_t smtpu_csr_count_f64(const double* a, int64_t rows, int64_t cols);
void smtpu_csr_fill_f32(const float* a, int64_t rows, int64_t cols,
                        int64_t* indptr, int64_t* indices, float* data);
void smtpu_csr_fill_f64(const double* a, int64_t rows, int64_t cols,
                        int64_t* indptr, int64_t* indices, double* data);
void smtpu_csr_to_dense_f32(const int64_t* indptr, const int64_t* indices,
                            const float* data, int64_t rows, int64_t cols,
                            float* out);
void smtpu_csr_to_dense_f64(const int64_t* indptr, const int64_t* indices,
                            const double* data, int64_t rows, int64_t cols,
                            double* out);
void smtpu_csr_spmm_f32(const int64_t* indptr, const int64_t* indices,
                        const float* data, int64_t rows, const float* b,
                        int64_t k, int64_t n, float* c);
void smtpu_csr_spmm_f64(const int64_t* indptr, const int64_t* indices,
                        const double* data, int64_t rows, const double* b,
                        int64_t k, int64_t n, double* c);
void smtpu_csr_transpose_f64(const int64_t* indptr, const int64_t* indices,
                             const double* data, int64_t rows, int64_t cols,
                             int64_t* t_indptr, int64_t* t_indices,
                             double* t_data);

// ---- parallel text parsing (textio.cpp) ----
int64_t smtpu_count_lines(const char* buf, int64_t len);
int64_t smtpu_parse_ijv(const char* buf, int64_t len, int64_t* rows,
                        int64_t* cols, double* vals, int64_t max_cells);
int64_t smtpu_parse_csv(const char* buf, int64_t len, char sep,
                        int64_t ncols, double* out, int64_t max_cells);

int smtpu_num_threads();
int smtpu_abi_version();

}  // extern "C"

#endif  // SMTPU_H
