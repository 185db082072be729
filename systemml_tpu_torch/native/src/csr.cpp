// Copied from systemml_tpu/native/src/csr.cpp for the PyTorch port (host code:
// binary-block IO, host CSR and the text parsers; built with g++ -fopenmp
// by systemml_tpu_torch/native/__init__.py into systemml_tpu_torch/_build/).
//
// Host CSR kernels: construction from dense, densification, CSR x dense
// multiply, transpose — all OpenMP-parallel over rows.
//
// These replace the reference's multithreaded Java sparse kernels
// (runtime/matrix/data/LibMatrixMult.java sparse paths; the CUDA side's
// cusparse CSRPointer, gpu/context/CSRPointer.java) for the HOST tier of
// the sparse plane: device-side sparse compute stays on the XLA/Pallas
// path (runtime/sparse.py BCOO + padded-ELL), but format conversion and
// host sparse products run here.

#include "smtpu.h"

#include <cstring>
#include <vector>

namespace {

template <typename T>
int64_t csr_count(const T* a, int64_t rows, int64_t cols) {
  int64_t nnz = 0;
#pragma omp parallel for reduction(+ : nnz) schedule(static)
  for (int64_t i = 0; i < rows; ++i) {
    const T* row = a + i * cols;
    int64_t c = 0;
    for (int64_t j = 0; j < cols; ++j) c += (row[j] != (T)0);
    nnz += c;
  }
  return nnz;
}

template <typename T>
void csr_fill(const T* a, int64_t rows, int64_t cols, int64_t* indptr,
              int64_t* indices, T* data) {
  // pass 1: per-row counts -> indptr prefix sum
  indptr[0] = 0;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < rows; ++i) {
    const T* row = a + i * cols;
    int64_t c = 0;
    for (int64_t j = 0; j < cols; ++j) c += (row[j] != (T)0);
    indptr[i + 1] = c;
  }
  for (int64_t i = 0; i < rows; ++i) indptr[i + 1] += indptr[i];
  // pass 2: independent per-row fill
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < rows; ++i) {
    const T* row = a + i * cols;
    int64_t p = indptr[i];
    for (int64_t j = 0; j < cols; ++j)
      if (row[j] != (T)0) { indices[p] = j; data[p] = row[j]; ++p; }
  }
}

template <typename T>
void csr_to_dense(const int64_t* indptr, const int64_t* indices,
                  const T* data, int64_t rows, int64_t cols, T* out) {
  memset(out, 0, sizeof(T) * (size_t)(rows * cols));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < rows; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      out[i * cols + indices[p]] = data[p];
}

// C[rows, n] = A_csr[rows, k] @ B[k, n]: row-parallel saxpy formulation
// (each nonzero a_ip streams B's row p through C's row i — sequential
// reads of B, write-local to the thread's C row).
template <typename T>
void csr_spmm(const int64_t* indptr, const int64_t* indices, const T* data,
              int64_t rows, const T* b, int64_t n, T* c) {
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t i = 0; i < rows; ++i) {
    T* ci = c + i * n;
    memset(ci, 0, sizeof(T) * (size_t)n);
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const T aip = data[p];
      const T* bp = b + indices[p] * n;
      for (int64_t j = 0; j < n; ++j) ci[j] += aip * bp[j];
    }
  }
}

}  // namespace

extern "C" {

int64_t smtpu_csr_count_f32(const float* a, int64_t rows, int64_t cols) {
  return csr_count(a, rows, cols);
}
int64_t smtpu_csr_count_f64(const double* a, int64_t rows, int64_t cols) {
  return csr_count(a, rows, cols);
}
void smtpu_csr_fill_f32(const float* a, int64_t rows, int64_t cols,
                        int64_t* indptr, int64_t* indices, float* data) {
  csr_fill(a, rows, cols, indptr, indices, data);
}
void smtpu_csr_fill_f64(const double* a, int64_t rows, int64_t cols,
                        int64_t* indptr, int64_t* indices, double* data) {
  csr_fill(a, rows, cols, indptr, indices, data);
}
void smtpu_csr_to_dense_f32(const int64_t* indptr, const int64_t* indices,
                            const float* data, int64_t rows, int64_t cols,
                            float* out) {
  csr_to_dense(indptr, indices, data, rows, cols, out);
}
void smtpu_csr_to_dense_f64(const int64_t* indptr, const int64_t* indices,
                            const double* data, int64_t rows, int64_t cols,
                            double* out) {
  csr_to_dense(indptr, indices, data, rows, cols, out);
}
void smtpu_csr_spmm_f32(const int64_t* indptr, const int64_t* indices,
                        const float* data, int64_t rows, const float* b,
                        int64_t /*k*/, int64_t n, float* c) {
  csr_spmm(indptr, indices, data, rows, b, n, c);
}
void smtpu_csr_spmm_f64(const int64_t* indptr, const int64_t* indices,
                        const double* data, int64_t rows, const double* b,
                        int64_t /*k*/, int64_t n, double* c) {
  csr_spmm(indptr, indices, data, rows, b, n, c);
}

void smtpu_csr_transpose_f64(const int64_t* indptr, const int64_t* indices,
                             const double* data, int64_t rows, int64_t cols,
                             int64_t* t_indptr, int64_t* t_indices,
                             double* t_data) {
  const int64_t nnz = indptr[rows];
  // column histogram -> t_indptr
  for (int64_t j = 0; j <= cols; ++j) t_indptr[j] = 0;
  for (int64_t p = 0; p < nnz; ++p) ++t_indptr[indices[p] + 1];
  for (int64_t j = 0; j < cols; ++j) t_indptr[j + 1] += t_indptr[j];
  // scatter (cursor array keeps it single pass; rows scanned in order so
  // each output column's row indices come out sorted)
  std::vector<int64_t> cur(t_indptr, t_indptr + cols);
  for (int64_t i = 0; i < rows; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t q = cur[indices[p]]++;
      t_indices[q] = i;
      t_data[q] = data[p];
    }
}

}  // extern "C"
