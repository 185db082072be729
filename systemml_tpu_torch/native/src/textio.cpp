// Copied from systemml_tpu/native/src/textio.cpp for the PyTorch port (host code:
// binary-block IO, host CSR and the text parsers; built with g++ -fopenmp
// by systemml_tpu_torch/native/__init__.py into systemml_tpu_torch/_build/).
//
// Parallel text parsing: line counting, "i j v" textcell, and numeric
// CSV — chunked over OpenMP threads with chunk boundaries snapped to
// newlines, so each thread parses a disjoint line range.
//
// Replaces the reference's parallel text readers
// (runtime/io/ReaderTextCellParallel.java, ReaderTextCSVParallel.java —
// thread-per-split over HDFS input splits) for local files; numpy's
// loadtxt is single-threaded Python-loop territory, which is exactly the
// gap the reference filled with its parallel readers.

#include "smtpu.h"

#include <cstdlib>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Split [0, len) into per-thread chunks whose starts sit just after a
// newline (chunk 0 starts at 0).  Returns nchunks, fills starts[].
int chunk_starts(const char* buf, int64_t len, int64_t* starts, int max_chunks) {
  int n = 1;
#ifdef _OPENMP
  n = omp_get_max_threads();
#endif
  if (n > max_chunks) n = max_chunks;
  if ((int64_t)n > len) n = len > 0 ? 1 : 0;
  starts[0] = 0;
  int out = 1;
  for (int t = 1; t < n; ++t) {
    int64_t s = len * t / n;
    while (s < len && buf[s - 1] != '\n') ++s;
    if (s >= len) break;
    if (s > starts[out - 1]) starts[out++] = s;
  }
  starts[out] = len;
  return out;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

}  // namespace

extern "C" {

int64_t smtpu_count_lines(const char* buf, int64_t len) {
  int64_t n = 0;
#pragma omp parallel for reduction(+ : n) schedule(static)
  for (int64_t i = 0; i < len; ++i) n += (buf[i] == '\n');
  if (len > 0 && buf[len - 1] != '\n') ++n;  // unterminated last line
  return n;
}

// Parse "i j v" lines into three column-strided slots of vals:
// vals[0..n) = i, vals[n..2n) = j, vals[2n..3n) = v, where n is the
// returned cell count (max_cells bounds it).  Blank lines are skipped.
// Returns -1 on malformed input.
int64_t smtpu_parse_ijv(const char* buf, int64_t len, int64_t* rows,
                        int64_t* cols, double* vals, int64_t max_cells) {
  int64_t starts[257];
  int nchunks = chunk_starts(buf, len, starts, 256);
  if (nchunks == 0) return 0;
  // per-chunk counts first so each thread writes a disjoint output range
  int64_t counts[256] = {0};
  int err = 0;
#pragma omp parallel for schedule(static)
  for (int t = 0; t < nchunks; ++t) {
    int64_t c = 0;
    for (int64_t i = starts[t]; i < starts[t + 1]; ++i)
      if (buf[i] == '\n') ++c;
    if (starts[t + 1] == len && len > 0 && buf[len - 1] != '\n') ++c;
    counts[t] = c;
  }
  int64_t offs[257];
  offs[0] = 0;
  for (int t = 0; t < nchunks; ++t) offs[t + 1] = offs[t] + counts[t];
  if (offs[nchunks] > max_cells) return -2;
  int64_t written[256] = {0};
#pragma omp parallel for schedule(static)
  for (int t = 0; t < nchunks; ++t) {
    const char* p = buf + starts[t];
    const char* end = buf + starts[t + 1];
    int64_t slot = offs[t];
    int lerr = 0;  // thread-local; folded into the shared flag once below
    while (p < end && !lerr) {
      p = skip_ws(p, end);
      if (p >= end) break;
      if (*p == '\n') { ++p; continue; }  // blank line
      // each field must start on the CURRENT line: strtoll/strtod skip
      // '\n' as whitespace and would stitch the next line into a short
      // row (diverging from the strict-line fallback parsers)
      char* q;
      long long i = strtoll(p, &q, 10);
      if (q == p) { lerr = 1; break; }
      p = skip_ws(q, end);
      if (p >= end || *p == '\n') { lerr = 1; break; }
      long long j = strtoll(p, &q, 10);
      if (q == p) { lerr = 1; break; }
      p = skip_ws(q, end);
      if (p >= end || *p == '\n') { lerr = 1; break; }
      double v = strtod(p, &q);
      if (q == p) { lerr = 1; break; }
      p = q;
      while (p < end && *p != '\n') ++p;
      if (p < end) ++p;
      rows[slot] = (int64_t)i;
      cols[slot] = (int64_t)j;
      vals[slot] = v;
      ++slot;
    }
    if (lerr) {
#pragma omp atomic write
      err = 1;
    }
    written[t] = slot - offs[t];
  }
  if (err) return -1;
  // compact out skipped blank lines (counts were line counts)
  int64_t n = 0;
  for (int t = 0; t < nchunks; ++t) {
    if (offs[t] != n)
      for (int64_t s = 0; s < written[t]; ++s) {
        rows[n + s] = rows[offs[t] + s];
        cols[n + s] = cols[offs[t] + s];
        vals[n + s] = vals[offs[t] + s];
      }
    n += written[t];
  }
  return n;
}

// Parse a numeric CSV with a known column count into row-major out.
// Caller strips any header line before the call (pass buf past it).
// Returns number of rows parsed, or -1 on malformed input / -2 overflow.
int64_t smtpu_parse_csv(const char* buf, int64_t len, char sep,
                        int64_t ncols, double* out, int64_t max_cells) {
  int64_t starts[257];
  int nchunks = chunk_starts(buf, len, starts, 256);
  if (nchunks == 0) return 0;
  int64_t counts[256] = {0};
#pragma omp parallel for schedule(static)
  for (int t = 0; t < nchunks; ++t) {
    int64_t c = 0;
    for (int64_t i = starts[t]; i < starts[t + 1]; ++i)
      if (buf[i] == '\n') ++c;
    if (starts[t + 1] == len && len > 0 && buf[len - 1] != '\n') ++c;
    counts[t] = c;
  }
  int64_t offs[257];
  offs[0] = 0;
  for (int t = 0; t < nchunks; ++t) offs[t + 1] = offs[t] + counts[t];
  if (offs[nchunks] * ncols > max_cells) return -2;
  int err = 0;
  int64_t written[256] = {0};
#pragma omp parallel for schedule(static)
  for (int t = 0; t < nchunks; ++t) {
    const char* p = buf + starts[t];
    const char* end = buf + starts[t + 1];
    int64_t row = offs[t];
    int lerr = 0;  // thread-local; folded into the shared flag once below
    while (p < end && !lerr) {
      p = skip_ws(p, end);
      if (p >= end) break;
      if (*p == '\n') { ++p; continue; }
      double* o = out + row * ncols;
      for (int64_t j = 0; j < ncols && !lerr; ++j) {
        // field must start on the current line — strtod skips '\n' as
        // whitespace and would stitch the next line into a short row
        if (p >= end || *p == '\n') { lerr = 1; break; }
        char* q;
        double v = strtod(p, &q);
        if (q == p) { lerr = 1; break; }
        o[j] = v;
        p = skip_ws(q, end);
        if (j + 1 < ncols) {
          if (p < end && *p == sep) ++p;
          else { lerr = 1; break; }
        }
      }
      // ragged rows with EXTRA fields must error, not be silently
      // truncated — the np.loadtxt fallback raises on them, and native
      // vs fallback results must not diverge
      if (!lerr && p < end && *p != '\n') lerr = 1;
      while (p < end && *p != '\n') ++p;
      if (p < end) ++p;
      ++row;
    }
    if (lerr) {
#pragma omp atomic write
      err = 1;
    }
    written[t] = row - offs[t];
  }
  if (err) return -1;
  int64_t n = 0;
  for (int t = 0; t < nchunks; ++t) {
    if (offs[t] != n)
      memmove(out + n * ncols, out + offs[t] * ncols,
              sizeof(double) * (size_t)(written[t] * ncols));
    n += written[t];
  }
  return n;
}

}  // extern "C"
