// Fast CSV column extractor for EEG trial exports.
//
// The preprocessing layer's host-side bottleneck is parsing many wide Emotiv
// CSVs (50+ columns, 10^4-10^5 rows) of which only 14 EEG channels + one time
// column are needed. This loader memory-maps the file, scans it once, and
// converts only the requested columns with std::from_chars (correctly-rounded,
// locale-independent — bit-identical to pandas' float64 parsing for finite
// inputs). Non-numeric or empty fields become NaN (pandas to_numeric
// errors="coerce" semantics).
//
// C ABI (used from Python via ctypes, see eegsynth_torch/data/fast_csv.py):
//   csv_open        -> handle with row/col counts after a header scan
//   csv_read_columns-> parse selected columns into a caller double buffer
//   csv_close
//
// Single-threaded per file.

#include <algorithm>
#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct CsvFile {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  size_t body_offset = 0;   // first byte after the header line
  int64_t n_rows = 0;       // data rows (excluding header)
  int n_cols = 0;
  std::string header;       // header line (no newline)
};

inline const char* find_newline(const char* p, const char* end) {
  const void* nl = memchr(p, '\n', static_cast<size_t>(end - p));
  return nl ? static_cast<const char*>(nl) : end;
}

}  // namespace

extern "C" {

// Opens + mmaps the file, scans the header and counts rows.
// Returns an opaque handle (or nullptr on failure).
void* csv_open(const char* path) {
  auto* f = new CsvFile();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { delete f; return nullptr; }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size == 0) { close(f->fd); delete f; return nullptr; }
  f->size = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (m == MAP_FAILED) { close(f->fd); delete f; return nullptr; }
  f->data = static_cast<const char*>(m);

  const char* end = f->data + f->size;
  const char* nl = find_newline(f->data, end);
  f->header.assign(f->data, static_cast<size_t>(nl - f->data));
  if (!f->header.empty() && f->header.back() == '\r') f->header.pop_back();
  f->body_offset = static_cast<size_t>(nl - f->data) + (nl < end ? 1 : 0);

  f->n_cols = 1;
  for (char c : f->header) if (c == ',') ++f->n_cols;

  // Count non-empty data lines.
  int64_t rows = 0;
  const char* p = f->data + f->body_offset;
  while (p < end) {
    const char* q = find_newline(p, end);
    if (q > p && !(q - p == 1 && *p == '\r')) ++rows;
    p = q + 1;
  }
  f->n_rows = rows;
  return f;
}

int64_t csv_num_rows(void* handle) { return static_cast<CsvFile*>(handle)->n_rows; }
int csv_num_cols(void* handle) { return static_cast<CsvFile*>(handle)->n_cols; }

// Copies the header into buf (truncated to buf_len-1), returns its full length.
int64_t csv_header(void* handle, char* buf, int64_t buf_len) {
  auto* f = static_cast<CsvFile*>(handle);
  if (buf_len > 0) {
    int64_t n = std::min<int64_t>(buf_len - 1, (int64_t)f->header.size());
    memcpy(buf, f->header.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return static_cast<int64_t>(f->header.size());
}

// Parses `n_sel` columns (by 0-based index, ascending not required) for all
// rows into `out` (row-major, shape n_rows x n_sel). Missing / malformed
// fields become NaN. Returns rows written, or -1 on error.
int64_t csv_read_columns(void* handle, const int32_t* sel, int32_t n_sel,
                         double* out) {
  auto* f = static_cast<CsvFile*>(handle);
  if (!f || n_sel <= 0) return -1;
  const double kNaN = std::nan("");

  // Map column index -> output slot (columns outside selection get -1).
  std::vector<int32_t> slot(static_cast<size_t>(f->n_cols), -1);
  int32_t max_col = -1;
  for (int32_t i = 0; i < n_sel; ++i) {
    if (sel[i] < 0 || sel[i] >= f->n_cols) return -1;
    slot[static_cast<size_t>(sel[i])] = i;
    max_col = std::max(max_col, sel[i]);
  }

  const char* p = f->data + f->body_offset;
  const char* end = f->data + f->size;
  int64_t row = 0;
  while (p < end && row < f->n_rows) {
    const char* line_end = find_newline(p, end);
    if (line_end == p || (line_end - p == 1 && *p == '\r')) { p = line_end + 1; continue; }
    double* out_row = out + row * n_sel;
    for (int32_t i = 0; i < n_sel; ++i) out_row[i] = kNaN;

    int col = 0;
    const char* field = p;
    const char* le = line_end;
    if (le > p && le[-1] == '\r') --le;
    for (const char* q = p; q <= le && col <= max_col; ++q) {
      if (q == le || *q == ',') {
        int32_t s = slot[static_cast<size_t>(col)];
        if (s >= 0 && q > field) {
          const char* b = field;
          while (b < q && (*b == ' ' || *b == '\t')) ++b;
          const char* e = q;
          while (e > b && (e[-1] == ' ' || e[-1] == '\t')) --e;
          // pandas parses quoted numeric fields ("1.5") and '+'-signed
          // numbers (+1.5); from_chars accepts neither — normalize first
          if (e - b >= 2 && *b == '"' && e[-1] == '"') { ++b; --e; }
          if (b < e && *b == '+') ++b;
          if (e > b) {
            double v;
            auto res = std::from_chars(b, e, v);
            if (res.ec == std::errc() && res.ptr == e) out_row[s] = v;
          }
        }
        ++col;
        field = q + 1;
      }
    }
    ++row;
    p = line_end + 1;
  }
  return row;
}

void csv_close(void* handle) {
  auto* f = static_cast<CsvFile*>(handle);
  if (f) {
    if (f->data) munmap(const_cast<char*>(f->data), f->size);
    if (f->fd >= 0) close(f->fd);
    delete f;
  }
}

}  // extern "C"
