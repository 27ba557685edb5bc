// Native data plane of diffsheg_tpu_torch: the port's own copy of
// diffsheg_tpu/runtime/native/dataplane.cpp, with the same C ABI
// (dt_abi_version() == 1), so both packages read the same bytes the same way.
//
// The reference's input pipeline pays a per-sample deserialize
// (pyarrow-over-LMDB, reference datasets/beat.py:413-455) and parses the
// bvh_rot text exports with per-line numpy fromstring
// (datasets/beat.py:168-172).  This library provides the two host-side hot
// paths as native code over the memory-mapped cache format:
//
//   dt_gather_rows   — multi-threaded row gather (batch assembly straight
//                      from the page cache into a numpy buffer; one memcpy
//                      per row, rows split over threads);
//   dt_parse_floats  — bulk float parsing (cache build: hundreds of MB of
//                      BVH text per dataset).  ' ', '\t', '\r' and ','
//                      separate values, '\n' ends a row, a byte strtod
//                      cannot start a value with is skipped, and a value
//                      is whatever strtod reads (hex floats too).
//
// Pure C ABI for ctypes; no exceptions cross the boundary.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

extern "C" {

// Gather k rows of row_bytes each: dst[i] = src[idx[i]] for i in [0, k).
// Rows are split contiguously over n_threads (clamped to hardware).
void dt_gather_rows(const uint8_t* src, int64_t row_bytes,
                    const int64_t* idx, int64_t k,
                    uint8_t* dst, int32_t n_threads) {
  if (k <= 0 || row_bytes <= 0) return;
  int hw = (int)std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  int nt = n_threads > 0 ? (n_threads < hw ? n_threads : hw) : 1;
  // Small batches: not worth thread spawn overhead.
  if (nt == 1 || k * row_bytes < (int64_t)1 << 20) {
    for (int64_t i = 0; i < k; ++i)
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                  (size_t)row_bytes);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  int64_t chunk = (k + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < k ? lo + chunk : k;
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                    (size_t)row_bytes);
    });
  }
  for (auto& th : ts) th.join();
}

// Parse up to max_vals whitespace/newline-separated doubles from text.
// Returns the number of values written; *n_rows receives the number of
// newline-terminated rows encountered (for shape inference).
int64_t dt_parse_floats(const char* text, int64_t text_len,
                        double* out, int64_t max_vals, int64_t* n_rows) {
  int64_t n = 0;
  int64_t rows = 0;
  bool row_has_vals = false;
  const char* p = text;
  const char* end = text + text_len;
  while (p < end && n < max_vals) {
    // skip separators, counting row breaks
    while (p < end) {
      char c = *p;
      if (c == '\n') {
        if (row_has_vals) { ++rows; row_has_vals = false; }
        ++p;
      } else if (c == ' ' || c == '\t' || c == '\r' || c == ',') {
        ++p;
      } else {
        break;
      }
    }
    if (p >= end) break;
    char* next = nullptr;
    double v = std::strtod(p, &next);
    if (next == p) { ++p; continue; }  // unparseable byte: skip
    out[n++] = v;
    row_has_vals = true;
    p = next;
  }
  if (row_has_vals) ++rows;
  if (n_rows) *n_rows = rows;
  return n;
}

// Version tag so python can verify ABI.
int32_t dt_abi_version() { return 1; }

}  // extern "C"
