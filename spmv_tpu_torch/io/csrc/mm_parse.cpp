// Fast parallel MatrixMarket body parser.
//
// Native equivalent of the reference's data loader (mmio/mmio.c:265-296 and
// the per-driver fscanf loops, e.g. coo.c:81): parses the coordinate body
// of a .mtx file — `count` lines of "row col [value [imag]]" — into int32
// index arrays and a float64 value array.
//
// Design: the body is one entry per line; the buffer is split at newline
// boundaries into per-thread slices, each thread counts its lines, an
// exclusive scan assigns output offsets, then all threads parse in
// parallel with branch-light custom int/float scanners (strtod is the
// fallback for full precision on long mantissas).
//
// Exposed via a C ABI for ctypes (spmv_tpu_torch/io/native.py), which builds
// it with the host C++ compiler. The port's own copy of the JAX package's
// native/mm_parse.cpp: the same code and ABI (mm_native_abi_version() == 1).

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_i32(const char* p, const char* end, int32_t* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  int64_t v = 0;
  while (p < end && (unsigned)(*p - '0') <= 9u) v = v * 10 + (*p++ - '0');
  *out = (int32_t)(neg ? -v : v);
  return p;
}

// Fast double parse for the common "-123.456789e-12" shapes; falls back to
// strtod when the mantissa is long enough for rounding to matter.
inline const char* parse_f64(const char* p, const char* end, double* out) {
  const char* start = skip_ws(p, end);
  p = start;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  uint64_t mant = 0;
  int digits = 0, frac = 0, exp10 = 0;
  while (p < end && (unsigned)(*p - '0') <= 9u) {
    mant = mant * 10 + (*p++ - '0');
    ++digits;
  }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && (unsigned)(*p - '0') <= 9u) {
      mant = mant * 10 + (*p++ - '0');
      ++digits;
      ++frac;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
    int e = 0;
    while (p < end && (unsigned)(*p - '0') <= 9u) e = e * 10 + (*p++ - '0');
    exp10 = eneg ? -e : e;
  }
  if (digits == 0) {  // nan/inf or garbage — let strtod decide
    char* q;
    *out = strtod(start, &q);
    return q;
  }
  if (digits <= 15 && exp10 - frac >= -22 && exp10 - frac <= 22) {
    static const double pow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,
                                   1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
                                   1e12, 1e13, 1e14, 1e15, 1e16, 1e17,
                                   1e18, 1e19, 1e20, 1e21, 1e22};
    int e = exp10 - frac;
    double v = (double)mant;
    v = e >= 0 ? v * pow10[e] : v / pow10[-e];
    *out = neg ? -v : v;
    return p;
  }
  char* q;
  *out = strtod(start, &q);
  return q;
}

struct Slice {
  const char* begin;
  const char* end;
  int64_t first_entry;
  int64_t n_entries;
};

int64_t count_lines(const char* p, const char* end) {
  int64_t n = 0;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) {
      // trailing content without newline counts if non-blank
      for (const char* q = p; q < end; ++q)
        if (!isspace((unsigned char)*q)) return n + 1;
      return n;
    }
    for (const char* q = p; q < nl; ++q)
      if (!isspace((unsigned char)*q)) {
        ++n;
        break;
      }
    p = nl + 1;
  }
  return n;
}

}  // namespace

extern "C" {

// Parse `count` coordinate entries from buf[0:len).
// tokens_per_entry: 2 (pattern), 3 (real/integer), 4 (complex).
// rows/cols: int32 out arrays of size count.
// vals: float64 out array (size count, or 2*count for complex); may be
// null for pattern.
// Returns the number of entries parsed (== count on success).
int64_t mm_parse_body(const char* buf, int64_t len, int64_t count,
                      int tokens_per_entry, int32_t* rows, int32_t* cols,
                      double* vals, int n_threads) {
  const char* end = buf + len;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  if (count < 4096) n_threads = 1;

  // Split at newline boundaries.
  std::vector<Slice> slices(n_threads);
  int64_t chunk = len / n_threads;
  const char* p = buf;
  for (int t = 0; t < n_threads; ++t) {
    const char* q = (t == n_threads - 1) ? end : buf + (t + 1) * chunk;
    if (q < end) {
      const char* nl = (const char*)memchr(q, '\n', end - q);
      q = nl ? nl + 1 : end;
    }
    if (q < p) q = p;
    slices[t] = {p, q, 0, 0};
    p = q;
  }

  // Pass 1: count entries per slice (parallel).
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t)
      ts.emplace_back([&, t] {
        slices[t].n_entries = count_lines(slices[t].begin, slices[t].end);
      });
    for (auto& th : ts) th.join();
  }
  int64_t total = 0;
  for (auto& s : slices) {
    s.first_entry = total;
    total += s.n_entries;
  }
  if (total < count) return total;  // truncated body

  // Pass 2: parse (parallel).
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t)
    ts.emplace_back([&, t] {
      const Slice& s = slices[t];
      const char* sp = s.begin;
      int vstride = (tokens_per_entry == 4) ? 2 : 1;
      for (int64_t i = s.first_entry;
           i < s.first_entry + s.n_entries && i < count; ++i) {
        // skip blank lines
        while (sp < s.end) {
          const char* q = skip_ws(sp, s.end);
          if (q < s.end && *q != '\n') break;
          sp = (q < s.end) ? q + 1 : s.end;
        }
        sp = parse_i32(sp, s.end, &rows[i]);
        sp = parse_i32(sp, s.end, &cols[i]);
        if (tokens_per_entry >= 3 && vals) sp = parse_f64(sp, s.end, &vals[i * vstride]);
        if (tokens_per_entry == 4 && vals) sp = parse_f64(sp, s.end, &vals[i * vstride + 1]);
        const char* nl = (const char*)memchr(sp, '\n', s.end - sp);
        sp = nl ? nl + 1 : s.end;
      }
    });
  for (auto& th : ts) th.join();
  return count;
}

int mm_native_abi_version() { return 1; }

}  // extern "C"
