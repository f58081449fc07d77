// Native text parsers for the host data path.
//
// The port's copy of parameter_server_tpu/native/src/textparse.cc.  The
// reference keeps its example parsers in C++ because text parsing is the
// CPU-bound half of sparse training (``src/data/text_parser.h/.cc``,
// ``src/data/slot_reader.h`` [U]); we do the same.  Two formats:
//
//   libsvm:  "<label> <idx>:<val> <idx>:<val> ...\n"   -> CSR batch
//   criteo:  "<label>\t<13 ints>\t<26 hex cats>\n"     -> dense + hashed keys
//
// Exposed as a plain C ABI loaded via ctypes (no pybind11 in this image).
// Contract with the Python side (data/text.py): two-call protocol — count()
// sizes the output arrays, fill() parses into caller-allocated numpy buffers.
// Both calls are single pass over the buffer per thread; fill() splits the
// buffer at line boundaries across nthreads worker threads.
//
// Key hashing MUST stay bit-identical to utils/keys.py::mix64 (splitmix64
// finalizer, same constants) — tests assert C++ vs numpy parity.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMixMul1 = 0xFF51AFD7ED558CCDULL;
constexpr uint64_t kMixMul2 = 0xC4CEB9FE1A85EC53ULL;

inline uint64_t mix64(uint64_t x, uint64_t seed) {
  x = (x ^ seed) * kMixMul1;
  x ^= x >> 33;
  x *= kMixMul2;
  x ^= x >> 33;
  return x;
}

// Sentinel mixed per-slot for missing criteo categorical fields.
constexpr uint64_t kMissingCat = 0xFFFFFFFFFFFFFFFEULL;

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline double parse_float(const char* p, const char* end, const char** out) {
  // Hand-rolled strtod subset: [-+]?digits[.digits][eE[-+]digits].
  // Avoids strtod's locale + NUL-termination requirements on a mmap'd
  // buffer.  No digits in the mantissa => *out == input p (no consumption),
  // which callers use to detect malformed fields.  The Python fallback
  // (_float_prefix in data/text.py) mirrors this function bit-for-bit.
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  double v = 0.0;
  int digits = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10.0 + (*p++ - '0');
    ++digits;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p++ - '0') * scale;
      scale *= 0.1;
      ++digits;
    }
  }
  if (digits == 0) {
    *out = start;
    return 0.0;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '+' || *p == '-')) eneg = (*p++ == '-');
    int ex = 0;
    // saturate: any exponent > 9999 already over/underflows double, and an
    // unchecked accumulator is signed-int-overflow UB on 10+ digit exponents
    while (p < end && *p >= '0' && *p <= '9') {
      if (ex < 10000) ex = ex * 10 + (*p - '0');
      ++p;
    }
    if (v != 0.0) v *= std::pow(10.0, eneg ? -ex : ex);  // avoid 0*inf = nan
  }
  *out = p;
  return neg ? -v : v;
}

inline uint64_t parse_u64(const char* p, const char* end, const char** out) {
  uint64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = p;
  return v;
}

inline int hex_digit(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// Split [buf, buf+len) into nchunks at line boundaries. Returns nchunks+1
// offsets; chunk i is [off[i], off[i+1]) and starts at a line start.
std::vector<int64_t> line_chunks(const char* buf, int64_t len, int nchunks) {
  std::vector<int64_t> off(1, 0);
  for (int i = 1; i < nchunks; ++i) {
    int64_t target = len * i / nchunks;
    if (target <= off.back()) target = off.back();
    const void* nl = memchr(buf + target, '\n', len - target);
    int64_t cut = nl ? (static_cast<const char*>(nl) - buf) + 1 : len;
    off.push_back(cut);
  }
  off.push_back(len);
  return off;
}

void run_chunks(const char* buf, int64_t len, int nthreads,
                const std::vector<int64_t>& off,
                void (*fn)(const char*, const char*, int, void*), void* ctx) {
  int n = static_cast<int>(off.size()) - 1;
  if (nthreads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(buf + off[i], buf + off[i + 1], i, ctx);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n);
  for (int i = 0; i < n; ++i)
    threads.emplace_back(fn, buf + off[i], buf + off[i + 1], i, ctx);
  for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------- libsvm ---

struct LibsvmCounts {
  std::vector<int64_t> rows, nnz;
};

inline bool at_token_end(const char* p, const char* end) {
  return p >= end || *p == ' ' || *p == '\t' || *p == '\r' || *p == '\n';
}

inline const char* skip_token(const char* p, const char* end) {
  while (!at_token_end(p, end)) ++p;
  return p;
}

// Parse one "key:value" feature token. Returns true iff well-formed: key is
// all digits, optional ":value" where value is a non-empty numeric, and the
// token terminates at whitespace/EOL.  Malformed tokens are skipped whole
// (never partially consumed — guarantees forward progress; the Python
// fallback applies the same accept/skip rule, keeping parity).
inline bool parse_feature(const char* p, const char* end, const char** out,
                          uint64_t* key, float* val) {
  const char* start = p;
  const char* q;
  *key = parse_u64(p, end, &q);
  if (q == p) {  // no digits: malformed (qid:, comments handled by caller)
    *out = skip_token(p, end);
    return false;
  }
  p = q;
  *val = 1.0f;
  if (p < end && *p == ':') {
    ++p;
    *val = static_cast<float>(parse_float(p, end, &q));
    if (q == p) {  // empty/non-numeric value
      *out = skip_token(start, end);
      return false;
    }
    p = q;
  }
  if (!at_token_end(p, end)) {  // trailing junk glued to the token
    *out = skip_token(start, end);
    return false;
  }
  *out = p;
  return true;
}

void libsvm_count_chunk(const char* p, const char* end, int idx, void* vctx) {
  auto* ctx = static_cast<LibsvmCounts*>(vctx);
  int64_t rows = 0, nnz = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }  // blank line
    if (*p == '#') {  // full-line comment (fallback parity)
      while (p < end && *p != '\n') ++p;
      continue;
    }
    ++rows;
    // label: numeric prefix; junk label parses as 0 and is token-skipped
    const char* q;
    parse_float(p, end, &q);
    p = (q == p) ? skip_token(p, end) : q;
    // features
    while (p < end && *p != '\n') {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n') break;
      if (*p == '#') {  // trailing comment: skip to EOL
        while (p < end && *p != '\n') ++p;
        break;
      }
      uint64_t key;
      float val;
      if (parse_feature(p, end, &q, &key, &val)) ++nnz;
      p = q;
    }
    if (p < end) ++p;  // consume '\n'
  }
  ctx->rows[idx] = rows;
  ctx->nnz[idx] = nnz;
}

struct LibsvmFill {
  float* labels;
  int64_t* indptr;       // [rows + 1], indptr[0] pre-set to 0 by Python
  uint64_t* indices;
  float* values;
  std::vector<int64_t> row_base, nnz_base;  // per-chunk output offsets
};

void libsvm_fill_chunk(const char* p, const char* end, int idx, void* vctx) {
  auto* ctx = static_cast<LibsvmFill*>(vctx);
  int64_t r = ctx->row_base[idx];
  int64_t k = ctx->nnz_base[idx];
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }
    if (*p == '#') {
      while (p < end && *p != '\n') ++p;
      continue;
    }
    const char* q;
    ctx->labels[r] = static_cast<float>(parse_float(p, end, &q));
    p = (q == p) ? skip_token(p, end) : q;
    while (p < end && *p != '\n') {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n') break;
      if (*p == '#') {
        while (p < end && *p != '\n') ++p;
        break;
      }
      uint64_t key;
      float val;
      if (parse_feature(p, end, &q, &key, &val)) {
        ctx->indices[k] = key;
        ctx->values[k] = val;
        ++k;
      }
      p = q;
    }
    ctx->indptr[r + 1] = k;
    ++r;
    if (p < end) ++p;
  }
}

// ---------------------------------------------------------------- criteo ---

struct CriteoCtx {
  std::vector<int64_t> rows;     // count phase
  float* labels = nullptr;       // fill phase
  float* dense = nullptr;        // [rows, n_dense]
  uint64_t* keys = nullptr;      // [rows, n_cat]
  std::vector<int64_t> row_base;
  int n_dense = 13, n_cat = 26;
};

inline bool line_blank(const char* p, const char* e) {
  // whitespace-only lines are skipped (fallback parity: line.strip())
  for (; p < e; ++p)
    if (*p != ' ' && *p != '\t' && *p != '\r') return false;
  return true;
}

void criteo_count_chunk(const char* p, const char* end, int idx, void* vctx) {
  auto* ctx = static_cast<CriteoCtx*>(vctx);
  int64_t rows = 0;
  while (p < end) {
    const void* nl = memchr(p, '\n', end - p);
    const char* e = nl ? static_cast<const char*>(nl) : end;
    if (!line_blank(p, e)) ++rows;
    p = e + 1;
  }
  ctx->rows[idx] = rows;
}

void criteo_fill_chunk(const char* p, const char* end, int idx, void* vctx) {
  auto* ctx = static_cast<CriteoCtx*>(vctx);
  int64_t r = ctx->row_base[idx];
  const int nd = ctx->n_dense, nc = ctx->n_cat;
  while (p < end) {
    const void* nlv = memchr(p, '\n', end - p);
    const char* eol = nlv ? static_cast<const char*>(nlv) : end;
    if (line_blank(p, eol)) { p = eol + 1; continue; }
    // label: numeric prefix, then field-isolate (junk never desyncs columns)
    const char* q;
    ctx->labels[r] = static_cast<float>(parse_float(p, eol, &q));
    p = q;
    while (p < eol && *p != '\t') ++p;
    if (p < eol) ++p;
    // dense ints (may be empty between tabs -> 0, matching criteo missing);
    // junk after the numeric prefix is skipped so columns never desync
    float* drow = ctx->dense + r * nd;
    for (int i = 0; i < nd; ++i) {
      drow[i] = 0.0f;
      if (p < eol && *p != '\t') {
        drow[i] = static_cast<float>(parse_float(p, eol, &q));
        p = q;
      }
      while (p < eol && *p != '\t') ++p;  // field-isolate
      if (p < eol) ++p;
    }
    // categorical hex fields -> per-slot salted mix64 keys
    uint64_t* krow = ctx->keys + r * nc;
    for (int i = 0; i < nc; ++i) {
      uint64_t raw = 0;
      bool present = false;
      while (p < eol && *p != '\t') {
        int d = hex_digit(*p);
        if (d < 0) break;
        raw = (raw << 4) | static_cast<uint64_t>(d);
        present = true;
        ++p;
      }
      while (p < eol && *p != '\t') ++p;  // tolerate junk
      krow[i] = mix64(present ? raw : kMissingCat,
                      static_cast<uint64_t>(i) + 1);
      if (p < eol && *p == '\t') ++p;
    }
    ++r;
    p = eol + 1;
  }
}

}  // namespace

extern "C" {

// Count rows/nnz of a libsvm buffer.  Writes per-chunk counts into the
// caller-allocated chunk_rows/chunk_nnz (each of size nthreads) so the
// subsequent ps_libsvm_fill can place chunk output without re-counting —
// one count pass + one fill pass total.
void ps_libsvm_count(const char* buf, int64_t len, int nthreads,
                     int64_t* out_rows, int64_t* out_nnz,
                     int64_t* chunk_rows, int64_t* chunk_nnz) {
  int nt = nthreads > 0 ? nthreads : 1;
  auto off = line_chunks(buf, len, nt);
  int n = static_cast<int>(off.size()) - 1;
  LibsvmCounts ctx{std::vector<int64_t>(n, 0), std::vector<int64_t>(n, 0)};
  run_chunks(buf, len, nthreads, off, libsvm_count_chunk, &ctx);
  int64_t rows = 0, nnz = 0;
  for (int i = 0; i < n; ++i) {
    rows += ctx.rows[i];
    nnz += ctx.nnz[i];
    if (chunk_rows) chunk_rows[i] = ctx.rows[i];
    if (chunk_nnz) chunk_nnz[i] = ctx.nnz[i];
  }
  *out_rows = rows;
  *out_nnz = nnz;
}

// Fill caller-allocated CSR buffers (sized from ps_libsvm_count), with the
// per-chunk counts that call produced (same buf/len/nthreads required).
// indptr has rows+1 entries; this writes indptr[1..rows].
void ps_libsvm_fill(const char* buf, int64_t len, int nthreads,
                    const int64_t* chunk_rows, const int64_t* chunk_nnz,
                    float* labels, int64_t* indptr, uint64_t* indices,
                    float* values) {
  auto off = line_chunks(buf, len, nthreads > 0 ? nthreads : 1);
  int n = static_cast<int>(off.size()) - 1;
  LibsvmFill ctx;
  ctx.labels = labels;
  ctx.indptr = indptr;
  ctx.indices = indices;
  ctx.values = values;
  ctx.row_base.assign(n, 0);
  ctx.nnz_base.assign(n, 0);
  for (int i = 1; i < n; ++i) {
    ctx.row_base[i] = ctx.row_base[i - 1] + chunk_rows[i - 1];
    ctx.nnz_base[i] = ctx.nnz_base[i - 1] + chunk_nnz[i - 1];
  }
  indptr[0] = 0;
  run_chunks(buf, len, nthreads, off, libsvm_fill_chunk, &ctx);
}

void ps_criteo_count(const char* buf, int64_t len, int nthreads,
                     int64_t* out_rows, int64_t* chunk_rows) {
  auto off = line_chunks(buf, len, nthreads > 0 ? nthreads : 1);
  int n = static_cast<int>(off.size()) - 1;
  CriteoCtx ctx;
  ctx.rows.assign(n, 0);
  run_chunks(buf, len, nthreads, off, criteo_count_chunk, &ctx);
  int64_t rows = 0;
  for (int i = 0; i < n; ++i) {
    rows += ctx.rows[i];
    if (chunk_rows) chunk_rows[i] = ctx.rows[i];
  }
  *out_rows = rows;
}

void ps_criteo_fill(const char* buf, int64_t len, int nthreads,
                    const int64_t* chunk_rows, int n_dense, int n_cat,
                    float* labels, float* dense, uint64_t* keys) {
  auto off = line_chunks(buf, len, nthreads > 0 ? nthreads : 1);
  int n = static_cast<int>(off.size()) - 1;
  CriteoCtx ctx;
  ctx.labels = labels;
  ctx.dense = dense;
  ctx.keys = keys;
  ctx.n_dense = n_dense;
  ctx.n_cat = n_cat;
  ctx.row_base.assign(n, 0);
  for (int i = 1; i < n; ++i)
    ctx.row_base[i] = ctx.row_base[i - 1] + chunk_rows[i - 1];
  run_chunks(buf, len, nthreads, off, criteo_fill_chunk, &ctx);
}

// Exposed for hash-parity tests against utils/keys.py::mix64.
uint64_t ps_mix64(uint64_t x, uint64_t seed) { return mix64(x, seed); }

}  // extern "C"
