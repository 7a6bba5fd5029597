// Native host-side ingest and baseline loops for fps_tpu_torch.
//
// The port's copy of fps_tpu/native/src/fps_native.cc, the same C ABI and
// the same arithmetic, so its parsers, pair generator and sequential
// baselines give the JAX package's library's outputs on the same inputs.
// The accelerator path is PyTorch and CUDA; this file is the *host* side:
//   * dataset file parsing (np.loadtxt is ~50x slower than a tight scanner
//     on MovieLens-20M-sized rating files), and
//   * skip-gram pair generation with frequent-word subsampling and a
//     dynamic window (a per-token branchy loop, word2vec's ingest shape).
//
// Exposed as a tiny C ABI consumed via ctypes: fps_tpu_torch/native/
// __init__.py builds this file with g++ at first use into native/_build/
// (keyed by a hash of the source) and falls back to the numpy
// implementations when no compiler is present.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>

namespace {

// splitmix64 — deterministic, seedable, fast.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // uniform integer in [1, hi]
  int one_to(int hi) { return 1 + static_cast<int>(next() % hi); }
};

}  // namespace

extern "C" {

namespace {

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// Parse an unsigned int at p; advances p. Returns -1 if no digits.
inline long parse_uint(const char*& p, const char* end) {
  if (p >= end || !is_digit(*p)) return -1;
  long v = 0;
  while (p < end && is_digit(*p)) v = v * 10 + (*p++ - '0');
  return v;
}

// Parse a simple decimal (digits[.digits]); advances p. NaN if no digits.
inline float parse_decimal(const char*& p, const char* end) {
  long ip = parse_uint(p, end);
  if (ip < 0) return -1.0f;
  double v = static_cast<double>(ip);
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && is_digit(*p)) {
      v += (*p++ - '0') * scale;
      scale *= 0.1;
    }
  }
  return static_cast<float>(v);
}

inline void skip_sep(const char*& p, const char* end) {
  while (p < end && (*p == '\t' || *p == ',' || *p == ' ')) ++p;
}

inline void skip_line(const char*& p, const char* end) {
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;
}

}  // namespace

// Count newline-terminated lines in a file (capacity sizing for
// fps_parse_ratings — keeps the whole "how many rows might this file have"
// question on the native side, one warm-cache read instead of a Python
// chunk loop). Returns -1 if the file cannot be read.
long fps_count_lines(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  const size_t bufsz = 1 << 18;  // heap: callers may run on small-stack threads
  char* buf = static_cast<char*>(malloc(bufsz));
  if (!buf) {
    fclose(f);
    return -1;
  }
  long lines = 0;
  size_t got;
  char last = '\n';
  while ((got = fread(buf, 1, bufsz, f)) > 0) {
    for (size_t i = 0; i < got; ++i)
      if (buf[i] == '\n') ++lines;
    last = buf[got - 1];
  }
  free(buf);
  fclose(f);
  if (last != '\n') ++lines;  // unterminated final line
  return lines;
}

// Parse a ratings file: lines of "user sep item sep rating [sep extra...]"
// with sep in {tab, comma, space}. '#'-leading lines are comments and are
// skipped anywhere (np.loadtxt convention). Other non-digit-leading lines
// are treated as skippable headers ONLY before the first data row; after
// data has started they count in *malformed, as do lines that start like
// data but fail mid-parse. A file that yields ZERO data rows but had
// header-skipped lines also reports them as malformed — a quoted-field csv
// must error, not parse to an empty dataset. user/item are written verbatim
// (caller re-indexes). Returns rows written, or -1 if the file cannot be
// read. Writes at most cap rows. Whole-file buffered manual scanner —
// per-line stdio + strtol measured ~7x slower on ML-20M files.
long fps_parse_ratings(const char* path, int32_t* users, int32_t* items,
                       float* ratings, long cap, long* malformed) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return -1;
  }
  long size = ftell(f);
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  char* buf = static_cast<char*>(malloc(size + 1));
  if (!buf) {
    fclose(f);
    return -1;
  }
  long got = static_cast<long>(fread(buf, 1, size, f));
  fclose(f);
  const char* p = buf;
  const char* end = buf + got;
  long headers = 0;
  long n = 0;
  long bad = 0;
  while (n < cap && p < end) {
    while (p < end && *p == ' ') ++p;
    if (p >= end) break;
    if (*p == '\n' || (*p == '\r' && (p + 1 >= end || p[1] == '\n'))) {
      skip_line(p, end);  // empty line (LF or CRLF)
      continue;
    }
    if (*p == '#') {  // comment line, valid anywhere
      skip_line(p, end);
      continue;
    }
    if (!is_digit(*p)) {
      if (n == 0) {
        ++headers;  // header line before any data
      } else {
        ++bad;  // non-data line mid-file: corrupt, not a header
      }
      skip_line(p, end);
      continue;
    }
    long u = parse_uint(p, end);
    skip_sep(p, end);
    long i = parse_uint(p, end);
    skip_sep(p, end);
    float r = parse_decimal(p, end);
    if (u < 0 || i < 0 || r < 0.0f) {  // malformed data line
      ++bad;
      skip_line(p, end);
      continue;
    }
    users[n] = static_cast<int32_t>(u);
    items[n] = static_cast<int32_t>(i);
    ratings[n] = r;
    ++n;
    skip_line(p, end);
  }
  free(buf);
  if (n == 0 && headers > 0) bad += headers;  // all-header file: not data
  if (malformed) *malformed = bad;
  return n;
}

namespace {

// Signed decimal with optional exponent ("-1", "+0.25", "1e-3"); advances p.
// Returns false if nothing parseable at p.
inline bool parse_signed(const char*& p, const char* end, double* out) {
  double sign = 1.0;
  if (p < end && (*p == '+' || *p == '-')) {
    if (*p == '-') sign = -1.0;
    ++p;
  }
  if (p >= end || (!is_digit(*p) && *p != '.')) return false;
  double v = 0.0;
  bool digits = false;  // "." / "-." must fail like Python float("."), not
                        // parse as 0.0 — native and fallback loaders must
                        // classify degenerate tokens identically.
  while (p < end && is_digit(*p)) {
    v = v * 10.0 + (*p++ - '0');
    digits = true;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && is_digit(*p)) {
      v += (*p++ - '0') * scale;
      scale *= 0.1;
      digits = true;
    }
  }
  if (!digits) return false;
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    double esign = 1.0;
    if (p < end && (*p == '+' || *p == '-')) {
      if (*p == '-') esign = -1.0;
      ++p;
    }
    if (p >= end || !is_digit(*p)) return false;
    double e = 0.0;
    while (p < end && is_digit(*p)) e = e * 10.0 + (*p++ - '0');
    // Cap: beyond ~1e310 the scale is inf/0 anyway, and an O(e) loop on a
    // hostile exponent ("1e2000000000") must not hang the parser.
    long ecap = e > 310.0 ? 310 : static_cast<long>(e);
    double scale = 1.0;
    for (long k = 0; k < ecap; ++k) scale *= 10.0;
    v = esign > 0 ? v * scale : v / scale;
  }
  *out = sign * v;
  return true;
}

// FNV-1a 64-bit over bytes, finalized with splitmix64 — the categorical
// feature hash. fps_tpu_torch/utils/datasets.py's fallback reimplements this
// bit-for-bit; the two must stay in sync.
inline uint64_t hash_bytes(uint64_t seed, const char* s, long len) {
  uint64_t h = 1469598103934665603ULL ^ seed;
  for (long i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  uint64_t z = h + 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

inline char* read_whole_file(const char* path, long* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  // An unseekable path (pipe, directory) must surface as an I/O error, not
  // as a valid empty dataset: ftell returns -1 there.
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return nullptr;
  }
  long size = ftell(f);
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return nullptr;
  }
  char* buf = static_cast<char*>(malloc(size + 1));
  if (!buf) {
    fclose(f);
    return nullptr;
  }
  *out_len = static_cast<long>(fread(buf, 1, size, f));
  fclose(f);
  return buf;
}

}  // namespace

// svmlight/RCV1 scanner, pass 1: rows and the max feature count of any
// line, so the caller can size the padded (rows, nnz) arrays. Lines:
//   <label> <idx>:<val> <idx>:<val> ... [# comment]
// '#'-leading lines are comments; blank lines skipped. Returns data-looking
// row count, or -1 if the file cannot be read.
long fps_svmlight_dims(const char* path, long* max_nnz) {
  long size = 0;
  char* buf = read_whole_file(path, &size);
  if (!buf) return -1;
  const char* p = buf;
  const char* end = buf + size;
  long rows = 0, mx = 0;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '\n' || *p == '#') {
      skip_line(p, end);
      continue;
    }
    long nnz = 0;
    const char* q = p;
    while (q < end && *q != '\n' && *q != '#') {
      if (*q == ':') ++nnz;
      ++q;
    }
    if (nnz > mx) mx = nnz;
    ++rows;
    skip_line(p, end);
  }
  free(buf);
  *max_nnz = mx;
  return rows;
}

// svmlight/RCV1 scanner, pass 2: fill CALLER-ZEROED padded row-major
// (cap_rows x nnz_cap) id/value arrays (pad slots stay id 0 / value 0 —
// inactive by the models' x != 0 convention) plus float labels. Feature
// ids are written verbatim (svmlight is conventionally 1-based; the caller
// re-indexes). Rows with more than nnz_cap features keep the FIRST nnz_cap
// and count in *truncated. Structurally malformed data lines (unparseable
// label, broken idx:val token) count in *malformed — callers refuse the
// file rather than silently drop lines, matching fps_parse_ratings.
long fps_parse_svmlight(const char* path, float* labels, int32_t* ids,
                        float* vals, long cap_rows, long nnz_cap,
                        long* truncated, long* malformed) {
  long size = 0;
  char* buf = read_whole_file(path, &size);
  if (!buf) return -1;
  const char* p = buf;
  const char* end = buf + size;
  long n = 0, bad = 0, trunc = 0;
  while (n < cap_rows && p < end) {
    while (p < end && (*p == ' ' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '\n' || *p == '#') {
      skip_line(p, end);
      continue;
    }
    double label;
    if (!parse_signed(p, end, &label)) {
      ++bad;
      skip_line(p, end);
      continue;
    }
    long nnz = 0;
    bool ok = true;
    while (p < end && *p != '\n' && *p != '#' && *p != '\r') {
      while (p < end && *p == ' ') ++p;
      if (p >= end || *p == '\n' || *p == '#' || *p == '\r') break;
      long idx = parse_uint(p, end);
      if (idx < 0 || p >= end || *p != ':') {
        ok = false;
        break;
      }
      ++p;  // ':'
      double v;
      if (!parse_signed(p, end, &v)) {
        ok = false;
        break;
      }
      if (nnz < nnz_cap) {
        ids[n * nnz_cap + nnz] = static_cast<int32_t>(idx);
        vals[n * nnz_cap + nnz] = static_cast<float>(v);
        ++nnz;
      } else {
        ++trunc;
        // keep scanning to validate the rest of the line
      }
    }
    if (!ok) {
      ++bad;
      // wipe any partial row
      for (long k = 0; k < nnz_cap; ++k) {
        ids[n * nnz_cap + k] = 0;
        vals[n * nnz_cap + k] = 0.0f;
      }
      skip_line(p, end);
      continue;
    }
    labels[n] = static_cast<float>(label);
    ++n;
    skip_line(p, end);
  }
  free(buf);
  if (truncated) *truncated = trunc;
  if (malformed) *malformed = bad;
  return n;
}

// Criteo click-logs scanner: one example per line,
//   <label> \t I1..I13 (ints, may be empty/negative) \t C1..C26 (hex tokens,
//   may be empty)
// Numeric column j (0-based) with value x >= 0 becomes feature id j with
// value log1p(x); negative or empty numerics are treated as missing.
// Categorical column j with token s becomes feature id
//   13 + hash(j, s) % (num_features - 13)      (FNV-1a + splitmix64)
// with value 1.0. Output is CALLER-ZEROED row-major (cap_rows x 39) with a
// FIXED-SLOT layout: numeric column j always sits at slot j (id j, value 0
// when missing — inactive by the models' x != 0 convention), categoricals
// append from slot 13; absent fields leave inactive pads. Lines with a
// non-0/1 label or a wrong field count are malformed. Returns rows, or -1
// on IO error.
long fps_parse_criteo(const char* path, float* labels, int32_t* ids,
                      float* vals, long cap_rows, long num_features,
                      long* malformed) {
  long size = 0;
  char* buf = read_whole_file(path, &size);
  if (!buf) return -1;
  const long kNum = 13, kCat = 26, kNnz = kNum + kCat;
  const long cat_space = num_features - kNum;
  const char* p = buf;
  const char* end = buf + size;
  long n = 0, bad = 0;
  while (n < cap_rows && p < end) {
    if (*p == '\n') {
      ++p;
      continue;
    }
    if (*p == '\r' && (p + 1 >= end || p[1] == '\n')) {
      p += (p + 1 < end) ? 2 : 1;  // blank CRLF line, skip like the fallback
      continue;
    }
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    const char* le = line_end;
    if (le > p && le[-1] == '\r') --le;

    bool ok = true;
    // label
    long label = parse_uint(p, le);
    if (label != 0 && label != 1) ok = false;
    // FIXED-SLOT layout: numeric column j always occupies batch slot j
    // (id j; value 0 = inactive when missing/negative), so slot<->id is
    // deterministic for the dense head — models exploit it by pulling and
    // pushing the 13 numeric weights densely (LogRegConfig.dense_features)
    // instead of paying 13 scatter rows per example. Categorical features
    // append from slot 13 in field order; absent cats leave inactive pads.
    long nnz = kNum;  // cat slots start after the fixed numeric head
    long field = 0;
    while (ok && field < kNnz) {
      if (p >= le || *p != '\t') {
        ok = false;
        break;
      }
      ++p;  // tab
      const char* fs = p;
      while (p < le && *p != '\t') ++p;
      long flen = p - fs;
      if (field < kNum) {
        ids[n * kNnz + field] = static_cast<int32_t>(field);
        vals[n * kNnz + field] = 0.0f;  // inactive unless present below
      }
      if (flen == 0) {
        ++field;
        continue;  // missing value
      }
      if (field < kNum) {
        const char* q = fs;
        double v;
        if (!parse_signed(q, fs + flen, &v) || q != fs + flen) {
          ok = false;
          break;
        }
        if (v >= 0.0) {
          // log1p, cheap enough inline
          double x = v, r = 0.0;
          r = __builtin_log1p(x);
          vals[n * kNnz + field] = static_cast<float>(r);
        }
      } else {
        uint64_t h = hash_bytes(static_cast<uint64_t>(field), fs, flen);
        ids[n * kNnz + nnz] =
            static_cast<int32_t>(kNum + static_cast<long>(h % cat_space));
        vals[n * kNnz + nnz] = 1.0f;
        ++nnz;
      }
      ++field;
    }
    if (ok && (field != kNnz || p != le)) ok = false;
    if (!ok) {
      ++bad;
      for (long k = 0; k < kNnz; ++k) {
        ids[n * kNnz + k] = 0;
        vals[n * kNnz + k] = 0.0f;
      }
      p = line_end < end ? line_end + 1 : end;
      continue;
    }
    labels[n] = static_cast<float>(label);
    ++n;
    p = line_end < end ? line_end + 1 : end;
  }
  free(buf);
  if (malformed) *malformed = bad;
  return n;
}

// Skip-gram pair generation over a token segment, mirroring
// fps_tpu_torch/models/word2vec.py's skipgram_chunks inner loop:
//   1. drop position t with probability 1 - keep_p[token[t]]  (subsampling)
//   2. per kept position, draw half-width h ~ U{1..window}
//   3. for d in 1..h with t+d kept-in-range: emit (kept[t], kept[t+d]) and
//      (kept[t+d], kept[t])  (both directions, distance gated by the LEFT
//      element's half-width, exactly like the numpy implementation)
// Deterministic for a given seed. Returns pairs written (<= cap).
long fps_skipgram_pairs(const int32_t* tokens, long n, int window,
                        uint64_t seed, const float* keep_p, int32_t vocab,
                        int32_t* centers, int32_t* contexts, long cap) {
  if (n <= 0 || window <= 0) return 0;
  Rng rng(seed);
  // Pass 1: subsample into a kept buffer (indices compacted).
  int32_t* kept = static_cast<int32_t*>(malloc(sizeof(int32_t) * n));
  if (!kept) return -1;
  long m = 0;
  for (long t = 0; t < n; ++t) {
    int32_t tok = tokens[t];
    double kp = (keep_p && tok >= 0 && tok < vocab) ? keep_p[tok] : 1.0;
    if (kp >= 1.0 || rng.uniform() < kp) kept[m++] = tok;
  }
  long out = 0;
  for (long t = 0; t < m && out < cap; ++t) {
    int h = rng.one_to(window);
    for (int d = 1; d <= h && t + d < m; ++d) {
      if (out + 2 > cap) break;
      centers[out] = kept[t];
      contexts[out] = kept[t + d];
      ++out;
      centers[out] = kept[t + d];
      contexts[out] = kept[t];
      ++out;
    }
  }
  free(kept);
  return out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Measured sequential-baseline hot loops (bench.py's reference stand-in).
//
// The reference's hot path is a per-record parameter-server loop riding
// Flink operators: worker receives a record, sends a pull message through a
// keyed shuffle to the server operator, gets the row back, computes, sends a
// push message. Its JVM stack cannot run in this image, so bench.py needs a
// measured stand-in rather than a guessed constant. Two modes, both strictly
// GENEROUS to the reference:
//
//   mode 0 ("ideal"): the fused sequential loop — pull/update/push collapse
//     into direct array access. A floor no real deployment reaches (no
//     framework, no serialization, no network, tables cache-resident).
//   mode 1 ("ps"):    the same loop with every pull request, pull response
//     and push delta forced through a bounded ring of message slots with
//     real (noinline) memcpy on both ends — the cheapest possible model of
//     the reference's operator hops: serialize -> channel -> deserialize
//     becomes memcpy -> ring -> memcpy, with zero JVM, network or
//     coordination cost on top.
//
// Timing uses CLOCK_MONOTONIC and excludes allocation/init. Each loop also
// reports its own training-quality metric (online MSE / SGNS loss /
// logloss) so the caller can verify the baseline LEARNS — the equal-epochs
// credit in bench.py depends on it.

namespace {

inline double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

// Bounded message ring: NSLOT fixed-size slots, reused round-robin like a
// channel buffer. send/recv are noinline so -O3 cannot collapse the message
// path back into the ideal loop — each message pays two real calls and two
// real memcpys, the irreducible cost of an operator hop.
struct Ring {
  // >= largest message: id + kMaxClasses floats (multiclass PA row) and
  // id + 100 floats (rank-100 w2v/MF rows) both fit; static_asserts at
  // the consumers tie the caps to this size.
  static const long SLOT = 512;
  static const long NSLOT = 256;
  char* data;
  long w;
  Ring() : data(static_cast<char*>(malloc(SLOT * NSLOT))), w(0) {}
  ~Ring() { free(data); }
  bool ok() const { return data != nullptr; }
};

// Move an int32 id in and out of a float-typed message slot without
// violating strict aliasing; memcpy compiles to the same single store/load.
inline void put_id(float* slot, int32_t id) { memcpy(slot, &id, sizeof(id)); }
inline int32_t get_id(const float* slot) {
  int32_t id;
  memcpy(&id, slot, sizeof(id));
  return id;
}

__attribute__((noinline)) char* ring_send(Ring& r, const void* src,
                                          long nbytes) {
  char* slot = r.data + (r.w++ % Ring::NSLOT) * Ring::SLOT;
  memcpy(slot, src, nbytes);
  return slot;
}

__attribute__((noinline)) void ring_recv(void* dst, const char* slot,
                                         long nbytes) {
  memcpy(dst, slot, nbytes);
}

inline float fast_sigmoid_arg(float z) {
  // Guard exp against overflow; the loops' lr keep z small in practice.
  if (z > 30.0f) z = 30.0f;
  if (z < -30.0f) z = -30.0f;
  return z;
}

}  // namespace

extern "C" {

// Sequential per-record MF SGD (the reference's worker-local user factors /
// server-resident item factors split): per rating, pull the item row,
// compute the error, update the local user row, push the item delta.
// Runs `epochs` passes over the n ratings in the given order, writing
// per-epoch wall seconds and per-epoch ONLINE train MSE (pre-update error,
// the same semantic as the TPU path's metrics stream). Returns total train
// seconds, or -1 on allocation failure.
double fps_baseline_mf(const int32_t* users, const int32_t* items,
                       const float* ratings, long n, long num_users,
                       long num_items, int rank, float lr, float reg,
                       uint64_t seed, int epochs, int ps_mode,
                       double* per_epoch_s, double* per_epoch_mse) {
  if (rank > 120) return -1.0;  // qbuf/dbuf + ring slot budget (cf. w2v)
  float* P = static_cast<float*>(malloc(sizeof(float) * num_users * rank));
  float* Q = static_cast<float*>(malloc(sizeof(float) * num_items * rank));
  if (!P || !Q) {
    free(P);
    free(Q);
    return -1.0;
  }
  Rng rng(seed);
  for (long k = 0; k < num_users * rank; ++k)
    P[k] = static_cast<float>((rng.uniform() - 0.5) * 0.2);
  for (long k = 0; k < num_items * rank; ++k)
    Q[k] = static_cast<float>((rng.uniform() - 0.5) * 0.2);

  Ring ring;
  if (ps_mode && !ring.ok()) {
    free(P);
    free(Q);
    return -1.0;
  }
  float qbuf[128];
  float dbuf[129];
  double total = 0.0;
  for (int e = 0; e < epochs; ++e) {
    double se = 0.0;
    double t0 = now_s();
    for (long k = 0; k < n; ++k) {
      long u = users[k], i = items[k];
      float r = ratings[k];
      float* p = P + u * rank;
      const float* q;
      if (ps_mode) {
        // pull request (item id) -> server; response (rank floats) back.
        int32_t req = static_cast<int32_t>(i);
        char* s1 = ring_send(ring, &req, sizeof(req));
        int32_t got_i;
        ring_recv(&got_i, s1, sizeof(got_i));
        char* s2 = ring_send(ring, Q + got_i * rank, sizeof(float) * rank);
        ring_recv(qbuf, s2, sizeof(float) * rank);
        q = qbuf;
      } else {
        q = Q + i * rank;
      }
      float dot = 0.0f;
      for (int d = 0; d < rank; ++d) dot += p[d] * q[d];
      float err = r - dot;
      se += static_cast<double>(err) * err;
      if (ps_mode) {
        // local user update + push message (id + rank floats) -> server.
        put_id(&dbuf[0], static_cast<int32_t>(i));
        for (int d = 0; d < rank; ++d) {
          float pd = p[d];
          dbuf[1 + d] = lr * (err * pd - reg * q[d]);
          p[d] = pd + lr * (err * q[d] - reg * pd);
        }
        char* s3 = ring_send(ring, dbuf, sizeof(float) * (rank + 1));
        ring_recv(dbuf, s3, sizeof(float) * (rank + 1));
        float* qrow = Q + get_id(&dbuf[0]) * rank;
        for (int d = 0; d < rank; ++d) qrow[d] += dbuf[1 + d];
      } else {
        float* qrow = Q + i * rank;
        for (int d = 0; d < rank; ++d) {
          float pd = p[d], qd = qrow[d];
          p[d] = pd + lr * (err * qd - reg * pd);
          qrow[d] = qd + lr * (err * pd - reg * qd);
        }
      }
    }
    double dt = now_s() - t0;
    total += dt;
    if (per_epoch_s) per_epoch_s[e] = dt;
    if (per_epoch_mse) per_epoch_mse[e] = se / (n > 0 ? n : 1);
  }
  free(P);
  free(Q);
  return total;
}

// Sequential per-pair word2vec SGNS: per (center, context) pair, pull the
// center row and the 1+negatives output rows, update all of them, push them
// back. Negatives are drawn from the unigram^0.75 cdf by binary search
// (the reference's unigram-table draw). One pass over the given pairs.
// Writes the mean SGNS loss over the pass. Returns seconds, or -1.
double fps_baseline_w2v(const int32_t* centers, const int32_t* contexts,
                        long n_pairs, const double* uni_cdf, long vocab,
                        int dim, int negatives, float lr, uint64_t seed,
                        int ps_mode, double* mean_loss) {
  if (dim > 120) return -1.0;  // ring slot budget
  float* IN = static_cast<float*>(malloc(sizeof(float) * vocab * dim));
  float* OUT = static_cast<float*>(malloc(sizeof(float) * vocab * dim));
  if (!IN || !OUT) {
    free(IN);
    free(OUT);
    return -1.0;
  }
  Rng rng(seed);
  for (long k = 0; k < vocab * dim; ++k)
    IN[k] = static_cast<float>((rng.uniform() - 0.5) / dim);
  memset(OUT, 0, sizeof(float) * vocab * dim);

  Ring ring;
  if (ps_mode && !ring.ok()) {
    free(IN);
    free(OUT);
    return -1.0;
  }
  float vbuf[128], ubuf[128], dbuf[129];
  double loss = 0.0;
  double t0 = now_s();
  for (long k = 0; k < n_pairs; ++k) {
    long c = centers[k];
    float* v;
    if (ps_mode) {
      int32_t req = static_cast<int32_t>(c);
      char* s1 = ring_send(ring, &req, sizeof(req));
      int32_t gi;
      ring_recv(&gi, s1, sizeof(gi));
      char* s2 = ring_send(ring, IN + gi * dim, sizeof(float) * dim);
      ring_recv(vbuf, s2, sizeof(float) * dim);
      v = vbuf;
    } else {
      v = IN + c * dim;
    }
    float dv[128];
    for (int d = 0; d < dim; ++d) dv[d] = 0.0f;
    for (int j = 0; j <= negatives; ++j) {
      long o;
      if (j == 0) {
        o = contexts[k];
      } else {
        // binary search the cdf for a unigram^0.75 draw
        double x = rng.uniform();
        long lo = 0, hi = vocab - 1;
        while (lo < hi) {
          long mid = (lo + hi) >> 1;
          if (uni_cdf[mid] < x) lo = mid + 1; else hi = mid;
        }
        o = lo;
      }
      float* u;
      if (ps_mode) {
        int32_t req = static_cast<int32_t>(o);
        char* s1 = ring_send(ring, &req, sizeof(req));
        int32_t gi;
        ring_recv(&gi, s1, sizeof(gi));
        char* s2 = ring_send(ring, OUT + gi * dim, sizeof(float) * dim);
        ring_recv(ubuf, s2, sizeof(float) * dim);
        u = ubuf;
      } else {
        u = OUT + o * dim;
      }
      float z = 0.0f;
      for (int d = 0; d < dim; ++d) z += v[d] * u[d];
      z = fast_sigmoid_arg(z);
      float sig = 1.0f / (1.0f + __builtin_expf(-z));
      float label = (j == 0) ? 1.0f : 0.0f;
      float g = sig - label;
      loss += (label > 0.5f)
                  ? -__builtin_log(sig > 1e-7f ? sig : 1e-7f)
                  : -__builtin_log(1.0f - sig > 1e-7f ? 1.0f - sig : 1e-7f);
      for (int d = 0; d < dim; ++d) dv[d] -= lr * g * u[d];
      if (ps_mode) {
        put_id(&dbuf[0], static_cast<int32_t>(o));
        for (int d = 0; d < dim; ++d) dbuf[1 + d] = -lr * g * v[d];
        char* s3 = ring_send(ring, dbuf, sizeof(float) * (dim + 1));
        ring_recv(dbuf, s3, sizeof(float) * (dim + 1));
        float* orow = OUT + get_id(&dbuf[0]) * dim;
        for (int d = 0; d < dim; ++d) orow[d] += dbuf[1 + d];
      } else {
        for (int d = 0; d < dim; ++d) u[d] -= lr * g * v[d];
      }
    }
    if (ps_mode) {
      put_id(&dbuf[0], static_cast<int32_t>(c));
      for (int d = 0; d < dim; ++d) dbuf[1 + d] = dv[d];
      char* s3 = ring_send(ring, dbuf, sizeof(float) * (dim + 1));
      ring_recv(dbuf, s3, sizeof(float) * (dim + 1));
      float* crow = IN + get_id(&dbuf[0]) * dim;
      for (int d = 0; d < dim; ++d) crow[d] += dbuf[1 + d];
    } else {
      for (int d = 0; d < dim; ++d) v[d] += dv[d];
    }
  }
  double dt = now_s() - t0;
  if (mean_loss)
    *mean_loss = loss / ((n_pairs > 0 ? n_pairs : 1) * (1 + negatives));
  free(IN);
  free(OUT);
  return dt;
}

// Sequential per-example sparse logistic regression: the reference's
// worker pulls each active feature id INDIVIDUALLY and pushes one delta per
// feature (SURVEY §3.4's fan-out). Pad slots (value exactly 0) are skipped.
// One pass; writes mean logloss. Returns seconds, or -1.
double fps_baseline_logreg(const int32_t* ids, const float* vals,
                           const float* labels, long n, long nnz,
                           long num_features, float lr, int ps_mode,
                           double* mean_logloss) {
  float* w = static_cast<float*>(calloc(num_features, sizeof(float)));
  if (!w) return -1.0;
  Ring ring;
  if (ps_mode && !ring.ok()) {
    free(w);
    return -1.0;
  }
  double loss = 0.0;
  double t0 = now_s();
  for (long k = 0; k < n; ++k) {
    const int32_t* fid = ids + k * nnz;
    const float* fval = vals + k * nnz;
    float z = 0.0f;
    for (long j = 0; j < nnz; ++j) {
      if (fval[j] == 0.0f) continue;
      float wj;
      if (ps_mode) {
        char* s1 = ring_send(ring, &fid[j], sizeof(int32_t));
        int32_t gi;
        ring_recv(&gi, s1, sizeof(gi));
        char* s2 = ring_send(ring, &w[gi], sizeof(float));
        ring_recv(&wj, s2, sizeof(float));
      } else {
        wj = w[fid[j]];
      }
      z += wj * fval[j];
    }
    z = fast_sigmoid_arg(z);
    float sig = 1.0f / (1.0f + __builtin_expf(-z));
    float y = labels[k];
    float g = (sig - y) * lr;
    loss += (y > 0.5f)
                ? -__builtin_log(sig > 1e-7f ? sig : 1e-7f)
                : -__builtin_log(1.0f - sig > 1e-7f ? 1.0f - sig : 1e-7f);
    for (long j = 0; j < nnz; ++j) {
      if (fval[j] == 0.0f) continue;
      if (ps_mode) {
        float msg[2];
        put_id(&msg[0], fid[j]);
        msg[1] = -g * fval[j];
        char* s3 = ring_send(ring, msg, sizeof(msg));
        ring_recv(msg, s3, sizeof(msg));
        w[get_id(&msg[0])] += msg[1];
      } else {
        w[fid[j]] -= g * fval[j];
      }
    }
  }
  double dt = now_s() - t0;
  if (mean_logloss) *mean_logloss = loss / (n > 0 ? n : 1);
  free(w);
  return dt;
}


// Sequential per-example passive-aggressive (binary, Crammer et al. 2006):
// the reference's shape — pull each active feature individually, compute
// the margin and the closed-form step (variant 0=PA, 1=PA-I, 2=PA-II),
// push one delta per feature. Labels in {-1,+1}; pad slots (value 0)
// skipped. One pass; writes the mean hinge loss and the online mistake
// fraction. Returns seconds, or -1.
double fps_baseline_pa(const int32_t* ids, const float* vals,
                       const float* labels, long n, long nnz,
                       long num_features, float C, int variant, int ps_mode,
                       double* mean_hinge, double* mistake_frac) {
  float* w = static_cast<float*>(calloc(num_features, sizeof(float)));
  if (!w) return -1.0;
  Ring ring;
  if (ps_mode && !ring.ok()) {
    free(w);
    return -1.0;
  }
  double hinge = 0.0;
  long mistakes = 0;
  double t0 = now_s();
  for (long k = 0; k < n; ++k) {
    const int32_t* fid = ids + k * nnz;
    const float* fval = vals + k * nnz;
    float y = labels[k];
    float m = 0.0f, x2 = 0.0f;
    for (long j = 0; j < nnz; ++j) {
      if (fval[j] == 0.0f) continue;
      float wj;
      if (ps_mode) {
        char* s1 = ring_send(ring, &fid[j], sizeof(int32_t));
        int32_t gi;
        ring_recv(&gi, s1, sizeof(gi));
        char* s2 = ring_send(ring, &w[gi], sizeof(float));
        ring_recv(&wj, s2, sizeof(float));
      } else {
        wj = w[fid[j]];
      }
      m += wj * fval[j];
      x2 += fval[j] * fval[j];
    }
    float l = 1.0f - y * m;
    if (l < 0.0f) l = 0.0f;
    hinge += l;
    if (y * m <= 0.0f) ++mistakes;
    if (l > 0.0f && x2 > 0.0f) {
      float tau;
      if (variant == 0) {
        tau = l / x2;
      } else if (variant == 1) {
        tau = l / x2;
        if (tau > C) tau = C;
      } else {
        tau = l / (x2 + 0.5f / C);
      }
      float step = tau * y;
      for (long j = 0; j < nnz; ++j) {
        if (fval[j] == 0.0f) continue;
        if (ps_mode) {
          float msg[2];
          put_id(&msg[0], fid[j]);
          msg[1] = step * fval[j];
          char* s3 = ring_send(ring, msg, sizeof(msg));
          ring_recv(msg, s3, sizeof(msg));
          w[get_id(&msg[0])] += msg[1];
        } else {
          w[fid[j]] += step * fval[j];
        }
      }
    }
  }
  double dt = now_s() - t0;
  if (mean_hinge) *mean_hinge = hinge / (n > 0 ? n : 1);
  if (mistake_frac)
    *mistake_frac = static_cast<double>(mistakes) / (n > 0 ? n : 1);
  free(w);
  return dt;
}

// Sequential per-example MULTICLASS passive-aggressive (Crammer et al.
// 2006 max-margin-violation update — the closed form the TPU path's
// MulticlassPassiveAggressiveWorker computes in batch): per example, pull
// each active feature's num_classes-float class row, score all classes,
// take the true class r vs the highest-scoring wrong class s,
// l = max(0, 1 - (score_r - score_s)), tau per variant with ||x||^2
// DOUBLED (the update touches two class columns), then push one
// num_classes-float delta row per active feature (+tau*x_j in column r,
// -tau*x_j in column s). Labels are class indices in [0, num_classes).
// ps_mode forces every pull request/response and push delta through the
// message ring exactly like the binary loop, with row-sized messages.
// One pass; writes mean hinge loss and the online mistake fraction.
// Returns seconds, or -1.
double fps_baseline_pa_mc(const int32_t* ids, const float* vals,
                          const int32_t* labels, long n, long nnz,
                          long num_features, long num_classes, float C,
                          int variant, int ps_mode, double* mean_hinge,
                          double* mistake_frac) {
  // The class cap is tied to the fixed buffers below and the ring slot:
  // msg carries id + num_classes floats, rowbuf/scores hold num_classes.
  const long kMaxClasses = 120;
  static_assert(sizeof(float) * (kMaxClasses + 1) <= Ring::SLOT,
                "multiclass PA message must fit one ring slot");
  static_assert(kMaxClasses + 1 <= 128,
                "multiclass PA buffers are 128 floats");
  if (num_classes < 3 || num_classes > kMaxClasses) return -1.0;
  // Labels index the scores/msg stack arrays and the weight rows: an
  // out-of-range class (1-based labels, -1 missing sentinel) must surface
  // as the -1 error return, not as silent memory corruption.
  for (long k = 0; k < n; ++k) {
    if (labels[k] < 0 || labels[k] >= num_classes) return -1.0;
  }
  float* w =
      static_cast<float*>(calloc(num_features * num_classes, sizeof(float)));
  if (!w) return -1.0;
  Ring ring;
  if (ps_mode && !ring.ok()) {
    free(w);
    return -1.0;
  }
  float rowbuf[128];
  float msg[128];  // id + num_classes floats
  float scores[128];
  double hinge = 0.0;
  long mistakes = 0;
  double t0 = now_s();
  for (long k = 0; k < n; ++k) {
    const int32_t* fid = ids + k * nnz;
    const float* fval = vals + k * nnz;
    long r = labels[k];
    for (long c = 0; c < num_classes; ++c) scores[c] = 0.0f;
    float x2 = 0.0f;
    for (long j = 0; j < nnz; ++j) {
      if (fval[j] == 0.0f) continue;
      const float* row;
      if (ps_mode) {
        char* s1 = ring_send(ring, &fid[j], sizeof(int32_t));
        int32_t gi;
        ring_recv(&gi, s1, sizeof(gi));
        char* s2 = ring_send(ring, w + static_cast<long>(gi) * num_classes,
                             sizeof(float) * num_classes);
        ring_recv(rowbuf, s2, sizeof(float) * num_classes);
        row = rowbuf;
      } else {
        row = w + static_cast<long>(fid[j]) * num_classes;
      }
      float xv = fval[j];
      for (long c = 0; c < num_classes; ++c) scores[c] += row[c] * xv;
      x2 += xv * xv;
    }
    // Highest-scoring WRONG class s; prediction = overall argmax (first
    // max wins, matching jnp.argmax).
    long s = (r == 0) ? 1 : 0;
    long pred = 0;
    for (long c = 1; c < num_classes; ++c) {
      if (scores[c] > scores[pred]) pred = c;
      if (c != r && scores[c] > scores[s]) s = c;
    }
    if (pred != r) ++mistakes;
    float l = 1.0f - (scores[r] - scores[s]);
    if (l < 0.0f) l = 0.0f;
    hinge += l;
    if (l > 0.0f && x2 > 0.0f) {
      float x2m = 2.0f * x2;
      float tau;
      if (variant == 0) {
        tau = l / x2m;
      } else if (variant == 1) {
        tau = l / x2m;
        if (tau > C) tau = C;
      } else {
        tau = l / (x2m + 0.5f / C);
      }
      for (long j = 0; j < nnz; ++j) {
        if (fval[j] == 0.0f) continue;
        float step = tau * fval[j];
        if (ps_mode) {
          put_id(&msg[0], fid[j]);
          for (long c = 0; c < num_classes; ++c) msg[1 + c] = 0.0f;
          msg[1 + r] = step;
          msg[1 + s] = -step;
          char* s3 = ring_send(ring, msg, sizeof(float) * (num_classes + 1));
          ring_recv(msg, s3, sizeof(float) * (num_classes + 1));
          float* wrow =
              w + static_cast<long>(get_id(&msg[0])) * num_classes;
          for (long c = 0; c < num_classes; ++c) wrow[c] += msg[1 + c];
        } else {
          float* wrow = w + static_cast<long>(fid[j]) * num_classes;
          wrow[r] += step;
          wrow[s] -= step;
        }
      }
    }
  }
  double dt = now_s() - t0;
  if (mean_hinge) *mean_hinge = hinge / (n > 0 ? n : 1);
  if (mistake_frac)
    *mistake_frac = static_cast<double>(mistakes) / (n > 0 ? n : 1);
  free(w);
  return dt;
}

}  // extern "C"
