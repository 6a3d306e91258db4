// Native text parsers: libsvm + criteo -> flat CSR arrays.
//
// Reference analog: src/data/text_parser.cc (the reference parses libsvm /
// criteo / adfea into slot-based Example protos in C++; parsing is a real
// hot path at CTR scale). This extension keeps that path native: it turns a
// chunk of complete text lines into flat (labels, row_splits, keys, vals,
// slots) arrays consumed zero-copy by numpy via ctypes.
//
// Contract notes:
//  - Caller passes a buffer of COMPLETE lines (the Python wrapper carries
//    partial tails between chunks).
//  - Outputs are caller-allocated; capacities passed in. Return value is 0
//    on success, -1 on capacity overflow, -2 on parse error (err_line gets
//    the 0-based index of the offending line in the chunk).
//  - Key hashing stays on the numpy side (utils.hashing) so Python and C++
//    ingest agree bit-for-bit by construction.
//  - ``slots`` may be NULL for slot-free formats (libsvm): the parser then
//    skips the per-entry zero store and the caller skips the buffer.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// fast positive-integer / hex parse; returns false on junk.
// (plain range compares, not std::isdigit: the locale-aware function
// call is a measurable cost in the per-entry hot loop)
inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// ---- SWAR digit-run parsing (the classic 8-digits-per-multiply trick,
// as in fast_float/simdjson — public-domain bit patterns). The per-entry
// digit loops are the parser's hot path at CTR scale; converting up to 8
// digits with three multiplies instead of eight loop iterations is the
// single biggest lever toward the >=GB/s/host ingest target.

inline uint64_t load8(const char* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// number of LEADING decimal-digit bytes in the 8 loaded chars (0..8).
// Conservative under cross-byte carries (can only under-count, never
// call a non-digit a digit), so a short count just means the per-digit
// tail loop finishes the run — correctness never depends on it.
inline int leading_digits(uint64_t v) {
  uint64_t t =
      (((v & 0xF0F0F0F0F0F0F0F0ull) |
        (((v + 0x0606060606060606ull) & 0xF0F0F0F0F0F0F0F0ull) >> 4)) ^
       0x3333333333333333ull);
  return t ? __builtin_ctzll(t) >> 3 : 8;
}

// parse EXACTLY 8 digit bytes (first text char in the low byte) to their
// numeric value: pairwise digit merges via three multiplies
inline uint32_t swar8(uint64_t val) {
  val = (val & 0x0F0F0F0F0F0F0F0Full) * 2561 >> 8;
  val = (val & 0x00FF00FF00FF00FFull) * 6553601 >> 16;
  return static_cast<uint32_t>(
      (val & 0x0000FFFF0000FFFFull) * 42949672960001ull >> 32);
}

const uint64_t POW10_U64[9] = {1ull,      10ull,      100ull,
                               1000ull,   10000ull,   100000ull,
                               1000000ull, 10000000ull, 100000000ull};

// exactly-representable powers of ten for the correctly-rounded float
// fast path (shared by the bounded and sentinel parsers)
const double P10[23] = {
    1.0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// parse k (1..7) leading digits of the loaded chunk: shift them into the
// high bytes and pad the low bytes with ASCII zeros so swar8 sees a full
// 8-digit string "0...0 d0..d_{k-1}"
inline uint32_t swar_partial(uint64_t w, int k) {
  return swar8((w << ((8 - k) * 8)) | (0x3030303030303030ull >> (k * 8)));
}

inline bool parse_u64(const char*& p, const char* end, uint64_t& out) {
  if (p >= end || !is_digit(*p)) return false;
  uint64_t v = 0;
  // 8-digit SWAR chunks while a full load is in bounds. Wrap-around on
  // overlong runs matches the per-digit loop exactly: (v*10+d) mod 2^64
  // iterated k times == (v*10^k + chunk) mod 2^64.
  while (end - p >= 8) {
    uint64_t w = load8(p);
    int k = leading_digits(w);
    if (k == 0) break;
    if (k == 8) {
      v = v * 100000000ull + swar8(w);
      p += 8;
      continue;  // run may extend into the next 8 bytes
    }
    v = v * POW10_U64[k] + swar_partial(w, k);
    p += k;
    break;  // run ended at a non-digit
  }
  while (p < end && is_digit(*p)) {  // tail (near buffer end)
    v = v * 10 + static_cast<uint64_t>(*p - '0');
    ++p;
  }
  out = v;
  return true;
}

inline bool parse_hex64(const char*& p, const char* end, uint64_t& out) {
  uint64_t v = 0;
  const char* start = p;
  while (p < end) {
    char c = *p;
    int d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
    else break;
    v = (v << 4) | static_cast<uint64_t>(d);
    ++p;
  }
  if (p == start) return false;
  out = v;
  return true;
}

#if defined(__AVX2__)
// 8 hex chars -> uint32 in ~12 ops (vs 8 branchy loop iterations; the
// hex id parse is HALF of criteo parse time, measured). Validates with
// one SSE range check; nibble = (c & 0xF) + 9*(bit6 of c), which maps
// '0'-'9' / 'a'-'f' / 'A'-'F' without branches.
inline bool hex8(const char* p, uint32_t& out) {
  uint64_t w;
  std::memcpy(&w, p, 8);
  const __m128i v = _mm_cvtsi64_si128(static_cast<long long>(w));
  const __m128i lower = _mm_or_si128(v, _mm_set1_epi8(0x20));
  const __m128i dig = _mm_and_si128(
      _mm_cmpgt_epi8(v, _mm_set1_epi8('0' - 1)),
      _mm_cmpgt_epi8(_mm_set1_epi8('9' + 1), v));
  const __m128i alpha = _mm_and_si128(
      _mm_cmpgt_epi8(lower, _mm_set1_epi8('a' - 1)),
      _mm_cmpgt_epi8(_mm_set1_epi8('f' + 1), lower));
  if ((_mm_movemask_epi8(_mm_or_si128(dig, alpha)) & 0xFF) != 0xFF)
    return false;
  const uint64_t nib = (w & 0x0F0F0F0F0F0F0F0Full) +
                       9 * ((w >> 6) & 0x0101010101010101ull);
  const uint64_t t = ((nib << 4) | (nib >> 8)) & 0x00FF00FF00FF00FFull;
  out = static_cast<uint32_t>(((t & 0xFF) << 24) |
                              (((t >> 16) & 0xFF) << 16) |
                              (((t >> 32) & 0xFF) << 8) |
                              ((t >> 48) & 0xFF));
  return true;
}
#endif

inline double parse_float_slow(const char*& p, const char* end) {
  // strtod needs a NUL-terminated-ish region; lines are short, copy-free use
  // is fine because strtod stops at the first invalid char and the buffer
  // always ends with '\n' (guaranteed by the wrapper).
  char* q = nullptr;
  double v = std::strtod(p, &q);
  p = (q && q <= end) ? q : p;
  return v;
}

inline double parse_float(const char*& p, const char* end) {
  // Exact fast path for plain decimals (the overwhelming case in ML text
  // formats): when the collected mantissa fits in 53 bits and the decimal
  // exponent is within +/-22, one double multiply/divide by an exactly-
  // representable power of ten is CORRECTLY ROUNDED — bit-identical to
  // strtod (and hence to the Python parsers). Everything else (inf/nan,
  // hex floats, 19+ significant digits, big exponents) falls back to
  // strtod, reparsing from the start so consumption always matches.
  const char* s = p;
  bool neg = false;
  if (s < end && (*s == '-' || *s == '+')) {
    neg = (*s == '-');
    ++s;
  }
  uint64_t mant = 0;
  int ndig = 0, exp10 = 0;
  bool any = false, inexact = false;
  // integer part: SWAR chunks while they provably stay within the
  // 19-significant-digit budget; the per-digit loop finishes tails,
  // short runs, and the (rare) 19-digit boundary with the original
  // one-digit-at-a-time semantics
  while (end - s >= 8 && ndig + 8 <= 19) {
    uint64_t w = load8(s);
    int k = leading_digits(w);
    if (k == 0) break;
    any = true;
    mant = mant * POW10_U64[k] +
           (k == 8 ? swar8(w) : swar_partial(w, k));
    ndig += k;
    s += k;
    if (k < 8) break;  // run ended at a non-digit
  }
  while (s < end && *s >= '0' && *s <= '9') {
    any = true;
    if (ndig < 19) {
      mant = mant * 10 + static_cast<uint64_t>(*s - '0');
      ++ndig;
    } else {
      ++exp10;  // dropped trailing integer digit
      inexact = true;
    }
    ++s;
  }
  if (s < end && *s == '.') {
    ++s;
    while (end - s >= 8 && ndig + 8 <= 19) {
      uint64_t w = load8(s);
      int k = leading_digits(w);
      if (k == 0) break;
      any = true;
      mant = mant * POW10_U64[k] +
             (k == 8 ? swar8(w) : swar_partial(w, k));
      ndig += k;
      exp10 -= k;
      s += k;
      if (k < 8) break;
    }
    while (s < end && *s >= '0' && *s <= '9') {
      any = true;
      if (ndig < 19) {
        mant = mant * 10 + static_cast<uint64_t>(*s - '0');
        ++ndig;
        --exp10;
      } else {
        inexact = true;  // dropped fraction digit
      }
      ++s;
    }
  }
  if (!any) return parse_float_slow(p, end);  // inf/nan/junk: strtod rules
  // C99 hex floats ("0x1Ap-3"): the leading 0 scanned as decimal; detect
  // the x/X and let strtod parse (and consume) the whole literal
  if (mant == 0 && s < end && (*s == 'x' || *s == 'X'))
    return parse_float_slow(p, end);
  if (s < end && (*s == 'e' || *s == 'E')) {
    const char* es = s + 1;
    bool eneg = false;
    if (es < end && (*es == '-' || *es == '+')) {
      eneg = (*es == '-');
      ++es;
    }
    int ev = 0;
    bool edig = false;
    while (es < end && *es >= '0' && *es <= '9' && ev < 10000) {
      ev = ev * 10 + (*es - '0');
      edig = true;
      ++es;
    }
    if (edig) {
      exp10 += eneg ? -ev : ev;
      s = es;
    }
    // 'e' with no digits: the number ends before 'e' (strtod agrees)
  }
  if (!inexact && mant < (1ull << 53) && exp10 >= -22 && exp10 <= 22) {
    double v = static_cast<double>(mant);
    v = exp10 >= 0 ? v * P10[exp10] : v / P10[-exp10];
    p = s;
    return neg ? -v : v;
  }
  return parse_float_slow(p, end);
}

inline void skip_ws(const char*& p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
}

// ---- sentinel-scanning variants. The wrapper guarantees the chunk's
// last byte is a line terminator, so whitespace/digit/number runs always
// stop at '\n' (or '\r') WITHOUT a per-byte end compare — that compare,
// plus the per-line memchr pass of find_line_end, is where the bounded
// parser spends a third of its time at CTR entry sizes. hard_end bounds
// only the 8-byte SWAR loads and the rare strtod fallback.

inline void skip_ws_nl(const char*& p) {
  while (*p == ' ' || *p == '\t') ++p;
}

inline bool parse_u64_nl(const char*& p, const char* hard_end,
                         uint64_t& out) {
  if (!is_digit(*p)) return false;
  uint64_t v = 0;
  while (hard_end - p >= 8) {
    uint64_t w = load8(p);
    int k = leading_digits(w);
    if (k == 0) break;
    if (k == 8) {
      v = v * 100000000ull + swar8(w);
      p += 8;
      continue;
    }
    v = v * POW10_U64[k] + swar_partial(w, k);
    p += k;
    break;
  }
  while (is_digit(*p)) {
    v = v * 10 + static_cast<uint64_t>(*p - '0');
    ++p;
  }
  out = v;
  return true;
}

inline double parse_float_nl(const char*& p, const char* hard_end) {
  // sentinel twin of parse_float (identical rounding semantics: exact
  // fast path or strtod fallback reparsing from the start)
  const char* s = p;
  bool neg = false;
  if (*s == '-' || *s == '+') {
    neg = (*s == '-');
    ++s;
  }
  uint64_t mant = 0;
  int ndig = 0, exp10 = 0;
  bool any = false, inexact = false;
  while (hard_end - s >= 8 && ndig + 8 <= 19) {
    uint64_t w = load8(s);
    int k = leading_digits(w);
    if (k == 0) break;
    any = true;
    mant = mant * POW10_U64[k] + (k == 8 ? swar8(w) : swar_partial(w, k));
    ndig += k;
    s += k;
    if (k < 8) break;
  }
  while (is_digit(*s)) {
    any = true;
    if (ndig < 19) {
      mant = mant * 10 + static_cast<uint64_t>(*s - '0');
      ++ndig;
    } else {
      ++exp10;
      inexact = true;
    }
    ++s;
  }
  if (*s == '.') {
    ++s;
    while (hard_end - s >= 8 && ndig + 8 <= 19) {
      uint64_t w = load8(s);
      int k = leading_digits(w);
      if (k == 0) break;
      any = true;
      mant = mant * POW10_U64[k] + (k == 8 ? swar8(w) : swar_partial(w, k));
      ndig += k;
      exp10 -= k;
      s += k;
      if (k < 8) break;
    }
    while (is_digit(*s)) {
      any = true;
      if (ndig < 19) {
        mant = mant * 10 + static_cast<uint64_t>(*s - '0');
        ++ndig;
        --exp10;
      } else {
        inexact = true;
      }
      ++s;
    }
  }
  if (!any) return parse_float_slow(p, hard_end);
  if (mant == 0 && (*s == 'x' || *s == 'X'))
    return parse_float_slow(p, hard_end);
  if (*s == 'e' || *s == 'E') {
    const char* es = s + 1;
    bool eneg = false;
    if (*es == '-' || *es == '+') {
      eneg = (*es == '-');
      ++es;
    }
    int ev = 0;
    bool edig = false;
    while (is_digit(*es) && ev < 10000) {
      ev = ev * 10 + (*es - '0');
      edig = true;
      ++es;
    }
    if (edig) {
      exp10 += eneg ? -ev : ev;
      s = es;
    }
  }
  if (!inexact && mant < (1ull << 53) && exp10 >= -22 && exp10 <= 22) {
    double v = static_cast<double>(mant);
    v = exp10 >= 0 ? v * P10[exp10] : v / P10[-exp10];
    p = s;
    return neg ? -v : v;
  }
  return parse_float_slow(p, hard_end);
}

// Line end for [p, buf_end): first '\n', '\r', or '\r\n' terminator (or
// buf_end), universal-newlines style, so CRLF and lone-CR files parse like
// the Python text-mode readers. ``any_cr`` is a chunk-level hint computed
// ONCE (one memchr over the chunk): the overwhelmingly common LF-only
// file skips the per-line '\r' scan — a second full pass over every
// line's bytes otherwise.
inline const char* find_line_end(const char* p, const char* end,
                                 const char** next_line, bool any_cr) {
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  if (any_cr) {
    // search '\r' only up to nl: scanning to end on every LF-only line
    // would make parsing quadratic in the chunk size
    const char* cr_stop = nl ? nl : end;
    const char* cr = static_cast<const char*>(memchr(p, '\r', cr_stop - p));
    if (cr) {
      *next_line = (cr + 1 < end && cr[1] == '\n') ? cr + 2 : cr + 1;
      return cr;
    }
  }
  *next_line = nl ? nl + 1 : end + 1;
  return nl ? nl : end;
}

inline bool chunk_has_cr(const char* buf, int64_t len) {
  return memchr(buf, '\r', len) != nullptr;
}

#if defined(__AVX2__)
// value of the first k (0..8) digit bytes of a loaded chunk
inline uint64_t swar_prefix(uint64_t w, int k) {
  if (k == 8) return swar8(w);
  if (k == 0) return 0;
  return swar_partial(w, k);
}

// Parse a digit-only token span [q, te). The byte AT te is always a
// delimiter (non-digit), so leading_digits() self-terminates inside the
// span — one unguarded 8-byte load replaces the per-digit loop whenever
// q+8 stays in the buffer (q <= safe8). Rejects non-digit bytes inside
// the span; falls back to the per-digit loop for 9+ digit keys or
// end-of-buffer tokens.
inline bool parse_key_span(const char* q, const char* te, const char* safe8,
                           uint64_t& out) {
  const int64_t len = te - q;
  if (len <= 8 && q <= safe8) {
    uint64_t w = load8(q);
    if (leading_digits(w) < len) return false;
    out = swar_prefix(w, static_cast<int>(len));
    return true;
  }
  const char* p = q;
  if (!parse_u64(p, te, out)) return false;
  return p == te;
}

// Fast path for the overwhelming value/label shape [-+]?DDD(.DDD)? with
// <= 53-bit mantissa: two unguarded loads, no loop. Returns false (no
// consumption) on anything else — exponents, inf/nan, 17+ digits, hex,
// end-of-buffer spans — which the caller re-parses via the exact
// bounded parse_float. Correctly rounded for the same reason that path
// is: mant < 2^53, |exp10| <= 8 <= 22.
inline bool parse_val_span_fast(const char* q, const char* te,
                                const char* safe8, double& out) {
  const char* p = q;
  bool neg = false;
  if (p < te && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  if (p >= te || p > safe8) return false;
  const uint64_t w = load8(p);
  const int k1 = leading_digits(w);  // stops at '.' or the end delimiter
  uint64_t mant = swar_prefix(w, k1);
  int ndig = k1, frac = 0;
  p += k1;
  if (p < te && *p == '.') {
    ++p;
    if (p > safe8) return false;
    const uint64_t w2 = load8(p);
    const int k2 = leading_digits(w2);
    mant = mant * POW10_U64[k2] + swar_prefix(w2, k2);
    ndig += k2;
    frac = k2;
    p += k2;
  }
  if (p != te || ndig == 0 || mant >= (1ull << 53)) return false;
  double v = static_cast<double>(mant);
  if (frac) v /= P10[frac];
  out = neg ? -v : v;
  return true;
}

// one 32-byte block -> bitmask of libsvm structural bytes (the token
// delimiters: ws, ':', line ends). simdjson-style stage-1 scan: the
// parser then touches only delimiter positions, never re-scanning token
// bytes — tokens are parsed from known [start, end) spans.
inline uint32_t delim_mask32(const char* p) {
  const __m256i c = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p));
  const __m256i m = _mm256_or_si256(
      _mm256_or_si256(
          _mm256_cmpeq_epi8(c, _mm256_set1_epi8(' ')),
          _mm256_cmpeq_epi8(c, _mm256_set1_epi8('\t'))),
      _mm256_or_si256(
          _mm256_cmpeq_epi8(c, _mm256_set1_epi8(':')),
          _mm256_or_si256(
              _mm256_cmpeq_epi8(c, _mm256_set1_epi8('\n')),
              _mm256_cmpeq_epi8(c, _mm256_set1_epi8('\r')))));
  return static_cast<uint32_t>(_mm256_movemask_epi8(m));
}

// AVX2 libsvm parser: delimiter-driven state machine over the structural
// bitmask (S_LABEL -> S_KEY <-> S_VALUE per line). Exactly the bounded
// parser's semantics, error lines included; ~2x over per-byte scanning
// at CTR entry sizes because work is per-DELIMITER (2-3 per entry), not
// per byte.
int ps_parse_libsvm_simd(const char* buf, int64_t len,
                         int64_t max_rows, int64_t max_nnz,
                         float* labels, int64_t* row_splits,
                         uint64_t* keys, float* vals, uint64_t* slots,
                         int64_t* out_rows, int64_t* out_nnz,
                         int64_t* err_line) {
  const char* end = buf + len;
  int64_t rows = 0, nnz = 0, line = 0;
  row_splits[0] = 0;
  if (len <= 0) {
    *out_rows = 0;
    *out_nnz = 0;
    return 0;
  }
  if (end[-1] != '\n' && end[-1] != '\r') return -6;  // closed-lines contract
  enum State { S_LABEL, S_KEY, S_VALUE };
  State st = S_LABEL;
  bool in_row = false;
  const char* ts = buf;  // current token start
  // spans starting at q <= safe8 may use one unguarded 8-byte load; the
  // handful of tokens in the final 8 bytes take the per-digit fallback
  const char* safe8 = end - 8;
  for (int64_t base = 0; base < len; base += 32) {
    uint32_t m;
    if (len - base >= 32) {
      m = delim_mask32(buf + base);
    } else {
      m = 0;
      for (int64_t i = base; i < len; ++i) {
        char c = buf[i];
        if (c == ' ' || c == '\t' || c == ':' || c == '\n' || c == '\r')
          m |= 1u << (i - base);
      }
    }
    while (m) {
      const int b = __builtin_ctz(m);
      m &= m - 1;
      const char* dp = buf + base + b;
      const char d = *dp;
      const char* te = dp;
      if (d == '\n' && dp > buf && dp[-1] == '\r') {
        ts = dp + 1;  // the LF of a CRLF: same line end, already handled
        continue;
      }
      if (d == ':') {
        // only a nonempty KEY token may end at ':' (a ':' at line start,
        // after a label, inside a value, or "::" is a parse error — the
        // per-byte parsers reject the same shapes)
        uint64_t k;
        if (st != S_KEY || ts == te || !parse_key_span(ts, te, safe8, k)) {
          *err_line = line;
          return -2;
        }
        if (nnz >= max_nnz) return -1;
        keys[nnz] = k;  // value lands at this same slot on the next token
        st = S_VALUE;
        ts = dp + 1;
        continue;
      }
      // d is ws or a line end: the token (possibly empty) is complete
      if (ts != te) {
        if (st == S_LABEL) {
          if (rows >= max_rows) return -1;
          double y;
          if (!parse_val_span_fast(ts, te, safe8, y)) {
            const char* q = ts;
            y = parse_float(q, te);
            if (q != te) {  // junk after the number: same error as per-byte
              *err_line = line;
              return -2;
            }
          }
          labels[rows] = y > 0 ? 1.0f : 0.0f;
          in_row = true;
          st = S_KEY;
        } else if (st == S_KEY) {  // bare key: implicit value 1.0
          uint64_t k;
          if (!parse_key_span(ts, te, safe8, k)) {
            *err_line = line;
            return -2;
          }
          if (nnz >= max_nnz) return -1;
          keys[nnz] = k;
          vals[nnz] = 1.0f;
          if (slots) slots[nnz] = 0;
          ++nnz;
        } else {  // S_VALUE
          double v;
          if (!parse_val_span_fast(ts, te, safe8, v)) {
            const char* q = ts;
            v = parse_float(q, te);
            if (q != te) {
              *err_line = line;
              return -2;
            }
          }
          vals[nnz] = static_cast<float>(v);
          if (slots) slots[nnz] = 0;
          ++nnz;
          st = S_KEY;
        }
      } else if (st == S_VALUE) {  // "k:" with empty value means 1.0
        vals[nnz] = 1.0f;
        if (slots) slots[nnz] = 0;
        ++nnz;
        st = S_KEY;
      }
      if (d == '\n' || d == '\r') {
        if (in_row) {
          ++rows;
          row_splits[rows] = nnz;
          in_row = false;
        }
        st = S_LABEL;
        ++line;
      }
      ts = dp + 1;
    }
  }
  *out_rows = rows;
  *out_nnz = nnz;
  return 0;
}
#endif  // __AVX2__

}  // namespace

extern "C" {

// count occurrences of up to four byte values in one pass (AVX2 compare
// + popcount; ~10 GB/s). The wrapper sizes its exact output arrays from
// newline/colon/ws counts — python's bytes.count pays per-occurrence
// overhead (~14 ns/hit measured), which at CTR colon densities costs
// more than the parse itself.
void ps_count4(const char* buf, int64_t len, char a, char b, char c, char d,
               int64_t* out) {
  int64_t ca = 0, cb = 0, cc = 0, cd = 0;
  int64_t i = 0;
#if defined(__AVX2__)
  const __m256i va = _mm256_set1_epi8(a), vb = _mm256_set1_epi8(b),
                vc = _mm256_set1_epi8(c), vd = _mm256_set1_epi8(d);
  for (; i + 32 <= len; i += 32) {
    const __m256i x =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(buf + i));
    ca += __builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(x, va))));
    cb += __builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(x, vb))));
    cc += __builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(x, vc))));
    cd += __builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(x, vd))));
  }
#endif
  for (; i < len; ++i) {
    ca += buf[i] == a;
    cb += buf[i] == b;
    cc += buf[i] == c;
    cd += buf[i] == d;
  }
  out[0] = ca;
  out[1] = cb;
  out[2] = cc;
  out[3] = cd;
}

// libsvm: "label k:v k:v ...". Labels <= 0 -> 0, > 0 -> 1. Slot = 0.
//
// Sentinel-scanning single pass: requires the buffer to END with a line
// terminator (returns -6 otherwise; parse_chunk appends '\n'). Every
// whitespace/number run then provably stops at the final '\n'/'\r', so
// the hot loops carry no per-byte end compares and no per-line memchr —
// worth ~1.3x over the bounded two-pass shape at CTR entry sizes.
// (With AVX2 the structural-scan parser below replaces this path
// entirely; this scalar body is the portable fallback.)
int ps_parse_libsvm_scalar(const char* buf, int64_t len,
                    int64_t max_rows, int64_t max_nnz,
                    float* labels, int64_t* row_splits,  // size max_rows+1
                    uint64_t* keys, float* vals, uint64_t* slots,
                    int64_t* out_rows, int64_t* out_nnz, int64_t* err_line) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t rows = 0, nnz = 0, line = 0;
  row_splits[0] = 0;
  if (len <= 0) {
    *out_rows = 0;
    *out_nnz = 0;
    return 0;
  }
  if (end[-1] != '\n' && end[-1] != '\r') return -6;  // sentinel contract
  while (p < end) {
    skip_ws_nl(p);
    if (*p == '\n') {  // blank line
      ++p;
      ++line;
      continue;
    }
    if (*p == '\r') {
      p += (p + 1 < end && p[1] == '\n') ? 2 : 1;
      ++line;
      continue;
    }
    if (rows >= max_rows) return -1;
    double y = parse_float_nl(p, end);
    labels[rows] = y > 0 ? 1.0f : 0.0f;
    while (true) {
      skip_ws_nl(p);
      if (*p == '\n') {
        ++p;
        break;
      }
      if (*p == '\r') {
        p += (p + 1 < end && p[1] == '\n') ? 2 : 1;
        break;
      }
      uint64_t k;
      if (!parse_u64_nl(p, end, k)) {
        *err_line = line;
        return -2;
      }
      float v = 1.0f;
      if (*p == ':') {
        ++p;
        // empty value ("k:" then whitespace/EOL) means 1.0, like the Python
        // parser; never let strtod skip leading whitespace across the EOL
        if (*p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') {
          v = static_cast<float>(parse_float_nl(p, end));
        }
      }
      if (nnz >= max_nnz) return -1;
      keys[nnz] = k;
      vals[nnz] = v;
      if (slots) slots[nnz] = 0;  // null for slotless callers
      ++nnz;
    }
    ++rows;
    row_splits[rows] = nnz;
    ++line;
  }
  *out_rows = rows;
  *out_nnz = nnz;
  return 0;
}

int ps_parse_libsvm(const char* buf, int64_t len,
                    int64_t max_rows, int64_t max_nnz,
                    float* labels, int64_t* row_splits,
                    uint64_t* keys, float* vals, uint64_t* slots,
                    int64_t* out_rows, int64_t* out_nnz, int64_t* err_line) {
#if defined(__AVX2__)
  return ps_parse_libsvm_simd(buf, len, max_rows, max_nnz, labels,
                              row_splits, keys, vals, slots, out_rows,
                              out_nnz, err_line);
#else
  return ps_parse_libsvm_scalar(buf, len, max_rows, max_nnz, labels,
                                row_splits, keys, vals, slots, out_rows,
                                out_nnz, err_line);
#endif
}

// criteo TSV: label \t 13 ints \t 26 hex cats. Missing fields skipped.
// Integer column j -> key j, slot j+1, value sign*log1p(|x|);
// categorical column j -> key hex id, slot j+14, value 1.0.
int ps_parse_criteo(const char* buf, int64_t len,
                    int64_t max_rows, int64_t max_nnz,
                    float* labels, int64_t* row_splits,
                    uint64_t* keys, float* vals, uint64_t* slots,
                    int64_t* out_rows, int64_t* out_nnz, int64_t* err_line) {
  (void)err_line;  // criteo skips malformed lines instead of erroring
  const char* p = buf;
  const char* end = buf + len;
  const bool any_cr = chunk_has_cr(buf, len);
  int64_t rows = 0, nnz = 0, line = 0;
  row_splits[0] = 0;
  while (p < end) {
    const char* next_line;
    const char* line_end = find_line_end(p, end, &next_line, any_cr);
    if (p >= line_end) {
      p = next_line;
      ++line;
      continue;
    }
    // count fields first: need 40 columns; otherwise skip the line.
    // memchr hops tab-to-tab at SIMD speed instead of testing every byte
    int cols = 1;
    for (const char* q = p; q < line_end; ++q) {
      q = static_cast<const char*>(memchr(q, '\t', line_end - q));
      if (!q) break;
      ++cols;
    }
    if (cols < 40) {
      p = next_line;
      ++line;
      continue;
    }
    if (rows >= max_rows) return -1;
    labels[rows] = (*p == '1' && (p + 1 == line_end || p[1] == '\t')) ? 1.0f : 0.0f;
    const char* f = static_cast<const char*>(memchr(p, '\t', line_end - p));
    int col = 0;  // 0-based among the 39 feature columns
    while (f && col < 39) {
      ++f;  // past the tab
      const char* fe = static_cast<const char*>(memchr(f, '\t', line_end - f));
      const char* field_end = fe ? fe : line_end;
      if (field_end > f) {  // non-empty
        if (nnz >= max_nnz) return -1;
        if (col < 13) {
          const char* fp = f;
          bool neg = (*fp == '-');
          if (neg) ++fp;
          uint64_t x;
          // require the WHOLE field to parse: junk like "3x7" is skipped,
          // never truncated to a prefix (both ingest paths agree on this)
          if (parse_u64(fp, field_end, x) && fp == field_end) {
            double lx = std::log1p(static_cast<double>(x));
            keys[nnz] = static_cast<uint64_t>(col);
            vals[nnz] = static_cast<float>(neg ? -lx : lx);
            slots[nnz] = static_cast<uint64_t>(col + 1);
            ++nnz;
          }
        } else {
          uint64_t h = 0;
          bool ok = false;
#if defined(__AVX2__)
          // real criteo cat ids are 8 hex chars (16 tolerated); the
          // 8-byte loads cover exactly the field bytes, so no overread.
          // Other lengths (and junk) take the per-char fallback
          const int64_t flen = field_end - f;
          if (flen == 8) {
            uint32_t v32;
            if (hex8(f, v32)) {
              h = v32;
              ok = true;
            }
          } else if (flen == 16) {
            uint32_t hi32, lo32;
            if (hex8(f, hi32) && hex8(f + 8, lo32)) {
              h = (static_cast<uint64_t>(hi32) << 32) | lo32;
              ok = true;
            }
          }
#endif
          if (!ok) {
            const char* fp = f;
            ok = parse_hex64(fp, field_end, h) && fp == field_end;
          }
          if (ok) {
            keys[nnz] = h;
            vals[nnz] = 1.0f;
            slots[nnz] = static_cast<uint64_t>(col - 13 + 14);
            ++nnz;
          }
        }
      }
      ++col;
      f = fe;
    }
    ++rows;
    row_splits[rows] = nnz;
    p = next_line;
    ++line;
  }
  *out_rows = rows;
  *out_nnz = nnz;
  return 0;
}

// Hash + localize kernel (ref: src/app/linear_method/localizer.h — remap
// touched keys to dense local ids; the per-batch hot loop after parsing).
// Reproduces utils/hashing.hash_keys + np.unique(return_inverse) exactly:
// splitmix64 with slot salt into [1, num_keys), then SORTED unique keys +
// 0-based inverse ids. Runs with the GIL released (ctypes), so the
// prefetch pipeline's builder threads scale across cores — numpy's
// unique/hash hold the GIL and serialize them.
//
// identity != 0 skips hashing: gid = raw + 1 (the exact-parity key mode).
// Sorting: 2-pass LSD radix over the high 32 bits of (gid<<32 | idx),
// which requires gid to fit 32 bits (num_keys <= 2^32 — practically
// always). Return codes: 0 success; -3 identity gid outside
// [1, num_keys); -4 alloc failure; -5 num_keys > 2^32. On -3/-5 the
// caller falls back to the numpy path (which owns the error text for -3
// and handles arbitrarily large key spaces for -5).

static inline uint64_t sm64_mix(uint64_t x) {
  // identical constants/steps to utils/hashing.splitmix64 (which adds C1
  // as its first step)
  uint64_t z = x + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

int ps_hash_localize(const uint64_t* raw, const uint64_t* slots, int64_t n,
                     uint64_t num_keys, int identity,
                     int64_t* out_unique, int32_t* out_inverse,
                     int64_t* out_nuniq) {
  if (n == 0) {
    *out_nuniq = 0;
    return 0;
  }
  uint64_t* packed =
      static_cast<uint64_t*>(std::malloc(2 * sizeof(uint64_t) * n));
  if (!packed) return -4;
  uint64_t* alt = packed + n;
  const uint64_t usable = num_keys - 1;  // hashed gids land in [1, num_keys)
  const uint64_t C1 = 0x9E3779B97F4A7C15ull;
  if (identity) {
    for (int64_t i = 0; i < n; ++i) {
      uint64_t gid = raw[i] + 1;
      if (gid >= num_keys || gid == 0) {
        std::free(packed);
        return -3;
      }
      packed[i] = (gid << 32) | static_cast<uint64_t>(i);
    }
  } else if (slots) {
    for (int64_t i = 0; i < n; ++i) {
      uint64_t gid = sm64_mix(raw[i] ^ sm64_mix(slots[i] + C1)) % usable + 1;
      packed[i] = (gid << 32) | static_cast<uint64_t>(i);
    }
  } else {
    const uint64_t salt0 = sm64_mix(C1);  // slot 0 salt, hoisted
    for (int64_t i = 0; i < n; ++i) {
      uint64_t gid = sm64_mix(raw[i] ^ salt0) % usable + 1;
      packed[i] = (gid << 32) | static_cast<uint64_t>(i);
    }
  }
  if (num_keys <= (1ull << 32) && n < (int64_t(1) << 32)) {
    // stable LSD radix over gid bits only (low idx bits untouched, so
    // equal gids keep insertion order, like a stable sort). The count
    // table lives on the heap: builder threads may carry small stacks
    // (512 KB default pthread stacks on some platforms).
    int64_t* count =
        static_cast<int64_t*>(std::malloc(65537 * sizeof(int64_t)));
    if (!count) {
      std::free(packed < alt ? packed : alt);
      return -4;
    }
    for (int pass = 0; pass < 2; ++pass) {
      int shift = 32 + 16 * pass;
      std::memset(count, 0, 65537 * sizeof(int64_t));
      for (int64_t i = 0; i < n; ++i)
        ++count[((packed[i] >> shift) & 0xffff) + 1];
      for (int b = 0; b < 65536; ++b) count[b + 1] += count[b];
      for (int64_t i = 0; i < n; ++i)
        alt[count[(packed[i] >> shift) & 0xffff]++] = packed[i];
      uint64_t* t = packed;
      packed = alt;
      alt = t;
    }
    std::free(count);
  } else {
    // gid may exceed 32 bits: the (gid<<32 | idx) pack is lossy there
    std::free(packed);
    return -5;  // caller falls back to numpy (num_keys > 2^32)
  }
  int64_t u = 0;
  uint64_t prev = ~0ull;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t gid = packed[i] >> 32;
    uint32_t idx = static_cast<uint32_t>(packed[i]);
    if (gid != prev) {
      out_unique[u++] = static_cast<int64_t>(gid);
      prev = gid;
    }
    out_inverse[idx] = static_cast<int32_t>(u - 1);
  }
  *out_nuniq = u;
  // note: `packed` here may be the original malloc block or its second
  // half; free the block start
  std::free(packed < alt ? packed : alt);
  return 0;
}

// adfea: "line_id label fea:grp fea:grp ...". Pure one-hot ad features:
// value is implicitly 1.0, the group id is the slot. Leading line id is
// metadata and dropped WITHOUT being parsed (ids like hashes are fine,
// matching the Python path). A token without ':' gets slot 0.
int ps_parse_adfea(const char* buf, int64_t len,
                   int64_t max_rows, int64_t max_nnz,
                   float* labels, int64_t* row_splits,
                   uint64_t* keys, float* vals, uint64_t* slots,
                   int64_t* out_rows, int64_t* out_nnz, int64_t* err_line) {
  const char* p = buf;
  const char* end = buf + len;
  const bool any_cr = chunk_has_cr(buf, len);
  int64_t rows = 0, nnz = 0, line = 0;
  row_splits[0] = 0;
  while (p < end) {
    const char* next_line;
    const char* line_end = find_line_end(p, end, &next_line, any_cr);
    skip_ws(p, line_end);
    if (p >= line_end) {  // blank line
      p = next_line;
      ++line;
      continue;
    }
    if (rows >= max_rows) return -1;
    while (p < line_end && *p != ' ' && *p != '\t') ++p;  // drop line id token
    skip_ws(p, line_end);
    if (p >= line_end) {  // line id but no label: skip, like the Python path
      p = next_line;
      ++line;
      continue;
    }
    // label must be a full float token (Python float() raises on junk)
    const char* tok = p;
    double y = parse_float(p, line_end);
    if (p == tok || (p < line_end && *p != ' ' && *p != '\t')) {
      *err_line = line;
      return -2;
    }
    labels[rows] = y > 0 ? 1.0f : 0.0f;
    while (true) {
      skip_ws(p, line_end);
      if (p >= line_end) break;
      uint64_t k;
      if (!parse_u64(p, line_end, k)) {
        *err_line = line;
        return -2;
      }
      uint64_t g = 0;
      if (p < line_end && *p == ':') {
        ++p;
        // "k:" with empty group -> slot 0, like Python's `if g:` guard
        if (p < line_end && *p != ' ' && *p != '\t' &&
            !parse_u64(p, line_end, g)) {
          *err_line = line;
          return -2;
        }
      }
      if (nnz >= max_nnz) return -1;
      keys[nnz] = k;
      vals[nnz] = 1.0f;
      slots[nnz] = g;
      ++nnz;
    }
    ++rows;
    row_splits[rows] = nnz;
    p = next_line;
    ++line;
  }
  *out_rows = rows;
  *out_nnz = nnz;
  return 0;
}

}  // extern "C"
