// High-throughput mpileup parser for sid-tpu (host runtime, C++17).
//
// Implements the exact grammar of the reference parser
// (the reference's pileup.cpp:13-167 — described, not copied): whitespace-run
// tokenization; read-bases column with './,' reference resolution, case =
// strand, '^x' skip, '+N'/'-N' indel skip, everything else dropped; Phred+33
// qualities decoded (byte-33) mod 256 then clamped to >= 1; base qualities
// paired positionally with surviving bases (missing -> 1).
//
// Parallelism: the buffer is split into newline-aligned byte ranges, one
// worker thread per range filling thread-local columnar buffers; ranges are
// concatenated in order afterwards, so output is byte-identical to a serial
// parse. This is the component the reference left as dead OpenMP code
// (call.cpp:22-50) — here it is the production path feeding device tensors.
//
// C ABI (ctypes): sidtpu_parse() returns an opaque result; accessors expose
// the columnar arrays; sidtpu_free() releases.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#if defined(__AVX2__) || defined(__AVX512BW__)
#include <immintrin.h>
#endif
#if defined(__AVX512BW__) && defined(__AVX512VBMI__) && defined(__AVX512VL__)
#define SIDTPU_AVX512 1
#endif

namespace {

// Allocator whose zero-arg construct is default-init (a no-op for scalar
// types): resize() on the per-read scratch vectors below adjusts the size
// WITHOUT zeroing bytes the SIMD/raw-pointer stores are about to overwrite.
// The value-initializing std::vector::resize was measurable store traffic on
// the terms-only quality parse — it re-zeroed n+64 bytes per token even when
// capacity already persisted (grow-then-shrink pattern).
template <typename T>
struct NoInitAlloc : std::allocator<T> {
  template <typename U>
  struct rebind {
    using other = NoInitAlloc<U>;
  };
  NoInitAlloc() = default;
  template <typename U>
  NoInitAlloc(const NoInitAlloc<U>&) {}
  template <typename U>
  void construct(U* p) {
    ::new (static_cast<void*>(p)) U;  // default-init, no zeroing
  }
  template <typename U, typename... Args>
  void construct(U* p, Args&&... args) {
    ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
  }
};
template <typename T>
using raw_vec = std::vector<T, NoInitAlloc<T>>;

struct ChromTable {
  // first-appearance-ordered chromosome names (few; linear scan is fine)
  std::vector<std::string> names;
  int32_t id_of(const char* s, size_t n) {
    for (size_t i = 0; i < names.size(); ++i) {
      if (names[i].size() == n && memcmp(names[i].data(), s, n) == 0)
        return static_cast<int32_t>(i);
    }
    names.emplace_back(s, n);
    return static_cast<int32_t>(names.size() - 1);
  }
};

struct Shard {
  std::vector<int32_t> chrom_id;
  std::vector<int32_t> pos;
  std::vector<uint8_t> ref_base;
  std::vector<uint16_t> counts;  // 4 per site
  // reads (CSR), only filled when want_reads; raw_vec: resize never zeroes
  std::vector<int32_t> read_len;  // per site
  raw_vec<int8_t> read_code;
  raw_vec<uint8_t> read_strand;
  raw_vec<uint8_t> read_bq;
  raw_vec<uint8_t> read_mq;
  // quality-method per-site terms (flags bit 0): log-likelihood sums and
  // top-2 alleles, computed inline while the line's reads are cache-hot
  std::vector<double> term_hom;
  std::vector<double> term_het;
  std::vector<int8_t> t_major;
  std::vector<int8_t> t_second;
  // errors: line numbers (1-based within the shard, fixed up at merge)
  std::vector<int64_t> err_line;
  std::vector<int32_t> err_code;  // 0 = malformed, 1 = missing mapping quals
  ChromTable chroms;
  int64_t lines_seen = 0;
};

// (256, 4) f64 table of per-read log terms by Phred value q, columns
// [ln(1-e), ln(e), ln(1-2e/3), ln(2e/3)], e = 10^(-q/10). The table is
// injected from Python (models/quality.quality_term_tables) so the inline
// accumulation is bitwise identical to the numpy reduceat path — libm pow
// and numpy's pow may differ by 1 ulp, the shared table cannot.
double g_qual_table_buf[1024];
const double* g_qual_table = nullptr;

inline bool is_sep(char c) { return c == ' ' || c == '\t'; }

struct Tok {
  const char* p;
  size_t n;
};

// split a line into whitespace-run-separated tokens; returns count
inline int tokenize(const char* s, const char* end, Tok* toks, int max_toks) {
  int k = 0;
  const char* p = s;
  while (p < end && k < max_toks) {
    while (p < end && is_sep(*p)) ++p;
    const char* q = p;
    while (q < end && !is_sep(*q)) ++q;
    if (q > p) {
      toks[k].p = p;
      toks[k].n = static_cast<size_t>(q - p);
      ++k;
    }
    p = q;
  }
  return k;
}

#if defined(__AVX2__)
// SIMD tokenizer: 32-byte separator bitmasks (cmpeq ' '/'\t' + movemask),
// token boundaries extracted with tzcnt over the mask bits. Stops as soon
// as max_toks tokens are delimited, so counts-only parsing never touches
// the quality columns' bytes. Falls back to the scalar loop when the
// 32-byte overread would cross the parse buffer's end.
inline int tokenize_avx2(const char* s, const char* line_end,
                         const char* hard_end, Tok* toks, int max_toks) {
  if (line_end + 32 > hard_end)
    return tokenize(s, line_end, toks, max_toks);
  const __m256i vsp = _mm256_set1_epi8(' ');
  const __m256i vtb = _mm256_set1_epi8('\t');
  const size_t len = static_cast<size_t>(line_end - s);
  int k = 0;
  size_t tok_start = 0;
  bool in_tok = false;
  for (size_t i = 0; i < len; i += 32) {
    const __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s + i));
    uint32_t sep = static_cast<uint32_t>(_mm256_movemask_epi8(
        _mm256_or_si256(_mm256_cmpeq_epi8(v, vsp), _mm256_cmpeq_epi8(v, vtb))));
    if (len - i < 32)  // pad bits beyond the line as separators
      sep |= ~((1u << (len - i)) - 1u);
    uint32_t rem = 0xFFFFFFFFu;  // bits of this chunk not yet consumed
    for (;;) {
      if (!in_tok) {
        const uint32_t cand = ~sep & rem;
        if (cand == 0) break;  // rest of chunk is separators
        const uint32_t pos = static_cast<uint32_t>(__builtin_ctz(cand));
        tok_start = i + pos;
        in_tok = true;
        rem = static_cast<uint32_t>(0xFFFFFFFFull << (pos + 1));
      } else {
        const uint32_t cand = sep & rem;
        if (cand == 0) break;  // token continues into the next chunk
        const uint32_t pos = static_cast<uint32_t>(__builtin_ctz(cand));
        toks[k].p = s + tok_start;
        toks[k].n = i + pos - tok_start;
        in_tok = false;
        if (++k == max_toks) return k;
        rem = static_cast<uint32_t>(0xFFFFFFFFull << (pos + 1));
      }
    }
  }
  if (in_tok && k < max_toks) {  // line length a multiple of 32: close token
    toks[k].p = s + tok_start;
    toks[k].n = len - tok_start;
    ++k;
  }
  return k;
}
#endif  // __AVX2__

#if defined(SIDTPU_AVX512)
// AVX-512 tokenizer: 64-byte chunks, separator bitmasks straight from
// k-registers (cmpeq_epi8_mask), token boundaries via tzcnt over 64-bit
// masks. Masked loads (maskz_loadu) never fault on the masked-out tail, so
// unlike the AVX2 variant this needs no hard_end overread guard. Masked-out
// lanes read as 0 (not a separator) and are force-marked as separators via
// ~kmask, matching the AVX2 pad-bits-as-separators convention.
inline int tokenize_avx512(const char* s, const char* line_end, Tok* toks,
                           int max_toks) {
  const size_t len = static_cast<size_t>(line_end - s);
  int k = 0;
  size_t tok_start = 0;
  bool in_tok = false;
  const __m512i vsp = _mm512_set1_epi8(' ');
  const __m512i vtb = _mm512_set1_epi8('\t');
  for (size_t i = 0; i < len; i += 64) {
    const size_t rem_bytes = len - i;
    const __mmask64 km =
        rem_bytes >= 64 ? ~0ull : ((1ull << rem_bytes) - 1ull);
    const __m512i v = _mm512_maskz_loadu_epi8(km, s + i);
    uint64_t sep = _mm512_cmpeq_epi8_mask(v, vsp) |
                   _mm512_cmpeq_epi8_mask(v, vtb) |
                   ~static_cast<uint64_t>(km);
    uint64_t rem = ~0ull;  // bits of this chunk not yet consumed
    for (;;) {
      if (!in_tok) {
        const uint64_t cand = ~sep & rem;
        if (cand == 0) break;  // rest of chunk is separators
        const unsigned pos = static_cast<unsigned>(__builtin_ctzll(cand));
        tok_start = i + pos;
        in_tok = true;
        rem = pos >= 63 ? 0 : (~0ull << (pos + 1));
      } else {
        const uint64_t cand = sep & rem;
        if (cand == 0) break;  // token continues into the next chunk
        const unsigned pos = static_cast<unsigned>(__builtin_ctzll(cand));
        toks[k].p = s + tok_start;
        toks[k].n = i + pos - tok_start;
        in_tok = false;
        if (++k == max_toks) return k;
        rem = pos >= 63 ? 0 : (~0ull << (pos + 1));
      }
    }
  }
  if (in_tok && k < max_toks) {  // line length a multiple of 64: close token
    toks[k].p = s + tok_start;
    toks[k].n = len - tok_start;
    ++k;
  }
  return k;
}
#endif  // SIDTPU_AVX512

inline int32_t parse_atoi(const char* p, size_t n) {
  size_t i = 0;
  while (i < n && (p[i] == ' ' || (p[i] >= '\t' && p[i] <= '\r'))) ++i;
  long sign = 1;
  if (i < n && (p[i] == '+' || p[i] == '-')) {
    if (p[i] == '-') sign = -1;
    ++i;
  }
  long v = 0;
  while (i < n && p[i] >= '0' && p[i] <= '9') {
    v = v * 10 + (p[i] - '0');
    ++i;
  }
  return static_cast<int32_t>(sign * v);
}

// base byte -> code (0..3) and strand; -1 if not a base
inline int base_code(uint8_t b, int* strand) {
  switch (b) {
    case 'a': *strand = 0; return 0;
    case 'A': *strand = 1; return 0;
    case 'c': *strand = 0; return 1;
    case 'C': *strand = 1; return 1;
    case 'g': *strand = 0; return 2;
    case 'G': *strand = 1; return 2;
    case 't': *strand = 0; return 3;
    case 'T': *strand = 1; return 3;
    default: return -1;
  }
}

inline uint8_t to_upper_ascii(uint8_t c) {
  return (c >= 'a' && c <= 'z') ? static_cast<uint8_t>(c - 32) : c;
}
inline uint8_t to_lower_ascii(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<uint8_t>(c + 32) : c;
}

// Branchless counting tables: kCountTables[ref][byte] -> 0..3 (A,C,G,T) or
// 4 (dropped). One table per possible reference byte so './,' resolve with
// no branches. Valid only for tokens without '^'/'+'/'-' escapes (pre-scan).
struct CountTables {
  uint8_t t[256][256];
  CountTables() {
    for (int ref = 0; ref < 256; ++ref) {
      for (int b = 0; b < 256; ++b) {
        int strand;
        int code = base_code(static_cast<uint8_t>(b), &strand);
        t[ref][b] = code >= 0 ? static_cast<uint8_t>(code) : 4;
      }
      int strand;
      uint8_t up = to_upper_ascii(static_cast<uint8_t>(ref));
      uint8_t lo = to_lower_ascii(static_cast<uint8_t>(ref));
      int cu = base_code(up, &strand);
      int cl = base_code(lo, &strand);
      t[ref]['.'] = cu >= 0 ? static_cast<uint8_t>(cu) : 4;
      t[ref][','] = cl >= 0 ? static_cast<uint8_t>(cl) : 4;
    }
  }
};
const CountTables kCountTables;

// Per-reference-byte full classification for the read-materializing path:
// bits 0-1 code, bit 2 strand, bit 3 is-base, bit 4 '^' escape, bit 5
// '+'/'-' indel escape ('.'/',' pre-resolved through toupper/tolower of the
// reference, exactly the spec's substitute-then-classify order).
struct FullTables {
  uint8_t t[256][256];
  FullTables() {
    for (int ref = 0; ref < 256; ++ref) {
      uint8_t up = to_upper_ascii(static_cast<uint8_t>(ref));
      uint8_t lo = to_lower_ascii(static_cast<uint8_t>(ref));
      for (int b = 0; b < 256; ++b) {
        uint8_t eff = static_cast<uint8_t>(b);
        if (eff == '.') eff = up;
        else if (eff == ',') eff = lo;
        int strand;
        int code = base_code(eff, &strand);
        uint8_t v = 0;
        if (code >= 0) {
          v = static_cast<uint8_t>(code | (strand << 2) | 8);
        } else if (eff == '^') {
          v = 16;
        } else if (eff == '+' || eff == '-') {
          v = 32;
        }
        t[ref][b] = v;
      }
    }
  }
};
const FullTables kFullTables;

// counts-only fast path: no escapes possible in the token
inline void count_bases_fast(const char* s, size_t n, uint8_t ref,
                             uint16_t counts[4]) {
  const uint8_t* tbl = kCountTables.t[ref];
  uint32_t cnt[5] = {0, 0, 0, 0, 0};
  size_t i = 0;
  for (; i + 4 <= n; i += 4) {
    cnt[tbl[static_cast<uint8_t>(s[i])]]++;
    cnt[tbl[static_cast<uint8_t>(s[i + 1])]]++;
    cnt[tbl[static_cast<uint8_t>(s[i + 2])]]++;
    cnt[tbl[static_cast<uint8_t>(s[i + 3])]]++;
  }
  for (; i < n; ++i) cnt[tbl[static_cast<uint8_t>(s[i])]]++;
  for (int k = 0; k < 4; ++k)
    counts[k] = static_cast<uint16_t>(counts[k] + cnt[k]);
}

#if defined(__AVX2__)
// SIMD counts-only pass: one sweep classifies 32 bytes at a time with
// compare+movemask+popcount against the 8 base letters plus '.'/',' and
// simultaneously screens for '^'/'+'/'-' escapes (returns false so the
// caller re-parses with the scalar grammar path — escapes change counting
// semantics, pileup.cpp:125-147). The final partial chunk is handled with a
// validity mask; requires the 32-byte overread to stay inside the parse
// buffer (hard_end), which holds for every token except ones near the very
// end of the buffer.
inline bool count_bases_avx2(const char* s, size_t n, const char* hard_end,
                             uint8_t ref, uint16_t counts[4]) {
  if (s + ((n + 31) & ~static_cast<size_t>(31)) > hard_end) return false;
  const __m256i tA = _mm256_set1_epi8('A'), ta = _mm256_set1_epi8('a');
  const __m256i tC = _mm256_set1_epi8('C'), tc = _mm256_set1_epi8('c');
  const __m256i tG = _mm256_set1_epi8('G'), tg = _mm256_set1_epi8('g');
  const __m256i tT = _mm256_set1_epi8('T'), tt = _mm256_set1_epi8('t');
  const __m256i tdot = _mm256_set1_epi8('.'), tcom = _mm256_set1_epi8(',');
  const __m256i thead = _mm256_set1_epi8('^');
  const __m256i tplus = _mm256_set1_epi8('+'), tminus = _mm256_set1_epi8('-');
  uint32_t acc[10] = {0};
  for (size_t i = 0; i < n; i += 32) {
    const __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(s + i));
    const uint32_t valid =
        (n - i >= 32) ? 0xFFFFFFFFu
                      : ((1u << (n - i)) - 1u);
    const __m256i esc = _mm256_or_si256(
        _mm256_cmpeq_epi8(v, thead),
        _mm256_or_si256(_mm256_cmpeq_epi8(v, tplus),
                        _mm256_cmpeq_epi8(v, tminus)));
    if (static_cast<uint32_t>(_mm256_movemask_epi8(esc)) & valid) return false;
    acc[0] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tA))) & valid));
    acc[1] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tC))) & valid));
    acc[2] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tG))) & valid));
    acc[3] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tT))) & valid));
    acc[4] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, ta))) & valid));
    acc[5] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tc))) & valid));
    acc[6] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tg))) & valid));
    acc[7] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tt))) & valid));
    acc[8] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tdot))) & valid));
    acc[9] += static_cast<uint32_t>(__builtin_popcount(
        static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, tcom))) & valid));
  }
  uint32_t cnt[5] = {acc[0] + acc[4], acc[1] + acc[5], acc[2] + acc[6],
                     acc[3] + acc[7], 0};
  cnt[kCountTables.t[ref]['.']] += acc[8];  // '.' -> toupper(ref) code or 4
  cnt[kCountTables.t[ref][',']] += acc[9];  // ',' -> tolower(ref) code or 4
  for (int k = 0; k < 4; ++k)
    counts[k] = static_cast<uint16_t>(counts[k] + cnt[k]);
  return true;
}
#endif  // __AVX2__

#if defined(SIDTPU_AVX512)
// Per-reference 128-entry class tables for the AVX-512 counts pass: one
// vpermt2b lookup replaces the AVX2 variant's ten per-letter compares.
// Classes: 0-3 = A/C/G/T count bucket (after the spec's './,' substitution
// through the reference byte), 4 = dropped, 5 = '^'/'+'/'-' escape (caller
// falls back to the grammar path, pileup.cpp:125-147 semantics). vpermt2b
// indexes with the low 7 bits only, so bytes >= 128 are screened first with
// vpmovb2m (they classify as dropped in the scalar tables; here they force
// the scalar fallback, which is exact).
struct ClassTables128 {
  alignas(64) uint8_t t[256][128];
  ClassTables128() {
    for (int ref = 0; ref < 256; ++ref)
      for (int b = 0; b < 128; ++b)
        t[ref][b] = (b == '^' || b == '+' || b == '-')
                        ? 5
                        : kCountTables.t[ref][b];
  }
};
const ClassTables128 kClassTables128;

inline bool count_bases_avx512(const char* s, size_t n, uint8_t ref,
                               uint16_t counts[4]) {
  const uint8_t* row = kClassTables128.t[ref];
  const __m512i tab_lo =
      _mm512_load_si512(reinterpret_cast<const void*>(row));
  const __m512i tab_hi =
      _mm512_load_si512(reinterpret_cast<const void*>(row + 64));
  const __m512i k1 = _mm512_set1_epi8(1), k2 = _mm512_set1_epi8(2);
  const __m512i k3 = _mm512_set1_epi8(3), k5 = _mm512_set1_epi8(5);
  const __m512i k0 = _mm512_setzero_si512();
  uint64_t acc[4] = {0, 0, 0, 0};
  for (size_t i = 0; i < n; i += 64) {
    const size_t rem = n - i;
    const __mmask64 km = rem >= 64 ? ~0ull : ((1ull << rem) - 1ull);
    const __m512i v = _mm512_maskz_loadu_epi8(km, s + i);
    if (_mm512_movepi8_mask(v)) return false;  // byte >= 128: scalar path
    const __m512i cls = _mm512_permutex2var_epi8(tab_lo, v, tab_hi);
    if (_mm512_mask_cmpeq_epi8_mask(km, cls, k5)) return false;  // escape
    acc[0] += static_cast<uint64_t>(
        __builtin_popcountll(_mm512_mask_cmpeq_epi8_mask(km, cls, k0)));
    acc[1] += static_cast<uint64_t>(
        __builtin_popcountll(_mm512_mask_cmpeq_epi8_mask(km, cls, k1)));
    acc[2] += static_cast<uint64_t>(
        __builtin_popcountll(_mm512_mask_cmpeq_epi8_mask(km, cls, k2)));
    acc[3] += static_cast<uint64_t>(
        __builtin_popcountll(_mm512_mask_cmpeq_epi8_mask(km, cls, k3)));
  }
  for (int k = 0; k < 4; ++k)
    counts[k] = static_cast<uint16_t>(counts[k] + acc[k]);
  return true;
}

#if defined(__AVX512VBMI2__)
// Terms-only read-code extraction (the quality method's production parse):
// classify 64 bytes with the vpermt2b class table, screen escapes, and
// compress the surviving base codes IN ORDER (vpcompressb) straight into the
// read_code scratch — replacing the per-byte scalar loop. Exact for tokens
// without '^'/'+'/'-' after './,' substitution (same precondition as the
// counts-only fast path; escapes or bytes >= 128 restore the scalar grammar
// path, pileup.cpp:125-147). Order preservation matters: qualities pair
// positionally with surviving bases and the term sums are sequential.
inline bool parse_read_codes_avx512(const Tok& t, uint8_t ref,
                                    uint16_t counts[4], Shard& out) {
  const char* s = t.p;
  const size_t n = t.n;
  const uint8_t* row = kClassTables128.t[ref];
  const __m512i tab_lo =
      _mm512_load_si512(reinterpret_cast<const void*>(row));
  const __m512i tab_hi =
      _mm512_load_si512(reinterpret_cast<const void*>(row + 64));
  const __m512i k1 = _mm512_set1_epi8(1), k2 = _mm512_set1_epi8(2);
  const __m512i k3 = _mm512_set1_epi8(3), k4 = _mm512_set1_epi8(4);
  const __m512i k5 = _mm512_set1_epi8(5);
  const __m512i k0 = _mm512_setzero_si512();
  const size_t base = out.read_code.size();
  out.read_code.resize(base + n + 64);  // headroom for full-width stores
  int8_t* w = out.read_code.data() + base;
  uint64_t acc[4] = {0, 0, 0, 0};
  size_t nk = 0;
  for (size_t i = 0; i < n; i += 64) {
    const size_t rem = n - i;
    const __mmask64 km = rem >= 64 ? ~0ull : ((1ull << rem) - 1ull);
    const __m512i v = _mm512_maskz_loadu_epi8(km, s + i);
    const __m512i cls = _mm512_permutex2var_epi8(tab_lo, v, tab_hi);
    if (_mm512_movepi8_mask(v) ||
        _mm512_mask_cmpeq_epi8_mask(km, cls, k5)) {
      out.read_code.resize(base);
      return false;  // byte >= 128 or escape: scalar grammar path
    }
    const __mmask64 keep = _mm512_mask_cmplt_epi8_mask(km, cls, k4);
    acc[0] += static_cast<uint64_t>(
        __builtin_popcountll(_mm512_mask_cmpeq_epi8_mask(km, cls, k0)));
    acc[1] += static_cast<uint64_t>(
        __builtin_popcountll(_mm512_mask_cmpeq_epi8_mask(km, cls, k1)));
    acc[2] += static_cast<uint64_t>(
        __builtin_popcountll(_mm512_mask_cmpeq_epi8_mask(km, cls, k2)));
    acc[3] += static_cast<uint64_t>(
        __builtin_popcountll(_mm512_mask_cmpeq_epi8_mask(km, cls, k3)));
    // compress to a register then one unmasked store: vpcompressb's
    // direct-to-memory form takes a byte-granular store penalty
    _mm512_storeu_si512(reinterpret_cast<void*>(w + nk),
                        _mm512_maskz_compress_epi8(keep, cls));
    nk += static_cast<size_t>(__builtin_popcountll(keep));
  }
  out.read_code.resize(base + nk);
  for (int k = 0; k < 4; ++k)
    counts[k] = static_cast<uint16_t>(counts[k] + acc[k]);
  return true;
}
#endif  // __AVX512VBMI2__

#endif  // SIDTPU_AVX512

// parse one read-bases token; appends codes/strands, fills counts[4].
// Single packed-table lookup per byte ('.'/',' resolution, code, strand,
// escape class all folded into kFullTables); when materializing reads the
// outputs are written through raw pointers into pre-grown vectors — the
// per-byte push_back capacity checks were the with-reads path's bottleneck.
inline void parse_read_bases(const Tok& t, uint8_t ref, uint16_t counts[4],
                             bool want_reads, bool want_strand, Shard& out) {
  const char* s = t.p;
  const size_t n = t.n;
  const uint8_t* tbl = kFullTables.t[ref];
  int8_t* code_w = nullptr;
  uint8_t* strand_w = nullptr;
  size_t w = 0;
  if (want_reads) {
    w = out.read_code.size();
    out.read_code.resize(w + n);  // upper bound; shrunk to fit below
    code_w = out.read_code.data();
    if (want_strand) {
      out.read_strand.resize(w + n);
      strand_w = out.read_strand.data();
    }
  }
  for (size_t i = 0; i < n; ++i) {
    const uint8_t c = tbl[static_cast<uint8_t>(s[i])];
    if (c & 8) {  // ACGT (or resolved './,')
      counts[c & 3] = static_cast<uint16_t>(counts[c & 3] + 1);
      if (want_reads) {
        code_w[w] = static_cast<int8_t>(c & 3);
        if (want_strand) strand_w[w] = (c >> 2) & 1;
        ++w;
      }
    } else if (c & 16) {  // '^' skips the following mapping-quality char
      ++i;
    } else if (c & 32) {  // '+'/'-' indel
      if (i + 1 < n && s[i + 1] >= '0' && s[i + 1] <= '9') {
        size_t j = i + 1;
        uint64_t length = 0;
        while (j < n && s[j] >= '0' && s[j] <= '9') {
          length = length * 10 + static_cast<uint64_t>(s[j] - '0');
          if (length > (1ull << 40)) length = (1ull << 40);  // clamp, see below
          ++j;
        }
        // skip the digits and that many inserted/deleted bases
        uint64_t next = static_cast<uint64_t>(j) + length;
        if (next >= n) break;
        i = static_cast<size_t>(next) - 1;  // loop ++i lands on next
      }
      // '+'/'-' not followed by a digit is ignored
    }
    // everything else ('$', '*', 'N', '<', '>', ...) dropped
  }
  if (want_reads) {
    out.read_code.resize(w);
    if (want_strand) out.read_strand.resize(w);
  }
}

// top-2 alleles with the count*4+index tie-break
// (models/common.major_allele_indices_np, call.cpp:52-60)
inline void top2_alleles(const uint16_t counts[4], int& major, int& second) {
  int32_t sc[4];
  for (int k = 0; k < 4; ++k)
    sc[k] = static_cast<int32_t>(counts[k]) * 4 + k;
  major = 0;
  for (int k = 1; k < 4; ++k)
    if (sc[k] > sc[major]) major = k;
  second = major == 0 ? 1 : 0;
  for (int k = 0; k < 4; ++k)
    if (k != major && sc[k] > sc[second]) second = k;
}

// (quality decoding — (byte-33) mod 256 clamped to >= 1, pileup.cpp:155-167
// — is inlined at the use site in parse_range: only the first nb bytes of
// each token are needed, paired positionally with the surviving bases)

void parse_range(const char* data, const char* end, const char* hard_end,
                 bool want_bq, bool want_mq, bool strict, bool want_terms,
                 bool drop_reads, Shard& out) {
  const bool want_reads = want_bq || want_mq;
  Tok toks[8];
  const char* line = data;
  int64_t line_no = 0;
  // chrom pos ref cov bases [bq] [mq]; the bq column is positional even
  // when unparsed (the reference always consumes it). Tokenization stops at
  // `needed` tokens, so counts-only parsing never scans the quality columns.
  const int needed = want_mq ? 7 : (want_bq ? 6 : 5);
  while (line < end) {
    const char* nl = static_cast<const char*>(
        memchr(line, '\n', static_cast<size_t>(end - line)));
    const char* line_end = nl ? nl : end;
    ++line_no;
    if (line_end > line) {  // skip empty lines
#if defined(SIDTPU_AVX512)
      int nt = tokenize_avx512(line, line_end, toks, needed);
#elif defined(__AVX2__)
      int nt = tokenize_avx2(line, line_end, hard_end, toks, needed);
#else
      int nt = tokenize(line, line_end, toks, needed);
#endif
      bool bad_ref = nt >= 3 && toks[2].n != 1;
      if (nt < needed || bad_ref) {
        out.err_line.push_back(line_no);
        // MALFORMED_OR_MISSING (code 1) whenever the mapping-quality column
        // is the missing one: with want_mq the spec's bq check fires first
        // only when bq itself is parsed (pileup_py.parse_pileup_line)
        bool missing_mq = want_mq && !bad_ref &&
            (nt == 6 || (nt == 5 && !want_bq));
        out.err_code.push_back(missing_mq ? 1 : 0);
        if (strict) return;
      } else {
        int32_t cid = out.chroms.id_of(toks[0].p, toks[0].n);
        out.chrom_id.push_back(cid);
        out.pos.push_back(parse_atoi(toks[1].p, toks[1].n));
        uint8_t ref = static_cast<uint8_t>(toks[2].p[0]);
        out.ref_base.push_back(ref);
        uint16_t counts[4] = {0, 0, 0, 0};
        size_t reads_before = out.read_code.size();
        // the fast paths are grammar-exact only when no escape characters
        // can appear after './,' substitution: a reference byte of
        // '^'/'+'/'-' would turn substituted dots into escapes
        // (pileup.cpp:78-83 then :125-147), so those lines take the scalar
        // grammar path
        bool counted = false;
        bool ref_ok = ref != '^' && ref != '+' && ref != '-';
        if (!want_reads && ref_ok) {
#if defined(SIDTPU_AVX512)
          counted = count_bases_avx512(toks[4].p, toks[4].n, ref, counts);
#elif defined(__AVX2__)
          counted = count_bases_avx2(toks[4].p, toks[4].n, hard_end, ref, counts);
#endif
          if (!counted &&
              memchr(toks[4].p, '^', toks[4].n) == nullptr &&
              memchr(toks[4].p, '+', toks[4].n) == nullptr &&
              memchr(toks[4].p, '-', toks[4].n) == nullptr) {
            count_bases_fast(toks[4].p, toks[4].n, ref, counts);
            counted = true;
          }
        }
#if defined(SIDTPU_AVX512) && defined(__AVX512VBMI2__)
        if (!counted && want_reads && drop_reads && ref_ok) {
          // terms-only mode never needs strands, so the compressed-code
          // extraction covers it whenever the token is escape-free
          counted = parse_read_codes_avx512(toks[4], ref, counts, out);
        }
#endif
        if (!counted) {
          parse_read_bases(toks[4], ref, counts, want_reads, !drop_reads, out);
        }
        for (int k = 0; k < 4; ++k) out.counts.push_back(counts[k]);
        if (want_reads) {
          size_t nb = out.read_code.size() - reads_before;
          if (!drop_reads) out.read_len.push_back(static_cast<int32_t>(nb));
          // qualities pair positionally with the surviving bases (spec:
          // the j-th surviving base takes the j-th raw quality char), so
          // only the first nb bytes of each quality token are decoded,
          // missing chars filling with 1
          if (drop_reads && want_bq && want_mq && toks[5].n >= nb &&
              toks[6].n >= nb) {
            // terms-only fast path (the quality method's production mode):
            // decode + min + table term accumulation fused into one pass —
            // per-read bq/mq are never materialized. Accumulation stays
            // sequential in read order, so the sums are bitwise identical
            // to the general path below (call.cpp:325-342's order).
            int major, second;
            top2_alleles(counts, major, second);
            double lh = 0.0, lht = 0.0;
            const int8_t* code = out.read_code.data() + reads_before;
            const char* bqs = toks[5].p;
            const char* mqs = toks[6].p;
            for (size_t j = 0; j < nb; ++j) {
              uint8_t b = static_cast<uint8_t>(bqs[j] - 33);
              b = b < 1 ? 1 : b;
              uint8_t m = static_cast<uint8_t>(mqs[j] - 33);
              m = m < 1 ? 1 : m;
              const unsigned q = b < m ? b : m;
              const double* row = g_qual_table + 4 * q;
              const int cj = code[j];
              lh += (cj == major) ? row[0] : row[1];
              lht += (cj == major || cj == second) ? row[2] : row[3];
            }
            out.term_hom.push_back(lh);
            out.term_het.push_back(lht);
            out.t_major.push_back(static_cast<int8_t>(major));
            out.t_second.push_back(static_cast<int8_t>(second));
            // read_code is per-line scratch here (shrinking resize never
            // deallocates, so it stays L1-warm)
            out.read_code.resize(reads_before);
          } else {
            out.read_bq.resize(reads_before + nb);
            out.read_mq.resize(reads_before + nb);
            uint8_t* bq_w = out.read_bq.data() + reads_before;
            uint8_t* mq_w = out.read_mq.data() + reads_before;
            size_t nbq = want_bq ? (toks[5].n < nb ? toks[5].n : nb) : 0;
            for (size_t j = 0; j < nbq; ++j) {
              uint8_t q = static_cast<uint8_t>(toks[5].p[j] - 33);
              bq_w[j] = q < 1 ? 1 : q;
            }
            for (size_t j = nbq; j < nb; ++j) bq_w[j] = 1;
            size_t nmq = want_mq ? (toks[6].n < nb ? toks[6].n : nb) : 0;
            for (size_t j = 0; j < nmq; ++j) {
              uint8_t q = static_cast<uint8_t>(toks[6].p[j] - 33);
              mq_w[j] = q < 1 ? 1 : q;
            }
            for (size_t j = nmq; j < nb; ++j) mq_w[j] = 1;
            if (want_terms) {
              int major, second;
              top2_alleles(counts, major, second);
              // sequential f64 accumulation in read order == the numpy
              // np.add.reduceat segment sums, bitwise (call.cpp:325-342)
              double lh = 0.0, lht = 0.0;
              const int8_t* code = out.read_code.data() + reads_before;
              for (size_t j = 0; j < nb; ++j) {
                const unsigned q = bq_w[j] < mq_w[j] ? bq_w[j] : mq_w[j];
                const double* row = g_qual_table + 4 * q;
                const int cj = code[j];
                lh += (cj == major) ? row[0] : row[1];
                lht += (cj == major || cj == second) ? row[2] : row[3];
              }
              out.term_hom.push_back(lh);
              out.term_het.push_back(lht);
              out.t_major.push_back(static_cast<int8_t>(major));
              out.t_second.push_back(static_cast<int8_t>(second));
              if (drop_reads) {
                out.read_code.resize(reads_before);
                out.read_strand.resize(reads_before);
                out.read_bq.resize(reads_before);
                out.read_mq.resize(reads_before);
              }
            }
          }
        }
      }
    }
    if (!nl) break;
    line = nl + 1;
  }
  out.lines_seen = line_no;
}

struct Result {
  std::vector<int32_t> chrom_id;
  std::vector<int32_t> pos;
  std::vector<uint8_t> ref_base;
  std::vector<uint16_t> counts;
  std::vector<int64_t> read_offsets;
  std::vector<int8_t> read_code;
  std::vector<uint8_t> read_strand;
  std::vector<uint8_t> read_bq;
  std::vector<uint8_t> read_mq;
  std::vector<double> term_hom;
  std::vector<double> term_het;
  std::vector<int8_t> t_major;
  std::vector<int8_t> t_second;
  std::vector<int64_t> err_line;
  std::vector<int32_t> err_code;
  std::string chrom_blob;            // '\n'-joined names
  int64_t num_sites = 0;
};

template <typename T, typename SrcVec>
void concat_into(std::vector<T>& dst, std::vector<SrcVec*> srcs) {
  size_t total = 0;
  for (auto* s : srcs) total += s->size();
  dst.reserve(total);
  for (auto* s : srcs) dst.insert(dst.end(), s->begin(), s->end());
}

}  // namespace

extern "C" {

void* sidtpu_parse_ex(const char* data, int64_t len, int want_bq, int want_mq,
                      int strict, int n_threads, int flags) {
  // flags bit 0: compute per-site quality terms inline (requires both
  // quality columns and a prior sidtpu_set_quality_table call); bit 1:
  // terms-only — don't materialize the per-read arrays (the quality device
  // path needs only the terms)
  const bool want_terms =
      (flags & 1) && g_qual_table != nullptr && want_bq && want_mq;
  const bool drop_reads = want_terms && (flags & 2);
  auto* res = new Result();
  const char* end = data + len;
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 4);
  if (nt > 64) nt = 64;
  // newline-aligned range boundaries
  std::vector<const char*> bounds;
  bounds.push_back(data);
  for (int t = 1; t < nt; ++t) {
    const char* guess = data + (len * t) / nt;
    if (guess <= bounds.back()) continue;
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', static_cast<size_t>(end - guess)));
    const char* b = nl ? nl + 1 : end;
    if (b > bounds.back() && b < end) bounds.push_back(b);
  }
  bounds.push_back(end);
  size_t nshard = bounds.size() - 1;

  std::vector<Shard> shards(nshard);
  std::vector<std::thread> threads;
  for (size_t s = 0; s < nshard; ++s) {
    threads.emplace_back([&, s]() {
      parse_range(bounds[s], bounds[s + 1], end, want_bq != 0, want_mq != 0,
                  strict != 0, want_terms, drop_reads, shards[s]);
    });
  }
  for (auto& t : threads) t.join();

  // merge: remap chromosome ids to global first-appearance order
  ChromTable global;
  int64_t line_base = 0;
  for (size_t s = 0; s < nshard; ++s) {
    Shard& sh = shards[s];
    std::vector<int32_t> remap(sh.chroms.names.size());
    for (size_t i = 0; i < sh.chroms.names.size(); ++i) {
      remap[i] = global.id_of(sh.chroms.names[i].data(), sh.chroms.names[i].size());
    }
    for (auto& c : sh.chrom_id) c = remap[c];
    for (auto& l : sh.err_line) l += line_base;
    line_base += sh.lines_seen;
  }
  {
    std::vector<std::vector<int32_t>*> v;
    for (auto& s : shards) v.push_back(&s.chrom_id);
    concat_into(res->chrom_id, v);
  }
  {
    std::vector<std::vector<int32_t>*> v;
    for (auto& s : shards) v.push_back(&s.pos);
    concat_into(res->pos, v);
  }
  {
    std::vector<std::vector<uint8_t>*> v;
    for (auto& s : shards) v.push_back(&s.ref_base);
    concat_into(res->ref_base, v);
  }
  {
    std::vector<std::vector<uint16_t>*> v;
    for (auto& s : shards) v.push_back(&s.counts);
    concat_into(res->counts, v);
  }
  if ((want_bq || want_mq) && !drop_reads) {
    res->read_offsets.reserve(res->pos.size() + 1);
    res->read_offsets.push_back(0);
    for (auto& s : shards) {
      for (int32_t l : s.read_len)
        res->read_offsets.push_back(res->read_offsets.back() + l);
    }
    std::vector<raw_vec<int8_t>*> vc;
    for (auto& s : shards) vc.push_back(&s.read_code);
    concat_into(res->read_code, vc);
    std::vector<raw_vec<uint8_t>*> vs;
    for (auto& s : shards) vs.push_back(&s.read_strand);
    concat_into(res->read_strand, vs);
    std::vector<raw_vec<uint8_t>*> vb;
    for (auto& s : shards) vb.push_back(&s.read_bq);
    concat_into(res->read_bq, vb);
    std::vector<raw_vec<uint8_t>*> vm;
    for (auto& s : shards) vm.push_back(&s.read_mq);
    concat_into(res->read_mq, vm);
  }
  if (want_terms) {
    std::vector<std::vector<double>*> vh, ve;
    std::vector<std::vector<int8_t>*> vmj, vsc;
    for (auto& s : shards) {
      vh.push_back(&s.term_hom);
      ve.push_back(&s.term_het);
      vmj.push_back(&s.t_major);
      vsc.push_back(&s.t_second);
    }
    concat_into(res->term_hom, vh);
    concat_into(res->term_het, ve);
    concat_into(res->t_major, vmj);
    concat_into(res->t_second, vsc);
  }
  {
    std::vector<std::vector<int64_t>*> v;
    for (auto& s : shards) v.push_back(&s.err_line);
    concat_into(res->err_line, v);
    std::vector<std::vector<int32_t>*> v2;
    for (auto& s : shards) v2.push_back(&s.err_code);
    concat_into(res->err_code, v2);
  }
  for (const auto& name : global.names) {
    uint32_t len = static_cast<uint32_t>(name.size());
    res->chrom_blob.append(reinterpret_cast<const char*>(&len), 4);
    res->chrom_blob += name;
  }
  res->num_sites = static_cast<int64_t>(res->pos.size());
  return res;
}

void* sidtpu_parse(const char* data, int64_t len, int want_bq, int want_mq,
                   int strict, int n_threads) {
  return sidtpu_parse_ex(data, len, want_bq, want_mq, strict, n_threads, 0);
}

void sidtpu_set_quality_table(const double* tab) {
  memcpy(g_qual_table_buf, tab, sizeof g_qual_table_buf);
  g_qual_table = g_qual_table_buf;
}

void sidtpu_free(void* r) { delete static_cast<Result*>(r); }

int64_t sidtpu_num_terms(void* r) {
  return static_cast<int64_t>(static_cast<Result*>(r)->term_hom.size());
}
const double* sidtpu_term_hom(void* r) { return static_cast<Result*>(r)->term_hom.data(); }
const double* sidtpu_term_het(void* r) { return static_cast<Result*>(r)->term_het.data(); }
const int8_t* sidtpu_term_major(void* r) { return static_cast<Result*>(r)->t_major.data(); }
const int8_t* sidtpu_term_second(void* r) { return static_cast<Result*>(r)->t_second.data(); }

int64_t sidtpu_num_sites(void* r) { return static_cast<Result*>(r)->num_sites; }
int64_t sidtpu_num_reads(void* r) {
  return static_cast<int64_t>(static_cast<Result*>(r)->read_code.size());
}
int64_t sidtpu_num_errors(void* r) {
  return static_cast<int64_t>(static_cast<Result*>(r)->err_line.size());
}
const int32_t* sidtpu_chrom_id(void* r) { return static_cast<Result*>(r)->chrom_id.data(); }
const int32_t* sidtpu_pos(void* r) { return static_cast<Result*>(r)->pos.data(); }
const uint8_t* sidtpu_ref_base(void* r) { return static_cast<Result*>(r)->ref_base.data(); }
const uint16_t* sidtpu_counts(void* r) { return static_cast<Result*>(r)->counts.data(); }
const int64_t* sidtpu_read_offsets(void* r) { return static_cast<Result*>(r)->read_offsets.data(); }
const int8_t* sidtpu_read_code(void* r) { return static_cast<Result*>(r)->read_code.data(); }
const uint8_t* sidtpu_read_strand(void* r) { return static_cast<Result*>(r)->read_strand.data(); }
const uint8_t* sidtpu_read_bq(void* r) { return static_cast<Result*>(r)->read_bq.data(); }
const uint8_t* sidtpu_read_mq(void* r) { return static_cast<Result*>(r)->read_mq.data(); }
const int64_t* sidtpu_err_line(void* r) { return static_cast<Result*>(r)->err_line.data(); }
const int32_t* sidtpu_err_code(void* r) { return static_cast<Result*>(r)->err_code.data(); }
const char* sidtpu_chrom_blob(void* r) { return static_cast<Result*>(r)->chrom_blob.data(); }
int64_t sidtpu_chrom_blob_len(void* r) {
  return static_cast<int64_t>(static_cast<Result*>(r)->chrom_blob.size());
}

}  // extern "C"

// ---------------------------------------------------------------------------

namespace {

// length-prefixed chromosome table: [u32 len][bytes]... (names may contain
// any byte, including NUL and newline)
std::vector<std::string> split_chrom_blob(const char* blob, int64_t blob_len) {
  std::vector<std::string> out;
  int64_t i = 0;
  while (i + 4 <= blob_len) {
    uint32_t len;
    memcpy(&len, blob + i, 4);
    i += 4;
    if (i + static_cast<int64_t>(len) > blob_len) break;
    out.emplace_back(blob + i, len);
    i += len;
  }
  return out;
}

}  // namespace

// CSV writer: formats output records exactly like the reference's ostream
// serializer (call.hpp:29-38) — glibc printf "%g" for the two confidence
// doubles (C++ default ostream precision 6), "hom"/"het" labels, genotype
// from the top-2 allele indices. Multithreaded over row ranges.

namespace {

const char kAlleles[] = "ACGT";

// ---------------------------------------------------------------------------
// Fast correctly-rounded %g (precision 6), Grisu-style.
//
// glibc's printf is the byte-parity standard for the confidence columns
// (call.hpp:33-36 prints with ostream defaults == %g). snprintf costs
// ~0.6 us/value on this host — the dominant cost of per-site serialization
// (the quality method emits 2M distinct doubles per 1M sites). This routine
// computes the correctly-rounded 6-significant-digit decimal with one
// 64x64->128 multiply against a round-to-nearest power-of-ten table
// (fmt_g_pow10.h, error <= 0.5 ulp of 2^-64), then formats %g's f/e style
// selection and trailing-zero stripping directly. Whenever the rounding
// decision falls within the accumulated error margin (<= 2 lsb; we use 8),
// it falls back to glibc snprintf, so the output is byte-identical to glibc
// for every input by construction — ambiguity resolves to the standard, and
// exact ties (round-half-even) always land in the fallback. Non-finite
// values also fall back ("inf"/"nan"/"-nan" conventions stay glibc's).

#include "fmt_g_pow10.h"

// round-to-nearest high 64 bits of a*b (error <= 0.5 lsb)
inline uint64_t mul_hi_round(uint64_t a, uint64_t b) {
  unsigned __int128 p = static_cast<unsigned __int128>(a) * b;
  return static_cast<uint64_t>((p + (static_cast<unsigned __int128>(1) << 63)) >> 64);
}

// fallback-rate observability: every snprintf escape from the fast path
// bumps this counter (relaxed atomic — fallbacks are rare by design, so the
// common path never touches it). Exposed via sidtpu_format_g_fallbacks().
std::atomic<uint64_t> g_fmt_fallbacks{0};

inline int fmt_fallback(double v, char* out) {
  g_fmt_fallbacks.fetch_add(1, std::memory_order_relaxed);
  return snprintf(out, 32, "%g", v);
}

// writes %g of v into out (>= 32 bytes), returns length
inline int format_g6(double v, char* out) {
  uint64_t bits;
  memcpy(&bits, &v, 8);
  bool neg = bits >> 63;
  bits &= ~(1ull << 63);
  if (bits == 0) {
    char* w = out;
    if (neg) *w++ = '-';
    *w++ = '0';
    return static_cast<int>(w - out);
  }
  if (bits >= 0x7ff0000000000000ull)  // inf/nan: glibc's spellings
    return fmt_fallback(v, out);

  // v = m * 2^e2 with m normalized to [2^63, 2^64)
  int e2 = static_cast<int>(bits >> 52);
  uint64_t m = bits & ((1ull << 52) - 1);
  if (e2 == 0) {
    e2 = -1074;  // subnormal
  } else {
    m |= 1ull << 52;
    e2 -= 1075;
  }
  int lz = __builtin_clzll(m);
  m <<= lz;
  e2 -= lz;

  double av = neg ? -v : v;
  // decimal exponent estimate; off-by-one near powers of ten is corrected
  // below by the digit-count branches
  int d = static_cast<int>(std::floor(std::log10(av)));
  for (int attempt = 0; attempt < 2; ++attempt) {
    int K = 5 - d;  // scale so v*10^K has ~6 integer digits
    if (K < kPow10KMin || K > kPow10KMax) return fmt_fallback(v, out);
    const auto& p = kPow10[K - kPow10KMin];
    uint64_t w64 = mul_hi_round(m, p.sig);
    int ew = e2 + p.exp + 64;  // v*10^K ~= w64 * 2^ew
    int s = -ew;
    if (s <= 4 || s >= 60) return fmt_fallback(v, out);
    uint64_t I = w64 >> s;
    uint64_t frac = w64 & ((1ull << s) - 1);
    // total error of w64 <= 1 lsb (0.5 table + 0.5 product rounding);
    // margin 8 is conservative and still astronomically rarely hit
    const uint64_t kMargin = 8;
    uint64_t D;
    int X;  // decimal exponent of the leading digit
    if (I >= 100000 && I < 1000000) {
      uint64_t half = 1ull << (s - 1);
      if (frac > half + kMargin) D = I + 1;
      else if (frac + kMargin < half) D = I;
      else return fmt_fallback(v, out);
      X = d;
    } else if (I >= 1000000 && I < 10000000) {
      // 7 integer digits: round at the tens place
      uint64_t rem = ((I % 10) << s) | frac;
      uint64_t half = 5ull << s;
      if (rem > half + kMargin) D = I / 10 + 1;
      else if (rem + kMargin < half) D = I / 10;
      else return fmt_fallback(v, out);
      X = d + 1;
    } else if (I >= 10000 && I < 100000 && attempt == 0) {
      --d;  // estimate was one high; rescale
      continue;
    } else {
      return fmt_fallback(v, out);
    }
    if (D == 1000000) {  // rounding carried into a new decade
      D = 100000;
      ++X;
    }

    char dig[6];
    for (int i = 5; i >= 0; --i) {
      dig[i] = static_cast<char>('0' + D % 10);
      D /= 10;
    }
    int nd = 6;
    while (nd > 1 && dig[nd - 1] == '0') --nd;

    char* o = out;
    if (neg) *o++ = '-';
    if (X < -4 || X >= 6) {  // e style
      *o++ = dig[0];
      if (nd > 1) {
        *o++ = '.';
        memcpy(o, dig + 1, static_cast<size_t>(nd - 1));
        o += nd - 1;
      }
      *o++ = 'e';
      int ax = X;
      if (ax < 0) {
        *o++ = '-';
        ax = -ax;
      } else {
        *o++ = '+';
      }
      if (ax >= 100) {
        *o++ = static_cast<char>('0' + ax / 100);
        ax %= 100;
      }
      *o++ = static_cast<char>('0' + ax / 10);
      *o++ = static_cast<char>('0' + ax % 10);
    } else if (X < 0) {  // 0.000ddd
      *o++ = '0';
      *o++ = '.';
      for (int i = 0; i < -X - 1; ++i) *o++ = '0';
      memcpy(o, dig, static_cast<size_t>(nd));
      o += nd;
    } else if (X >= nd - 1) {  // pure integer
      memcpy(o, dig, static_cast<size_t>(nd));
      o += nd;
      for (int i = 0; i < X - (nd - 1); ++i) *o++ = '0';
    } else {  // ddd.ddd
      memcpy(o, dig, static_cast<size_t>(X + 1));
      o += X + 1;
      *o++ = '.';
      memcpy(o, dig + X + 1, static_cast<size_t>(nd - X - 1));
      o += nd - X - 1;
    }
    return static_cast<int>(o - out);
  }
  return fmt_fallback(v, out);
}

// fast %g for the values the LRT emits constantly: the winning hypothesis's
// p-value is exactly erfc(0) = 1 and underflowed likelihoods give exactly 0,
// so ~half of all confidence fields skip formatting entirely. Everything
// else goes through format_g6 (glibc-%g-exact by construction; -0.0 prints
// "-0" there like glibc).
inline void append_g(double v, std::string& out, char* num) {
  if (v == 1.0) {
    out += '1';
    return;
  }
  if (v == 0.0) {
    if (std::signbit(v)) out += '-';
    out += '0';
    return;
  }
  int len = format_g6(v, num);
  out.append(num, static_cast<size_t>(len));
}

// raw-pointer variant for preallocated row buffers
inline char* write_g(double v, char* w) {
  if (v == 1.0) {
    *w++ = '1';
    return w;
  }
  if (v == 0.0) {
    if (std::signbit(v)) *w++ = '-';
    *w++ = '0';
    return w;
  }
  return w + format_g6(v, w);
}

inline char* write_i32(int32_t v, char* w) {
  if (v < 0) *w++ = '-';
  uint32_t u = v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
  char tmp[12];
  int k = 0;
  do {
    tmp[k++] = static_cast<char>('0' + u % 10);
    u /= 10;
  } while (u);
  while (k) *w++ = tmp[--k];
  return w;
}

void write_rows(const std::vector<std::string>& chroms, const int32_t* chrom_id,
                const int32_t* pos, const uint8_t* is_het, const int32_t* major,
                const int32_t* second, const double* conf_hom,
                const double* conf_het, const char* conf_type, int64_t begin,
                int64_t end, std::string& out) {
  // raw-pointer assembly into a worst-case-sized buffer (like the indexed
  // writer): one resize up front, no per-append capacity checks
  size_t max_chrom = 1;
  for (auto& c : chroms) max_chrom = c.size() > max_chrom ? c.size() : max_chrom;
  const size_t type_len = strlen(conf_type);
  // chrom, ',', pos(11), ",het,"(5), gt(2), ',', %g(32), ',', %g(32), ',',
  // conf_type, '\n' — 32 bytes per %g field matches format_g6's documented
  // contract (incl. the snprintf fallback's size argument + NUL)
  const size_t row_cap = max_chrom + 1 + 11 + 5 + 2 + 1 + 32 + 1 + 32 + 1 +
                         type_len + 1;
  out.resize(static_cast<size_t>(end - begin) * row_cap);
  char* base = &out[0];
  char* w = base;
  for (int64_t i = begin; i < end; ++i) {
    const std::string& ch = chroms[static_cast<size_t>(chrom_id[i])];
    memcpy(w, ch.data(), ch.size());
    w += ch.size();
    *w++ = ',';
    w = write_i32(pos[i], w);
    bool het = is_het[i] != 0;
    memcpy(w, het ? ",het," : ",hom,", 5);
    w += 5;
    char a = kAlleles[major[i] & 3];
    *w++ = a;
    *w++ = het ? kAlleles[second[i] & 3] : a;
    *w++ = ',';
    w = write_g(conf_hom[i], w);
    *w++ = ',';
    w = write_g(conf_het[i], w);
    *w++ = ',';
    memcpy(w, conf_type, type_len);
    w += type_len;
    *w++ = '\n';
  }
  out.resize(static_cast<size_t>(w - base));
}

}  // namespace

extern "C" {

// Returns a malloc'd buffer in *out (caller frees with sidtpu_buffer_free);
// return value is the byte length.
int64_t sidtpu_write_csv(const char* chrom_blob, int64_t chrom_blob_len,
                         const int32_t* chrom_id,
                         const int32_t* pos, const uint8_t* is_het,
                         const int32_t* major, const int32_t* second,
                         const double* conf_hom, const double* conf_het,
                         const char* conf_type, int64_t n, int with_header,
                         int n_threads, char** out) {
  // split the '\n'-joined chromosome table
  std::vector<std::string> chroms = split_chrom_blob(chrom_blob, chrom_blob_len);
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 4);
  if (nt > 64) nt = 64;
  if (static_cast<int64_t>(nt) > n) nt = n > 0 ? static_cast<int>(n) : 1;

  std::vector<std::string> parts(static_cast<size_t>(nt));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    int64_t begin = n * t / nt;
    int64_t end = n * (t + 1) / nt;
    threads.emplace_back([&, t, begin, end]() {
      // write_rows sizes the buffer itself (one worst-case resize)
      write_rows(chroms, chrom_id, pos, is_het, major, second, conf_hom,
                 conf_het, conf_type, begin, end, parts[static_cast<size_t>(t)]);
    });
  }
  for (auto& th : threads) th.join();

  static const char kHeader[] = "chrom,pos,label,gt,hom_conf,het_conf,conf_type\n";
  size_t total = with_header ? sizeof(kHeader) - 1 : 0;
  for (auto& p : parts) total += p.size();
  char* buf = static_cast<char*>(malloc(total + 1));
  char* w = buf;
  if (with_header) {
    memcpy(w, kHeader, sizeof(kHeader) - 1);
    w += sizeof(kHeader) - 1;
  }
  for (auto& p : parts) {
    memcpy(w, p.data(), p.size());
    w += p.size();
  }
  *w = '\0';
  *out = buf;
  return static_cast<int64_t>(total);
}

void sidtpu_buffer_free(char* p) { free(p); }

// direct %g hook for differential testing against glibc snprintf
// (out must hold >= 32 bytes; returns length, no NUL guarantee)
int sidtpu_format_g(double v, char* out) { return format_g6(v, out); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Unique-profile histogram (countUniqueProfiles, pileup.cpp:169-196): the
// (N,4) uint16 count rows pack into order-preserving uint64 keys; a flat
// open-addressing hash (identity-mixed, linear probing) assigns class ids in
// O(N), classes then sort lexicographically and per-site ids remap — far
// faster than a comparison sort over N keys. Threaded over site ranges with
// per-thread maps merged at the end (U ~ 10^3..10^5 is tiny next to N).

namespace {

inline uint64_t mix_key(uint64_t k) {
  // splitmix64 finalizer: packed profiles differ in high bits; mix so the
  // low bits used for table indexing spread
  k += 0x9e3779b97f4a7c15ull;
  k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ull;
  k = (k ^ (k >> 27)) * 0x94d049bb133111ebull;
  return k ^ (k >> 31);
}

struct FlatMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  std::vector<uint8_t> used;
  size_t mask = 0;
  size_t count = 0;

  void init(size_t expect) {
    size_t cap = 64;
    while (cap < expect * 2) cap <<= 1;
    keys.assign(cap, 0);
    vals.assign(cap, 0);
    used.assign(cap, 0);
    mask = cap - 1;
    count = 0;
  }

  void grow() {
    FlatMap bigger;
    bigger.init(keys.size());  // doubles (init uses expect*2)
    for (size_t i = 0; i < keys.size(); ++i)
      if (used[i]) bigger.put(keys[i], vals[i]);
    *this = std::move(bigger);
  }

  void put(uint64_t k, int32_t v) {
    size_t i = mix_key(k) & mask;
    while (used[i]) i = (i + 1) & mask;
    used[i] = 1;
    keys[i] = k;
    vals[i] = v;
    ++count;
  }

  // returns the class id for k, inserting next_id if absent (sets *inserted)
  int32_t get_or_insert(uint64_t k, int32_t next_id, bool* inserted) {
    if (count * 2 >= keys.size()) grow();
    size_t i = mix_key(k) & mask;
    while (used[i]) {
      if (keys[i] == k) {
        *inserted = false;
        return vals[i];
      }
      i = (i + 1) & mask;
    }
    used[i] = 1;
    keys[i] = k;
    vals[i] = next_id;
    ++count;
    *inserted = true;
    return next_id;
  }

  int32_t find(uint64_t k) const {
    size_t i = mix_key(k) & mask;
    while (used[i]) {
      if (keys[i] == k) return vals[i];
      i = (i + 1) & mask;
    }
    return -1;
  }
};

struct UniqueResult {
  std::vector<uint16_t> profiles;  // (U,4)
  std::vector<int64_t> mult;       // (U,)
  std::vector<int32_t> inverse;    // (N,)
  int64_t num_classes = 0;
};

inline uint64_t pack_row(const uint16_t* row) {
  return (static_cast<uint64_t>(row[0]) << 48) |
         (static_cast<uint64_t>(row[1]) << 32) |
         (static_cast<uint64_t>(row[2]) << 16) | static_cast<uint64_t>(row[3]);
}

}  // namespace

extern "C" {

void* sidtpu_unique_profiles(const uint16_t* counts, int64_t n, int n_threads) {
  auto* res = new UniqueResult();
  res->inverse.resize(static_cast<size_t>(n));
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 4);
  if (nt > 64) nt = 64;
  if (static_cast<int64_t>(nt) * 4096 > n) {
    nt = static_cast<int>(n / 4096) + 1;
  }

  // pass 1: per-thread maps assign local class ids; local uniques collected
  std::vector<std::vector<uint64_t>> local_keys(static_cast<size_t>(nt));
  std::vector<std::vector<int64_t>> local_mult(static_cast<size_t>(nt));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    int64_t begin = n * t / nt;
    int64_t end = n * (t + 1) / nt;
    threads.emplace_back([&, t, begin, end]() {
      FlatMap map;
      map.init(1024);
      auto& lk = local_keys[static_cast<size_t>(t)];
      auto& lm = local_mult[static_cast<size_t>(t)];
      for (int64_t i = begin; i < end; ++i) {
        uint64_t key = pack_row(counts + i * 4);
        bool ins;
        int32_t id = map.get_or_insert(
            key, static_cast<int32_t>(lk.size()), &ins);
        if (ins) {
          lk.push_back(key);
          lm.push_back(0);
        }
        lm[static_cast<size_t>(id)] += 1;
        res->inverse[static_cast<size_t>(i)] = id;  // local id for now
      }
    });
  }
  for (auto& th : threads) th.join();

  // merge local uniques into the global sorted table
  std::vector<uint64_t> all_keys;
  for (auto& lk : local_keys) all_keys.insert(all_keys.end(), lk.begin(), lk.end());
  std::vector<uint64_t> sorted = all_keys;
  std::sort(sorted.begin(), sorted.end());
  sorted.erase(std::unique(sorted.begin(), sorted.end()), sorted.end());
  const int64_t u = static_cast<int64_t>(sorted.size());

  FlatMap global;
  global.init(static_cast<size_t>(u) + 1);
  for (int64_t c = 0; c < u; ++c)
    global.put(sorted[static_cast<size_t>(c)], static_cast<int32_t>(c));

  res->num_classes = u;
  res->profiles.resize(static_cast<size_t>(u) * 4);
  res->mult.assign(static_cast<size_t>(u), 0);
  for (int64_t c = 0; c < u; ++c) {
    uint64_t k = sorted[static_cast<size_t>(c)];
    res->profiles[static_cast<size_t>(c) * 4 + 0] = static_cast<uint16_t>(k >> 48);
    res->profiles[static_cast<size_t>(c) * 4 + 1] = static_cast<uint16_t>((k >> 32) & 0xFFFF);
    res->profiles[static_cast<size_t>(c) * 4 + 2] = static_cast<uint16_t>((k >> 16) & 0xFFFF);
    res->profiles[static_cast<size_t>(c) * 4 + 3] = static_cast<uint16_t>(k & 0xFFFF);
  }

  // per-thread local->global remap tables; accumulate multiplicities
  std::vector<std::vector<int32_t>> remap(static_cast<size_t>(nt));
  for (int t = 0; t < nt; ++t) {
    auto& lk = local_keys[static_cast<size_t>(t)];
    auto& rm = remap[static_cast<size_t>(t)];
    rm.resize(lk.size());
    for (size_t j = 0; j < lk.size(); ++j) {
      int32_t g = global.find(lk[j]);
      rm[j] = g;
      res->mult[static_cast<size_t>(g)] += local_mult[static_cast<size_t>(t)][j];
    }
  }

  // pass 2: rewrite per-site local ids as global sorted class ids
  threads.clear();
  for (int t = 0; t < nt; ++t) {
    int64_t begin = n * t / nt;
    int64_t end = n * (t + 1) / nt;
    threads.emplace_back([&, t, begin, end]() {
      const auto& rm = remap[static_cast<size_t>(t)];
      for (int64_t i = begin; i < end; ++i)
        res->inverse[static_cast<size_t>(i)] =
            rm[static_cast<size_t>(res->inverse[static_cast<size_t>(i)])];
    });
  }
  for (auto& th : threads) th.join();
  return res;
}

int64_t sidtpu_unique_num_classes(void* r) {
  return static_cast<UniqueResult*>(r)->num_classes;
}
const uint16_t* sidtpu_unique_class_profiles(void* r) {
  return static_cast<UniqueResult*>(r)->profiles.data();
}
const int64_t* sidtpu_unique_class_mult(void* r) {
  return static_cast<UniqueResult*>(r)->mult.data();
}
const int32_t* sidtpu_unique_inverse(void* r) {
  return static_cast<UniqueResult*>(r)->inverse.data();
}
void sidtpu_unique_free(void* r) { delete static_cast<UniqueResult*>(r); }

// Batched glibc-libm erfc: the exact_pvalues path computes LRT p-values
// erfc(sqrt(chisq/2)) on the host with the same libm the long-double oracle
// uses (math.erfc), so device/oracle CSV parity is independent of the XLA
// backend's erfc approximation (stats.cpp:33's gsl_cdf_chisq_Q analogue).
void sidtpu_erfc(const double* x, double* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = erfc(x[i]);
}

// Fused threaded LRT p-values from log-likelihoods (stats.cpp:29-37):
// chisq = 2*max(0, l1-l0), p = erfc(sqrt(chisq/2)), log_l0 == -inf -> 0.
// Elementwise over disjoint ranges, so threading is bitwise-deterministic;
// the arithmetic mirrors ops/stats.lrt_pvalue_from_logs_np operation for
// operation (NaN in either log propagates through max/sqrt/erfc exactly as
// numpy's maximum does; fmax would wrongly absorb it).
void sidtpu_lrt_pvalues(const double* log_l0, const double* log_l1,
                        double* out, int64_t n, int n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const double l0 = log_l0[i];
      const double d = log_l1[i] - l0;
      // np.maximum(0, d): NaN propagates, unlike fmax
      const double m = (d > 0.0 || d != d) ? d : 0.0;
      double p = erfc(sqrt(m));  // 2*m*0.5 == m exactly
      if (std::isinf(l0) && l0 < 0.0) p = 0.0;
      out[i] = p;
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 2);
  if (nt > 1 && n >= (1 << 16)) {
    std::vector<std::thread> threads;
    int64_t per = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * per;
      int64_t hi = lo + per < n ? lo + per : n;
      if (lo >= hi) break;
      threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
  } else {
    work(0, n);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Indexed CSV writer: per-profile classifications joined to sites.
//
// For the profile-deduplicated methods (local/bayes/likelihood_ratio) the
// label/genotype/confidence columns depend only on the site's unique profile,
// so the expensive "%g" formatting runs once per *class* (U ~ 10^3..10^5) and
// each row is assembled as chrom,pos + a memcpy of the class suffix.

extern "C" {

int64_t sidtpu_write_csv_indexed(
    const char* chrom_blob, int64_t chrom_blob_len,
    const int32_t* chrom_id, const int32_t* pos,
    const int32_t* class_idx, int64_t n, const uint8_t* cls_is_het,
    const int32_t* cls_major, const int32_t* cls_second,
    const double* cls_conf_hom, const double* cls_conf_het, int64_t n_cls,
    const char* conf_type, int with_header, int n_threads, char** out) {
  std::vector<std::string> chroms = split_chrom_blob(chrom_blob, chrom_blob_len);
  // pre-format per-class suffix: ",label,gt,hom_conf,het_conf,conf_type\n"
  std::vector<std::string> suffix(static_cast<size_t>(n_cls));
  {
    char num[64];
    for (int64_t c = 0; c < n_cls; ++c) {
      std::string& s = suffix[static_cast<size_t>(c)];
      bool het = cls_is_het[c] != 0;
      s += het ? ",het," : ",hom,";
      char a = kAlleles[cls_major[c] & 3];
      s += a;
      s += het ? kAlleles[cls_second[c] & 3] : a;
      s += ',';
      append_g(cls_conf_hom[c], s, num);
      s += ',';
      append_g(cls_conf_het[c], s, num);
      s += ',';
      s += conf_type;
      s += '\n';
    }
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 4);
  if (nt > 64) nt = 64;
  if (static_cast<int64_t>(nt) > n) nt = n > 0 ? static_cast<int>(n) : 1;

  // raw-pointer row assembly: per-thread buffer sized from worst-case row
  size_t max_chrom = 1, max_suffix = 1;
  for (auto& c : chroms) max_chrom = c.size() > max_chrom ? c.size() : max_chrom;
  for (auto& s : suffix) max_suffix = s.size() > max_suffix ? s.size() : max_suffix;
  const size_t row_cap = max_chrom + 1 + 12 + max_suffix;

  std::vector<std::string> parts(static_cast<size_t>(nt));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    int64_t begin = n * t / nt;
    int64_t end = n * (t + 1) / nt;
    threads.emplace_back([&, t, begin, end]() {
      std::string& o = parts[static_cast<size_t>(t)];
      o.resize(static_cast<size_t>(end - begin) * row_cap);
      char* base = &o[0];
      char* w = base;
      for (int64_t i = begin; i < end; ++i) {
        const std::string& ch = chroms[static_cast<size_t>(chrom_id[i])];
        memcpy(w, ch.data(), ch.size());
        w += ch.size();
        *w++ = ',';
        // inline unsigned itoa (positions are int32; negatives via sign)
        int32_t v = pos[i];
        if (v < 0) { *w++ = '-'; }
        uint32_t uv = v < 0 ? static_cast<uint32_t>(-(int64_t)v)
                            : static_cast<uint32_t>(v);
        char tmp[12];
        int k = 0;
        do { tmp[k++] = static_cast<char>('0' + uv % 10); uv /= 10; } while (uv);
        while (k) *w++ = tmp[--k];
        const std::string& sf = suffix[static_cast<size_t>(class_idx[i])];
        memcpy(w, sf.data(), sf.size());
        w += sf.size();
      }
      o.resize(static_cast<size_t>(w - base));
    });
  }
  for (auto& th : threads) th.join();

  static const char kHeader2[] = "chrom,pos,label,gt,hom_conf,het_conf,conf_type\n";
  size_t total = with_header ? sizeof(kHeader2) - 1 : 0;
  for (auto& p : parts) total += p.size();
  char* buf = static_cast<char*>(malloc(total + 1));
  char* w = buf;
  if (with_header) {
    memcpy(w, kHeader2, sizeof(kHeader2) - 1);
    w += sizeof(kHeader2) - 1;
  }
  for (auto& p : parts) {
    memcpy(w, p.data(), p.size());
    w += p.size();
  }
  *w = '\0';
  *out = buf;
  return static_cast<int64_t>(total);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Long-double Lynch kernels: native acceleration of the exact-fit oracle.
//
// Bitwise-identical reimplementation of sid_tpu/exact/lynch_ld.py's
// compound_neg_log_likelihood_ld / {hom,het}_marginal_ld (themselves the
// long-double oracle for the reference's lynch.cpp:37-61 objective and
// lynch.hpp:57-90 kernels). Every operation keeps the oracle's operand
// order and precision promotions:
//   - bases computed in f64 then promoted to long double (x86 80-bit),
//   - powl with integer-valued long-double exponents — precomputed as
//     tables powl(base, (long double)k), k = 0..max_cov, which is the
//     exact same call the oracle's np.power makes per element,
//   - per-profile pair terms accumulate in the reference's i<j order,
//   - the compound objective's profile sum is strictly sequential
//     (threads only fill the per-profile terms array; the reduction runs
//     on one thread in index order, matching np.cumsum).
// The f64 log multinomial coefficients are passed in from Python (scipy
// gammaln — the oracle's source of lgamma values) so no lgamma
// implementation difference can creep in.

namespace {

struct LdPowTables {
  std::vector<long double> match_het;  // powl((1-2e/3)/2, k)
  std::vector<long double> match_hom;  // powl(1-e, k)
  std::vector<long double> err;        // powl(e/3, k)
};

LdPowTables build_pow_tables(double eps, int max_cov) {
  LdPowTables t;
  const long double mh = static_cast<long double>((1.0 - 2.0 / 3.0 * eps) / 2.0);
  const long double mo = static_cast<long double>(1.0 - eps);
  const long double er = static_cast<long double>(eps / 3.0);
  t.match_het.resize(static_cast<size_t>(max_cov) + 1);
  t.match_hom.resize(static_cast<size_t>(max_cov) + 1);
  t.err.resize(static_cast<size_t>(max_cov) + 1);
  for (int k = 0; k <= max_cov; ++k) {
    const long double lk = static_cast<long double>(k);
    t.match_het[static_cast<size_t>(k)] = powl(mh, lk);
    t.match_hom[static_cast<size_t>(k)] = powl(mo, lk);
    t.err[static_cast<size_t>(k)] = powl(er, lk);
  }
  return t;
}

// hom/het marginal likelihoods for profiles[lo:hi) at a fixed epsilon;
// outputs are indexed u - out_base. denom = 1 - sum nt_i^2 accumulated in
// long double (the oracle's s loop).
void lynch_marginals_range(const int32_t* prof, const double* mc_log,
                           const double* nt, const LdPowTables& tab,
                           long double denom, int64_t lo, int64_t hi,
                           long double* out_hom, long double* out_het,
                           int64_t out_base) {
  for (int64_t u = lo; u < hi; ++u) {
    const int32_t* p = prof + u * 4;
    const int cov = p[0] + p[1] + p[2] + p[3];
    const long double mc = expl(static_cast<long double>(mc_log[u]));
    // het: reference accumulation order i-major, j = i+1..3 (lynch.hpp:57-74)
    long double lhet = 0.0L;
    for (int i = 0; i < 4; ++i) {
      for (int j = i + 1; j < 4; ++j) {
        const double w = nt[i] * nt[j];  // double product, then promote
        const int nij = p[i] + p[j];
        lhet = lhet + static_cast<long double>(w) *
                          tab.match_het[static_cast<size_t>(nij)] *
                          tab.err[static_cast<size_t>(cov - nij)];
      }
    }
    lhet = lhet / denom;
    // hom: sum over the 4 candidate alleles (lynch.hpp:82-90)
    long double lhom = 0.0L;
    for (int i = 0; i < 4; ++i) {
      lhom = lhom + static_cast<long double>(nt[i]) *
                        tab.match_hom[static_cast<size_t>(p[i])] *
                        tab.err[static_cast<size_t>(cov - p[i])];
    }
    out_het[u - out_base] = mc * lhet;
    out_hom[u - out_base] = mc * lhom;
  }
}

long double lynch_denominator(const double* nt) {
  long double s = 0.0L;
  for (int i = 0; i < 4; ++i)
    s = s + static_cast<long double>(nt[i] * nt[i]);
  return 1.0L - s;
}

int lynch_max_cov(const int32_t* prof, int64_t U) {
  int max_cov = 0;
  for (int64_t u = 0; u < U; ++u) {
    const int32_t* p = prof + u * 4;
    const int cov = p[0] + p[1] + p[2] + p[3];
    if (cov > max_cov) max_cov = cov;
  }
  return max_cov;
}

void run_ranged(int64_t U, int n_threads,
                const std::function<void(int64_t, int64_t)>& work) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 2);
  if (nt > 1 && U >= 4096) {
    std::vector<std::thread> threads;
    int64_t per = (U + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * per;
      int64_t hi = lo + per < U ? lo + per : U;
      if (lo >= hi) break;
      threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
  } else {
    work(0, U);
  }
}

}  // namespace

extern "C" {

// compoundLikelihood (lynch.cpp:37-61) in oracle precision semantics.
// prof: (U,4) int32; mult: (U,) int64; mc_log: (U,) f64 log multinomial
// coefficients; nt: (4,) f64. Returns the double-valued objective.
double sidtpu_compound_nll_ld(const int32_t* prof, const int64_t* mult,
                              const double* mc_log, const double* nt,
                              double pi, double eps, int64_t U,
                              int n_threads) {
  if (pi < 0.0 || pi > 1.0 || eps < 0.0 || eps > 1.0)
    return std::numeric_limits<double>::max();
  const int max_cov = lynch_max_cov(prof, U);
  const LdPowTables tab = build_pow_tables(eps, max_cov);
  const long double denom = lynch_denominator(nt);
  const long double pi_ld = static_cast<long double>(pi);
  const long double one_minus_pi = static_cast<long double>(1.0 - pi);
  std::vector<long double> terms(static_cast<size_t>(U));
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<long double> hom(static_cast<size_t>(hi - lo));
    std::vector<long double> het(static_cast<size_t>(hi - lo));
    lynch_marginals_range(prof, mc_log, nt, tab, denom, lo, hi,
                          hom.data(), het.data(), lo);
    for (int64_t u = lo; u < hi; ++u) {
      const long double L =
          one_minus_pi * hom[static_cast<size_t>(u - lo)] +
          pi_ld * het[static_cast<size_t>(u - lo)];
      terms[static_cast<size_t>(u)] =
          L > 0.0L ? logl(L) * static_cast<long double>(mult[u]) : 0.0L;
    }
  };
  run_ranged(U, n_threads, work);
  long double total = 0.0L;
  for (int64_t u = 0; u < U; ++u) total = total + terms[static_cast<size_t>(u)];
  if (std::isinf(total)) {
    total = total > 0.0L ? std::numeric_limits<long double>::max()
                         : -std::numeric_limits<long double>::max();
  }
  return static_cast<double>(-total);
}

// Per-profile {L_hom, L_het} at the fitted epsilon (lynch.cpp:26-33),
// long double out (numpy longdouble-compatible: x86-64 80-bit, 16-byte
// stride for both g++ and numpy).
void sidtpu_lynch_marginals_ld(const int32_t* prof, const double* mc_log,
                               const double* nt, double eps, int64_t U,
                               long double* out_hom, long double* out_het,
                               int n_threads) {
  const int max_cov = lynch_max_cov(prof, U);
  const LdPowTables tab = build_pow_tables(eps, max_cov);
  const long double denom = lynch_denominator(nt);
  auto work = [&](int64_t lo, int64_t hi) {
    lynch_marginals_range(prof, mc_log, nt, tab, denom, lo, hi, out_hom,
                          out_het, 0);
  };
  run_ranged(U, n_threads, work);
}

}  // extern "C"

extern "C" {

// %g fast-path observability: cumulative count of snprintf fallbacks taken
// by format_g6 since load (or the last reset). The fast path is
// glibc-%g-exact by construction; this counter shows how often the
// rounding-ambiguity escape actually fires on real outputs.
uint64_t sidtpu_format_g_fallbacks(int reset) {
  uint64_t v = g_fmt_fallbacks.load(std::memory_order_relaxed);
  if (reset) g_fmt_fallbacks.store(0, std::memory_order_relaxed);
  return v;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused quality-method finalization (call.cpp:344-369): allele-balance
// binomial, 80-bit underflow clamp, prior weighting, and both LRT p-values
// in ONE threaded pass. Bitwise-identical to the Python composition
// models/quality.finalize_quality_np + ops/stats.lrt_pvalue_from_logs_np:
// every operation is elementary IEEE f64 except erfc, which is the same
// glibc call the host path uses. Prior logs and the underflow constant are
// passed in precomputed so the caller's (numpy/glibc) values are used
// verbatim.

extern "C" {

int sidtpu_quality_finalize(
    const uint16_t* counts,       // (N,4)
    const int32_t* major, const int32_t* second,
    const double* log_hom, const double* log_het,
    const double* lgamma_tab, int64_t tab_len,
    double log_prior_hom, double log_prior_het, int use_prior,
    double alpha, double underflow_log, int64_t n,
    double* out_p1, double* out_p2, uint8_t* out_het, int n_threads) {
  // precondition: the table covers n_major+n_second+1 for every site
  int64_t max_n = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint16_t* c = counts + i * 4;
    int64_t nn = (int64_t)c[major[i] & 3] + c[second[i] & 3];
    if (nn > max_n) max_n = nn;
  }
  if (max_n + 1 >= tab_len) return -1;

  const double ln2 = log(2.0);
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint16_t* c = counts + i * 4;
      const int64_t nn = (int64_t)c[major[i] & 3] + c[second[i] & 3];
      const int64_t kk = c[second[i] & 3];
      const double log_c =
          lgamma_tab[nn + 1] - lgamma_tab[nn - kk + 1] - lgamma_tab[kk + 1];
      double lh = log_hom[i];
      double lt = log_het[i] + log_c - (double)nn * ln2;
      // clamp BEFORE the prior (finalize_quality_np order)
      double lpp1 = lh < underflow_log ? -INFINITY : lh;
      double lpp2 = lt < underflow_log ? -INFINITY : lt;
      if (use_prior) {
        lpp1 += log_prior_hom;
        lpp2 += log_prior_het;
      }
      // LRT x2 (sidtpu_lrt_pvalues arithmetic: NaN-propagating max)
      {
        const double d = lpp1 - lpp2;
        const double m = (d > 0.0 || d != d) ? d : 0.0;
        double p = erfc(sqrt(m));
        if (std::isinf(lpp2) && lpp2 < 0.0) p = 0.0;
        out_p1[i] = p;
      }
      {
        const double d = lpp2 - lpp1;
        const double m = (d > 0.0 || d != d) ? d : 0.0;
        double p = erfc(sqrt(m));
        if (std::isinf(lpp1) && lpp1 < 0.0) p = 0.0;
        out_p2[i] = p;
      }
      out_het[i] = out_p2[i] < alpha ? 1 : 0;
    }
  };
  run_ranged(n, n_threads, work);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Per-profile `local`-method classification (callSiteMLError's per-profile
// loop, call.cpp:238-273) in oracle long-double arithmetic. Bitwise-identical
// to the numpy longdouble spec exact/engine.local_classify_profiles_ld
// (itself the oracle for the reference's plug-in-error kernels
// lynch.hpp:76-96 and likelihoodRatioTest stats.cpp:29-37): error rates in
// f64 with the NaN-preserving threshold cap, bases computed in f64 then
// promoted to long double, per-profile powl/expl/logl are the same glibc
// calls numpy longdouble makes, and the chi-square survival function is
// glibc erfc on f64. The f64 log multinomial coefficients come in from
// Python (scipy gammaln — the oracle's lgamma source).

namespace {

// stats_ld.lrt_pvalue_ld (stats.cpp:29-37) on linear long doubles.
// `a != 0` is NaN-inclusive (the oracle's branch); max follows Python's
// max(a, b) = b if b > a else a.
double lrt_pvalue_linear_ld(long double a, long double b) {
  if (a != 0.0L) {
    // (b > a) ? b : a is the in-repo oracle's Python max(), NOT the
    // reference's fmaxl (stats.cpp:31): they differ on NaN inputs
    // (fmaxl(NaN, b) == b; this returns a when the comparison is false).
    // Unreachable divergence in practice — NaN error rates only occur at
    // cov == 0, where powl(x, 0) == 1 keeps both likelihoods finite — but a
    // refactor toward fmaxl would silently change the oracle spec.
    const long double mx = (b > a) ? b : a;
    const double chisq = static_cast<double>(-2.0L * (logl(a) - logl(mx)));
    return erfc(sqrt(chisq * 0.5));
  }
  return 0.0;  // gsl_cdf_chisq_Q(DBL_MAX, 1) underflows to 0
}

}  // namespace

extern "C" {

void sidtpu_local_classify_ld(const int32_t* prof, const double* mc_log,
                              const int32_t* major, const int32_t* second,
                              double error_threshold, double snp_prior,
                              double alpha, int64_t U, double* out_p1,
                              double* out_p2, uint8_t* out_het,
                              int n_threads) {
  const long double prior_hom =
      static_cast<long double>(1.0 - snp_prior);  // f64 first, then promote
  const long double prior_het = static_cast<long double>(snp_prior);
  const int use_prior = snp_prior > 0.0;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t u = lo; u < hi; ++u) {
      const int32_t* p = prof + u * 4;
      const int icov = p[0] + p[1] + p[2] + p[3];
      const double cov = static_cast<double>(icov);
      const double n1 = static_cast<double>(p[major[u] & 3]);
      const double n2 = static_cast<double>(p[second[u] & 3]);

      // plug-in error rates (call.cpp:242-254); 0/0 -> NaN rides through the
      // threshold cap (NaN > thr is false) and powl(x, 0) == 1 below
      double e1 = (cov - n1) / cov;
      if (e1 > error_threshold) e1 = error_threshold;
      double e2 = 1.5 * (cov - n1 - n2) / cov;
      if (e2 > error_threshold) e2 = error_threshold;

      const long double mc = expl(static_cast<long double>(mc_log[u]));
      // hom at the major allele (lynch.hpp:92-96 / hom_fixed_ld)
      const long double mb1 = static_cast<long double>(1.0 - e1);
      const long double eb1 = static_cast<long double>(e1 / 3.0);
      const int n0 = p[major[u] & 3];
      long double l1 = mc * powl(mb1, static_cast<long double>(n0)) *
                       powl(eb1, static_cast<long double>(icov - n0));
      // het at (major, second) (lynch.hpp:76-80 / het_fixed_ld)
      const long double mb2 =
          static_cast<long double>((1.0 - 2.0 / 3.0 * e2) / 2.0);
      const long double eb2 = static_cast<long double>(e2 / 3.0);
      const int n01 = p[major[u] & 3] + p[second[u] & 3];
      long double l2 = mc * powl(mb2, static_cast<long double>(n01)) *
                       powl(eb2, static_cast<long double>(icov - n01));

      if (use_prior) {
        l1 = l1 * prior_hom;
        l2 = l2 * prior_het;
      }

      out_p1[u] = lrt_pvalue_linear_ld(l2, l1);
      out_p2[u] = lrt_pvalue_linear_ld(l1, l2);
      out_het[u] = (l2 > l1 && out_p2[u] < alpha) ? 1 : 0;
    }
  };
  run_ranged(U, n_threads, work);
}

}  // extern "C"
