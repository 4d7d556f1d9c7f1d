// Indexed CSV writer of the port (host runtime, C++17): the rows of a
// per-class result written once, in place, into a buffer the caller holds.
//
// The output is libsidtpu's sidtpu_write_csv_indexed's (parser.cpp), byte
// for byte: each row is `chrom,pos` and its class's suffix
// `,label,gt,hom_conf,het_conf,conf_type\n`, the suffix formatted once a
// class with libsidtpu's glibc-exact %g (sidtpu_format_g, whose address the
// caller hands in, so the %g code lives in one library).
//
// Two calls, with the caller's allocation between them:
//   sidtpu_csv_plan    formats the suffixes, splits the rows over the
//                      threads (hardware_concurrency, at most 64, at most
//                      n) and sums each thread's exact byte count;
//   sidtpu_csv_total   the output's exact size, header included (-1 for
//                      an index outside its table);
//   sidtpu_csv_fill    each thread writes its rows at its prefix offset
//                      into the caller's buffer of that size;
//   sidtpu_csv_free    releases the plan.
// The plan keeps pointers to the caller's row arrays until it is freed.

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

typedef int (*FormatG)(double, char*);

const char kAlleles[] = "ACGT";
const char kHeader[] = "chrom,pos,label,gt,hom_conf,het_conf,conf_type\n";
const size_t kHeaderLen = sizeof(kHeader) - 1;

struct Text {
  uint32_t off, len;
};

// Text blobs end in this many spare bytes, so a copy may read whole
// 16-byte blocks past any entry's end.
const size_t kPad = 16;

struct Plan {
  std::string chrom_bytes, suffix_bytes;
  std::vector<Text> chroms, suffixes;
  const int32_t* chrom_id;
  const int32_t* pos;
  const int32_t* class_idx;
  bool header;
  std::vector<int64_t> begin;   // nt + 1 row bounds
  std::vector<int64_t> offset;  // nt + 1 byte offsets, header included
  size_t max_row = 0;           // the longest row's bytes
};

const char kPairs[] =
    "00010203040506070809101112131415161718192021222324252627282930313233343536373839"
    "40414243444546474849505152535455565758596061626364656667686970717273747576777879"
    "8081828384858687888990919293949596979899";

inline uint32_t magnitude(int32_t v) {
  return v < 0 ? static_cast<uint32_t>(-static_cast<int64_t>(v)) : static_cast<uint32_t>(v);
}

inline int digits(uint32_t v) {
  return 1 + (v >= 10u) + (v >= 100u) + (v >= 1000u) + (v >= 10000u) + (v >= 100000u) +
         (v >= 1000000u) + (v >= 10000000u) + (v >= 100000000u) + (v >= 1000000000u);
}

// The decimal digits of v, written backwards from the end e.
inline void write_digits(char* e, uint32_t v) {
  while (v >= 100) {
    const uint32_t q = v / 100;
    memcpy(e -= 2, kPairs + 2 * (v - 100 * q), 2);
    v = q;
  }
  if (v >= 10)
    memcpy(e - 2, kPairs + 2 * v, 2);
  else
    e[-1] = static_cast<char>('0' + v);
}

// len bytes from src to dst as whole 16-byte blocks: up to 15 bytes past
// dst + len are overwritten and src must be readable as far.
inline void copy_blocks(char* dst, const char* src, uint32_t len) {
  for (uint32_t o = 0; o < len; o += 16) memcpy(dst + o, src + o, 16);
}

void append_g(FormatG format_g, double v, std::string& out) {
  char num[64];
  out.append(num, static_cast<size_t>(format_g(v, num)));
}

// [u32 len][bytes]... as in the parser's chromosome blob
void split_blob(const char* blob, int64_t blob_len, Plan& p) {
  int64_t i = 0;
  while (i + 4 <= blob_len) {
    uint32_t len;
    memcpy(&len, blob + i, 4);
    i += 4;
    if (i + static_cast<int64_t>(len) > blob_len) break;
    p.chroms.push_back({static_cast<uint32_t>(p.chrom_bytes.size()), len});
    p.chrom_bytes.append(blob + i, len);
    i += len;
  }
}

template <typename F>
void for_each_thread(const Plan& p, F&& work) {
  const int nt = static_cast<int>(p.begin.size()) - 1;
  if (nt == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nt));
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void* sidtpu_csv_plan(
    const char* chrom_blob, int64_t chrom_blob_len,
    const int32_t* chrom_id, const int32_t* pos,
    const int32_t* class_idx, int64_t n, const uint8_t* cls_is_het,
    const int32_t* cls_major, const int32_t* cls_second,
    const double* cls_conf_hom, const double* cls_conf_het, int64_t n_cls,
    const char* conf_type, int with_header, int n_threads, FormatG format_g) {
  Plan* p = new Plan();
  split_blob(chrom_blob, chrom_blob_len, *p);
  p->chrom_bytes.append(kPad, '\0');
  p->chrom_id = chrom_id;
  p->pos = pos;
  p->class_idx = class_idx;
  p->header = with_header != 0;
  p->suffixes.reserve(static_cast<size_t>(n_cls));
  std::string& s = p->suffix_bytes;
  for (int64_t c = 0; c < n_cls; ++c) {
    const size_t start = s.size();
    const bool het = cls_is_het[c] != 0;
    s += het ? ",het," : ",hom,";
    const char a = kAlleles[cls_major[c] & 3];
    s += a;
    s += het ? kAlleles[cls_second[c] & 3] : a;
    s += ',';
    append_g(format_g, cls_conf_hom[c], s);
    s += ',';
    append_g(format_g, cls_conf_het[c], s);
    s += ',';
    s += conf_type;
    s += '\n';
    p->suffixes.push_back({static_cast<uint32_t>(start), static_cast<uint32_t>(s.size() - start)});
  }
  s.append(kPad, '\0');
  size_t max_chrom = 0, max_suffix = 0;
  for (const Text& c : p->chroms) max_chrom = c.len > max_chrom ? c.len : max_chrom;
  for (const Text& c : p->suffixes) max_suffix = c.len > max_suffix ? c.len : max_suffix;
  p->max_row = max_chrom + 1 + 11 + max_suffix;

  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 4);
  if (nt > 64) nt = 64;
  if (static_cast<int64_t>(nt) > n) nt = n > 0 ? static_cast<int>(n) : 1;
  p->begin.resize(static_cast<size_t>(nt) + 1);
  for (int t = 0; t <= nt; ++t) p->begin[static_cast<size_t>(t)] = n * t / nt;

  // each thread's exact byte count (-1 where a row's chromosome or class
  // is out of its table's range), then their prefix sums
  std::vector<int64_t> bytes(static_cast<size_t>(nt));
  for_each_thread(*p, [&](int t) {
    const Text* chroms = p->chroms.data();
    const Text* suffixes = p->suffixes.data();
    const uint32_t n_chroms = static_cast<uint32_t>(p->chroms.size());
    const uint32_t n_suffixes = static_cast<uint32_t>(p->suffixes.size());
    int64_t sum = 0;
    bool bad = false;
    for (int64_t i = p->begin[static_cast<size_t>(t)]; i < p->begin[static_cast<size_t>(t) + 1]; ++i) {
      const uint32_t c = static_cast<uint32_t>(chrom_id[i]), k = static_cast<uint32_t>(class_idx[i]);
      bad |= (c >= n_chroms) | (k >= n_suffixes);
      sum += chroms[c < n_chroms ? c : 0].len + 1 + (pos[i] < 0) + digits(magnitude(pos[i])) +
             suffixes[k < n_suffixes ? k : 0].len;
    }
    bytes[static_cast<size_t>(t)] = bad ? -1 : sum;
  });
  p->offset.resize(static_cast<size_t>(nt) + 1);
  p->offset[0] = p->header ? static_cast<int64_t>(kHeaderLen) : 0;
  bool bad = false;
  for (int t = 0; t < nt; ++t) {
    const int64_t b = bytes[static_cast<size_t>(t)];
    bad |= b < 0;
    p->offset[static_cast<size_t>(t) + 1] = p->offset[static_cast<size_t>(t)] + (b < 0 ? 0 : b);
  }
  if (bad) p->offset.back() = -1;
  return p;
}

// The output's exact size, or -1 where a row's chromosome or class index
// lies outside its table (the plan must then not be filled).
int64_t sidtpu_csv_total(void* plan) { return static_cast<Plan*>(plan)->offset.back(); }

// Writes the planned output into out (sidtpu_csv_total bytes, no NUL);
// returns the bytes written, which equal the total.
int64_t sidtpu_csv_fill(void* plan, char* out) {
  const Plan& p = *static_cast<Plan*>(plan);
  if (p.header) memcpy(out, kHeader, kHeaderLen);
  std::vector<int64_t> written(p.begin.size() - 1);
  for_each_thread(p, [&](int t) {
    const char* const chrom_bytes = p.chrom_bytes.data();
    const char* const suffix_bytes = p.suffix_bytes.data();
    const Text* const chroms = p.chroms.data();
    const Text* const suffixes = p.suffixes.data();
    const int32_t* const chrom_id = p.chrom_id;
    const int32_t* const pos = p.pos;
    const int32_t* const class_idx = p.class_idx;
    char* const start = out + p.offset[static_cast<size_t>(t)];
    char* const end = out + p.offset[static_cast<size_t>(t) + 1];
    // rows that start before this point leave room for a block copy's
    // overrun inside this thread's part; the next row writes over it
    const int64_t room = static_cast<int64_t>(p.max_row) + 16;
    char* const blocks_end = end - start > room ? end - room : start;
    char* w = start;
    const int64_t hi = p.begin[static_cast<size_t>(t) + 1];
    for (int64_t i = p.begin[static_cast<size_t>(t)]; i < hi; ++i) {
      const Text ch = chroms[chrom_id[i]];
      const Text sf = suffixes[class_idx[i]];
      const int32_t v = pos[i];
      const uint32_t mag = magnitude(v);
      const bool fast = w < blocks_end;
      if (fast)
        copy_blocks(w, chrom_bytes + ch.off, ch.len);
      else
        memcpy(w, chrom_bytes + ch.off, ch.len);
      w += ch.len;
      *w++ = ',';
      if (v < 0) *w++ = '-';
      w += digits(mag);
      write_digits(w, mag);
      if (fast)
        copy_blocks(w, suffix_bytes + sf.off, sf.len);
      else
        memcpy(w, suffix_bytes + sf.off, sf.len);
      w += sf.len;
    }
    written[static_cast<size_t>(t)] = w - start;
  });
  int64_t total = p.header ? static_cast<int64_t>(kHeaderLen) : 0;
  for (int64_t b : written) total += b;
  return total;
}

void sidtpu_csv_free(void* plan) { delete static_cast<Plan*>(plan); }

}  // extern "C"
