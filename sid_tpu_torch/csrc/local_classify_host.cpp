// Host build of the kernel's per-profile arithmetic (local_classify.cuh),
// looped over arrays, so the CPU tests can hold the very expressions the
// card runs against the torch f64 twin before any card sees them.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC \
//       -o liblocal_classify_host.so local_classify_host.cpp
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "local_classify.cuh"

extern "C" {

void sid_local_classify_host(const int32_t* prof, const int32_t* major,
                             const int32_t* second, double thr,
                             const double* tab, int tab_len, double* l1,
                             double* l2, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* p = prof + 4 * i;
    const sid::LogLik2 r = sid::local_log_likelihoods_one(
        p[0], p[1], p[2], p[3], major[i], second[i], thr, tab, tab_len);
    l1[i] = r.l1;
    l2[i] = r.l2;
  }
}

// The kernel's row loop: counts (n, 4) uint16; params and every as
// sid_local_classify_launch takes them; table indices below head_len read
// from head (the kernel's shared-memory copy of the table's first entries),
// the others from tab; out: 17 n bytes, l1 (n f64), l2 (n f64), then the n
// bytes.
void sid_local_classify_rows_host(const uint16_t* counts, int64_t n,
                                  const double* params, int every,
                                  const double* tab, int tab_len,
                                  const double* head, int head_len, void* out) {
  const sid::ClassifyParams p{params[0], params[1], params[2], params[3],
                              params[4], params[5], every};
  const sid::StagedTable table{head, head_len, tab, tab_len};
  double* l1 = static_cast<double*>(out);
  double* l2 = l1 + n;
  uint8_t* packed = reinterpret_cast<uint8_t*>(l1 + 2 * n);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t word[2];
    memcpy(word, counts + 4 * i, sizeof(word));
    packed[i] = static_cast<uint8_t>(
        sid::classify_row(word[0], word[1], p, table, l1 + i, l2 + i));
  }
}

// B5's row loop (local_classify_lrt_kernel): counts, params, every and the
// table as sid_local_classify_rows_host takes them; lrt and use_prior as
// sid_local_classify_lrt_launch takes them; out: 17 n bytes, p1 (n f64), p2
// (n f64), then the n bytes (is_het in bit 5).
void sid_local_classify_lrt_rows_host(const uint16_t* counts, int64_t n,
                                      const double* params, int every,
                                      const double* lrt, int use_prior,
                                      const double* tab, int tab_len,
                                      const double* head, int head_len, void* out) {
  const sid::ClassifyParams p{params[0], params[1], params[2], params[3],
                              params[4], params[5], every};
  const sid::LocalLrtParams q{lrt[0], lrt[1], lrt[2], use_prior};
  const sid::StagedTable table{head, head_len, tab, tab_len};
  const double z = erfc(0.0);
  double* p1 = static_cast<double*>(out);
  double* p2 = p1 + n;
  uint8_t* packed = reinterpret_cast<uint8_t*>(p1 + 2 * n);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t word[2];
    memcpy(word, counts + 4 * i, sizeof(word));
    packed[i] = static_cast<uint8_t>(
        sid::classify_row_lrt(word[0], word[1], p, q, table, z, p1 + i, p2 + i));
  }
}

// B5's one-erfc tail over logs: (p1, p2) = lrt_pair_from(l1, l2,
// erfc(sqrt(lrt_pair_arg(l1, l2))), erfc(0.0)), the pair that
// (lrt_pvalue(l2, l1), lrt_pvalue(l1, l2)) gives with two erfc
void sid_lrt_pair_one_erfc_host(const double* l1, const double* l2, int64_t n, double* p1, double* p2) {
  const double z = erfc(0.0);
  for (int64_t i = 0; i < n; ++i) {
    const double e = erfc(sqrt(sid::lrt_pair_arg(l1[i], l2[i])));
    sid::lrt_pair_from(l1[i], l2[i], e, z, p1 + i, p2 + i);
  }
}

// lrt_pvalue(l0, l1) over arrays, the two-erfc form
void sid_lrt_pvalue_pairs_host(const double* l0, const double* l1, int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = sid::lrt_pvalue(l0[i], l1[i]);
}

double sid_long_double_underflow_log() { return sid::kLongDoubleUnderflowLog; }

}  // extern "C"
