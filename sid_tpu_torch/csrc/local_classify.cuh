// Per-profile arithmetic of the `local` classify, shared by the CUDA kernel
// (local_classify.cu) and a g++ host build (local_classify_host.cpp) that
// the CPU tests hold against the torch f64 twin
// (sid_tpu_torch/ops/local_classify.py::local_classify_ref).
//
// Per profile (counts c0..c3, major / second allele index):
//   cov = sum c, n1 = c[major], n2 = c[second]
//   e1 = (cov - n1) / cov,            capped at thr (NaN stays NaN)
//   e2 = 1.5 * (cov - n1 - n2) / cov, capped at thr
//   l1 = mnom + xlogy(n1, log1p(-e1)) + xlogy(cov - n1, log(e1 / 3))
//   l2 = mnom + xlogy(n1 + n2, log((1 - 2/3 e2) / 2)) + xlogy(cov - n1 - n2, log(e2 / 3))
//   mnom = lgamma[cov + 1] - (((lgamma[c0+1] + lgamma[c1+1]) + lgamma[c2+1]) + lgamma[c3+1])
// and a result below the 80-bit long-double underflow line becomes -inf
// (call.cpp:238-254, lynch.hpp:76-96; sid_tpu/models/local.py:71-95).
//
// classify_row adds what the host used to do around it, from one row of
// four uint16 counts: the top-2 alleles (keys count * 4 + i, the largest is
// major and the next second: sid_tpu/models/common.py:30-44) and the
// long-double range screen of models/local.py::long_double_range_rows
// (cov * ln4 > LD_LOG_MAX or cov * K + prior > -LD_LOG_MIN, with the
// constants from the host), packed into one byte. classify_row_lrt adds
// sid_tpu's fused tail of the row (the prior, both LRTs through lrt.cuh
// with one erfc, and is_het in bit 5) for the exact_pvalues=False flow.
//
// Every operation is a separate IEEE f64 operation in that order: build
// with contraction off (nvcc --fmad=false, g++ -ffp-contract=off).
#pragma once

#include <math.h>
#include <stdint.h>

#include "lrt.cuh"

#ifndef SID_HD
#ifdef __CUDACC__
#define SID_HD __host__ __device__ __forceinline__
#else
#define SID_HD inline
#endif
#endif

namespace sid {

// -16445 * ln 2 in f64 (sid_tpu/models/common.py LONG_DOUBLE_UNDERFLOW_LOG):
// natural log of the smallest positive 80-bit subnormal, 2^-16445
constexpr double kLongDoubleUnderflowLog = -0x1.6436716d5406ep+13;

struct LogLik2 {
  double l1;
  double l2;
};

// x * logy with the powl(base, 0) == 1 convention; a select, since 0 * NaN
// and 0 * -inf are NaN
SID_HD double xlogy(int x, double logy) {
  return x == 0 ? 0.0 : static_cast<double>(x) * logy;
}

SID_HD int pick(int c0, int c1, int c2, int c3, int idx) {
  return idx == 0 ? c0 : idx == 1 ? c1 : idx == 2 ? c2 : c3;
}

// table read; an index past the table gives NaN instead of a stray read
SID_HD double lgamma_at(const double* tab, int tab_len, int k) {
  if (k < 0 || k >= tab_len) return NAN;
#ifdef __CUDA_ARCH__
  return __ldg(tab + k);
#else
  return tab[k];
#endif
}

SID_HD double clamp_underflow(double l) {
  return l < kLongDoubleUnderflowLog ? -INFINITY : l;
}

// the lgamma table in global memory
struct GlobalTable {
  const double* tab;
  int tab_len;
  SID_HD double operator()(int k) const { return lgamma_at(tab, tab_len, k); }
};

// the same table with its first head_len entries read from a copy (shared
// memory on the card): the same values, so the same bits
struct StagedTable {
  const double* head;
  int head_len;
  const double* tab;
  int tab_len;
  SID_HD double operator()(int k) const {
    return (k >= 0 && k < head_len) ? head[k] : lgamma_at(tab, tab_len, k);
  }
};

template <class Table>
SID_HD LogLik2 local_log_likelihoods_from(int c0, int c1, int c2, int c3,
                                          int major, int second, double thr,
                                          const Table& table) {
  const int icov = c0 + c1 + c2 + c3;
  const double cov = static_cast<double>(icov);
  const int n1 = pick(c0, c1, c2, c3, major);
  const int n2 = pick(c0, c1, c2, c3, second);
  const double mnom =
      table(icov + 1) -
      (((table(c0 + 1) + table(c1 + 1)) + table(c2 + 1)) + table(c3 + 1));

  // 0/0 -> NaN at zero coverage; NaN > thr is false, so NaN rides through
  double e1 = (cov - static_cast<double>(n1)) / cov;
  e1 = e1 > thr ? thr : e1;
  const double l1 = (mnom + xlogy(n1, log1p(-e1))) + xlogy(icov - n1, log(e1 / 3.0));

  double e2 = 1.5 * (cov - static_cast<double>(n1) - static_cast<double>(n2)) / cov;
  e2 = e2 > thr ? thr : e2;
  const int n12 = n1 + n2;
  const double l2 = (mnom + xlogy(n12, log((1.0 - 2.0 / 3.0 * e2) / 2.0))) +
                    xlogy(icov - n12, log(e2 / 3.0));

  return LogLik2{clamp_underflow(l1), clamp_underflow(l2)};
}

SID_HD LogLik2 local_log_likelihoods_one(int c0, int c1, int c2, int c3,
                                         int major, int second, double thr,
                                         const double* tab, int tab_len) {
  return local_log_likelihoods_from(c0, c1, c2, c3, major, second, thr,
                                    GlobalTable{tab, tab_len});
}

// ---- the fused row: counts in, (l1, l2) and one byte out ----

// the -E threshold and the range screen's constants, each computed on the
// host by models/common.py::long_double_screen's expressions
struct ClassifyParams {
  double thr;
  double ln4;             // log(4)
  double k;               // K: -log of the smallest base the -E cap allows
  double prior;           // the prior's log bound, 0 without a prior
  double ld_log_max;      // LD_LOG_MAX
  double neg_ld_log_min;  // -LD_LOG_MIN
  int every;              // flag every row (-E < 0 or a prior >= 1)
};

// the byte: major in bits 0-1, second in bits 2-3, the range flag in bit 4
constexpr unsigned kFlagBit = 16u;

struct Top2 {
  int major;
  int second;
};

// The two largest of the keys count * 4 + i (distinct, so no ties): the
// reference's stable ascending sort's positions 3 and 2, where a tie in
// count goes to the higher base index.
SID_HD Top2 top2(int c0, int c1, int c2, int c3) {
  const int k0 = c0 * 4, k1 = c1 * 4 + 1, k2 = c2 * 4 + 2, k3 = c3 * 4 + 3;
  const int a = k0 > k1 ? k0 : k1, b = k0 > k1 ? k1 : k0;  // a > b
  const int c = k2 > k3 ? k2 : k3, d = k2 > k3 ? k3 : k2;  // c > d
  const int top = a > c ? a : c;
  const int next = a > c ? (b > c ? b : c) : (a > d ? a : d);
  return Top2{top & 3, next & 3};
}

// models/local.py::long_double_range_rows for one coverage, in its order
SID_HD bool out_of_long_double_range(int icov, const ClassifyParams& p) {
  if (p.every) return true;
  const double c = static_cast<double>(icov);
  return c * p.ln4 > p.ld_log_max || c * p.k + p.prior > p.neg_ld_log_min;
}

SID_HD unsigned pack_row(Top2 t, bool flagged) {
  return static_cast<unsigned>(t.major) | static_cast<unsigned>(t.second) << 2 |
         (flagged ? kFlagBit : 0u);
}

// One row, from its counts as two 32-bit words of little-endian uint16
// (lo = c0 | c1 << 16, hi = c2 | c3 << 16): writes l1, l2 and returns the
// byte.
template <class Table>
SID_HD unsigned classify_row(uint32_t lo, uint32_t hi, const ClassifyParams& p,
                             const Table& table, double* l1, double* l2) {
  const int c0 = static_cast<int>(lo & 0xffffu), c1 = static_cast<int>(lo >> 16);
  const int c2 = static_cast<int>(hi & 0xffffu), c3 = static_cast<int>(hi >> 16);
  const Top2 t = top2(c0, c1, c2, c3);
  const LogLik2 r =
      local_log_likelihoods_from(c0, c1, c2, c3, t.major, t.second, p.thr, table);
  *l1 = r.l1;
  *l2 = r.l2;
  return pack_row(t, out_of_long_double_range(c0 + c1 + c2 + c3, p));
}

// ---- the fused on-device LRT: the same row, then prior, LRTs, is_het ----

// the prior's two logs (host glibc scalars: log(1 - prior), log(prior)),
// added when a prior > 0 is set, and the significance level
struct LocalLrtParams {
  double log_prior_hom;
  double log_prior_het;
  double alpha;
  int use_prior;
};

// the byte's bit 5: is_het
constexpr unsigned kHetBit = 32u;

// classify_row, then sid_tpu/models/local.py:59-65 (classify_local's tail):
// l1 += log(1 - prior), l2 += log(prior) with a prior; p1 = lrt(l2, l1),
// p2 = lrt(l1, l2) with one erfc (lrt.cuh lrt_pair_arg, lrt_pair_from; z is
// erfc(0.0) as the caller evaluated it once), bitwise the two lrt_pvalue
// calls; is_het = l2 > l1 and p2 < alpha, as bit 5 of the byte. Writes p1
// and p2 and returns the byte.
template <class Table>
SID_HD unsigned classify_row_lrt(uint32_t lo, uint32_t hi, const ClassifyParams& p,
                                 const LocalLrtParams& q, const Table& table, double z,
                                 double* p1, double* p2) {
  double l1, l2;
  unsigned byte = classify_row(lo, hi, p, table, &l1, &l2);
  if (q.use_prior) {
    l1 = add_keep_nan(l1, q.log_prior_hom);
    l2 = add_keep_nan(l2, q.log_prior_het);
  }
  lrt_pair_from(l1, l2, erfc(sqrt(lrt_pair_arg(l1, l2))), z, p1, p2);
  if (l2 > l1 && *p2 < q.alpha) byte |= kHetBit;
  return byte;
}

}  // namespace sid
