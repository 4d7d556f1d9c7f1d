// Per-site arithmetic of the quality finalize's het side, shared by the CUDA
// kernel (quality_finalize.cu) and a g++ host build
// (quality_finalize_host.cpp) that the CPU tests hold against the torch f64
// version (sid_tpu_torch/ops/quality_finalize.py::quality_finalize_ref).
//
// Per site (counts c0..c3, major / second allele index from one byte):
//   n = c[major] + c[second], k = c[second]
//   lt   = (log_het + ((lgamma[n+1] - lgamma[n-k+1]) - lgamma[k+1])) - n * ln2
//   lpp2 = lt below the 80-bit underflow line ? -inf : lt, then + log(prior)
//          when a prior is set
// (call.cpp:344-369), in the operation order of libsidtpu's
// sidtpu_quality_finalize (csrc/host/parser.cpp) and of sid_tpu's
// models/quality.py::finalize_quality_np, so the bits are theirs. ln2, the
// underflow line and the prior's log come from the host.
//
// quality_lrt_row is the full form (sid_tpu/models/quality.py:133,
// finalize_quality) for the exact_pvalues=False flow: lpp2 as above, lpp1 =
// clamp(log_hom) + log(1 - prior) when a prior is set, p1 = lrt(lpp2, lpp1),
// p2 = lrt(lpp1, lpp2) and is_het = p2 < alpha: the composition of
// libsidtpu's sidtpu_quality_finalize, with one erfc for both p-values
// (lrt.cuh lrt_pair_arg, lrt_pair_from); quality_lrt_row_two_erfc is the
// same row with two lrt_pvalue calls, the form the host replays hold it
// against.
//
// Every operation is a separate IEEE f64 operation in that order: build
// with contraction off (nvcc --fmad=false, g++ -ffp-contract=off).
#pragma once

#include <math.h>
#include <stdint.h>

#include "local_classify.cuh"

namespace sid {

// the host's constants: log(2.0), LONG_DOUBLE_UNDERFLOW_LOG, log(prior)
struct QualityParams {
  double ln2;
  double underflow_log;
  double log_prior_het;
  int use_prior;  // add log_prior_het (a prior > 0 was given)
};

// One site from its counts as two 32-bit words of little-endian uint16
// (lo = c0 | c1 << 16, hi = c2 | c3 << 16) and its allele byte (major in
// bits 0-1, second in bits 2-3): returns lpp2. *miss is set when the table
// does not reach index n + 1, the largest the site reads; the value is then
// NaN (lgamma_at reads nothing past the table).
SID_HD double quality_het_row(uint32_t lo, uint32_t hi, unsigned alleles, double log_het,
                              const QualityParams& p, const double* tab, int tab_len,
                              bool* miss) {
  const int c0 = static_cast<int>(lo & 0xffffu), c1 = static_cast<int>(lo >> 16);
  const int c2 = static_cast<int>(hi & 0xffffu), c3 = static_cast<int>(hi >> 16);
  const int k = pick(c0, c1, c2, c3, static_cast<int>((alleles >> 2) & 3u));
  const int n = pick(c0, c1, c2, c3, static_cast<int>(alleles & 3u)) + k;
  *miss = n + 1 >= tab_len;
  const double log_c = (lgamma_at(tab, tab_len, n + 1) - lgamma_at(tab, tab_len, n - k + 1)) -
                       lgamma_at(tab, tab_len, k + 1);
  const double lt = (log_het + log_c) - static_cast<double>(n) * p.ln2;
  double lpp2 = lt < p.underflow_log ? -INFINITY : lt;
  if (p.use_prior) lpp2 += p.log_prior_het;
  return lpp2;
}

// the full form's further constants: log(1 - prior) (a host glibc scalar,
// added when QualityParams::use_prior) and the significance level
struct QualityLrtParams {
  double log_prior_hom;
  double alpha;
};

// The full form's logs: lpp2 (quality_het_row) and lpp1 = clamp(log_hom)
// plus log(1 - prior) when a prior is set; *miss as in quality_het_row.
SID_HD void quality_lrt_logs(uint32_t lo, uint32_t hi, unsigned alleles, double log_hom,
                             double log_het, const QualityParams& p, const QualityLrtParams& q,
                             const double* tab, int tab_len, bool* miss, double* lpp1,
                             double* lpp2) {
  *lpp2 = quality_het_row(lo, hi, alleles, log_het, p, tab, tab_len, miss);
  *lpp1 = clamp_below(log_hom, p.underflow_log);
  if (p.use_prior) *lpp1 = add_keep_nan(*lpp1, q.log_prior_hom);
}

// One site of the full form: writes p1 and p2, returns is_het; z is
// erfc(0.0) as the caller evaluated it. lrt_pair_from's (l1, l2) are
// (lpp1, lpp2), so its p1 is lrt_pvalue(lpp2, lpp1) and its p2
// lrt_pvalue(lpp1, lpp2).
SID_HD bool quality_lrt_row(uint32_t lo, uint32_t hi, unsigned alleles, double log_hom,
                            double log_het, const QualityParams& p, const QualityLrtParams& q,
                            const double* tab, int tab_len, double z, bool* miss, double* p1,
                            double* p2) {
  double lpp1, lpp2;
  quality_lrt_logs(lo, hi, alleles, log_hom, log_het, p, q, tab, tab_len, miss, &lpp1, &lpp2);
  lrt_pair_from(lpp1, lpp2, erfc(sqrt(lrt_pair_arg(lpp1, lpp2))), z, p1, p2);
  return *p2 < q.alpha;
}

// the same site with two erfc
SID_HD bool quality_lrt_row_two_erfc(uint32_t lo, uint32_t hi, unsigned alleles, double log_hom,
                                     double log_het, const QualityParams& p,
                                     const QualityLrtParams& q, const double* tab, int tab_len,
                                     bool* miss, double* p1, double* p2) {
  double lpp1, lpp2;
  quality_lrt_logs(lo, hi, alleles, log_hom, log_het, p, q, tab, tab_len, miss, &lpp1, &lpp2);
  *p1 = lrt_pvalue(lpp2, lpp1);
  *p2 = lrt_pvalue(lpp1, lpp2);
  return *p2 < q.alpha;
}

}  // namespace sid
