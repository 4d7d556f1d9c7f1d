// Per-element arithmetic of the likelihood_ratio method's device LRT and
// Benjamini-Hochberg step-up, shared by the CUDA kernels (lrt_bh.cu) and a
// g++ host build (lrt_bh_host.cpp) that the CPU tests hold against the
// host paths.
//
// The LRT of a profile (models/likelihood_ratio.py::lrt_classify):
//   hom = clamp(log_l_hom), het = clamp(log_l_het)
//   with the -R prior: het = clamp(het + log(pi)), hom = clamp(hom + log(1 - pi))
//   p1 = lrt(het, hom)  (confidence against het), p2 = lrt(hom, het)
// where clamp sends values below the 80-bit underflow line to -inf and the
// prior's logs are host glibc scalars. lrt_row gives (p1, p2) with one erfc
// (lrt.cuh lrt_pair_arg, lrt_pair_from); lrt_pair_two_erfc is the same pair
// as two lrt_pvalue calls, the form the host replays hold it against.
//
// BH over m p-values (stats.cpp:68-80; sid_tpu/ops/stats.py:78-99): with
// ord the descending order of p (NaN last),
//   s[0] = p[ord[0]], s[i] = p[ord[i]] * m / (m - i)
//   run[i] = min(s[0..i]), NaN propagating
//   out[ord[i]] = run[i] > 1 ? 1 : run[i]
// min is exact, so the running min is the same bits however it is split
// into blocks, as long as every combine keeps the earlier operand on the
// left (the first NaN in the order wins, and of equal values the last, as
// np.minimum.accumulate keeps them).
//
// Build with contraction off (nvcc --fmad=false, g++ -ffp-contract=off).
#pragma once

#include <math.h>
#include <stdint.h>

#include "lrt.cuh"

namespace sid {

// the host's constants: LONG_DOUBLE_UNDERFLOW_LOG (or -inf: no clamp), the
// prior's logs log(1 - pi) and log(pi)
struct LrtParams {
  double underflow_log;
  double log_prior_hom;
  double log_prior_het;
  int use_prior;
};

// the clamp and, with the prior, the prior added and clamped again
SID_HD void lrt_logs(double log_l_hom, double log_l_het, const LrtParams& p, double* hom,
                     double* het) {
  *hom = clamp_below(log_l_hom, p.underflow_log);
  *het = clamp_below(log_l_het, p.underflow_log);
  if (p.use_prior) {
    *het = clamp_below(add_keep_nan(*het, p.log_prior_het), p.underflow_log);
    *hom = clamp_below(add_keep_nan(*hom, p.log_prior_hom), p.underflow_log);
  }
}

// lrt_pvalues_kernel's row: (p1, p2) with one erfc, z = erfc(0.0) as the
// caller evaluated it. lrt_pair_from's (l1, l2) are (hom, het), so its p1
// is lrt_pvalue(het, hom) and its p2 lrt_pvalue(hom, het).
SID_HD void lrt_row(double log_l_hom, double log_l_het, const LrtParams& p, double z,
                    double* p1, double* p2) {
  double hom, het;
  lrt_logs(log_l_hom, log_l_het, p, &hom, &het);
  lrt_pair_from(hom, het, erfc(sqrt(lrt_pair_arg(hom, het))), z, p1, p2);
}

// the same pair with two erfc
SID_HD void lrt_pair_two_erfc(double log_l_hom, double log_l_het, const LrtParams& p,
                              double* p1, double* p2) {
  double hom, het;
  lrt_logs(log_l_hom, log_l_het, p, &hom, &het);
  *p1 = lrt_pvalue(het, hom);
  *p2 = lrt_pvalue(hom, het);
}

// s[i] of the sorted order: the raw p at i = 0 (stats.cpp:74), a NaN as it
// is, else (p * m) / (m - i) in that order
SID_HD double bh_scaled(double p, int64_t i, int64_t m) {
  if (i == 0 || p != p) return p;
  return p * static_cast<double>(m) / (static_cast<double>(m) - static_cast<double>(i));
}

// min of an earlier a and a later b as np.minimum takes it: the first NaN
// wins, else a < b ? a : b, so a tie (+0 and -0) gives the later b, as
// np.minimum.accumulate and torch.cummin do
SID_HD double min_first_nan(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

SID_HD double bh_clamp(double r) { return r > 1.0 ? 1.0 : r; }

}  // namespace sid
