// The likelihood-ratio test on log likelihoods, shared by every kernel of
// the fused on-device LRT (local_classify.cu, quality_finalize.cu,
// lrt_bh.cu) and by their g++ host builds.
//
// likelihoodRatioTest (stats.cpp:29-37) on logs, in libsidtpu's arithmetic
// (csrc/host/parser.cpp, sidtpu_lrt_pvalues):
//   d = l1 - l0
//   m = max(0, d), NaN propagating (not fmax, which drops a NaN, unlike
//       np.maximum and jnp.maximum)
//   p = erfc(sqrt(m))                 (chisq = 2m, Q(chisq, 1) = erfc(sqrt(chisq/2)))
//   p = 0 where l0 is -inf            (l0 == 0 in linear space)
// Under g++ erfc is glibc's, so the host build is bitwise
// sidtpu_lrt_pvalues; on the card it is CUDA's erfc, a few ulps from
// glibc's, so the card is held to the host by a stated tolerance.
//
// A NaN log comes out as the NaN itself: x86's subtract, sqrt and glibc's
// erfc pass the first NaN operand through, sign and all, and the CSV writer
// prints a negative NaN as -nan; the card's arithmetic need not keep a NaN's
// sign, so the NaN is returned without arithmetic.
//
// Build with contraction off (nvcc --fmad=false, g++ -ffp-contract=off).
#pragma once

#include <math.h>

#ifndef SID_HD
#ifdef __CUDACC__
#define SID_HD __host__ __device__ __forceinline__
#else
#define SID_HD inline
#endif
#endif

namespace sid {

// p-value of H0 (log likelihood l0) against H1 (l1)
SID_HD double lrt_pvalue(double l0, double l1) {
  if (l0 == -INFINITY) return 0.0;
  if (l1 != l1) return l1;
  if (l0 != l0) return l0;
  const double d = l1 - l0;
  const double m = (d > 0.0 || d != d) ? d : 0.0;
  return erfc(sqrt(m));
}

// lrt_pvalue's special cases in its order, else v
SID_HD double lrt_special_or(double l0, double l1, double v) {
  if (l0 == -INFINITY) return 0.0;
  if (l1 != l1) return l1;
  if (l0 != l0) return l0;
  return v;
}

// (lrt_pvalue(l2, l1), lrt_pvalue(l1, l2)) with one erfc. With d = l1 - l2,
// the first takes erfc(sqrt(max(0, d))) and the second
// erfc(sqrt(max(0, -d))), -d being l2 - l1 exactly; they cannot both be
// positive, so one erfc(sqrt(a)) serves the side that is, and the other
// takes z, erfc(0.0) as the caller evaluated it. d is NaN only where both
// logs are +inf (a NaN or -inf log is a special case), and then both sides
// take erfc(sqrt(d)) of the same NaN, as the two calls would.
// lrt_pair_arg gives a, lrt_pair_from the two p-values from e =
// erfc(sqrt(a)).
SID_HD double lrt_pair_arg(double l1, double l2) {
  const double d = l1 - l2;
  return (d > 0.0 || d != d) ? d : (d < 0.0 ? -d : 0.0);
}

SID_HD void lrt_pair_from(double l1, double l2, double e, double z, double* p1, double* p2) {
  const double d = l1 - l2;
  const bool nan = d != d;
  *p1 = lrt_special_or(l2, l1, (d > 0.0 || nan) ? e : z);
  *p2 = lrt_special_or(l1, l2, (d < 0.0 || nan) ? e : z);
}

// x + y where x may be NaN: x86's add passes the NaN through with its sign;
// the card's need not, so a NaN x is returned as it is
SID_HD double add_keep_nan(double x, double y) { return x != x ? x : x + y; }

// the reference's long doubles underflow to exactly 0 below this line
// (LONG_DOUBLE_UNDERFLOW_LOG): a select, so a NaN stays NaN
SID_HD double clamp_below(double l, double line) { return l < line ? -INFINITY : l; }

}  // namespace sid
