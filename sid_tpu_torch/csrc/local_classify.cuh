// Per-profile arithmetic of the slim `local` classify, shared by the CUDA
// kernel (local_classify.cu) and a g++ host build (local_classify_host.cpp)
// that the CPU tests hold against the torch f64 twin
// (sid_tpu_torch/ops/local_classify.py::local_log_likelihoods_ref).
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
// Every operation is a separate IEEE f64 operation in that order: build
// with contraction off (nvcc --fmad=false, g++ -ffp-contract=off).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SID_HD __host__ __device__ __forceinline__
#else
#define SID_HD inline
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

SID_HD LogLik2 local_log_likelihoods_one(int c0, int c1, int c2, int c3,
                                         int major, int second, double thr,
                                         const double* tab, int tab_len) {
  const int icov = c0 + c1 + c2 + c3;
  const double cov = static_cast<double>(icov);
  const int n1 = pick(c0, c1, c2, c3, major);
  const int n2 = pick(c0, c1, c2, c3, second);
  const double mnom =
      lgamma_at(tab, tab_len, icov + 1) -
      (((lgamma_at(tab, tab_len, c0 + 1) + lgamma_at(tab, tab_len, c1 + 1)) +
        lgamma_at(tab, tab_len, c2 + 1)) +
       lgamma_at(tab, tab_len, c3 + 1));

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

}  // namespace sid
