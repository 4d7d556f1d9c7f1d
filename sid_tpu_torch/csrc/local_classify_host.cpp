// Host build of the kernel's per-profile arithmetic (local_classify.cuh),
// looped over arrays, so the CPU tests can hold the very expressions the
// card runs against the torch f64 twin before any card sees them.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC \
//       -o liblocal_classify_host.so local_classify_host.cpp
#include <stdint.h>

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

double sid_long_double_underflow_log() { return sid::kLongDoubleUnderflowLog; }

}  // extern "C"
