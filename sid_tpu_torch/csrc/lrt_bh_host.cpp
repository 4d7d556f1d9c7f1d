// Host build of the device LRT and BH arithmetic (lrt.cuh, lrt_bh.cuh), so
// the CPU tests can hold the very expressions the card runs against the
// host paths before any card sees them: sid::lrt_pvalue with glibc's erfc
// against libsidtpu's sidtpu_lrt_pvalues, and the BH scan walked as the
// three kernels split it (tiles of `threads` x `items` positions) against
// the host BH.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC \
//       -o liblrt_bh_host.so lrt_bh_host.cpp
#include <math.h>
#include <stdint.h>

#include <vector>

#include "lrt_bh.cuh"

extern "C" {

// out[i] = lrt_pvalue(l0[i], l1[i])
void sid_lrt_pvalue_host(const double* l0, const double* l1, int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = sid::lrt_pvalue(l0[i], l1[i]);
}

// lrt_pvalues_kernel's row loop; params and use_prior as
// sid_lrt_pvalues_launch takes them; p2 may be null
void sid_lrt_pvalues_host(const double* lhom, const double* lhet, int64_t n,
                          const double* params, int use_prior, double* p1, double* p2) {
  const sid::LrtParams lp{params[0], params[1], params[2], use_prior};
  for (int64_t i = 0; i < n; ++i) {
    double a, b;
    sid::lrt_pair(lhom[i], lhet[i], lp, &a, &b);
    p1[i] = a;
    if (p2 != nullptr) p2[i] = b;
  }
}

// The BH passes in the kernels' split: tiles of threads x items positions;
// each tile's min from its threads' mins in thread order; the exclusive min
// of the tiles before each tile; each thread's walk from the tile's prefix
// and the exclusive min of the threads before it. het may be null.
void sid_bh_adjust_host(const double* p, const int64_t* ord, int64_t m, int threads, int items,
                        double alpha, double* out, uint8_t* het) {
  if (m <= 0) return;
  const int64_t tile = static_cast<int64_t>(threads) * items;
  const int64_t n_blocks = (m + tile - 1) / tile;
  auto thread_min = [&](int64_t first) {
    double agg = INFINITY;
    for (int k = 0; k < items && first + k < m; ++k) {
      const int64_t i = first + k;
      agg = sid::min_first_nan(agg, sid::bh_scaled(p[ord[i]], i, m));
    }
    return agg;
  };
  std::vector<double> block_min(n_blocks), prefix(n_blocks);
  for (int64_t b = 0; b < n_blocks; ++b) {
    double agg = INFINITY;
    for (int t = 0; t < threads; ++t) agg = sid::min_first_nan(agg, thread_min((b * threads + t) * items));
    block_min[b] = agg;
  }
  double carry = INFINITY;
  for (int64_t b = 0; b < n_blocks; ++b) {
    prefix[b] = carry;
    carry = sid::min_first_nan(carry, block_min[b]);
  }
  for (int64_t b = 0; b < n_blocks; ++b) {
    double before = INFINITY;  // the threads before t in this tile
    for (int t = 0; t < threads; ++t) {
      const int64_t first = (b * threads + t) * items;
      double run = n_blocks > 1 ? sid::min_first_nan(prefix[b], before) : before;
      for (int k = 0; k < items && first + k < m; ++k) {
        const int64_t i = first + k;
        const int64_t j = ord[i];
        run = sid::min_first_nan(run, sid::bh_scaled(p[j], i, m));
        const double r = sid::bh_clamp(run);
        out[j] = r;
        if (het != nullptr) het[j] = r < alpha ? 1 : 0;
      }
      before = sid::min_first_nan(before, thread_min(first));
    }
  }
}

}  // extern "C"
