// Host build of the quality finalize kernels' per-site arithmetic
// (quality_finalize.cuh), looped over arrays as the kernels walk them, so the
// CPU tests can hold the very expressions the card runs against the torch
// f64 version and libsidtpu's host pass before any card sees them: the het
// side's rows, the full form's sites in the two-erfc form, and the full
// form's grid-stride walk with its one-erfc row.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC \
//       -o libquality_finalize_host.so quality_finalize_host.cpp
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "quality_finalize.cuh"

extern "C" {

// counts (n, 4) uint16; alleles, log_het, params and use_prior as
// sid_quality_finalize_launch takes them; out: n f64; returns the misses.
uint32_t sid_quality_finalize_rows_host(const uint16_t* counts, const uint8_t* alleles,
                                        const double* log_het, int64_t n,
                                        const double* params, int use_prior,
                                        const double* tab, int tab_len, double* out) {
  const sid::QualityParams p{params[0], params[1], params[2], use_prior};
  uint32_t misses = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t word[2];
    memcpy(word, counts + 4 * i, sizeof(word));
    bool miss;
    out[i] = sid::quality_het_row(word[0], word[1], alleles[i], log_het[i], p, tab, tab_len,
                                  &miss);
    misses += miss;
  }
  return misses;
}

// The full form's sites in the two-erfc form (quality_lrt_row_two_erfc):
// as above, plus log_hom (n f64) and lrt: log(1 - prior), alpha; writes p1,
// p2 (n f64 each) and het (n bytes); returns the misses.
uint32_t sid_quality_finalize_lrt_rows_host(const uint16_t* counts, const uint8_t* alleles,
                                            const double* log_het, const double* log_hom,
                                            int64_t n, const double* params, int use_prior,
                                            const double* lrt, const double* tab, int tab_len,
                                            double* p1, double* p2, uint8_t* het) {
  const sid::QualityParams p{params[0], params[1], params[2], use_prior};
  const sid::QualityLrtParams q{lrt[0], lrt[1]};
  uint32_t misses = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t word[2];
    memcpy(word, counts + 4 * i, sizeof(word));
    bool miss;
    het[i] = sid::quality_lrt_row_two_erfc(word[0], word[1], alleles[i], log_hom[i], log_het[i], p,
                                           q, tab, tab_len, &miss, p1 + i, p2 + i);
    misses += miss;
  }
  return misses;
}

// quality_finalize_lrt_kernel's grid-stride walk over `threads` threads:
// thread t evaluates z = erfc(0.0) once, then takes sites t, t + threads,
// ... with quality_lrt_row. Arguments as sid_quality_finalize_lrt_rows_host's;
// visits (n bytes, or null) counts the writes of each site. Returns the
// misses.
uint32_t sid_quality_finalize_lrt_walk_host(const uint16_t* counts, const uint8_t* alleles,
                                            const double* log_het, const double* log_hom,
                                            int64_t n, const double* params, int use_prior,
                                            const double* lrt, const double* tab, int tab_len,
                                            double* p1, double* p2, uint8_t* het, int64_t threads,
                                            uint8_t* visits) {
  const sid::QualityParams p{params[0], params[1], params[2], use_prior};
  const sid::QualityLrtParams q{lrt[0], lrt[1]};
  uint32_t misses = 0;
  for (int64_t t = 0; t < threads; ++t) {
    const double z = erfc(0.0);
    for (int64_t i = t; i < n; i += threads) {
      uint32_t word[2];
      memcpy(word, counts + 4 * i, sizeof(word));
      bool miss;
      het[i] = sid::quality_lrt_row(word[0], word[1], alleles[i], log_hom[i], log_het[i], p, q,
                                    tab, tab_len, z, &miss, p1 + i, p2 + i);
      if (visits != nullptr) ++visits[i];
      misses += miss;
    }
  }
  return misses;
}

}  // extern "C"
