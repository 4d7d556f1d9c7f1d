// Host build of the device LRT and BH arithmetic (lrt.cuh, lrt_bh.cuh,
// bh_sort.cuh), so the CPU tests can hold the very expressions the card
// runs against the host paths before any card sees them: sid::lrt_pvalue
// with glibc's erfc against libsidtpu's sidtpu_lrt_pvalues; the LRT
// kernel's grid-stride walk with its one-erfc row against the two-erfc
// form; and BH walked
// as the kernels of lrt_bh.cu split it: the radix order's histogram, plan
// and digit passes over tiles, warps, rounds and lanes; the chained scan
// over tiles with its look-back; the one-block path for one or two arrays.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o liblrt_bh_host.so lrt_bh_host.cpp
#include <math.h>
#include <stdint.h>

#include <vector>

#include "bh_sort.cuh"
#include "lrt_bh.cuh"

namespace {

// block_exclusive_min of lrt_bh.cu over the block's per-thread aggregates,
// shuffle for shuffle: each warp's inclusive scan by doubling, the warps'
// totals the same way, then each thread's exclusive value
std::vector<double> block_exclusive_min(const std::vector<double>& v, double* total) {
  const int n = static_cast<int>(v.size());
  const int warps = n / 32;
  std::vector<double> x(v);
  for (int d = 1; d < 32; d <<= 1) {
    std::vector<double> y(x);
    for (int t = 0; t < n; ++t)
      if (t % 32 >= d) y[t] = sid::min_first_nan(x[t - d], x[t]);
    x = y;
  }
  std::vector<double> w(warps);
  for (int k = 0; k < warps; ++k) w[k] = x[32 * k + 31];
  for (int d = 1; d < warps; d <<= 1) {
    std::vector<double> y(w);
    for (int k = d; k < warps; ++k) y[k] = sid::min_first_nan(w[k - d], w[k]);
    w = y;
  }
  *total = w[warps - 1];
  std::vector<double> out(n);
  for (int t = 0; t < n; ++t) {
    const double before = t % 32 ? x[t - 1] : INFINITY;
    out[t] = t >= 32 ? sid::min_first_nan(w[t / 32 - 1], before) : before;
  }
  return out;
}

// One stable digit pass as bh_radix_pass_kernel walks it over tiles of
// threads x items pairs: warp w of a tile holds positions
// tile * T + w * 32 * items + 32 k + lane; ranks within a warp by rounds,
// then lanes; the bin count of the tiles before a tile is what the
// look-back adds up.
void digit_pass(const std::vector<uint64_t>& kin, const std::vector<uint32_t>& vin, int64_t m, int pass,
                int bits, int threads, int items, const std::vector<uint32_t>& offsets,
                std::vector<uint64_t>& kout, std::vector<uint32_t>& vout) {
  const int bins = 1 << bits, warps = threads / 32;
  const int64_t tile = static_cast<int64_t>(threads) * items;
  std::vector<uint32_t> before(bins, 0);  // the tiles before this one
  for (int64_t first = 0; first < m; first += tile) {
    std::vector<uint32_t> cnt(static_cast<size_t>(warps) * bins, 0), rank(tile, 0);
    for (int w = 0; w < warps; ++w)
      for (int k = 0; k < items; ++k)
        for (int lane = 0; lane < 32; ++lane) {
          const int64_t local = w * 32 * items + 32 * k + lane;
          if (first + local >= m) continue;
          const unsigned d = sid::radix_digit(kin[first + local], pass, bits);
          rank[local] = cnt[w * bins + d]++;
        }
    std::vector<uint32_t> own(bins, 0);
    for (int b = 0; b < bins; ++b)
      for (int w = 0; w < warps; ++w) {
        const uint32_t c = cnt[w * bins + b];
        cnt[w * bins + b] = own[b];
        own[b] += c;
      }
    for (int64_t local = 0; local < tile && first + local < m; ++local) {
      const int w = static_cast<int>(local / (32 * items));
      const unsigned d = sid::radix_digit(kin[first + local], pass, bits);
      const uint32_t at = offsets[pass * bins + d] + before[d] + cnt[w * bins + d] + rank[local];
      kout[at] = kin[first + local];
      vout[at] = vin[first + local];
    }
    for (int b = 0; b < bins; ++b) before[b] += own[b];
  }
}

}  // namespace

extern "C" {

// out[i] = lrt_pvalue(l0[i], l1[i])
void sid_lrt_pvalue_host(const double* l0, const double* l1, int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = sid::lrt_pvalue(l0[i], l1[i]);
}

// The LRT's rows in the two-erfc form (lrt_pair_two_erfc); params and
// use_prior as sid_lrt_pvalues_launch takes them; p2 may be null
void sid_lrt_pvalues_host(const double* lhom, const double* lhet, int64_t n,
                          const double* params, int use_prior, double* p1, double* p2) {
  const sid::LrtParams lp{params[0], params[1], params[2], use_prior};
  for (int64_t i = 0; i < n; ++i) {
    double a, b;
    sid::lrt_pair_two_erfc(lhom[i], lhet[i], lp, &a, &b);
    p1[i] = a;
    if (p2 != nullptr) p2[i] = b;
  }
}

// lrt_pvalues_kernel's grid-stride walk over `threads` threads: thread t
// evaluates z = erfc(0.0) once, then takes rows t, t + threads, ... with
// lrt_row. visits (n bytes, or null) counts the writes of each profile.
void sid_lrt_pvalues_walk_host(const double* lhom, const double* lhet, int64_t n,
                               const double* params, int use_prior, double* p1, double* p2,
                               int64_t threads, uint8_t* visits) {
  const sid::LrtParams lp{params[0], params[1], params[2], use_prior};
  for (int64_t t = 0; t < threads; ++t) {
    const double z = erfc(0.0);
    for (int64_t i = t; i < n; i += threads) {
      double a, b;
      sid::lrt_row(lhom[i], lhet[i], lp, z, &a, &b);
      p1[i] = a;
      if (p2 != nullptr) p2[i] = b;
      if (visits != nullptr) ++visits[i];
    }
  }
}

// bh_radix_key of each p
void sid_bh_radix_keys_host(const double* p, int64_t m, uint64_t* keys) {
  for (int64_t i = 0; i < m; ++i) keys[i] = sid::bh_radix_key(p[i]);
}

// bh_p_of_key of each key: p into out where ok[i] is 1; ok[i] is 0 where
// the key came from a zero or a NaN
void sid_bh_p_of_key_host(const uint64_t* keys, int64_t m, double* out, uint8_t* ok) {
  for (int64_t i = 0; i < m; ++i) ok[i] = sid::bh_p_of_key(keys[i], out + i) ? 1 : 0;
}

// The multi-block radix order of p (bh_histogram_kernel, bh_plan_kernel,
// bh_radix_pass_kernel) with `bits` bits a digit over tiles of threads x
// items pairs: order gets the sorted positions; returns the scatter passes
// run (the digits not the same in every key).
int sid_bh_radix_order_host(const double* p, int64_t m, int bits, int threads, int items,
                            uint32_t* order) {
  if (m <= 0) return 0;
  const int passes = sid::radix_passes(bits), bins = 1 << bits;
  std::vector<uint64_t> key(m);
  std::vector<uint32_t> hist(static_cast<size_t>(passes) * bins, 0);
  for (int64_t i = 0; i < m; ++i) {
    key[i] = sid::bh_radix_key(p[i]);
    for (int q = 0; q < passes; ++q) ++hist[q * bins + sid::radix_digit(key[i], q, bits)];
  }
  std::vector<uint32_t> offsets(hist.size());
  std::vector<int> trivial(passes);
  for (int q = 0; q < passes; ++q) {
    uint32_t run = 0;
    for (int b = 0; b < bins; ++b) {
      offsets[q * bins + b] = run;
      run += hist[q * bins + b];
    }
    trivial[q] = hist[q * bins + sid::radix_digit(key[0], q, bits)] == static_cast<uint32_t>(m);
  }
  std::vector<uint64_t> keys[2] = {std::vector<uint64_t>(m), std::vector<uint64_t>(m)};
  std::vector<uint32_t> vals[2] = {std::vector<uint32_t>(m), std::vector<uint32_t>(m)};
  std::vector<uint32_t> ident(m);
  for (int64_t i = 0; i < m; ++i) ident[i] = static_cast<uint32_t>(i);
  for (int q = 0; q < passes; ++q) {
    if (trivial[q]) continue;
    const int k = sid::radix_rank_of_pass(trivial.data(), q);
    const std::vector<uint64_t>& kin = k ? keys[(k - 1) & 1] : key;
    const std::vector<uint32_t>& vin = k ? vals[(k - 1) & 1] : ident;
    digit_pass(kin, vin, m, q, bits, threads, items, offsets, keys[k & 1], vals[k & 1]);
  }
  const int done = sid::radix_rank_of_pass(trivial.data(), passes);
  const std::vector<uint32_t>& out = done ? vals[(done - 1) & 1] : ident;
  for (int64_t i = 0; i < m; ++i) order[i] = out[i];
  return done;
}

// bh_scan_kernel over the order (m int64) in tiles of threads x items
// positions, in tile order; `lag` makes the look-back find the last `lag`
// tiles before each tile with their aggregates only, so it walks through
// them. het may be null.
void sid_bh_scan_host(const double* p, const int64_t* ord, int64_t m, int threads, int items, int lag,
                      double alpha, double* out, uint8_t* het) {
  if (m <= 0) return;
  const int64_t tile = static_cast<int64_t>(threads) * items;
  const int64_t tiles = (m + tile - 1) / tile;
  std::vector<double> agg(tiles), incl(tiles);
  for (int64_t b = 0; b < tiles; ++b) {
    const int64_t first = b * tile;
    std::vector<double> s(tile, INFINITY), thread_agg(threads, INFINITY);
    for (int t = 0; t < threads; ++t)
      for (int k = 0; k < items; ++k) {
        const int64_t i = first + static_cast<int64_t>(t) * items + k;
        if (i >= m) continue;
        s[t * items + k] = sid::bh_scaled(p[ord[i]], i, m);
        thread_agg[t] = sid::min_first_nan(thread_agg[t], s[t * items + k]);
      }
    double tile_agg;
    const std::vector<double> before = block_exclusive_min(thread_agg, &tile_agg);
    double excl = INFINITY;
    for (int64_t j = b - 1; j >= 0; --j) {
      if (b - j > lag) {
        excl = sid::min_first_nan(incl[j], excl);
        break;
      }
      excl = sid::min_first_nan(agg[j], excl);
    }
    agg[b] = tile_agg;
    incl[b] = sid::min_first_nan(excl, tile_agg);
    for (int t = 0; t < threads; ++t) {
      double run = sid::min_first_nan(excl, before[t]);
      for (int k = 0; k < items; ++k) {
        const int64_t i = first + static_cast<int64_t>(t) * items + k;
        if (i >= m) continue;
        const int64_t j = ord[i];
        run = sid::min_first_nan(run, s[t * items + k]);
        const double r = sid::bh_clamp(run);
        out[j] = r;
        if (het != nullptr) het[j] = r < alpha ? 1 : 0;
      }
    }
  }
}

// bh_small_kernel's block over each of n_arrays (1 or 2) arrays of m <=
// kSmallMax p-values: p[a] into out[a] and, when het[a] is not null, het[a].
// Returns the digit passes run over the last array, or -1 if m is too large.
int sid_bh_small_host(int n_arrays, const double* const* p, int64_t m, double alpha, double* const* out,
                      uint8_t* const* het) {
  if (m > sid::kSmallMax) return -1;
  int done = 0;
  for (int a = 0; a < n_arrays && m > 0; ++a) {
    const int bits = sid::kSmallBits, bins = 1 << bits, passes = sid::radix_passes(bits);
    const int warps = sid::small_ranking_warps(m);
    std::vector<uint32_t> idx[2] = {std::vector<uint32_t>(m), std::vector<uint32_t>(m)};
    std::vector<uint32_t> hist(static_cast<size_t>(passes) * bins, 0);
    for (int64_t i = 0; i < m; ++i) {
      idx[0][i] = static_cast<uint32_t>(i);
      const uint64_t key = sid::bh_radix_key(p[a][i]);
      for (int q = 0; q < passes; ++q) ++hist[q * bins + sid::radix_digit(key, q, bits)];
    }
    const uint64_t key0 = sid::bh_radix_key(p[a][0]);
    const int64_t seg = sid::small_warp_positions(m);
    int cur = 0;
    done = 0;
    for (int q = 0; q < passes; ++q) {
      if (hist[q * bins + sid::radix_digit(key0, q, bits)] == static_cast<uint32_t>(m)) continue;
      std::vector<uint32_t> cnt(static_cast<size_t>(warps) * bins, 0), rank(m, 0), bin_off(bins, 0);
      for (int w = 0; w < warps; ++w)
        for (int64_t r = 0; r < seg / 32; ++r)
          for (int lane = 0; lane < 32; ++lane) {
            const int64_t i = w * seg + 32 * r + lane;
            if (i >= m) continue;
            const unsigned d = sid::radix_digit(sid::bh_radix_key(p[a][idx[cur][i]]), q, bits);
            rank[i] = cnt[w * bins + d]++;
          }
      for (int b = 0; b < bins; ++b)
        for (int w = 0; w < warps; ++w) {
          const uint32_t c = cnt[w * bins + b];
          cnt[w * bins + b] = bin_off[b];
          bin_off[b] += c;
        }
      uint32_t run = 0;
      for (int b = 0; b < bins; ++b) {
        const uint32_t c = bin_off[b];
        bin_off[b] = run;
        run += c;
      }
      for (int64_t i = 0; i < m; ++i) {
        const int w = static_cast<int>(i / seg);
        const unsigned d = sid::radix_digit(sid::bh_radix_key(p[a][idx[cur][i]]), q, bits);
        idx[cur ^ 1][bin_off[d] + cnt[w * bins + d] + rank[i]] = idx[cur][i];
      }
      cur ^= 1;
      ++done;
    }
    const int threads = sid::kSmallThreads, items = sid::kSmallItems;
    std::vector<double> s(static_cast<size_t>(threads) * items, INFINITY), thread_agg(threads, INFINITY);
    for (int64_t i = 0; i < m; ++i) {
      s[i] = sid::bh_scaled(p[a][idx[cur][i]], i, m);
      thread_agg[i / items] = sid::min_first_nan(thread_agg[i / items], s[i]);
    }
    double total;
    const std::vector<double> before = block_exclusive_min(thread_agg, &total);
    for (int t = 0; t < threads; ++t) {
      double run_min = before[t];
      for (int k = 0; k < items; ++k) {
        const int64_t i = static_cast<int64_t>(t) * items + k;
        if (i >= m) continue;
        const uint32_t j = idx[cur][i];
        run_min = sid::min_first_nan(run_min, s[i]);
        const double r = sid::bh_clamp(run_min);
        out[a][j] = r;
        if (het[a] != nullptr) het[a][j] = r < alpha ? 1 : 0;
      }
    }
  }
  return done;
}

// the layout's total bytes: sort 1 for a multi-block BH with the hand
// order, 0 for a scan over a given order (sid_bh_scratch_bytes)
int64_t sid_bh_layout_bytes_host(int64_t m, int sort) { return sid::bh_layout(m, sort != 0).total; }

// the header's constants: kSortTile, kScanTile, kSmallMax, kSmallBits,
// kSortBits
void sid_bh_constants_host(int64_t* out) {
  out[0] = sid::kSortTile;
  out[1] = sid::kScanTile;
  out[2] = sid::kSmallMax;
  out[3] = sid::kSmallBits;
  out[4] = sid::kSortBits;
}

}  // extern "C"
