// Host build of the Lynch kernels' per-profile arithmetic, row record and
// fixed-order reduction (lynch.cuh), looped over arrays, so the CPU tests
// can hold the very expressions the card runs against the torch f64 version
// before any card sees them. The objective runs the kernel's chunks block by
// block as a grid of `grid` blocks would take them, then folds the chunk
// sums as the last block does on the card. The grid may not change the
// result. The lanes' objective and marginals run the same way over a
// cohort's record: the chunks of the running lanes block by block, each
// lane's chunk sums folded when its last chunk is done, and each row of the
// marginals at its lane's scalars.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC \
//       -o liblynch_host.so lynch_host.cpp
#include <stdint.h>
#include <string.h>

#include <vector>

#include "lynch.cuh"

namespace {

sid::LynchScalars unpack(const double* scalars) {
  sid::LynchScalars s;
  memcpy(&s, scalars, sizeof(s));
  return s;
}

void tree_fold(std::vector<double>& v, std::vector<int>& c) {
  for (int s = sid::kReduceThreads / 2; s > 0; s >>= 1) {
    for (int t = 0; t < s; ++t) {
      v[t] = v[t] + v[t + s];
      c[t] = c[t] + c[t + s];
    }
  }
}

}  // namespace

extern "C" {

int sid_lynch_chunk_rows_host() { return sid::kChunk; }

// lynch_row from the counts and the table: lhom, lhet, log_mix (f64) and
// the two flags, and m (log_multinomial)
void sid_lynch_rows_host(const int32_t* prof, const double* scalars,
                         const double* tab, int tab_len, int64_t n,
                         double* lhom, double* lhet, double* log_mix,
                         uint8_t* flag_marginals, uint8_t* flag_mixture,
                         double* m) {
  const sid::LynchScalars s = unpack(scalars);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* p = prof + 4 * i;
    const sid::LynchRow r = sid::lynch_row(p[0], p[1], p[2], p[3], s, tab, tab_len);
    lhom[i] = r.lhom;
    lhet[i] = r.lhet;
    log_mix[i] = r.log_mix;
    flag_marginals[i] = r.flag_marginals ? 1 : 0;
    flag_mixture[i] = r.flag_mixture ? 1 : 0;
    m[i] = sid::log_multinomial(p[0], p[1], p[2], p[3], tab, tab_len);
  }
}

// the set-up kernel: rec (3, n) f64 from the counts and multiplicities
void sid_lynch_records_host(const int32_t* prof, const int64_t* mult,
                            const double* tab, int tab_len, int64_t n,
                            double* rec) {
  for (int64_t i = 0; i < n; ++i) {
    int c[4];
    sid::load_profile(prof, i, c);
    sid::write_record(rec, n, i, c[0], c[1], c[2], c[3], mult[i], tab, tab_len);
  }
}

// the record as the kernels read it: the counts, m, the multiplicity and
// the theta-free screen of every row
void sid_lynch_read_records_host(const double* rec, int64_t n, int32_t* counts,
                                 double* m, double* mult, uint8_t* mc_over) {
  for (int64_t i = 0; i < n; ++i) {
    const sid::RowRecord r = sid::read_record(rec, n, i);
    counts[4 * i] = r.c0;
    counts[4 * i + 1] = r.c1;
    counts[4 * i + 2] = r.c2;
    counts[4 * i + 3] = r.c3;
    m[i] = r.m;
    mult[i] = r.mult;
    mc_over[i] = r.mc_over ? 1 : 0;
  }
}

// the objective's and the marginals' row functions over the records:
// log_mix and flag_mixture (mixture_row); lhom, lhet and flag_marginals
// (marginals_row)
void sid_lynch_record_rows_host(const double* rec, int64_t n,
                                const double* scalars, double* log_mix,
                                uint8_t* flag_mixture, double* lhom,
                                double* lhet, uint8_t* flag_marginals) {
  const sid::LynchScalars s = unpack(scalars);
  for (int64_t i = 0; i < n; ++i) {
    const sid::RowRecord r = sid::read_record(rec, n, i);
    bool f;
    log_mix[i] = sid::mixture_row(r, s, &f);
    flag_mixture[i] = f ? 1 : 0;
    const sid::Components k = sid::marginals_row(r, s, &f);
    lhom[i] = k.lhom;
    lhet[i] = k.lhet;
    flag_marginals[i] = f ? 1 : 0;
  }
}

// The objective kernel over the records, with a grid of `grid` blocks: the
// blocks run their chunks (grid-stride) and store their partials, then the
// partials fold in the fixed order. out[0] the sum of the unflagged terms,
// out[1] the flagged count; flags (n,) written per row.
void sid_lynch_nll_host(const double* rec, int64_t n, const double* scalars,
                        int grid, uint8_t* flags, double* out) {
  const sid::LynchScalars s = unpack(scalars);
  const int64_t n_chunks = (n + sid::kChunk - 1) / sid::kChunk;
  std::vector<double> part_sum(static_cast<size_t>(n_chunks));
  std::vector<int> part_cnt(static_cast<size_t>(n_chunks));
  std::vector<double> v(sid::kReduceThreads);
  std::vector<int> c(sid::kReduceThreads);
  for (int b = 0; b < grid; ++b) {
    for (int64_t chunk = b; chunk < n_chunks; chunk += grid) {
      for (int t = 0; t < sid::kReduceThreads; ++t)
        v[t] = sid::nll_thread_sum(chunk, t, rec, n, s, flags, &c[t]);
      tree_fold(v, c);
      part_sum[static_cast<size_t>(chunk)] = v[0];
      part_cnt[static_cast<size_t>(chunk)] = c[0];
    }
  }
  for (int t = 0; t < sid::kReduceThreads; ++t) {
    double acc = 0.0;
    int cnt = 0;
    for (int64_t base = 0; base < n_chunks; base += sid::kReduceThreads) {
      const int64_t i = base + t;
      acc = acc + (i < n_chunks ? part_sum[static_cast<size_t>(i)] : 0.0);
      cnt = cnt + (i < n_chunks ? part_cnt[static_cast<size_t>(i)] : 0);
    }
    v[t] = acc;
    c[t] = cnt;
  }
  tree_fold(v, c);
  out[0] = v[0];
  out[1] = static_cast<double>(c[0]);
}

// lane_of over the first `count` offsets for each of the n values xs
void sid_lynch_lane_of_host(const int64_t* off, int count, const int64_t* xs,
                            int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = sid::lane_of(off, count, xs[i]);
}

int64_t sid_lynch_lane_chunks_host(int64_t rows) { return sid::lane_chunks(rows); }

// The lanes' objective over a cohort's record of n rows, with a grid of
// `grid` blocks, as lynch_nll_lanes_kernel runs it: row_off (n_lanes + 1),
// scalars (n_lanes, 16), the n_active running lanes in increasing order;
// out (n_lanes, 2) written for the running lanes, flags for their rows.
void sid_lynch_nll_lanes_host(const double* rec, int64_t n, const int64_t* row_off,
                              int n_lanes, const double* scalars,
                              const int32_t* active, int n_active, int grid,
                              uint8_t* flags, double* out) {
  std::vector<int64_t> chunk_off(static_cast<size_t>(n_lanes) + 1, 0);
  for (int l = 0; l < n_lanes; ++l)
    chunk_off[l + 1] = chunk_off[l] + sid::lane_chunks(row_off[l + 1] - row_off[l]);
  std::vector<int64_t> act_off(static_cast<size_t>(n_active) + 1, 0);
  for (int a = 0; a < n_active; ++a) {
    const int l = active[a];
    act_off[a + 1] = act_off[a] + (chunk_off[l + 1] - chunk_off[l]);
  }
  std::vector<double> part_sum(static_cast<size_t>(chunk_off[n_lanes]));
  std::vector<int> part_cnt(static_cast<size_t>(chunk_off[n_lanes]));
  std::vector<int64_t> done(static_cast<size_t>(n_lanes), 0);
  std::vector<double> v(sid::kReduceThreads);
  std::vector<int> c(sid::kReduceThreads);
  for (int b = 0; b < grid; ++b) {
    for (int64_t j = b; j < act_off[n_active]; j += grid) {
      const int a = sid::lane_of(act_off.data(), n_active, j);
      const int l = active[a];
      const int64_t local = j - act_off[a];
      const int64_t first_chunk = chunk_off[l];
      const int64_t n_chunks = chunk_off[l + 1] - first_chunk;
      const sid::LynchScalars s = unpack(scalars + 16 * static_cast<int64_t>(l));
      for (int t = 0; t < sid::kReduceThreads; ++t)
        v[t] = sid::nll_rows_sum(row_off[l] + local * sid::kChunk, row_off[l + 1], t, rec, n, s,
                                 flags, &c[t]);
      tree_fold(v, c);
      part_sum[static_cast<size_t>(first_chunk + local)] = v[0];
      part_cnt[static_cast<size_t>(first_chunk + local)] = c[0];
      if (++done[l] < n_chunks) continue;
      for (int t = 0; t < sid::kReduceThreads; ++t) {
        double acc = 0.0;
        int cnt = 0;
        for (int64_t base = 0; base < n_chunks; base += sid::kReduceThreads) {
          const int64_t i = base + t;
          acc = acc + (i < n_chunks ? part_sum[static_cast<size_t>(first_chunk + i)] : 0.0);
          cnt = cnt + (i < n_chunks ? part_cnt[static_cast<size_t>(first_chunk + i)] : 0);
        }
        v[t] = acc;
        c[t] = cnt;
      }
      tree_fold(v, c);
      out[2 * l] = v[0];
      out[2 * l + 1] = static_cast<double>(c[0]);
      done[l] = 0;
    }
  }
}

// The lanes' marginals over a cohort's record of n rows: each row at its
// lane's scalars (row_off (n_lanes + 1), scalars (n_lanes, 16)).
void sid_lynch_marginals_lanes_host(const double* rec, int64_t n, const int64_t* row_off,
                                    int n_lanes, const double* scalars, double* lhom,
                                    double* lhet, uint8_t* flags) {
  for (int64_t i = 0; i < n; ++i) {
    const int l = sid::lane_of(row_off, n_lanes, i);
    const sid::LynchScalars s = unpack(scalars + 16 * static_cast<int64_t>(l));
    bool f;
    const sid::Components k = sid::marginals_row(sid::read_record(rec, n, i), s, &f);
    lhom[i] = k.lhom;
    lhet[i] = k.lhet;
    flags[i] = f ? 1 : 0;
  }
}

}  // extern "C"
