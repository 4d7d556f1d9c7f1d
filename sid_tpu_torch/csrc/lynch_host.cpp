// Host build of the Lynch kernels' per-profile arithmetic, row record and
// fixed-order reduction (lynch.cuh), looped over arrays, so the CPU tests
// can hold the very expressions the card runs against the torch f64 version
// before any card sees them. The objective runs the kernel's chunks block by
// block as a grid of `grid` blocks would take them, then folds the chunk
// sums as the last block does on the card. The grid may not change the
// result. The lanes' objective and marginals run the same way over a
// cohort's record and a table of lane slots, launch by launch: the walk of
// the running lanes' chunks block by block, each lane's chunk sums folded
// when its last chunk is done, and each row of the marginals at its lane's
// scalars.
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

// slot_of over the first `count` slots for each of the n walk chunks js
void sid_lynch_slot_of_host(const void* slots, int count, const int64_t* js, int64_t n, int32_t* out) {
  const sid::LaneSlot* sl = static_cast<const sid::LaneSlot*>(slots);
  for (int64_t i = 0; i < n; ++i) out[i] = sid::slot_of(sl, count, js[i]);
}

int64_t sid_lynch_lane_chunks_host(int64_t rows, int64_t chunk) { return sid::lane_chunks(rows, chunk); }

int sid_lynch_lane_slot_bytes_host() { return static_cast<int>(sizeof(sid::LaneSlot)); }

// The lanes' objective over a cohort's record of n rows, as the launches
// of lynch_nll_lanes_kernel run it with a grid of `grid` blocks: slots,
// n_slots LaneSlot in groups of per_launch (one launch each) whose
// walk_end each count from 0; out (n_slots, 2) in slot order, flags for
// the slots' rows.
void sid_lynch_nll_lanes_host(const double* rec, int64_t n, const void* slots, int n_slots,
                              int per_launch, int grid, uint8_t* flags, double* out) {
  std::vector<double> v(sid::kReduceThreads);
  std::vector<int> c(sid::kReduceThreads);
  for (int first = 0; first < n_slots; first += per_launch) {
    const sid::LaneSlot* sl = static_cast<const sid::LaneSlot*>(slots) + first;
    const int count = n_slots - first < per_launch ? n_slots - first : per_launch;
    const int64_t total = sl[count - 1].walk_end;
    const int64_t blocks = total < grid ? total : grid;
    std::vector<double> part_sum(static_cast<size_t>(total));
    std::vector<int> part_cnt(static_cast<size_t>(total));
    std::vector<int64_t> done(static_cast<size_t>(count), 0);
    for (int64_t b = 0; b < blocks; ++b) {
      for (int64_t j = b; j < total; j += blocks) {
        const int k = sid::slot_of(sl, count, j);
        const int64_t first_chunk = sid::walk_start(sl, k);
        const int64_t n_chunks = sl[k].walk_end - first_chunk;
        for (int t = 0; t < sid::kReduceThreads; ++t)
          v[t] = sid::nll_rows_sum(sl[k].first_row + (j - first_chunk) * sid::kChunk, sl[k].end_row, t,
                                   rec, n, sl[k].s, flags, &c[t]);
        tree_fold(v, c);
        part_sum[static_cast<size_t>(j)] = v[0];
        part_cnt[static_cast<size_t>(j)] = c[0];
        if (++done[k] < n_chunks) continue;
        // the block that completes the lane folds its chunk sums
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
        out[2 * (first + k)] = v[0];
        out[2 * (first + k) + 1] = static_cast<double>(c[0]);
        done[k] = 0;
      }
    }
  }
}

// The lanes' marginals over a cohort's record of n rows, as the launches
// of lynch_marginals_lanes_kernel run them with rows_per_thread rows of
// each chunk a thread (slots, whose walk counts chunks of that many rows
// a thread, per_launch and grid as above): each row at its lane's
// scalars.
void sid_lynch_marginals_lanes_host(const double* rec, int64_t n, const void* slots, int n_slots,
                                    int per_launch, int grid, int rows_per_thread, double* lhom,
                                    double* lhet, uint8_t* flags) {
  const int64_t chunk = static_cast<int64_t>(rows_per_thread) * sid::kReduceThreads;
  for (int first = 0; first < n_slots; first += per_launch) {
    const sid::LaneSlot* sl = static_cast<const sid::LaneSlot*>(slots) + first;
    const int count = n_slots - first < per_launch ? n_slots - first : per_launch;
    const int64_t total = sl[count - 1].walk_end;
    const int64_t blocks = total < grid ? total : grid;
    for (int64_t b = 0; b < blocks; ++b) {
      for (int64_t j = b; j < total; j += blocks) {
        const int k = sid::slot_of(sl, count, j);
        const int64_t row0 = sl[k].first_row + (j - sid::walk_start(sl, k)) * chunk;
        for (int r = 0; r < rows_per_thread; ++r) {
          for (int t = 0; t < sid::kReduceThreads; ++t) {
            const int64_t i = row0 + static_cast<int64_t>(r) * sid::kReduceThreads + t;
            if (i >= sl[k].end_row) continue;
            bool f;
            const sid::Components m = sid::marginals_row(sid::read_record(rec, n, i), sl[k].s, &f);
            lhom[i] = m.lhom;
            lhet[i] = m.lhet;
            flags[i] = f ? 1 : 0;
          }
        }
      }
    }
  }
}

}  // extern "C"
