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
// scalars. A sharded fit's objective on one device walks the device's
// shard table as its launch does, block by block, and folds the fit's
// chunk sums as that launch's last block does. The fit's loop on the card
// (its graph: the start, then rounds of lynch_fit_lanes_kernel while a lane
// runs) runs round by round, each lane's step where its last chunk is
// folded, as the kernel's block does it.
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

// a lane's chunk sums folded as the block that completes it folds them
void fold_lane(const std::vector<double>& part_sum, const std::vector<int>& part_cnt, int64_t first_chunk,
               int64_t n_chunks, std::vector<double>& v, std::vector<int>& c) {
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
}

template <int N>
long long fit_lanes(const double* rec, int64_t n, const sid::FitLane* lanes, int n_lanes, const double* starts,
                    double* scalars, double tol, int max_iterations, int dot_mode, double* history,
                    int64_t history_entries, uint8_t* flags, double* results, int grid) {
  std::vector<sid::FitLaneState<N>> state(static_cast<size_t>(n_lanes));
  for (int i = 0; i < n_lanes; ++i) {
    const double* st = starts + static_cast<int64_t>(i) * (2 * N + 1);
    sid::fit_start(state[i], st, st + N, st[2 * N], tol, max_iterations, dot_mode, scalars + 16 * static_cast<int64_t>(i));
  }
  const int64_t total = lanes[n_lanes - 1].walk_end;
  const int64_t blocks = total < grid ? total : grid;
  std::vector<double> part_sum(static_cast<size_t>(total));
  std::vector<int> part_cnt(static_cast<size_t>(total));
  std::vector<int64_t> done(static_cast<size_t>(n_lanes), 0);
  std::vector<double> v(sid::kReduceThreads);
  std::vector<int> c(sid::kReduceThreads);
  int running = n_lanes;
  long long rounds = 0;
  while (running > 0) {
    ++rounds;
    for (int64_t b = 0; b < blocks; ++b) {
      for (int64_t j = b; j < total; j += blocks) {
        const int k = sid::slot_of(lanes, n_lanes, j);
        const int mode = state[k].mode;
        if (mode == sid::kFitIdle) continue;
        const int64_t first_chunk = sid::walk_start(lanes, k);
        const int64_t n_chunks = lanes[k].walk_end - first_chunk;
        const sid::LynchScalars s = unpack(scalars + 16 * static_cast<int64_t>(k));
        if (mode == sid::kFitRows) {
          for (int t = 0; t < sid::kReduceThreads; ++t)
            v[t] = sid::nll_rows_sum(lanes[k].first_row + (j - first_chunk) * sid::kChunk, lanes[k].end_row, t, rec,
                                     n, s, flags, &c[t]);
          tree_fold(v, c);
          part_sum[static_cast<size_t>(j)] = v[0];
          part_cnt[static_cast<size_t>(j)] = c[0];
        }
        if (++done[k] < n_chunks) continue;
        done[k] = 0;
        double acc = 0.0;
        int cnt = 0;
        if (mode == sid::kFitRows) {
          fold_lane(part_sum, part_cnt, first_chunk, n_chunks, v, c);
          acc = v[0];
          cnt = c[0];
        }
        const int64_t kk = k;
        if (sid::fit_take(state[k], acc, cnt, scalars + 16 * kk, history + kk * history_entries * sid::kHistoryWidth<N>,
                          results + kk * sid::kResultWidth<N>))
          --running;
      }
    }
  }
  return rounds;
}

// the fold of n_chunks chunk sums as one block does it: the threads'
// shares (fold_thread_sum), then the tree
void fold_chunks(const double* part_sum, const int* part_cnt, int64_t n_chunks, double* out) {
  std::vector<double> v(sid::kReduceThreads);
  std::vector<int> c(sid::kReduceThreads);
  for (int t = 0; t < sid::kReduceThreads; ++t) v[t] = sid::fold_thread_sum(part_sum, part_cnt, n_chunks, t, &c[t]);
  tree_fold(v, c);
  out[0] = v[0];
  out[1] = static_cast<double>(c[0]);
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
  fold_chunks(part_sum.data(), part_cnt.data(), n_chunks, out);
}

int sid_lynch_shard_slot_bytes_host() { return static_cast<int>(sizeof(sid::ShardSlot)); }

// A sharded fit's objective on one device, as its launch of
// lynch_nll_shards_kernel runs it with a grid of `grid` blocks: table,
// n_shards ShardSlot (host pointers) whose chunks the blocks walk
// grid-stride, each chunk's sum and flagged count into part_sum, part_cnt
// at its global index and the rows' flags into its shard's; then with fold
// the n_chunks chunk sums of the whole fit folded into out[0] (the sum)
// and out[1] (the flagged count) as the last block folds them.
void sid_lynch_nll_shards_host(const void* table, int n_shards, const double* scalars, double* part_sum,
                               int32_t* part_cnt, int64_t n_chunks, int fold, int grid, double* out) {
  const sid::LynchScalars s = unpack(scalars);
  const sid::ShardSlot* sl = static_cast<const sid::ShardSlot*>(table);
  const int64_t total = n_shards > 0 ? sl[n_shards - 1].walk_end : 0;
  std::vector<double> v(sid::kReduceThreads);
  std::vector<int> c(sid::kReduceThreads);
  for (int b = 0; b < grid; ++b) {
    for (int64_t j = b; j < total; j += grid) {
      int64_t chunk = 0;
      for (int t = 0; t < sid::kReduceThreads; ++t) v[t] = sid::shard_chunk_sum(sl, n_shards, j, t, s, &c[t], &chunk);
      tree_fold(v, c);
      part_sum[chunk] = v[0];
      part_cnt[chunk] = c[0];
    }
  }
  if (fold) fold_chunks(part_sum, part_cnt, n_chunks, out);
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

int sid_lynch_fit_lane_bytes_host() { return static_cast<int>(sizeof(sid::FitLane)); }

// The fit's loop on the card, as its graph runs it with a grid of `grid`
// blocks a round (lynch.cu sid_lynch_fit_graph_create): lanes (n_lanes)
// FitLane over a record of n rows; starts (n_lanes, 2 dims + 1): x0, step,
// the fixed epsilon of a 1-D fit; scalars (n_lanes, 16), the eleven fixed
// ones in place (the five theta ones written); history (n_lanes,
// history_entries, dims + 2); results (n_lanes, dims + 5); flags (n,).
// Returns the rounds (the kernel's launches).
long long sid_lynch_fit_lanes_host(int dims, const double* rec, int64_t n, const void* lanes, int n_lanes,
                                   const double* starts, double* scalars, double tol, int max_iterations,
                                   int dot_mode, double* history, int64_t history_entries, uint8_t* flags,
                                   double* results, int grid) {
  const sid::FitLane* fl = static_cast<const sid::FitLane*>(lanes);
  if (dims == 1)
    return fit_lanes<1>(rec, n, fl, n_lanes, starts, scalars, tol, max_iterations, dot_mode, history,
                        history_entries, flags, results, grid);
  return fit_lanes<2>(rec, n, fl, n_lanes, starts, scalars, tol, max_iterations, dot_mode, history,
                      history_entries, flags, results, grid);
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
