// Per-profile arithmetic of the Lynch fit, shared by the CUDA kernels
// (lynch.cu) and a g++ host build (lynch_host.cpp) that the CPU tests hold
// against the torch f64 version (sid_tpu_torch/ops/likelihoods.py).
//
// Per profile (counts c0..c3, cov = sum c), with the theta-dependent scalars
// computed once per evaluation on the host (LynchScalars):
//   m     = lgamma[cov+1] - (((lgamma[c0+1] + lgamma[c1+1]) + lgamma[c2+1]) + lgamma[c3+1])
//   t_i   = (log nt_i + xlogy(c_i, log1p(-e))) + xlogy(cov - c_i, log(e/3))           i = 0..3
//   u_ij  = (log(nt_i nt_j) + xlogy(c_i + c_j, log((1-2e/3)/2))) + xlogy(cov - c_i - c_j, log(e/3))
//   lhom  = m + LSE_i t_i
//   lhet  = (m + LSE_{i<j} u_ij) - log1p(-sum nt^2)
//   log_mix = logaddexp(log1p(-pi) + lhom, log(pi) + lhet)
// with LSE and logaddexp as the installed JAX writes them (max shift, the
// isfinite guard on the shift, log1p(exp(-|d|)), NaN-propagating max) and the
// exp terms summed left to right (sid_tpu/ops/likelihoods.py:33-165).
//
// The long-double range screen (fault C2 in ROADMAP.md). The reference
// evaluates the same row in linear 80-bit long double: mc = expl(m), powers
// from powl, products and sums, then logl of the mixture, skipping rows whose
// mixture is not > 0 (lynch.cpp:37-61). Where a factor that decides a value
// leaves the normal long-double range, that evaluation is not the log-space
// one: mc overflows to inf (inf * 0 = NaN, the row is skipped), or the
// dominant term's powers underflow to 0. The screen flags a row when
//   - m > kSafeMax (mc may overflow), or
//   - a component (hom, het) that is not negligible in the mixture is out of
//     range: its dominant term below kSafeMin, or its value outside
//     [kSafeMin, kSafeMax], or
//   - the mixture itself is finite and outside [kSafeMin, kSafeMax].
// Every partial product of a term is >= the term (all its factors are <= 1),
// so the dominant term's log bounds each of its powers and partial products.
// A component is negligible when an upper bound on its long-double value is
// kNegligible nats below the mixture (or its weight is exactly 0). An exact
// zero (-inf in log space) is an exact zero in long double too and is never
// flagged; neither is a NaN that the log-space version has (sum nt^2 == 1).
// The marginals' screen is the component part alone, on both components.
//
// The per-fit row record. A fit evaluates the same rows ~100 times, so what
// does not depend on theta is computed once, by a set-up kernel: m (five
// table reads and four adds), the counts packed as four uint16, the
// multiplicity as f64 and the theta-free part of the screen (m > kSafeMax).
// The objective (mixture_row) and the marginals (marginals_row) then read
// 24 bytes a row and no table. lynch_row, the whole row from the counts and
// the table, is built from the same pieces.
//
// Every operation is a separate IEEE f64 operation in the order written:
// build with contraction off (nvcc --fmad=false, g++ -ffp-contract=off).
#pragma once

#include <math.h>
#include <stdint.h>

#include "local_classify.cuh"
#include "nmsimplex.cuh"

#ifdef __CUDA_ARCH__
#define SID_NO_UNROLL _Pragma("unroll 1")
#else
#define SID_NO_UNROLL
#endif

namespace sid {

// natural logs of the 80-bit long-double range: largest finite just under
// 2^16384, smallest normal 2^-16382; the margins are far wider than rounding
constexpr double kLdLogMax = 16384.0 * 0.69314718055994530942;
constexpr double kLdLogMinNormal = -16382.0 * 0.69314718055994530942;
constexpr double kMargin = 64.0;
constexpr double kSafeMax = kLdLogMax - kMargin;
constexpr double kSafeMin = kLdLogMinNormal + kMargin;
constexpr double kNegligible = 64.0;
// log 4 and log 6: the number of terms in each component's sum
constexpr double kLog4 = 1.3862943611198906;
constexpr double kLog6 = 1.791759469228055;

// Theta-dependent scalars, computed on the host in f64 (glibc) once per
// evaluation; layout = 16 doubles (ops/likelihoods.py lynch_scalars).
struct LynchScalars {
  double log_match_hom;     // log1p(-e)
  double log_err;           // log(e / 3)
  double log_match_het;     // log((1 - 2/3 e) / 2)
  double log_one_minus_pi;  // log1p(-pi)
  double log_pi;            // log(pi)
  double log_denom;         // log1p(-sum nt^2)
  double log_nt[4];         // log nt_i
  double log_w[6];          // log(nt_i * nt_j), pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
};

struct LynchRow {
  double lhom;
  double lhet;
  double log_mix;
  bool flag_marginals;  // the long-double marginals may differ
  bool flag_mixture;    // the long-double objective term may differ
};

// the two components of a row: their logs and largest terms (before the
// isfinite guard)
struct Components {
  double lhom;
  double lhet;
  double amax_hom;
  double amax_het;
};

// max that returns NaN when either input is NaN (XLA's max)
SID_HD double nan_max(double a, double b) {
  return (a != a || a > b) ? a : b;
}

SID_HD double logaddexp(double x1, double x2) {
  const double amax = nan_max(x1, x2);
  const double delta = x1 - x2;
  return delta != delta ? x1 + x2 : amax + log1p(exp(-fabs(delta)));
}

// log sum exp t_k over k < n, returning the max term too (before the guard)
template <int N>
SID_HD double logsumexp(const double (&t)[N], double* amax_out) {
  double amax = t[0];
  for (int k = 1; k < N; ++k) amax = nan_max(amax, t[k]);
  *amax_out = amax;
  const double shift = isfinite(amax) ? amax : 0.0;
  double s = exp(t[0] - shift);
  for (int k = 1; k < N; ++k) s = s + exp(t[k] - shift);
  return log(fabs(s)) + shift;
}

// the component is in range in long double: an exact zero, or a
// dominant term and a value inside the safe band
SID_HD bool component_ok(double amax, double value) {
  if (amax == -INFINITY) return true;
  return amax >= kSafeMin && value >= kSafeMin && value <= kSafeMax;
}

// negligible in the mixture: its weight is exactly 0, or an upper bound on
// its long-double value (terms no larger than the smallest normal each,
// times mc, over the denominator) sits kNegligible nats below the mixture
SID_HD bool component_negligible(double log_weight, double m, double amax,
                                 double log_n_terms, double log_denom,
                                 double log_mix) {
  if (log_weight == -INFINITY) return true;
  const double top = amax > kLdLogMinNormal ? amax : kLdLogMinNormal;
  const double bound = log_weight + (((m + log_n_terms) + top) - log_denom);
  return bound < log_mix - kNegligible;
}

SID_HD double log_multinomial(int c0, int c1, int c2, int c3,
                              const double* tab, int tab_len) {
  const int icov = c0 + c1 + c2 + c3;
  return lgamma_at(tab, tab_len, icov + 1) -
         (((lgamma_at(tab, tab_len, c0 + 1) + lgamma_at(tab, tab_len, c1 + 1)) +
           lgamma_at(tab, tab_len, c2 + 1)) +
          lgamma_at(tab, tab_len, c3 + 1));
}

SID_HD double hom_term(int c, int icov, double log_nt, const LynchScalars& s) {
  return (log_nt + xlogy(c, s.log_match_hom)) + xlogy(icov - c, s.log_err);
}

SID_HD double het_term(int n, int icov, double log_w, const LynchScalars& s) {
  return (log_w + xlogy(n, s.log_match_het)) + xlogy(icov - n, s.log_err);
}

SID_HD Components lynch_components(int c0, int c1, int c2, int c3, double m,
                                   const LynchScalars& s) {
  const int icov = c0 + c1 + c2 + c3;
  const double th[4] = {
      hom_term(c0, icov, s.log_nt[0], s), hom_term(c1, icov, s.log_nt[1], s),
      hom_term(c2, icov, s.log_nt[2], s), hom_term(c3, icov, s.log_nt[3], s)};
  const double tp[6] = {
      het_term(c0 + c1, icov, s.log_w[0], s), het_term(c0 + c2, icov, s.log_w[1], s),
      het_term(c0 + c3, icov, s.log_w[2], s), het_term(c1 + c2, icov, s.log_w[3], s),
      het_term(c1 + c3, icov, s.log_w[4], s), het_term(c2 + c3, icov, s.log_w[5], s)};
  Components k;
  k.lhom = m + logsumexp(th, &k.amax_hom);
  k.lhet = (m + logsumexp(tp, &k.amax_het)) - s.log_denom;
  return k;
}

SID_HD double mixture_log(const Components& k, const LynchScalars& s) {
  return logaddexp(s.log_one_minus_pi + k.lhom, s.log_pi + k.lhet);
}

SID_HD bool marginals_flag(bool mc_over, const Components& k) {
  return mc_over || !component_ok(k.amax_hom, k.lhom) ||
         !component_ok(k.amax_het, k.lhet);
}

SID_HD bool mixture_flag(bool mc_over, double m, const Components& k,
                         double log_mix, const LynchScalars& s) {
  const bool hom_decides =
      !component_ok(k.amax_hom, k.lhom) &&
      !component_negligible(s.log_one_minus_pi, m, k.amax_hom, kLog4, 0.0, log_mix);
  const bool het_decides =
      !component_ok(k.amax_het, k.lhet) &&
      !component_negligible(s.log_pi, m, k.amax_het, kLog6, s.log_denom, log_mix);
  const bool mix_out = isfinite(log_mix) && (log_mix < kSafeMin || log_mix > kSafeMax);
  return mc_over || mix_out || hom_decides || het_decides;
}

// the whole row from its counts and the lgamma table
SID_HD LynchRow lynch_row(int c0, int c1, int c2, int c3,
                          const LynchScalars& s, const double* tab,
                          int tab_len) {
  const double m = log_multinomial(c0, c1, c2, c3, tab, tab_len);
  const bool mc_over = m > kSafeMax;
  const Components k = lynch_components(c0, c1, c2, c3, m, s);
  LynchRow r;
  r.lhom = k.lhom;
  r.lhet = k.lhet;
  r.log_mix = mixture_log(k, s);
  r.flag_marginals = marginals_flag(mc_over, k);
  r.flag_mixture = mixture_flag(mc_over, m, k, r.log_mix, s);
  return r;
}

// ---- the row record ----
// Three planes of n entries of 8 bytes (structure of arrays, 24 bytes a
// row, one coalesced 8-byte load per plane):
//   plane 0  m, log_multinomial of the row (the same expression, so the
//            same bits);
//   plane 1  the multiplicity as f64, its sign bit set where m > kSafeMax
//            (multiplicities are >= 0, so the bit is free);
//   plane 2  the bits of a uint64: c0 | c1 << 16 | c2 << 32 | c3 << 48
//            (counts 0..65535).
constexpr int kRecordPlanes = 3;

struct RowRecord {
  int c0, c1, c2, c3;
  double m;
  double mult;   // the multiplicity, f64
  bool mc_over;  // m > kSafeMax: the theta-free part of the screen
};

SID_HD void write_record(double* rec, int64_t n, int64_t i, int c0, int c1,
                         int c2, int c3, int64_t mult, const double* tab,
                         int tab_len) {
  const double m = log_multinomial(c0, c1, c2, c3, tab, tab_len);
  const double w = static_cast<double>(mult);
  rec[i] = m;
  rec[n + i] = m > kSafeMax ? -w : w;
  reinterpret_cast<uint64_t*>(rec + 2 * n)[i] =
      static_cast<uint64_t>(static_cast<uint16_t>(c0)) |
      static_cast<uint64_t>(static_cast<uint16_t>(c1)) << 16 |
      static_cast<uint64_t>(static_cast<uint16_t>(c2)) << 32 |
      static_cast<uint64_t>(static_cast<uint16_t>(c3)) << 48;
}

SID_HD RowRecord read_record(const double* rec, int64_t n, int64_t i) {
#ifdef __CUDA_ARCH__
  const double m = __ldg(rec + i);
  const double w = __ldg(rec + n + i);
  const uint64_t q = __ldg(reinterpret_cast<const unsigned long long*>(rec + 2 * n) + i);
#else
  const double m = rec[i];
  const double w = rec[n + i];
  const uint64_t q = reinterpret_cast<const uint64_t*>(rec + 2 * n)[i];
#endif
  RowRecord r;
  r.c0 = static_cast<int>(q & 0xffff);
  r.c1 = static_cast<int>((q >> 16) & 0xffff);
  r.c2 = static_cast<int>((q >> 32) & 0xffff);
  r.c3 = static_cast<int>(q >> 48);
  r.m = m;
  r.mult = fabs(w);
  r.mc_over = signbit(w);
  return r;
}

// the objective's row: log_mix, and flag_mixture in *flagged
SID_HD double mixture_row(const RowRecord& r, const LynchScalars& s, bool* flagged) {
  const Components k = lynch_components(r.c0, r.c1, r.c2, r.c3, r.m, s);
  const double log_mix = mixture_log(k, s);
  *flagged = mixture_flag(r.mc_over, r.m, k, log_mix, s);
  return log_mix;
}

// the marginals' row: (lhom, lhet), and flag_marginals in *flagged
SID_HD Components marginals_row(const RowRecord& r, const LynchScalars& s, bool* flagged) {
  const Components k = lynch_components(r.c0, r.c1, r.c2, r.c3, r.m, s);
  *flagged = marginals_flag(r.mc_over, k);
  return k;
}

// the objective's term: 0 where the mixture is -inf, else log_mix * mult
SID_HD double lynch_term(double log_mix, double mult) {
  return log_mix == -INFINITY ? 0.0 : log_mix * mult;
}

// The objective's fixed-order reduction. Rows fall in chunks of kChunk;
// thread t of a chunk sums rows chunk*kChunk + k*kReduceThreads + t for
// k = 0..kRowsPerThread-1 in that order, starting from 0.0 (a row past the
// end, or flagged, adds 0.0); the kReduceThreads sums then fold as a tree,
// v[t] = v[t] + v[t + s] for s = kReduceThreads/2 .. 1. The chunk sums fold
// the same way in one block: thread t sums chunks t, t + kReduceThreads, ...
// (0.0 past the end), then the tree. The result depends on the row count
// and these constants alone, never on how many blocks run the chunks or
// which of them folds the chunk sums.
constexpr int kReduceThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kChunk = kReduceThreads * kRowsPerThread;

// row i of a (n, 4) int32 profile array; one 16-byte load on the card
// (the array is 16-byte aligned)
SID_HD void load_profile(const int32_t* prof, int64_t i, int c[4]) {
#ifdef __CUDA_ARCH__
  const int4 q = __ldg(reinterpret_cast<const int4*>(prof) + i);
  c[0] = q.x;
  c[1] = q.y;
  c[2] = q.z;
  c[3] = q.w;
#else
  for (int k = 0; k < 4; ++k) c[k] = prof[4 * i + k];
#endif
}

// one thread's share of the chunk that starts at row `first` and stops at
// row `end` at the latest: the sum of its unflagged terms, and how many of
// its rows were flagged (flags written for every row it covers). The
// record has n rows (its plane stride).
SID_HD double nll_rows_sum(int64_t first, int64_t end, int t, const double* rec,
                           int64_t n, const LynchScalars& s, uint8_t* flags,
                           int* n_flagged) {
  double acc = 0.0;
  int cnt = 0;
  SID_NO_UNROLL
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kReduceThreads + t;
    double term = 0.0;
    if (i < end) {
      const RowRecord r = read_record(rec, n, i);
      bool flagged;
      const double log_mix = mixture_row(r, s, &flagged);
      flags[i] = flagged ? 1 : 0;
      if (flagged) {
        ++cnt;
      } else {
        term = lynch_term(log_mix, r.mult);
      }
    }
    acc = acc + term;
  }
  *n_flagged = cnt;
  return acc;
}

// one thread's share of chunk `chunk` of a fit's n rows
SID_HD double nll_thread_sum(int64_t chunk, int t, const double* rec, int64_t n,
                             const LynchScalars& s, uint8_t* flags, int* n_flagged) {
  return nll_rows_sum(chunk * kChunk, n, t, rec, n, s, flags, n_flagged);
}

// Thread t's share of the fold of n_chunks chunk sums and flagged counts:
// chunks t, t + kReduceThreads, ... added in that order from 0.0 (0.0 past
// the end); the kReduceThreads shares then fold as a tree. On the card the
// chunk sums are read from L2 (other blocks, or other launches, wrote them).
SID_HD double fold_thread_sum(const double* part_sum, const int* part_cnt, int64_t n_chunks,
                              int t, int* n_flagged) {
  double acc = 0.0;
  int cnt = 0;
  for (int64_t base = 0; base < n_chunks; base += kReduceThreads) {
    const int64_t i = base + t;
#ifdef __CUDA_ARCH__
    acc = acc + (i < n_chunks ? __ldcg(part_sum + i) : 0.0);
    cnt = cnt + (i < n_chunks ? __ldcg(part_cnt + i) : 0);
#else
    acc = acc + (i < n_chunks ? part_sum[i] : 0.0);
    cnt = cnt + (i < n_chunks ? part_cnt[i] : 0);
#endif
  }
  *n_flagged = cnt;
  return acc;
}

// ---- lanes: many fits' rows in one record ----
// A cohort's fits (lanes) keep their rows one after another in one record;
// lane l holds rows off[l] .. off[l+1]-1. Its objective runs in chunks of
// kChunk rows that start at off[l] (a lane's last chunk may be short and
// never reaches into the next lane), so every lane sums its rows in the
// order a fit of those rows alone sums them. An empty lane has one chunk
// of no rows, whose sum is the 0.0 a fit of no rows gives.
// (The lanes' marginals walk chunks of another size the same way.)
SID_HD int64_t lane_chunks(int64_t rows, int64_t chunk = kChunk) {
  return rows > chunk ? (rows + chunk - 1) / chunk : 1;
}

// One running lane of a launch of the lane kernels (lynch.cu): its
// scalars, its rows first_row .. end_row - 1 of the record, and the end of
// its chunks in the launch's walk, which takes the running lanes' chunks
// one after another (walk_end is the running total of lane_chunks). 152
// bytes; the kernels read a launch's slots from the constant bank.
struct LaneSlot {
  LynchScalars s;
  int64_t first_row;
  int64_t end_row;
  int64_t walk_end;
};

// The slot of chunk j of the walk: the first k in [0, count) with
// slots[k].walk_end > j, for j below slots[count - 1].walk_end. Every lane
// (and every shard) has a chunk, so walk_end rises strictly and slot k
// holds chunks walk_start(k) .. walk_end - 1. A binary search over the
// slots (LaneSlot or ShardSlot).
template <typename Slot>
SID_HD int slot_of(const Slot* slots, int count, int64_t j) {
  int lo = 0;
  int hi = count - 1;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (slots[mid].walk_end > j) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

template <typename Slot>
SID_HD int64_t walk_start(const Slot* slots, int k) {
  return k > 0 ? slots[k - 1].walk_end : 0;
}

// ---- shards: a sharded fit's rows on one device ----
// A sharded fit (--devices) cuts the histogram into contiguous shards at
// multiples of kChunk rows, each with its own record. One launch takes
// every shard of one device through a table of ShardSlot (in the walk's
// order): the shard's record and flags, its rows, the global index of its
// first chunk, and the end of its chunks in the launch's walk (the running
// total of ceil(rows / kChunk); a shard has at least one row). 40 bytes;
// the kernel takes a launch's table as a kernel parameter (lynch.cu).
struct ShardSlot {
  const double* rec;
  int64_t rows;
  uint8_t* flags;
  int64_t first_chunk;
  int64_t walk_end;
};

// One thread's share of walk chunk j over the n_shards shards of table:
// chunk j - walk_start of its shard, over the shard's rows alone, exactly
// as nll_thread_sum takes that chunk of a fit of those rows. The shard
// starts at a multiple of kChunk rows of the histogram, so this is the
// one-device fit's chunk *global_chunk, with its bits.
SID_HD double shard_chunk_sum(const ShardSlot* table, int n_shards, int64_t j, int t,
                              const LynchScalars& s, int* n_flagged, int64_t* global_chunk) {
  const int k = slot_of(table, n_shards, j);
  const int64_t chunk = j - walk_start(table, k);
  *global_chunk = table[k].first_chunk + chunk;
  return nll_thread_sum(chunk, t, table[k].rec, table[k].rows, s, table[k].flags, n_flagged);
}

// ---- the fit's loop on the card: lanes that carry their simplex ----
// A fit on the card (lynch.cu lynch_fit_lanes_kernel, sid_tpu's jitted
// fit_lynch and its vmapped cohort fits around B3) runs S >= 1 lanes, each
// one nmsimplex2 minimization over its rows (a single fit is one lane).
// Each launch evaluates every running lane at its pending point; the block
// that folds a lane's objective then takes the value into the lane's
// simplex (fit_take) and sets its next point and scalars, which the next
// launch reads. A lane's mode says what the next launch does with it:
// nothing (it stopped), its rows at its scalars, or no row work and
// DBL_MAX (its point is outside the box [0, 1]^2, where DeviceObjective
// gives DBL_MAX without a launch).
enum FitMode : int32_t { kFitIdle = 0, kFitRows = 1, kFitOutOfBox = 2 };
// a lane stops DONE (converged or at max_iterations) or HANDOVER: an
// evaluation flagged rows for the long-double replay, which the host makes
enum FitStatus : int32_t { kFitRunning = 0, kFitDone = 1, kFitHandover = 2 };

// a lane's rows first_row .. end_row - 1 and the end of its chunks in the
// walk over every lane's chunks (the running total of lane_chunks); 24
// bytes, fixed for a fit
struct FitLane {
  int64_t first_row;
  int64_t end_row;
  int64_t walk_end;
};

// a lane's state on the card
template <int N>
struct FitLaneState {
  NmState<N> nm;
  double fixed_eps;     // N == 1: the error rate the pi fit holds
  int32_t mode;         // FitMode of the next launch
  int32_t status;       // FitStatus
  int32_t evaluations;  // entries written into the lane's history
  int32_t pad;
};

// A history entry: the point (N), its value, the rows it flagged. Where it
// flagged rows, the value is the sum of the unflagged terms (the host adds
// the flagged rows' long-double terms).
template <int N>
constexpr int kHistoryWidth = N + 2;
// a lane's result: x at the best corner (N), fval, converged, iterations,
// evaluations, status
template <int N>
constexpr int kResultWidth = N + 5;

// the lane's next evaluation from its pending point: in the box its five
// theta scalars into scalars[0..4] (its other 11 stay), else out of the box
template <int N>
SID_HD void fit_set_point(FitLaneState<N>& lane, double* scalars) {
  const double pi = lane.nm.xc[0];
  const double eps = N == 2 ? lane.nm.xc[N - 1] : lane.fixed_eps;
  if (theta_in_box(pi, eps)) {
    theta_scalars(pi, eps, scalars);
    lane.mode = kFitRows;
  } else {
    lane.mode = kFitOutOfBox;
  }
}

// a lane from its start: the simplex at x0 with step, its first point set
template <int N>
SID_HD void fit_start(FitLaneState<N>& lane, const double* x0, const double* step, double fixed_eps, double tol,
                      int max_iterations, int dot_mode, double* scalars) {
  nm_start(lane.nm, x0, step, tol, max_iterations, dot_mode);
  lane.fixed_eps = fixed_eps;
  lane.status = kFitRunning;
  lane.evaluations = 0;
  lane.pad = 0;
  fit_set_point(lane, scalars);
}

// the lane's result into out (kResultWidth<N> doubles)
template <int N>
SID_HD void fit_result(const FitLaneState<N>& lane, double* out) {
  for (int j = 0; j < N; ++j) out[j] = lane.nm.x1[lane.nm.best][j];
  out[N] = lane.nm.y1[lane.nm.best];
  out[N + 1] = lane.nm.converged;
  out[N + 2] = lane.nm.iterations;
  out[N + 3] = lane.evaluations;
  out[N + 4] = lane.status;
}

// The lane's evaluation of this launch is in: total and flagged are the
// fold of its rows (mode rows; unread out of the box). The entry goes into
// the lane's history; flagged rows hand the lane over, else its value
// -clamp(total, +-DBL_MAX) (DBL_MAX out of the box) advances the simplex
// and sets the next point. Returns whether the lane stopped (its result is
// then in result).
template <int N>
SID_HD bool fit_take(FitLaneState<N>& lane, double total, int flagged, double* scalars, double* history,
                     double* result) {
  double* h = history + static_cast<int64_t>(lane.evaluations) * kHistoryWidth<N>;
  for (int j = 0; j < N; ++j) h[j] = lane.nm.xc[j];
  lane.evaluations = lane.evaluations + 1;
  double y;
  if (lane.mode == kFitOutOfBox) {
    y = kDblMax;
  } else if (flagged > 0) {
    h[N] = total;
    h[N + 1] = flagged;
    lane.status = kFitHandover;
    lane.mode = kFitIdle;
    fit_result(lane, result);
    return true;
  } else {
    y = total > kDblMax ? kDblMax : (total < -kDblMax ? -kDblMax : total);
    y = -y;
  }
  h[N] = y;
  h[N + 1] = 0.0;
  nm_take(lane.nm, y);
  if (lane.nm.phase == kNmDone) {
    lane.status = kFitDone;
    lane.mode = kFitIdle;
    fit_result(lane, result);
    return true;
  }
  fit_set_point(lane, scalars);
  return false;
}

}  // namespace sid
