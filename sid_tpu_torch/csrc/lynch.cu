// The Lynch fit on Hopper: the per-fit row record, the compound objective
// (B2) and the per-profile marginals at the fitted error rate (B4).
//
// Replaces the XLA programs of sid_tpu that have no Pallas form:
//   B2  sid_tpu/ops/likelihoods.py:138 compound_neg_log_likelihood, evaluated
//       once per simplex step inside models/lynch.py:73-76 (fit_lynch);
//   B4  sid_tpu/ops/likelihoods.py:40,69 log_het_marginal / log_hom_marginal
//       at the fitted epsilon, models/lynch.py:81-83;
// and the record kernel computes once per fit what both recomputed per
// call: log_multinomial (sid_tpu/ops/likelihoods.py:33) and the
// theta-free part of the range screen. The per-profile math is lynch.cuh,
// shared with a g++ host build for the CPU tests. The theta-dependent
// scalars (every log of pi, epsilon and the base composition) come in from
// the host, so a row's own transcendentals are the 11 exp and 3 log/log1p
// of the two log-sum-exps and the logaddexp (B4: 10 exp, 2 log).
//
// What bounds them: f64 instructions. B2 reads a 24-byte record and writes
// a flag byte a row (25 MB at U = 1M, and the records stay in the 50 MB L2
// across evaluations) against ~260-450 f64 instructions a row (cuobjdump:
// those every row executes, and the row's code with every branch arm taken;
// the exp/log polynomials are most of it), 15-27 us of FP64 pipe at U = 1M
// against ~7.5 us of bytes. The design keeps the pipes fed:
//   - no lgamma gathers in the row: the record holds m;
//   - a register budget per kernel that ptxas meets with 0 spill bytes, and
//     a grid of exactly the resident blocks (the occupancy API, once per
//     workspace), each walking chunks grid-stride;
//   - one launch per evaluation: the last block to finish folds the chunk
//     sums, so there is no second kernel and no serial tail on one SM
//     (a sharded fit too: one launch a device, below).
//
// The objective's sum has a fixed order (lynch.cuh): each chunk of kChunk
// rows reduces in a fixed per-thread order and a fixed tree into its own
// partial slot; every block then stores its partials, makes them visible
// (__threadfence) and takes a ticket with atomicAdd; the block that takes
// the last ticket folds all partials in the fixed order and resets the
// ticket. The atomic elects a block and decides no order, so the sum does
// not depend on the grid size, the number of SMs or the order blocks
// finish: the fit's (pi, epsilon) are bitwise repeatable. Rows the
// long-double range screen flags add 0.0 and are counted; the host adds
// their long-double terms.
//
// Launch: on the caller's stream, no allocation (the wrapper passes every
// buffer), returns cudaGetLastError() so a refused launch is seen; the
// objective can also copy its (2,) result into a pinned host buffer and
// wait for it, so one evaluation is one call from the host.
//
// The cohort's lanes (population mode). Replaces the vmapped XLA programs
// of sid_tpu/models/population.py: _fit_pooled :70, _fit_batched :83 and
// _fit_pi_batched :152 (one nmsimplex2 while-loop per sample around B2) and
// _marginals_batched :298 (B4 per sample). The lanes' rows sit one after
// another in one record (written once by lynch_records_kernel, which has
// nothing lane-specific). A launch takes a table of up to kLanesPerLaunch
// running lanes (lynch.cuh LaneSlot: the lane's 16 scalars, its rows, the
// end of its chunks in the launch's walk). The host runs every lane's
// simplex in lockstep (exact/nmsimplex.py); each round is one launch of
// lynch_nll_lanes_kernel for every lane still running:
//   - the walk is the running lanes' chunks of kChunk rows, each lane's from
//     its first row (lynch.cuh lane_chunks); blocks take walk chunks
//     grid-stride, so each chunk a block takes belongs to one lane;
//   - each chunk reduces exactly as in lynch_nll_kernel into its own slot;
//     a per-lane ticket elects the block that completes a lane's last
//     chunk, and that block folds the lane's chunk sums in the single-lane
//     kernel's order and resets the ticket. So each lane's [sum, flagged
//     count] is bitwise lynch_nll_kernel's over that lane's rows alone,
//     whatever the other lanes, the grid or the order in which blocks
//     finish;
//   - the table goes up in one async copy from pinned memory into the
//     constant bank and the (A, 2) results come back in one, all enqueued
//     by one ctypes call a round; the host then waits on one stream sync
//     (after enqueueing the other devices' rounds, over a mesh). More running lanes
//     than kLanesPerLaunch run in launches of at most that many, one after
//     another on the stream; lanes are independent, so no bit moves.
// lynch_marginals_lanes_kernel is B4 for the whole cohort in one launch,
// over a walk of every lane's chunks of kMarginalsChunk rows, each row at
// its lane's scalars.
//
// A sharded fit (--devices; replaces sid_tpu/parallel/fit.py:29
// fit_lynch_global, B10, whose XLA program all-reduces each shard's sum).
// The histogram is cut into contiguous shards at multiples of kChunk rows,
// each shard with its own record on its own device. An evaluation is one
// launch of lynch_nll_shards_kernel on each device that holds shards:
//   - the launch walks every chunk of its device's shards grid-stride
//     through the device's table of them (lynch.cuh ShardSlot: record,
//     rows, flags, first global chunk, end of its chunks in the walk; at
//     most kShardsPerLaunch, and a device that holds more launches once
//     for each kShardsPerLaunch of them), built once per fit on the host
//     and passed by value as a kernel parameter (__grid_constant__, 1,280
//     bytes a launch), so a chunk's shard (lynch.cuh slot_of) and the shard's
//     record, rows and flags are read from the parameter bank where the
//     row loop uses them, as B2 reads its own: the kernel keeps B2's
//     register budget of 3 blocks an SM with 0 spill bytes. A table in
//     global memory spills at that budget (staged in shared memory or read
//     where used: the three pointers and counts then live in registers
//     through the row loop; chip_smoke.py --shard-variants prints ptxas's
//     report of both);
//   - each chunk reduces exactly as in lynch_nll_kernel (nll_thread_sum
//     over the shard's rows alone) and is stored at its global chunk index:
//     the shard starts at a multiple of kChunk, so every chunk sum is the
//     one the one-device kernel stores;
//   - on the fold's device (the mesh's first; its table lists its shards
//     last) every block then takes the ticket as lynch_nll_kernel's blocks
//     do, and the block that takes the last ticket folds all the fit's
//     chunk sums in the one-device order (fold_thread_sum + block_fold)
//     and resets the ticket; the same call copies the result into pinned
//     memory and waits for it. So the fit's (pi, epsilon) are bitwise the
//     one-device fit's for every mesh;
//   - a launch on another device stops after its chunk sums, which go into
//     buffers of its own, and its call records an event after it; the fold
//     device's call makes its stream wait for each such event and copies
//     those chunk sums into its own buffers (cudaMemcpyPeerAsync) before
//     its launch, all on the one stream of that launch: ordered by the
//     event and stream order, not by a wait that a library copy places.
// On one card that is one launch and one call from the host an evaluation
// for any shard count (before: a partials-only launch of lynch_nll_kernel
// a shard and a one-block fold kernel, k + 1 launches and calls). Rejected:
// merging a device's consecutive shards into one workspace when the fit is
// made. On one card [cuda:0] x k would then be the one-device fit, and
// nothing of the sharded path (the shard walk, the global chunk index, the
// copies into the fold's buffers) would run on the only card there is.
//
// The fit's loop on the card (B3: replaces sid_tpu/ops/nmsimplex.py:287
// minimize_nmsimplex2_jax, the while-loop that sid_tpu's jitted fit_lynch,
// models/lynch.py:60-85, and its vmapped cohort fits, models/population.py
// :70, :83 and :152, run around B2). A fit of S >= 1 lanes (the device fit
// is one) is one cooperative launch of lynch_fit_lanes_kernel, a grid of
// resident blocks (lynch.cuh fit_grid), so that every block is on the
// card while any waits:
//   - the prologue starts each lane (one thread a lane: its simplex, its
//     first point's scalars) and publishes its generation;
//   - then the blocks loop over rounds themselves. A round's row work is
//     the walk over every lane's units (lynch.cuh: one row slice of a
//     chunk, 256 rows), cut into one contiguous run a block, so that the
//     969 chunks of U = 991,985 are 3,876 units and a block's run 9 or 10
//     of them, not 2 or 3 chunks; a walk of no more chunks than the
//     resident blocks (a cohort of ~1,000 rows a lane) runs a chunk a
//     block instead (fit_whole_chunks: four blocks a chunk cost such a
//     cohort more than they saved). A piece of a run (its units of one
//     chunk) puts its rows' terms into the block's shared memory. A whole
//     chunk is summed from there; the pieces of a chunk that runs cut
//     write their terms into a term buffer (8 bytes a row, in L2), and the
//     block whose piece completes the chunk (its ticket) sums them. Either
//     way each thread adds its four terms in B2's order (lynch.cuh
//     chunk_terms_sum) and the block folds them with B2's tree. (Summed in
//     registers as B2 sums them, a whole chunk spilled at this budget.);
//   - before its first piece of lane k in round r, thread 0 waits with
//     acquire loads for lane k's generation to show its point r, with the
//     point's mode in the word (a lane runs its next round as soon as its
//     own step is done), and stages the point's scalars in shared memory;
//   - the block that takes a lane's last chunk ticket folds the lane's
//     chunk sums as lynch_nll_lanes_kernel does (so bitwise B2 over its
//     rows alone) and then, in one thread, takes the value into the lane's
//     simplex (lynch.cuh fit_take: the history entry, -clamp,
//     nmsimplex.cuh's step, the next point's five log scalars computed on
//     the card) and publishes the lane's next generation with a release
//     store (or its stop). A lane that stopped has no more rounds; a lane
//     out of the box does no row work but takes its tickets;
//   - every wait is bounded (a launch's wait_ns): past it the block writes
//     the launch's epoch as its error and returns, the other blocks see it
//     and return, and the call reports the timeout.
// A fit is one launch, one copy of the lanes' results and counters and one
// stream sync. An evaluation that flags rows for the long-double replay
// stops its lane (handover): the host replays the lane's history into its
// own loop (exact/nmsimplex.py replay) and goes on there.
//
// What bounds the lane kernels is what bounds B2 and B4: f64 instructions,
// long chains of dependent multiplies and adds (the exp/log polynomials
// under --fmad=false) whose latency only more resident warps hide. So they
// keep B2's and B4's register budget of 3 blocks an SM with 0 spill bytes.
// A block's chunk belongs to one lane, so the lane (found once a chunk by a
// binary search over the table) and its scalars are the same for the whole
// block, and the scalars are read from the constant bank where a row uses
// them instead of being held in 32 registers for the whole walk (with the
// table in global memory ptxas spills at this budget). The marginals take
// one row a thread of each chunk, so that a cohort of ~1,000 rows a lane
// still fills the card, and no row searches for its lane. Deferring every
// lane's fold to the last block was slower than the election at both of
// chip_smoke.py's cohort shapes (its --lane-variants).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "lynch.cuh"

namespace {

constexpr int kThreads = sid::kReduceThreads;
// register budgets: at most 65536 / (kMinBlocks * kThreads) registers a
// thread, chosen so that ptxas reports 0 spill bytes (the -Xptxas -v lines
// chip_smoke.py prints and checks)
constexpr int kNllMinBlocks = 3;
constexpr int kMarginalsMinBlocks = 3;
constexpr int kLanesMinBlocks = 3;
constexpr int kFitMinBlocks = 3;

// the running lanes of one launch of a lane kernel, written into the
// constant bank on the launch's stream just before it (58 KB of the 64 KB)
constexpr int kLanesPerLaunch = 384;
// the shards of a sharded fit one device's launch takes, in its table
// (a kernel parameter)
constexpr int kShardsPerLaunch = 32;
// the rows each thread takes of a chunk of the lanes' marginals, and so
// the rows of their chunks (the objective's chunks are sid::kChunk): one,
// so that a cohort of ~1,000 rows a lane still fills the card
constexpr int kMarginalsRowsPerThread = 1;
constexpr int kMarginalsChunk = kThreads * kMarginalsRowsPerThread;
__constant__ sid::LaneSlot c_slots[kLanesPerLaunch];

static_assert(sizeof(sid::LynchScalars) == 16 * sizeof(double),
              "LynchScalars must be 16 doubles");
static_assert(sizeof(sid::LaneSlot) == 19 * sizeof(double), "LaneSlot must be 152 bytes");
static_assert(sizeof(sid::ShardSlot) == 5 * sizeof(double), "ShardSlot must be 40 bytes");

// the shard table of one launch of lynch_nll_shards_kernel, its first
// n_shards entries used
struct ShardTable {
  sid::ShardSlot slot[kShardsPerLaunch];
};

// One copy that the fold device's call makes before its launch: bytes from
// src on device src_device into dst on the fold's device, after event (a
// cudaEvent_t recorded after the launch that wrote src; null: none). 40
// bytes; the host builds the list once per fit.
struct PeerPull {
  void* event;
  void* dst;
  const void* src;
  int64_t bytes;
  int64_t src_device;
};
static_assert(sizeof(PeerPull) == 40, "PeerPull must be 40 bytes");

// kernel launches since the library was loaded: records, objective,
// marginals, the lanes' objective, the lanes' marginals, a sharded fit's
// objective on one device
enum {
  kRecordsKernel = 0,
  kNllKernel = 1,
  kMarginalsKernel = 2,
  kNllLanesKernel = 3,
  kMarginalsLanesKernel = 4,
  kNllShardsKernel = 5,
  kFitLanesKernel = 6,
  kKernelCount = 7
};
std::atomic<long long> g_launches[kKernelCount];
// fits run to their results (one launch of lynch_fit_lanes_kernel each)
std::atomic<long long> g_fits;
// sid_lynch_fit_run's code for a launch whose wait timed out (no
// cudaError_t is negative)
constexpr int kFitTimedOut = -1;

// The block's tree fold of (v, c) over its kThreads threads; thread 0 ends
// with the block's result. The levels s >= 32 go through shared memory; the
// last five (s = 16 .. 1) are warp shuffles in which lane t adds lane
// t + s: the same addition v[t] + v[t + s] as the shared-memory tree.
__device__ void block_fold(double& v, int& c, double* sh_sum, int* sh_cnt) {
  const int t = threadIdx.x;
  sh_sum[t] = v;
  sh_cnt[t] = c;
  __syncthreads();
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    if (t < s) {
      sh_sum[t] = sh_sum[t] + sh_sum[t + s];
      sh_cnt[t] = sh_cnt[t] + sh_cnt[t + s];
    }
    __syncthreads();
  }
  if (t < 32) {
    v = sh_sum[t];
    c = sh_cnt[t];
    for (int s = 16; s > 0; s >>= 1) {
      v = v + __shfl_down_sync(0xffffffffu, v, s);
      c = c + __shfl_down_sync(0xffffffffu, c, s);
    }
  }
  __syncthreads();  // the shared arrays are free again
}

// The tail of an objective launch whose last block folds: thread 0 wrote
// this block's chunk sums, so publish them and take a ticket; the block
// that takes the last one (every chunk sum is then visible; read from L2)
// folds the n_chunks chunk sums in their order (fold_thread_sum +
// block_fold) into out and resets the ticket (0 between launches).
__device__ __forceinline__ void fold_if_last(const double* part_sum, const int* part_cnt, int64_t n_chunks,
                                             unsigned int* ticket, double* __restrict__ out, double* sh_sum,
                                             int* sh_cnt, bool& sh_last) {
  const int t = threadIdx.x;
  if (t == 0) {
    __threadfence();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  int cnt = 0;
  double acc = sid::fold_thread_sum(part_sum, part_cnt, n_chunks, t, &cnt);
  block_fold(acc, cnt, sh_sum, sh_cnt);
  if (t == 0) {
    out[0] = acc;
    out[1] = static_cast<double>(cnt);
    *ticket = 0;  // ready for the next evaluation
  }
}

__global__ void __launch_bounds__(kThreads)
    lynch_records_kernel(const int32_t* __restrict__ prof,
                         const int64_t* __restrict__ mult,
                         const double* __restrict__ tab, int tab_len,
                         int64_t n, double* __restrict__ rec) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int c[4];
    sid::load_profile(prof, i, c);
    sid::write_record(rec, n, i, c[0], c[1], c[2], c[3], __ldg(mult + i), tab, tab_len);
  }
}

// B2.
__global__ void __launch_bounds__(kThreads, kNllMinBlocks)
    lynch_nll_kernel(const double* __restrict__ rec, sid::LynchScalars s,
                     int64_t n, int64_t n_chunks, uint8_t* __restrict__ flags,
                     double* part_sum, int* part_cnt, unsigned int* ticket,
                     double* __restrict__ out) {
  __shared__ double sh_sum[kThreads];
  __shared__ int sh_cnt[kThreads];
  __shared__ bool sh_last;
  const int t = threadIdx.x;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    int cnt = 0;
    double v = sid::nll_thread_sum(chunk, t, rec, n, s, flags, &cnt);
    block_fold(v, cnt, sh_sum, sh_cnt);
    if (t == 0) {
      part_sum[chunk] = v;
      part_cnt[chunk] = cnt;
    }
  }
  fold_if_last(part_sum, part_cnt, n_chunks, ticket, out, sh_sum, sh_cnt, sh_last);
}

// A sharded fit's objective on one device (B10, sid_tpu/parallel/fit.py:29
// fit_lynch_global): the walk of the n_shards shards of table in chunks of
// kChunk rows, each chunk's sum and flagged
// count stored at its global index of part_sum, part_cnt and its rows'
// flags into its shard's. With fold (the fold's device) the block that
// takes the last ticket then folds the n_chunks chunk sums of the whole
// fit, as lynch_nll_kernel's last block does, into out, and resets the
// ticket (0 between launches); without, the kernel stops at its chunk sums.
__global__ void __launch_bounds__(kThreads, kNllMinBlocks)
    lynch_nll_shards_kernel(const __grid_constant__ ShardTable table, int n_shards, sid::LynchScalars s,
                            double* part_sum, int* part_cnt, int64_t n_chunks, unsigned int* ticket,
                            double* __restrict__ out, int fold) {
  __shared__ double sh_sum[kThreads];
  __shared__ int sh_cnt[kThreads];
  __shared__ bool sh_last;
  const int t = threadIdx.x;
  const int64_t total = n_shards > 0 ? table.slot[n_shards - 1].walk_end : 0;
  for (int64_t j = blockIdx.x; j < total; j += gridDim.x) {
    int cnt = 0;
    int64_t chunk;
    double v = sid::shard_chunk_sum(table.slot, n_shards, j, t, s, &cnt, &chunk);
    block_fold(v, cnt, sh_sum, sh_cnt);
    if (t == 0) {
      part_sum[chunk] = v;
      part_cnt[chunk] = cnt;
    }
  }
  // the other devices' chunk sums were copied in before the launch
  if (fold) fold_if_last(part_sum, part_cnt, n_chunks, ticket, out, sh_sum, sh_cnt, sh_last);
}

__global__ void __launch_bounds__(kThreads, kMarginalsMinBlocks)
    lynch_marginals_kernel(const double* __restrict__ rec, sid::LynchScalars s,
                           int64_t n, double* __restrict__ lhom,
                           double* __restrict__ lhet,
                           uint8_t* __restrict__ flags) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    bool flagged;
    const sid::Components k = sid::marginals_row(sid::read_record(rec, n, i), s, &flagged);
    lhom[i] = k.lhom;
    lhet[i] = k.lhet;
    flags[i] = flagged ? 1 : 0;
  }
}

// The objective of the n_slots running lanes of c_slots. rec: (3, n)
// record of all lanes; flags: (n,) uint8; part_sum, part_cnt: one entry a
// chunk of the walk; slot_ticket: (n_slots) counters, 0 between launches;
// out: (n_slots, 2) [sum of the unflagged terms, flagged count].
__global__ void __launch_bounds__(kThreads, kLanesMinBlocks)
    lynch_nll_lanes_kernel(const double* __restrict__ rec, int64_t n, int n_slots,
                           uint8_t* __restrict__ flags, double* part_sum, int* part_cnt,
                           unsigned int* slot_ticket, double* __restrict__ out) {
  __shared__ double sh_sum[kThreads];
  __shared__ int sh_cnt[kThreads];
  __shared__ bool sh_last;
  const int t = threadIdx.x;
  const int64_t total = c_slots[n_slots - 1].walk_end;
  for (int64_t j = blockIdx.x; j < total; j += gridDim.x) {
    // the chunk's lane: the same for the whole block
    const int k = sid::slot_of(c_slots, n_slots, j);
    const int64_t first_chunk = sid::walk_start(c_slots, k);
    const int64_t n_lane_chunks = c_slots[k].walk_end - first_chunk;
    int cnt = 0;
    double v = sid::nll_rows_sum(c_slots[k].first_row + (j - first_chunk) * sid::kChunk,
                                 c_slots[k].end_row, t, rec, n, c_slots[k].s, flags, &cnt);
    block_fold(v, cnt, sh_sum, sh_cnt);
    // thread 0 holds the chunk's sum: store it, publish it, count the chunk
    if (t == 0) {
      part_sum[j] = v;
      part_cnt[j] = cnt;
      __threadfence();
      sh_last = atomicAdd(slot_ticket + k, 1u) == n_lane_chunks - 1;
    }
    __syncthreads();
    if (sh_last) {
      // the lane's last chunk: fold its chunk sums as lynch_nll_kernel does
      __threadfence();
      double acc = 0.0;
      int lane_cnt = 0;
      for (int64_t base = 0; base < n_lane_chunks; base += kThreads) {
        const int64_t i = base + t;
        acc = acc + (i < n_lane_chunks ? __ldcg(part_sum + first_chunk + i) : 0.0);
        lane_cnt = lane_cnt + (i < n_lane_chunks ? __ldcg(part_cnt + first_chunk + i) : 0);
      }
      block_fold(acc, lane_cnt, sh_sum, sh_cnt);
      if (t == 0) {
        out[2 * k] = acc;
        out[2 * k + 1] = static_cast<double>(lane_cnt);
        slot_ticket[k] = 0;  // ready for the next launch
      }
    }
  }
}

// B4 for the rows of the n_slots lanes of c_slots, each at its lane's
// scalars (the pi entries unused): a walk of the lanes' chunks of
// kMarginalsChunk rows, each thread taking rows r * kThreads + t of a
// chunk. lhom, lhet: (n,) f64; flags: (n,) uint8.
__global__ void __launch_bounds__(kThreads, kLanesMinBlocks)
    lynch_marginals_lanes_kernel(const double* __restrict__ rec, int64_t n, int n_slots,
                                 double* __restrict__ lhom, double* __restrict__ lhet,
                                 uint8_t* __restrict__ flags) {
  const int t = threadIdx.x;
  const int64_t total = c_slots[n_slots - 1].walk_end;
  for (int64_t j = blockIdx.x; j < total; j += gridDim.x) {
    const int k = sid::slot_of(c_slots, n_slots, j);
    const int64_t first = c_slots[k].first_row + (j - sid::walk_start(c_slots, k)) * kMarginalsChunk;
    const int64_t end = c_slots[k].end_row;
    SID_NO_UNROLL
    for (int r = 0; r < kMarginalsRowsPerThread; ++r) {
      const int64_t i = first + static_cast<int64_t>(r) * kThreads + t;
      if (i < end) {
        bool flagged;
        const sid::Components c = sid::marginals_row(sid::read_record(rec, n, i), c_slots[k].s, &flagged);
        lhom[i] = c.lhom;
        lhet[i] = c.lhet;
        flags[i] = flagged ? 1 : 0;
      }
    }
  }
}

// Lane generations (gen, one 64-bit word a lane): the launch's epoch in
// the high word; in the low word (r << 2) | mode once the lane's point of
// its round r - 1 (r >= 1) is published with its FitMode, kGenStopped once
// it stopped. A launch's epoch is new (the wrapper counts launches), so a
// word the last launch left reads as not yet published.
constexpr unsigned int kGenStopped = 0xffffffffu;

__device__ __forceinline__ unsigned long long gen_word(unsigned int epoch, unsigned int low) {
  return (static_cast<unsigned long long>(epoch) << 32) | low;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// What a fit's launch takes (a __grid_constant__ parameter): the record
// (3, n); lanes (n_lanes) FitLane; starts (n_lanes, 2 N + 1); state
// (n_lanes) FitLaneState; scalars (n_lanes, 16) with the eleven fixed ones
// in place; history (n_lanes, history_entries, N + 2); flags and terms
// (n) for the rows; part_sum, part_cnt an entry a chunk of the walk;
// chunk_ticket (chunks) and lane_ticket (n_lanes), 0 between launches;
// gen (n_lanes); results (n_lanes, N + 5); error: the epoch of a launch
// whose wait timed out; n_units and n_chunks, the lengths of the walks
// over every lane's units and chunks; whole_chunks: a run a chunk
// (lynch.cuh fit_whole_chunks).
struct FitParams {
  const double* rec;
  int64_t n;
  const sid::FitLane* lanes;
  const double* starts;
  void* state;
  double* scalars;
  double* history;
  int64_t history_entries;
  uint8_t* flags;
  double* terms;
  double* part_sum;
  int* part_cnt;
  unsigned int* chunk_ticket;
  unsigned int* lane_ticket;
  unsigned long long* gen;
  double* results;
  unsigned int* error;
  int64_t n_units;
  int64_t n_chunks;
  double tol;
  unsigned long long wait_ns;
  int n_lanes;
  int max_iterations;
  int dot_mode;
  int whole_chunks;
  unsigned int epoch;
};

// Thread 0 of a block: wait until the word *gen is at least want (the
// lane published its point, or stopped) and return it, polling every
// ~0.1 us. Past wait_ns of waiting, or once another block reported an
// error in this launch, 0 (the timeout reported into *error).
__device__ unsigned long long wait_for(const unsigned long long* gen, unsigned long long want, unsigned int* error,
                                      unsigned int epoch, unsigned long long wait_ns) {
  unsigned long long g = load_acquire(gen);
  if (g >= want) return g;
  const unsigned long long t0 = global_ns();
  for (unsigned int spins = 1;; ++spins) {
    __nanosleep(100);
    g = load_acquire(gen);
    if (g >= want) return g;
    if (global_ns() - t0 > wait_ns) {
      atomicExch(error, epoch);
      return 0;
    }
    if ((spins & 63u) == 0 && *reinterpret_cast<volatile unsigned int*>(error) == epoch) return 0;
  }
}

// A lane's state copied between global memory (through L2: other blocks
// of the launch wrote it) and a local copy, 8 bytes at a time.
template <int N>
__device__ __forceinline__ void load_lane(const sid::FitLaneState<N>* g, sid::FitLaneState<N>& lane) {
  static_assert(sizeof(sid::FitLaneState<N>) % 8 == 0, "the lane state is copied 8 bytes at a time");
  const unsigned long long* src = reinterpret_cast<const unsigned long long*>(g);
  unsigned long long* dst = reinterpret_cast<unsigned long long*>(&lane);
  for (unsigned int w = 0; w < sizeof(lane) / 8; ++w) dst[w] = __ldcg(src + w);
}

template <int N>
__device__ __forceinline__ void store_lane(sid::FitLaneState<N>* g, const sid::FitLaneState<N>& lane) {
  const unsigned long long* src = reinterpret_cast<const unsigned long long*>(&lane);
  unsigned long long* dst = reinterpret_cast<unsigned long long*>(g);
  for (unsigned int w = 0; w < sizeof(lane) / 8; ++w) __stcg(dst + w, src[w]);
}

// A lane's start and step (lynch.cuh fit_start, fit_take) as calls of
// their own: their registers are not the row loop's (inlined, the 2-D
// step spilled 32 bytes). Each returns the lane's mode for its next point
// (kFitIdle once it stopped).
template <int N>
__device__ __noinline__ int lane_start(sid::FitLaneState<N>* g, const double* start, double tol, int max_iterations,
                                       int dot_mode, double* scalars) {
  sid::FitLaneState<N> lane{};
  sid::fit_start(lane, start, start + N, start[2 * N], tol, max_iterations, dot_mode, scalars);
  store_lane(g, lane);
  return lane.mode;
}

template <int N>
__device__ __noinline__ int lane_step(sid::FitLaneState<N>* g, double total, int flagged, double* scalars,
                                      double* history, double* result) {
  sid::FitLaneState<N> lane;
  load_lane(g, lane);
  sid::fit_take(lane, total, flagged, scalars, history, result);
  store_lane(g, lane);
  return lane.mode;
}

// A block's place in its rounds, which thread 0 moves (fit_next): its run
// of units and the next one, its round, whether a piece of the round had
// a running lane; the piece it takes next, the piece's lane and that
// lane's mode (-1: a wait failed, -2: the block is done), and whether the
// lane's scalars are to be staged; the lane whose point of known_round is
// staged (its mode known_mode); the lane table's entry of lane tab_lane
// (its units from tab_unit_start, its chunks from tab_chunk_start).
struct FitBlock {
  sid::FitPiece piece;
  sid::FitLane tab;
  int64_t tab_unit_start;
  int64_t tab_chunk_start;
  int64_t unit;
  int64_t run_begin;
  int64_t run_end;
  unsigned int round;
  unsigned int known_round;
  int first_lane;
  int lane;
  int tab_lane;
  int known_lane;
  int known_mode;
  int mode;
  int stage;
  int ran;
};

// The fit kernel's block state, its staged lane's scalars, and each
// thread's terms and flags of a chunk's slices (slot k * kThreads + t for
// slice k), in shared memory, so that no register holds them through a
// row (only lynch_fit_lanes_kernel and the calls below use them).
__shared__ FitBlock g_fit_block;
__shared__ sid::LynchScalars g_fit_scalars;
__shared__ double g_fit_terms[sid::kChunk];
__shared__ uint8_t g_fit_flags[sid::kChunk];

// the lane table's entry of lane k into the block's cache
__device__ __forceinline__ void cache_lane(FitBlock& b, const sid::FitLane* lanes, int k) {
  b.tab = lanes[k];
  b.tab_unit_start = k > 0 ? lanes[k - 1].unit_end : 0;
  b.tab_chunk_start = k > 0 ? lanes[k - 1].walk_end : 0;
  b.tab_lane = k;
}

// Thread 0: the block's next piece into g_fit_block. At its run's end, the
// next round from the run's start, unless no piece of the round had a
// running lane (then the block is done). The first piece of a lane in a
// round waits for the lane's point of that round (gen, error, epoch and
// wait_ns as in FitParams).
__device__ __noinline__ void fit_next(const sid::FitLane* lanes, const unsigned long long* gen, unsigned int* error,
                                      unsigned int epoch, unsigned long long wait_ns) {
  FitBlock& b = g_fit_block;
  int64_t unit = b.unit;
  unsigned int round = b.round;
  int ran = b.ran;
  int k = b.lane;
  if (unit >= b.run_end) {
    if (!ran) {
      b.mode = -2;
      return;
    }
    round = round + 1u;
    unit = b.run_begin;
    k = b.first_lane;
    ran = 0;
  }
  if (k != b.tab_lane) cache_lane(b, lanes, k);
  while (b.tab.unit_end <= unit) cache_lane(b, lanes, ++k);  // a run moves forward through the lanes
  const sid::FitPiece piece = sid::fit_piece(b.tab, b.tab_unit_start, b.tab_chunk_start, unit, b.run_end);
  int mode = b.known_mode;
  int stage = 0;
  if (k != b.known_lane || round != b.known_round) {
    const unsigned long long g = wait_for(gen + k, gen_word(epoch, (round + 1u) << 2), error, epoch, wait_ns);
    if (g == 0) {
      b.mode = -1;  // the wait failed: the launch stops
      return;
    }
    const unsigned int low = static_cast<unsigned int>(g);
    mode = low == kGenStopped ? static_cast<int>(sid::kFitIdle) : static_cast<int>(low & 3u);
    stage = mode == sid::kFitRows;
    b.known_lane = k;
    b.known_round = round;
    b.known_mode = mode;
  }
  b.piece = piece;
  b.unit = unit + piece.slices;
  b.round = round;
  b.lane = k;
  b.mode = mode;
  b.stage = stage;
  b.ran = ran | (mode != sid::kFitIdle);
}

// thread t's share of a chunk and its flagged rows
struct RowSum {
  double v;
  int cnt;
};

// Thread t's rows of the block's piece: each row's flag into flags, and
// its term (0.0 where flagged or at or past the lane's end) and flag into
// its slot of the row's slice.
__device__ __forceinline__ void fit_piece_rows(const FitParams& p) {
  const FitBlock& b = g_fit_block;
  const int t = threadIdx.x;
  SID_NO_UNROLL
  for (int k = b.piece.first_slice; k < b.piece.first_slice + b.piece.slices; ++k) {
    const int64_t i = b.piece.chunk_row + static_cast<int64_t>(k) * kThreads + t;
    double term = 0.0;
    bool flagged = false;
    if (i < b.tab.end_row) term = sid::fit_row_term(p.rec, p.n, i, g_fit_scalars, p.flags, &flagged);
    g_fit_terms[k * kThreads + t] = term;
    g_fit_flags[k * kThreads + t] = flagged ? 1 : 0;
  }
}

// A whole chunk's share of thread t from its slots, in nll_rows_sum's
// order (chunk_terms_sum's: 0.0 for a slice past the chunk's)
__device__ __forceinline__ RowSum fit_chunk_slots() {
  const int t = threadIdx.x;
  const int slices = g_fit_block.piece.chunk_slices;
  RowSum r{0.0, 0};
  for (int k = 0; k < sid::kRowsPerThread; ++k) {
    r.v = r.v + (k < slices ? g_fit_terms[k * kThreads + t] : 0.0);
    r.cnt = r.cnt + (k < slices ? g_fit_flags[k * kThreads + t] : 0);
  }
  return r;
}

// The piece of a chunk that runs cut: thread t's terms of its rows from
// their slots into the term buffer (rows before the lane's end)
__device__ __forceinline__ void fit_piece_out(const FitParams& p) {
  const FitBlock& b = g_fit_block;
  const int t = threadIdx.x;
  for (int k = b.piece.first_slice; k < b.piece.first_slice + b.piece.slices; ++k) {
    const int64_t i = b.piece.chunk_row + static_cast<int64_t>(k) * kThreads + t;
    if (i < b.tab.end_row) p.terms[i] = g_fit_terms[k * kThreads + t];
  }
}

// a chunk's share of thread t from the term buffer (other blocks wrote
// parts of it)
__device__ __forceinline__ RowSum fit_chunk_terms(const FitParams& p) {
  const FitBlock& b = g_fit_block;
  RowSum r;
  r.v = sid::chunk_terms_sum(b.piece.chunk_row, b.tab.end_row, threadIdx.x, p.terms, p.flags, &r.cnt);
  return r;
}

// A whole fit in one cooperative launch (every block resident): the
// lanes' starts, then each block's rounds over the pieces of its run (see
// the top of the file and lynch.cuh); a block stops after a round in which
// every lane of its run had stopped.
template <int N>
__global__ void __launch_bounds__(kThreads, kFitMinBlocks)
    lynch_fit_lanes_kernel(const __grid_constant__ FitParams p) {
  __shared__ double sh_sum[kThreads];
  __shared__ int sh_cnt[kThreads];
  __shared__ bool sh_chunk_last;
  __shared__ bool sh_lane_last;
  FitBlock& b = g_fit_block;
  const int t = threadIdx.x;
  sid::FitLaneState<N>* state = static_cast<sid::FitLaneState<N>*>(p.state);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + t; i < p.n_lanes;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int mode =
        lane_start<N>(state + i, p.starts + i * (2 * N + 1), p.tol, p.max_iterations, p.dot_mode, p.scalars + 16 * i);
    store_release(p.gen + i, gen_word(p.epoch, (1u << 2) | static_cast<unsigned int>(mode)));
  }
  if (t == 0) {
    b.run_begin = sid::fit_run_begin(p.lanes, p.n_lanes, blockIdx.x, gridDim.x, p.whole_chunks);
    b.run_end = sid::fit_run_begin(p.lanes, p.n_lanes, blockIdx.x + 1, gridDim.x, p.whole_chunks);
    b.first_lane = sid::unit_lane(p.lanes, p.n_lanes, b.run_begin);
    b.unit = b.run_begin;
    b.lane = b.first_lane;
    b.round = 0;
    b.ran = 0;
    b.tab_lane = -1;
    b.known_lane = -1;
  }
  for (;;) {
    __syncthreads();  // the last piece's reads of the shared values are done
    if (t == 0) fit_next(p.lanes, p.gen, p.error, p.epoch, p.wait_ns);
    __syncthreads();
    const int mode = b.mode;
    if (mode < 0) return;
    if (mode == sid::kFitIdle) continue;  // the lane stopped
    if (b.stage) {
      // the lane's point changed: its scalars into shared memory
      if (t < 16)
        reinterpret_cast<double*>(&g_fit_scalars)[t] = __ldcg(p.scalars + 16 * static_cast<int64_t>(b.lane) + t);
      __syncthreads();
    }
    // the piece's rows' terms; the piece that completes its chunk sums them
    if (mode == sid::kFitRows) fit_piece_rows(p);
    const bool whole = b.piece.slices == b.piece.chunk_slices;
    if (!whole) {
      // a chunk that runs cut: its terms through the term buffer, and the
      // chunk's last piece to finish sums them
      if (mode == sid::kFitRows) fit_piece_out(p);
      __syncthreads();  // every row's term is stored
      if (t == 0) {
        __threadfence();
        unsigned int* ticket = p.chunk_ticket + b.piece.chunk;
        const unsigned int slices = static_cast<unsigned int>(b.piece.slices);
        const bool last = atomicAdd(ticket, slices) + slices == static_cast<unsigned int>(b.piece.chunk_slices);
        if (last) *ticket = 0;  // ready for the lane's next round
        sh_chunk_last = last;
      }
      __syncthreads();
      if (!sh_chunk_last) continue;
      __threadfence();
    }
    RowSum r{0.0, 0};
    if (mode == sid::kFitRows) {
      r = whole ? fit_chunk_slots() : fit_chunk_terms(p);
      block_fold(r.v, r.cnt, sh_sum, sh_cnt);
    }
    // thread 0 holds the chunk's sum: store it; the lane's last chunk to
    // finish folds the lane and steps it
    if (t == 0) {
      const int k = b.lane;
      if (mode == sid::kFitRows) {
        p.part_sum[b.piece.chunk] = r.v;
        p.part_cnt[b.piece.chunk] = r.cnt;
      }
      __threadfence();
      const int64_t n_lane_chunks = b.tab.walk_end - b.tab_chunk_start;
      const bool last = atomicAdd(p.lane_ticket + k, 1u) == n_lane_chunks - 1;
      if (last) p.lane_ticket[k] = 0;  // ready for the lane's next round
      sh_lane_last = last;
    }
    __syncthreads();
    if (!sh_lane_last) continue;
    __threadfence();
    const int k = b.lane;
    const int64_t first_chunk = b.tab_chunk_start;
    const int64_t n_lane_chunks = b.tab.walk_end - first_chunk;
    double acc = 0.0;
    int lane_cnt = 0;
    if (mode == sid::kFitRows) {
      for (int64_t base = 0; base < n_lane_chunks; base += kThreads) {
        const int64_t i = base + t;
        acc = acc + (i < n_lane_chunks ? __ldcg(p.part_sum + first_chunk + i) : 0.0);
        lane_cnt = lane_cnt + (i < n_lane_chunks ? __ldcg(p.part_cnt + first_chunk + i) : 0);
      }
      block_fold(acc, lane_cnt, sh_sum, sh_cnt);
    }
    if (t == 0) {
      const int64_t kk = k;
      const int next = lane_step<N>(state + k, acc, lane_cnt, p.scalars + 16 * kk,
                                    p.history + kk * p.history_entries * sid::kHistoryWidth<N>,
                                    p.results + kk * sid::kResultWidth<N>);
      store_release(p.gen + k, gen_word(p.epoch, next == sid::kFitIdle
                                                     ? kGenStopped
                                                     : ((b.round + 2u) << 2) | static_cast<unsigned int>(next)));
    }
  }
}

// A fit's launch and what it takes: kept from its creation to its
// destruction.
struct FitPlan {
  FitParams params;
  const void* kernel = nullptr;
  int grid = 1;
  int64_t result_bytes = 0;
};

// min(needed, the blocks of `kernel` resident on the whole card), at least 1
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int64_t needed, int* grid) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  const int64_t g = needed < cap ? needed : cap;
  *grid = static_cast<int>(g > 1 ? g : 1);
  return cudaSuccess;
}

sid::LynchScalars unpack(const double* scalars) {
  sid::LynchScalars s;
  memcpy(&s, scalars, sizeof(s));
  return s;
}

int launched(int kernel) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches[kernel];
  return static_cast<int>(err);
}

// With host_out (pinned, 2 doubles) not null: the objective out (2,) f64
// copied there on st, and st waited for. Returns a cudaError_t.
int fetch_and_wait(const void* out, double* host_out, cudaStream_t st) {
  if (host_out == nullptr) return 0;
  cudaError_t e = cudaMemcpyAsync(host_out, out, 2 * sizeof(double), cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess) e = cudaStreamSynchronize(st);
  return static_cast<int>(e);
}

// The launches of a lane kernel over n_slots LaneSlot in pinned memory,
// in groups of kLanesPerLaunch whose walk_end each count from 0: for each
// group, its slots copied into the constant bank on st (not with upload
// 0, which launches one group of at most kLanesPerLaunch on what the bank
// holds), then launch(first slot, slots, blocks) with no more blocks than
// the group's walk has chunks. Returns a cudaError_t.
template <typename Launch>
int launch_groups(const void* slots_host, int n_slots, int upload, int grid, cudaStream_t st,
                  int kernel, Launch launch) {
  if (n_slots <= 0 || (!upload && n_slots > kLanesPerLaunch))
    return static_cast<int>(cudaErrorInvalidValue);
  const sid::LaneSlot* slots = static_cast<const sid::LaneSlot*>(slots_host);
  for (int first = 0; first < n_slots; first += kLanesPerLaunch) {
    const int count = n_slots - first < kLanesPerLaunch ? n_slots - first : kLanesPerLaunch;
    if (upload) {
      const cudaError_t e = cudaMemcpyToSymbolAsync(c_slots, slots + first, sizeof(sid::LaneSlot) * count, 0,
                                                    cudaMemcpyHostToDevice, st);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int64_t chunks = slots[first + count - 1].walk_end;
    launch(first, count, static_cast<int>(chunks < grid ? chunks : grid));
    const int err = launched(kernel);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// rows per objective chunk: part_sum / part_cnt hold ceil(n / chunk) entries
int sid_lynch_chunk_rows() { return sid::kChunk; }

// f64 planes of the row record (lynch.cuh): the record is (planes, n) f64
int sid_lynch_record_planes() { return sid::kRecordPlanes; }

// kernel launches since load: 0 records, 1 objective, 2 marginals, 3 the
// lanes' objective, 4 the lanes' marginals, 5 a sharded fit's objective on
// one device, 6 the fit's kernel (one launch a fit)
long long sid_lynch_launches(int kernel) {
  return kernel >= 0 && kernel < kKernelCount ? g_launches[kernel].load() : -1;
}

// The grids of a workspace of n rows on the current device, from the
// occupancy of each kernel: grids[0] records, [1] objective (capped at
// the chunk count), [2] marginals. Called once per workspace.
int sid_lynch_grids(int64_t n, int* grids) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  cudaError_t err = resident_grid(lynch_records_kernel, blocks, &grids[0]);
  if (err == cudaSuccess)
    err = resident_grid(lynch_nll_kernel, (n + sid::kChunk - 1) / sid::kChunk, &grids[1]);
  if (err == cudaSuccess) err = resident_grid(lynch_marginals_kernel, blocks, &grids[2]);
  return static_cast<int>(err);
}

// The records of n rows. prof: (n, 4) int32 counts in 0..65535, 16-byte
// aligned; mult: (n,) int64 >= 0; tab: (tab_len,) f64; rec: (3, n) f64.
int sid_lynch_records_launch(const void* prof, const void* mult, const void* tab,
                             int tab_len, int64_t n, void* rec, int grid,
                             void* stream) {
  if (n <= 0) return 0;
  lynch_records_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(prof), static_cast<const int64_t*>(mult),
      static_cast<const double*>(tab), tab_len, n, static_cast<double*>(rec));
  return launched(kRecordsKernel);
}

// B2, one kernel. rec: (3, n) records; scalars: 16 host doubles
// (LynchScalars); flags: (n,) uint8; part_sum: (n_chunks,) f64; part_cnt:
// (n_chunks,) int32; ticket: one uint32, 0 between launches; out: (2,) f64
// on the card. With host_out (pinned, 2 doubles) not null, out is copied
// there and the stream is waited for. Returns a cudaError_t.
int sid_lynch_nll_launch(const void* rec, const double* scalars, int64_t n,
                         void* flags, void* part_sum, void* part_cnt,
                         void* ticket, void* out, int grid, double* host_out,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  lynch_nll_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const double*>(rec), unpack(scalars), n,
      (n + sid::kChunk - 1) / sid::kChunk, static_cast<uint8_t*>(flags),
      static_cast<double*>(part_sum), static_cast<int*>(part_cnt),
      static_cast<unsigned int*>(ticket), static_cast<double*>(out));
  const int err = launched(kNllKernel);
  return err != 0 ? err : fetch_and_wait(out, host_out, st);
}

// The shards one launch of a sharded fit's objective takes on a device,
// and the bytes of one ShardSlot (lynch.cuh) and of one PeerPull
int sid_lynch_shards_per_launch() { return kShardsPerLaunch; }
int sid_lynch_shard_slot_bytes() { return static_cast<int>(sizeof(sid::ShardSlot)); }
int sid_lynch_peer_pull_bytes() { return static_cast<int>(sizeof(PeerPull)); }

// The grid of a device's launch of a sharded fit's objective over n_chunks
// walk chunks, on the current device: the resident blocks, capped at the
// chunks. Called once per fit.
int sid_lynch_shards_grid(int64_t n_chunks, int* grid) {
  return static_cast<int>(resident_grid(lynch_nll_shards_kernel, n_chunks, grid));
}

// One evaluation of a sharded fit on the current device, one call.
// table: n_shards ShardSlot (at most kShardsPerLaunch) in host memory,
// copied into the launch's parameters;
// scalars: 16 host doubles (LynchScalars); part_sum (n_chunks,) f64 and
// part_cnt (n_chunks,) int32: the fit's chunk sums by global chunk.
// Without fold: the launch, then with done (a cudaEvent_t) not null the
// event recorded after it. With fold: first each of the n_pulls PeerPull
// of pulls (host memory): the stream waits for its event, then its copy;
// then the launch, which folds the n_chunks chunk sums into out (2,) f64
// (ticket: one uint32, 0 between launches); then with host_out (pinned, 2
// doubles) not null, out is copied there and the stream waited for. All on
// stream. Returns a cudaError_t.
int sid_lynch_nll_shards_launch(const void* table, int n_shards, const double* scalars, void* part_sum,
                                void* part_cnt, int64_t n_chunks, void* ticket, void* out, int fold,
                                const void* pulls, int n_pulls, void* done, int grid, double* host_out,
                                void* stream) {
  if (n_shards < 0 || n_shards > kShardsPerLaunch) return static_cast<int>(cudaErrorInvalidValue);
  ShardTable tab{};
  memcpy(tab.slot, table, sizeof(sid::ShardSlot) * static_cast<size_t>(n_shards));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fold && n_pulls > 0) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    const PeerPull* pull = static_cast<const PeerPull*>(pulls);
    for (int i = 0; i < n_pulls && e == cudaSuccess; ++i) {
      if (pull[i].event != nullptr) e = cudaStreamWaitEvent(st, static_cast<cudaEvent_t>(pull[i].event), 0);
      if (e != cudaSuccess) break;
      const size_t bytes = static_cast<size_t>(pull[i].bytes);
      e = pull[i].src_device == device
              ? cudaMemcpyAsync(pull[i].dst, pull[i].src, bytes, cudaMemcpyDeviceToDevice, st)
              : cudaMemcpyPeerAsync(pull[i].dst, device, pull[i].src, static_cast<int>(pull[i].src_device),
                                    bytes, st);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lynch_nll_shards_kernel<<<grid, kThreads, 0, st>>>(
      tab, n_shards, unpack(scalars), static_cast<double*>(part_sum),
      static_cast<int*>(part_cnt), n_chunks, static_cast<unsigned int*>(ticket), static_cast<double*>(out),
      fold);
  const int err = launched(kNllShardsKernel);
  if (err != 0) return err;
  if (!fold) {
    return done == nullptr ? 0 : static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(done), st));
  }
  return fetch_and_wait(out, host_out, st);
}

// B4. rec: (3, n) records; scalars as above (the pi entries unused);
// lhom, lhet: (n,) f64; flags: (n,) uint8. Returns a cudaError_t.
int sid_lynch_marginals_launch(const void* rec, const double* scalars, int64_t n,
                               void* lhom, void* lhet, void* flags, int grid,
                               void* stream) {
  if (n <= 0) return 0;
  lynch_marginals_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rec), unpack(scalars), n,
      static_cast<double*>(lhom), static_cast<double*>(lhet),
      static_cast<uint8_t*>(flags));
  return launched(kMarginalsKernel);
}

// The running lanes one launch of a lane kernel takes, and the bytes of
// one LaneSlot (lynch.cuh)
int sid_lynch_lanes_per_launch() { return kLanesPerLaunch; }
// rows per chunk of the lanes' marginals (the objective's: sid_lynch_chunk_rows)
int sid_lynch_marginals_chunk_rows() { return kMarginalsChunk; }
int sid_lynch_lane_slot_bytes() { return static_cast<int>(sizeof(sid::LaneSlot)); }

// The grids of a cohort workspace whose lanes have n_chunks objective
// chunks and n_marginals_chunks marginals chunks in all, on the current
// device: grids[0] the lanes' objective, grids[1] the lanes' marginals,
// each the resident blocks capped at its chunks. Called once per workspace.
int sid_lynch_lanes_grids(int64_t n_chunks, int64_t n_marginals_chunks, int* grids) {
  cudaError_t err = resident_grid(lynch_nll_lanes_kernel, n_chunks, &grids[0]);
  if (err == cudaSuccess) err = resident_grid(lynch_marginals_lanes_kernel, n_marginals_chunks, &grids[1]);
  return static_cast<int>(err);
}

// The blocks of kernel k (the launch counters' numbering) resident on one
// SM of the current device, from the occupancy API.
int sid_lynch_blocks_per_sm(int kernel, int* per_sm) {
  const void* fns[kKernelCount] = {
      reinterpret_cast<const void*>(lynch_records_kernel), reinterpret_cast<const void*>(lynch_nll_kernel),
      reinterpret_cast<const void*>(lynch_marginals_kernel), reinterpret_cast<const void*>(lynch_nll_lanes_kernel),
      reinterpret_cast<const void*>(lynch_marginals_lanes_kernel),
      reinterpret_cast<const void*>(lynch_nll_shards_kernel),
      reinterpret_cast<const void*>(lynch_fit_lanes_kernel<2>)};
  if (kernel < 0 || kernel >= kKernelCount) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fns[kernel], kThreads, 0));
}

// One round of the lanes' objective, one call: the launches of
// launch_groups over slots_host (n_slots LaneSlot, pinned), each group's
// results at out + 2 * its first slot; then, with host_out (pinned) not
// null, the copy of out (n_slots, 2) f64 there, enqueued (the caller
// waits for the stream).
// flags: (n,) uint8; part_sum, part_cnt: an entry for each chunk of the
// longest walk; slot_ticket: kLanesPerLaunch uint32, 0 between launches.
// Returns a cudaError_t.
int sid_lynch_nll_lanes_launch(const void* rec, int64_t n, const void* slots_host, int n_slots,
                               int upload, void* flags, void* part_sum, void* part_cnt,
                               void* slot_ticket, void* out, int grid, double* host_out,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_groups(slots_host, n_slots, upload, grid, st, kNllLanesKernel,
                                [&](int first, int count, int blocks) {
    lynch_nll_lanes_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const double*>(rec), n, count, static_cast<uint8_t*>(flags),
        static_cast<double*>(part_sum), static_cast<int*>(part_cnt),
        static_cast<unsigned int*>(slot_ticket), static_cast<double*>(out) + 2 * static_cast<int64_t>(first));
  });
  if (err != 0 || host_out == nullptr) return err;
  return static_cast<int>(cudaMemcpyAsync(host_out, out, 2 * sizeof(double) * static_cast<size_t>(n_slots),
                                          cudaMemcpyDeviceToHost, st));
}

// The lanes' marginals: the launches of launch_groups over slots_host
// (n_slots LaneSlot, pinned, each lane at its epsilon's scalars); lhom,
// lhet: (n,) f64; flags: (n,) uint8. Returns a cudaError_t.
int sid_lynch_marginals_lanes_launch(const void* rec, int64_t n, const void* slots_host, int n_slots,
                                     int upload, void* lhom, void* lhet, void* flags, int grid,
                                     void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_groups(slots_host, n_slots, upload, grid, st, kMarginalsLanesKernel,
                       [&](int, int count, int blocks) {
    lynch_marginals_lanes_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const double*>(rec), n, count, static_cast<double*>(lhom),
        static_cast<double*>(lhet), static_cast<uint8_t*>(flags));
  });
}

// ---- the fit's loop on the card ----
int sid_lynch_fit_lane_bytes() { return static_cast<int>(sizeof(sid::FitLane)); }
int sid_lynch_fit_state_bytes(int dims) {
  return dims == 1 ? static_cast<int>(sizeof(sid::FitLaneState<1>))
                   : dims == 2 ? static_cast<int>(sizeof(sid::FitLaneState<2>)) : -1;
}
// rows per unit of a fit's row work (lynch.cuh kUnitRows)
int sid_lynch_fit_unit_rows() { return sid::kUnitRows; }
// fits launched and run to their results (sid_lynch_fit_run) since load
long long sid_lynch_fits() { return g_fits.load(); }
// a fit whose launch timed out waiting for a lane (the fit kernel's wait)
int sid_lynch_fit_timed_out() { return kFitTimedOut; }

// A fit of n_lanes lanes in dims (1 or 2) dimensions on the current
// device, planned: its kernel's grid and runs (lynch.cuh fit_grid over
// the resident blocks from the occupancy API: a cooperative launch needs
// every block resident) and its buffers (device memory, kept as long as
// the plan): rec (3, n) records; lanes (n_lanes) FitLane; starts (n_lanes,
// 2 dims + 1) f64; state (n_lanes) FitLaneState; scalars (n_lanes, 16) f64
// with the eleven fixed ones in place; history (n_lanes, history_entries,
// dims + 2) f64; flags (n) uint8; terms (n) f64; part_sum, part_cnt an
// entry a chunk of the walk; chunk_ticket (the walk's chunks) and
// lane_ticket (n_lanes) uint32, 0; gen (n_lanes) uint64, 0; results
// (n_lanes, dims + 5) f64; counters 16 bytes, 0 (the epoch of a launch
// whose wait timed out, at 0); n_units and n_chunks, the walks' lengths
// (the last lane's unit_end and walk_end). A wait longer than wait_ns ends the
// launch with that error. *out receives the plan (for sid_lynch_fit_run,
// _enqueue, _grid and _destroy). Returns a cudaError_t.
int sid_lynch_fit_create(int dims, const void* rec, int64_t n, const void* lanes, int n_lanes, const void* starts,
                         void* state, void* scalars, void* history, int64_t history_entries, void* flags,
                         void* terms, void* part_sum, void* part_cnt, void* chunk_ticket, void* lane_ticket,
                         void* gen, void* results, void* counters, int64_t n_units, int64_t n_chunks, double tol,
                         int max_iterations, int dot_mode, int64_t wait_ns, void** out) {
  if ((dims != 1 && dims != 2) || n_lanes <= 0 || wait_ns < 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = dims == 1 ? reinterpret_cast<const void*>(lynch_fit_lanes_kernel<1>)
                             : reinterpret_cast<const void*>(lynch_fit_lanes_kernel<2>);
  int resident = 1;
  const cudaError_t e = resident_grid(fn, n_units, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  FitPlan* plan = new FitPlan();
  FitParams& p = plan->params;
  p.rec = static_cast<const double*>(rec);
  p.n = n;
  p.lanes = static_cast<const sid::FitLane*>(lanes);
  p.starts = static_cast<const double*>(starts);
  p.state = state;
  p.scalars = static_cast<double*>(scalars);
  p.history = static_cast<double*>(history);
  p.history_entries = history_entries;
  p.flags = static_cast<uint8_t*>(flags);
  p.terms = static_cast<double*>(terms);
  p.part_sum = static_cast<double*>(part_sum);
  p.part_cnt = static_cast<int*>(part_cnt);
  p.chunk_ticket = static_cast<unsigned int*>(chunk_ticket);
  p.lane_ticket = static_cast<unsigned int*>(lane_ticket);
  p.gen = static_cast<unsigned long long*>(gen);
  p.results = static_cast<double*>(results);
  p.error = static_cast<unsigned int*>(counters);
  p.n_units = n_units;
  p.n_chunks = n_chunks;
  p.tol = tol;
  p.wait_ns = static_cast<unsigned long long>(wait_ns);
  p.n_lanes = n_lanes;
  p.max_iterations = max_iterations;
  p.dot_mode = dot_mode;
  p.whole_chunks = sid::fit_whole_chunks(n_chunks, resident);
  p.epoch = 0;
  plan->kernel = fn;
  plan->grid = static_cast<int>(sid::fit_grid(n_units, n_chunks, resident));
  plan->result_bytes = static_cast<int64_t>(n_lanes) * (dims + 5) * static_cast<int64_t>(sizeof(double));
  *out = plan;
  return 0;
}

// The plan's grid (blocks of its launch)
int sid_lynch_fit_grid(void* plan) { return static_cast<FitPlan*>(plan)->grid; }

// The fit launched on stream: one cooperative launch of the fit kernel
// with a new epoch. Returns a cudaError_t.
int sid_lynch_fit_enqueue(void* plan, void* stream) {
  FitPlan* fp = static_cast<FitPlan*>(plan);
  // epoch 0 is the words' state before the first launch
  fp->params.epoch = fp->params.epoch == 0xffffffffu ? 1u : fp->params.epoch + 1u;
  void* args[] = {&fp->params};
  cudaLaunchCooperativeKernel(fp->kernel, dim3(static_cast<unsigned>(fp->grid)), dim3(kThreads), args, 0,
                              static_cast<cudaStream_t>(stream));
  return launched(kFitLanesKernel);
}

// One fit: its launch, then the lanes' results and the counters copied
// into pinned host memory (results_host: n_lanes x (dims + 5) f64;
// counters_host: 16 bytes), one stream sync. A launch whose wait timed
// out returns kFitTimedOut, its tickets set back to 0 first. Returns a
// cudaError_t or kFitTimedOut.
int sid_lynch_fit_run(void* plan, void* results_host, void* counters_host, void* stream) {
  FitPlan* fp = static_cast<FitPlan*>(plan);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = sid_lynch_fit_enqueue(plan, stream);
  if (err != 0) return err;
  cudaError_t e = cudaMemcpyAsync(results_host, fp->params.results, fp->result_bytes, cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess) e = cudaMemcpyAsync(counters_host, fp->params.error, 16, cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess) e = cudaStreamSynchronize(st);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned int timed_out = 0;
  memcpy(&timed_out, counters_host, sizeof(timed_out));
  if (timed_out == fp->params.epoch) {
    e = cudaMemsetAsync(fp->params.chunk_ticket, 0, sizeof(unsigned int) * static_cast<size_t>(fp->params.n_chunks), st);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(fp->params.lane_ticket, 0, sizeof(unsigned int) * static_cast<size_t>(fp->params.n_lanes), st);
    if (e == cudaSuccess) e = cudaStreamSynchronize(st);
    return e != cudaSuccess ? static_cast<int>(e) : kFitTimedOut;
  }
  ++g_fits;
  return 0;
}

void sid_lynch_fit_destroy(void* plan) { delete static_cast<FitPlan*>(plan); }

const char* sid_lynch_error_string(int err) {
  if (err == kFitTimedOut) return "a wait of the fit kernel timed out";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
