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
//     sums, so there is no second kernel and no serial tail on one SM.
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
//     constant bank, the (A, 2) results come back in one, and the round
//     waits on one stream sync: one ctypes call a round. More running lanes
//     than kLanesPerLaunch run in launches of at most that many, one after
//     another on the stream; lanes are independent, so no bit moves.
// lynch_marginals_lanes_kernel is B4 for the whole cohort in one launch,
// over a walk of every lane's chunks of kMarginalsChunk rows, each row at
// its lane's scalars.
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

// the running lanes of one launch of a lane kernel, written into the
// constant bank on the launch's stream just before it (58 KB of the 64 KB)
constexpr int kLanesPerLaunch = 384;
// the rows each thread takes of a chunk of the lanes' marginals, and so
// the rows of their chunks (the objective's chunks are sid::kChunk): one,
// so that a cohort of ~1,000 rows a lane still fills the card
constexpr int kMarginalsRowsPerThread = 1;
constexpr int kMarginalsChunk = kThreads * kMarginalsRowsPerThread;
__constant__ sid::LaneSlot c_slots[kLanesPerLaunch];

static_assert(sizeof(sid::LynchScalars) == 16 * sizeof(double),
              "LynchScalars must be 16 doubles");
static_assert(sizeof(sid::LaneSlot) == 19 * sizeof(double), "LaneSlot must be 152 bytes");

// kernel launches since the library was loaded: records, objective,
// marginals, the lanes' objective, the lanes' marginals
enum {
  kRecordsKernel = 0,
  kNllKernel = 1,
  kMarginalsKernel = 2,
  kNllLanesKernel = 3,
  kMarginalsLanesKernel = 4,
  kKernelCount = 5
};
std::atomic<long long> g_launches[kKernelCount];

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
  // thread 0 wrote this block's partials: publish them, then take a ticket
  if (t == 0) {
    __threadfence();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  // the last block: every partial is visible; read them from L2
  __threadfence();
  double acc = 0.0;
  int cnt = 0;
  for (int64_t base = 0; base < n_chunks; base += kThreads) {
    const int64_t i = base + t;
    acc = acc + (i < n_chunks ? __ldcg(part_sum + i) : 0.0);
    cnt = cnt + (i < n_chunks ? __ldcg(part_cnt + i) : 0);
  }
  block_fold(acc, cnt, sh_sum, sh_cnt);
  if (t == 0) {
    out[0] = acc;
    out[1] = static_cast<double>(cnt);
    *ticket = 0;  // ready for the next evaluation
  }
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
// lanes' objective, 4 the lanes' marginals
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
  if (err != 0 || host_out == nullptr) return err;
  cudaError_t e = cudaMemcpyAsync(host_out, out, 2 * sizeof(double),
                                  cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess) e = cudaStreamSynchronize(st);
  return static_cast<int>(e);
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
      reinterpret_cast<const void*>(lynch_marginals_lanes_kernel)};
  if (kernel < 0 || kernel >= kKernelCount) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fns[kernel], kThreads, 0));
}

// One round of the lanes' objective, one call: the launches of
// launch_groups over slots_host (n_slots LaneSlot, pinned), each group's
// results at out + 2 * its first slot; then, with host_out (pinned) not
// null, out (n_slots, 2) f64 copied there and the stream waited for.
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
  cudaError_t e = cudaMemcpyAsync(host_out, out, 2 * sizeof(double) * static_cast<size_t>(n_slots),
                                  cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess) e = cudaStreamSynchronize(st);
  return static_cast<int>(e);
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

const char* sid_lynch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
