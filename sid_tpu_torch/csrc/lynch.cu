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
// nothing lane-specific), with lane row offsets. The host runs every
// lane's simplex in lockstep (exact/nmsimplex.py); each round is one launch
// of lynch_nll_lanes_kernel for every lane still running:
//   - chunks of kChunk rows start at each lane's first row (lynch.cuh
//     lane_chunks); blocks walk the running lanes' chunks grid-stride and
//     find a chunk's lane by a binary search over the running lanes' chunk
//     offsets (lane_of);
//   - each chunk reduces exactly as in lynch_nll_kernel into its own slot;
//     a per-lane atomic counter elects the block that completes a lane's
//     last chunk, and that block folds the lane's chunk sums in the
//     single-lane kernel's order and resets the counter. So each lane's
//     [sum, flagged count] is bitwise lynch_nll_kernel's over that lane's
//     rows alone, whatever the other lanes, the grid or the order in which
//     blocks finish;
//   - the (S, 16) scalars and the running lanes go up in one async copy
//     from pinned memory, the (S, 2) results come back in one, and the
//     round waits on one stream sync: one ctypes call a round.
// lynch_marginals_lanes_kernel is B4 for the whole cohort in one launch:
// each row finds its lane in the row offsets and reads that lane's
// scalars. What bounds them is what bounds B2 and B4 (f64 instructions);
// a lane's scalars are read from global memory (the same 128 bytes for a
// whole chunk, served by L1) instead of the kernel parameters.
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
// the lane kernels read their lane's scalars from global memory rather
// than the parameter bank, and need more registers for them
constexpr int kLanesMinBlocks = 2;

static_assert(sizeof(sid::LynchScalars) == 16 * sizeof(double),
              "LynchScalars must be 16 doubles");

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

// The objective of the running lanes. rec: (3, n) record of all lanes;
// row_off, chunk_off: (S+1) row and chunk offsets of the lanes;
// scalars: (S, 16) LynchScalars; active: the n_active running lanes in
// increasing order; act_chunk_off: (n_active + 1) offsets of their chunks
// in the walk; lane_ticket: (S) counters, 0 between launches; out: (S, 2)
// [sum of the unflagged terms, flagged count], written for running lanes.
__global__ void __launch_bounds__(kThreads, kLanesMinBlocks)
    lynch_nll_lanes_kernel(const double* __restrict__ rec, int64_t n,
                           const int64_t* __restrict__ row_off,
                           const int64_t* __restrict__ chunk_off,
                           const sid::LynchScalars* __restrict__ scalars,
                           const int* __restrict__ active,
                           const int64_t* __restrict__ act_chunk_off,
                           int n_active, uint8_t* __restrict__ flags,
                           double* part_sum, int* part_cnt,
                           unsigned int* lane_ticket, double* __restrict__ out) {
  __shared__ double sh_sum[kThreads];
  __shared__ int sh_cnt[kThreads];
  __shared__ bool sh_last;
  const int t = threadIdx.x;
  const int64_t total = act_chunk_off[n_active];
  for (int64_t j = blockIdx.x; j < total; j += gridDim.x) {
    const int a = sid::lane_of(act_chunk_off, n_active, j);
    const int lane = active[a];
    const int64_t local = j - act_chunk_off[a];
    const int64_t first_chunk = chunk_off[lane];
    const int64_t n_lane_chunks = chunk_off[lane + 1] - first_chunk;
    int cnt = 0;
    double v = sid::nll_rows_sum(row_off[lane] + local * sid::kChunk, row_off[lane + 1], t,
                                 rec, n, scalars[lane], flags, &cnt);
    block_fold(v, cnt, sh_sum, sh_cnt);
    // thread 0 holds the chunk's sum: store it, publish it, count the chunk
    if (t == 0) {
      part_sum[first_chunk + local] = v;
      part_cnt[first_chunk + local] = cnt;
      __threadfence();
      sh_last = atomicAdd(lane_ticket + lane, 1u) == n_lane_chunks - 1;
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
        out[2 * lane] = acc;
        out[2 * lane + 1] = static_cast<double>(lane_cnt);
        lane_ticket[lane] = 0;  // ready for the next round
      }
    }
  }
}

// B4 for every lane's rows at that lane's scalars. row_off: (S+1) row
// offsets; scalars: (S, 16).
__global__ void __launch_bounds__(kThreads, kLanesMinBlocks)
    lynch_marginals_lanes_kernel(const double* __restrict__ rec, int64_t n,
                                 const int64_t* __restrict__ row_off, int n_lanes,
                                 const sid::LynchScalars* __restrict__ scalars,
                                 double* __restrict__ lhom,
                                 double* __restrict__ lhet,
                                 uint8_t* __restrict__ flags) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int lane = sid::lane_of(row_off, n_lanes, i);
    bool flagged;
    const sid::Components k = sid::marginals_row(sid::read_record(rec, n, i), scalars[lane], &flagged);
    lhom[i] = k.lhom;
    lhet[i] = k.lhet;
    flags[i] = flagged ? 1 : 0;
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

// The grids of a cohort workspace of n rows in n_chunks lane chunks on the
// current device: grids[0] the lanes' objective (capped at the chunk
// count), grids[1] the lanes' marginals. Called once per workspace.
int sid_lynch_lanes_grids(int64_t n, int64_t n_chunks, int* grids) {
  cudaError_t err = resident_grid(lynch_nll_lanes_kernel, n_chunks, &grids[0]);
  if (err == cudaSuccess)
    err = resident_grid(lynch_marginals_lanes_kernel, (n + kThreads - 1) / kThreads, &grids[1]);
  return static_cast<int>(err);
}

// One round of the lanes' objective, one call. upload_host: pinned host
// bytes [scalars (n_lanes, 16) f64 | act_chunk_off (n_active + 1) int64 |
// active (n_active) int32], upload_bytes of them copied to upload_dev (the
// same layout, 8-byte aligned; none with upload_bytes 0, which launches
// again on what upload_dev holds); then the kernel; then, with host_out
// (pinned) not null, out (n_lanes, 2) f64 copied there and the stream
// waited for. row_off,
// chunk_off: (n_lanes + 1) int64 on the card; flags: (n,) uint8;
// part_sum, part_cnt: one slot a lane chunk; lane_ticket: (n_lanes)
// uint32, 0 between launches. Returns a cudaError_t.
int sid_lynch_nll_lanes_launch(const void* rec, int64_t n, const void* row_off,
                               const void* chunk_off, int n_lanes,
                               const void* upload_host, void* upload_dev,
                               int64_t upload_bytes, int n_active, void* flags,
                               void* part_sum, void* part_cnt, void* lane_ticket,
                               void* out, int grid, double* host_out,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (upload_bytes > 0)
    e = cudaMemcpyAsync(upload_dev, upload_host, static_cast<size_t>(upload_bytes),
                        cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const double* scalars = static_cast<const double*>(upload_dev);
  const int64_t* act_chunk_off = reinterpret_cast<const int64_t*>(scalars + 16 * static_cast<int64_t>(n_lanes));
  const int* active = reinterpret_cast<const int*>(act_chunk_off + n_active + 1);
  lynch_nll_lanes_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const double*>(rec), n, static_cast<const int64_t*>(row_off),
      static_cast<const int64_t*>(chunk_off),
      reinterpret_cast<const sid::LynchScalars*>(scalars), active, act_chunk_off, n_active,
      static_cast<uint8_t*>(flags), static_cast<double*>(part_sum), static_cast<int*>(part_cnt),
      static_cast<unsigned int*>(lane_ticket), static_cast<double*>(out));
  const int err = launched(kNllLanesKernel);
  if (err != 0 || host_out == nullptr) return err;
  e = cudaMemcpyAsync(host_out, out, 2 * sizeof(double) * static_cast<size_t>(n_lanes),
                      cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess) e = cudaStreamSynchronize(st);
  return static_cast<int>(e);
}

// The lanes' marginals. scalars_host: (n_lanes, 16) f64 in pinned memory,
// copied to scalars_dev first (none when null: the launch reads what
// scalars_dev holds); row_off: (n_lanes + 1) int64 on the card;
// lhom, lhet: (n,) f64; flags: (n,) uint8. Returns a cudaError_t.
int sid_lynch_marginals_lanes_launch(const void* rec, int64_t n, const void* row_off,
                                     int n_lanes, const void* scalars_host,
                                     void* scalars_dev, void* lhom, void* lhet,
                                     void* flags, int grid, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scalars_host != nullptr) {
    const cudaError_t e = cudaMemcpyAsync(scalars_dev, scalars_host,
                                          16 * sizeof(double) * static_cast<size_t>(n_lanes),
                                          cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lynch_marginals_lanes_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const double*>(rec), n, static_cast<const int64_t*>(row_off), n_lanes,
      static_cast<const sid::LynchScalars*>(scalars_dev), static_cast<double*>(lhom),
      static_cast<double*>(lhet), static_cast<uint8_t*>(flags));
  return launched(kMarginalsLanesKernel);
}

const char* sid_lynch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
