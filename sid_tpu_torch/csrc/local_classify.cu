// The `local` classify on Hopper: per unique profile, the top-2 alleles, the
// f64 log likelihoods (l1 hom at the major allele, l2 het at major + second)
// and the long-double range screen, from the counts alone.
//
// Replaces the TPU kernel sid_tpu/ops/pallas_classify.py
// (local_log_likelihoods_pallas, body _classify_kernel), which emulated f64
// with pairs of f32 (double-single) because the TPU has no f64, and took
// major / second from the XLA program sid_tpu/models/common.py:44
// (major_allele_indices, B8) and left the lgamma gathers to XLA. Here the
// arithmetic is native f64, term for term the f64 twin
// sid_tpu/models/local.py:71-95 (local_classify.cuh), and the top-2
// selection, the lgamma gathers and the range screen of
// models/local.py::long_double_range_rows are inside the kernel, so the host
// sends nothing but the counts and runs no argsort, coverage sum or screen.
//
// What bounds it: bytes. A row reads 8 B (four uint16 counts, one 8-byte
// load) and writes 17 B (l1, l2 and a byte: major, second, range flag), 25 B
// against the 40 B of the first port (int32 counts, host-made int32 allele
// indices, two f64); its ~60-200 f64 instructions (four log / log1p) are
// below the bytes' time at the card's FP64 rate. The design keeps the loads
// in flight and the grid full:
//   - a grid of exactly the resident blocks (the occupancy API, once per
//     device on the host), each thread walking rows grid-stride, so there
//     is no second wave of blocks;
//   - a register double buffer: each thread issues the next row's 8-byte
//     load before the current row's f64 math;
//   - the lgamma table's head (kTabHead entries, table_size's floor, so it
//     holds every index of coverage below 1023) staged in shared memory
//     once per block with cp.async, overlapped with the first row's load;
//     larger indices are read through __ldg as before (the same values,
//     so the same bits);
//   - launch bounds that ptxas meets with 0 spill bytes (chip_smoke.py
//     prints the -Xptxas -v line and asserts it).
//
// Launch: on the caller's stream, no allocation (the torch wrapper passes
// the output buffer), no device query (the caller passes the resident
// blocks it asked for once); returns cudaGetLastError() so a refused launch
// is seen.
#include <cuda_runtime.h>
#include <stdint.h>

#include "local_classify.cuh"

namespace {

constexpr int kThreads = 256;
// register budget: at most 65536 / (kMinBlocks * kThreads) registers a
// thread, so that ptxas reports 0 spill bytes
constexpr int kMinBlocks = 5;
constexpr int kTabHead = 1024;  // 8 KB of shared memory a block

// B5's launch bound: the blocks an SM it asks for. B5's rows read the
// table and the counts straight from global memory; B1's staging and
// prefetch, 5 blocks an SM and a tail regrouped by erfc's range arm were
// timed slower on the card (chip_smoke.B5_VARIANTS builds the first two by
// text substitution; PERF.md has the times).
constexpr int kLrtMinBlocks = 6;

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// the lgamma table's head into shared memory with cp.async (committed, not
// waited for); returns its length
__device__ __forceinline__ int stage_head(double* head, const double* tab, int tab_len) {
  const int head_len = tab_len < kTabHead ? tab_len : kTabHead;
  for (int k = threadIdx.x; k < head_len; k += kThreads) cp_async8(head + k, tab + k);
  asm volatile("cp.async.commit_group;\n" ::);
  return head_len;
}

__device__ __forceinline__ void wait_head() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// B1's row loop: the table's head staged, each thread's next row
// prefetched into registers, (l1, l2, byte) out
__device__ __forceinline__ void classify_rows(const uint2* __restrict__ counts, int64_t n,
                                              const sid::ClassifyParams& p,
                                              const double* __restrict__ tab, int tab_len,
                                              double* __restrict__ o1, double* __restrict__ o2,
                                              uint8_t* __restrict__ packed) {
  __shared__ double head[kTabHead];
  const int head_len = stage_head(head, tab, tab_len);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint2 next = i < n ? __ldg(counts + i) : make_uint2(0u, 0u);
  wait_head();

  const sid::StagedTable table{head, head_len, tab, tab_len};
  for (; i < n; i += stride) {
    const uint2 row = next;
    if (i + stride < n) next = __ldg(counts + i + stride);
    double a, b;
    const unsigned byte = sid::classify_row(row.x, row.y, p, table, &a, &b);
    o1[i] = a;
    o2[i] = b;
    packed[i] = static_cast<uint8_t>(byte);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    local_classify_kernel(const uint2* __restrict__ counts, int64_t n,
                          sid::ClassifyParams p, const double* __restrict__ tab,
                          int tab_len, double* __restrict__ l1,
                          double* __restrict__ l2, uint8_t* __restrict__ packed) {
  classify_rows(counts, n, p, tab, tab_len, l1, l2, packed);
}

// B5's rows one by one: classify_row_lrt (one erfc a row)
__device__ __forceinline__ void lrt_rows(const uint2* __restrict__ counts, int64_t n,
                                         const sid::ClassifyParams& p, const sid::LocalLrtParams& q,
                                         const double* __restrict__ tab, int tab_len, double z,
                                         double* __restrict__ o1, double* __restrict__ o2,
                                         uint8_t* __restrict__ packed) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const sid::GlobalTable table{tab, tab_len};
  for (; i < n; i += stride) {
    const uint2 row = __ldg(counts + i);
    double a, b;
    const unsigned byte = sid::classify_row_lrt(row.x, row.y, p, q, table, z, &a, &b);
    o1[i] = a;
    o2[i] = b;
    packed[i] = static_cast<uint8_t>(byte);
  }
}

// B5: the fused on-device LRT's classify (sid_tpu/models/local.py:30,
// classify_local, and its vmapped form population.py:287); zero is 0.0
// from the host, so erfc(0.0) is evaluated on the card, once a thread
__global__ void __launch_bounds__(kThreads, kLrtMinBlocks)
    local_classify_lrt_kernel(const uint2* __restrict__ counts, int64_t n,
                              sid::ClassifyParams p, sid::LocalLrtParams q, double zero,
                              const double* __restrict__ tab, int tab_len,
                              double* __restrict__ p1, double* __restrict__ p2,
                              uint8_t* __restrict__ packed) {
  lrt_rows(counts, n, p, q, tab, tab_len, erfc(zero), p1, p2, packed);
}

// A kernel's resident blocks on the whole current device (blocks an SM by
// the occupancy API x SMs); the caller computes it once per device.
template <class Kernel>
int resident_blocks(Kernel kernel, int* blocks) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * per_sm;
  return 0;
}

}  // namespace

extern "C" {

// The kernels' resident blocks on the whole current device; the caller
// computes them once per device.
int sid_local_classify_resident_blocks(int* blocks) {
  return resident_blocks(local_classify_kernel, blocks);
}

int sid_local_classify_lrt_resident_blocks(int* blocks) {
  return resident_blocks(local_classify_lrt_kernel, blocks);
}

// counts: (n, 4) uint16, 8-byte aligned; params: thr, ln4, K, prior,
// LD_LOG_MAX, -LD_LOG_MIN (6 host doubles) and `every`; tab: (tab_len,)
// f64; out: 17 n bytes, 8-byte aligned: l1 (n f64), l2 (n f64), then the
// n bytes; resident: sid_local_classify_resident_blocks's count. The grid is
// the resident blocks, or fewer where n needs fewer. Returns a cudaError_t.
int sid_local_classify_launch(const void* counts, int64_t n, const double* params,
                              int every, const void* tab, int tab_len, void* out,
                              int resident, void* stream) {
  if (n <= 0) return 0;
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  const sid::ClassifyParams p{params[0], params[1], params[2], params[3],
                              params[4], params[5], every};
  double* l1 = static_cast<double*>(out);
  local_classify_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(counts), n, p, static_cast<const double*>(tab),
      tab_len, l1, l1 + n, reinterpret_cast<uint8_t*>(l1 + 2 * n));
  return static_cast<int>(cudaGetLastError());
}

// B5 over the same counts, params and table as sid_local_classify_launch;
// lrt: log(1 - prior), log(prior), alpha (3 host doubles) and use_prior;
// out: 17 n bytes, 8-byte aligned: p1 (n f64), p2 (n f64), then the n bytes
// (B1's byte and is_het in bit 5); resident:
// sid_local_classify_lrt_resident_blocks's count. Returns a cudaError_t.
int sid_local_classify_lrt_launch(const void* counts, int64_t n, const double* params,
                                  int every, const double* lrt, int use_prior, const void* tab,
                                  int tab_len, void* out, int resident, void* stream) {
  if (n <= 0) return 0;
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  const sid::ClassifyParams p{params[0], params[1], params[2], params[3],
                              params[4], params[5], every};
  const sid::LocalLrtParams q{lrt[0], lrt[1], lrt[2], use_prior};
  double* p1 = static_cast<double*>(out);
  local_classify_lrt_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(counts), n, p, q, 0.0, static_cast<const double*>(tab), tab_len,
      p1, p1 + n, reinterpret_cast<uint8_t*>(p1 + 2 * n));
  return static_cast<int>(cudaGetLastError());
}

const char* sid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
