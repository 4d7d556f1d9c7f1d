// The quality finalize's het side on Hopper: per site, the allele-balance
// binomial ln C(n, k) - n ln 2 added to the per-read het sum, the 80-bit
// underflow clamp and the prior (quality_finalize.cuh).
//
// Replaces sid_tpu's XLA program sid_tpu/models/quality.py:113
// (finalize_quality_het_nk, reached through finalize_quality_het :90), which
// took (n, k) planes the host had gathered; sid_tpu added the prior on the
// host after it, and this kernel adds it too. Here the kernel gathers n and k
// from the counts itself, as the local classify kernel does its top-2, and
// the operation order is libsidtpu's sidtpu_quality_finalize, so the result
// is bitwise the host's (XLA contracts n * ln2 into an FMA and is not). The
// hom side (a clamp and one add) stays on the host.
//
// What bounds it: bytes. A site reads 8 B of counts (four uint16, one 8-byte
// load), 1 B of alleles and 8 B of log_het, and writes 8 B: 25 B, at 7 f64
// operations and three table reads (the table, 1 MB, stays in L2). The
// design is the simple one: one thread a site in a grid-stride loop, the
// grid the kernel's resident blocks from the occupancy API (asked once per
// device on the host), the table read through __ldg.
//
// quality_finalize_lrt_kernel is the full form for the exact_pvalues=False
// flow, in place of sid_tpu's XLA program sid_tpu/models/quality.py:133
// (finalize_quality): the same het side, then the hom clamp and prior, both
// LRT p-values and is_het, 25 B in and 17 B out a site. Its erfc (~100 f64
// instructions) weighs about as much as the bytes, so:
//   - one erfc a site (quality_finalize.cuh quality_lrt_row): the two
//     p-values take erfc(sqrt(max(0, d))) and erfc(sqrt(max(0, -d))), at
//     most one argument positive, so one erfc serves that side and the
//     other takes erfc(0.0), which each thread evaluates once from a 0.0
//     the host passes (the card's own erfc, not a constant); the bits are
//     the two-erfc form's (quality_lrt_row_two_erfc);
//   - one site a thread in a grid-stride loop (a thread taking two in
//     16-byte accesses was 3-4 % slower: more registers, fewer blocks);
//   - a launch bound of kLrtMinBlocks blocks an SM, the grid the resident
//     blocks.
//
// A site whose n + 1 lies past the table gets NaN and adds one to a miss
// count, zeroed on the stream before the kernel; the wrapper raises on a
// non-zero count (sid_tpu's host pass returned -1 for the same table).
//
// Launch: on the caller's stream, no allocation, no device query; returns
// cudaGetLastError() so a refused launch is seen.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quality_finalize.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    quality_finalize_kernel(const uint2* __restrict__ counts,
                            const uint8_t* __restrict__ alleles,
                            const double* __restrict__ log_het, int64_t n,
                            sid::QualityParams p, const double* __restrict__ tab,
                            int tab_len, double* __restrict__ out,
                            unsigned* __restrict__ misses) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint2 c = __ldg(counts + i);
    bool miss;
    out[i] = sid::quality_het_row(c.x, c.y, __ldg(alleles + i), __ldg(log_het + i), p, tab,
                                  tab_len, &miss);
    if (miss) atomicAdd(misses, 1u);
  }
}

// the blocks an SM B6's full form's launch bound asks for: the fastest of
// the variants timed on the card (chip_smoke.py --lrt-variants builds the
// others by text substitution; PERF.md has the times)
constexpr int kLrtMinBlocks = 4;

// B6's full form (sid_tpu/models/quality.py:133, finalize_quality): reads
// the het side's 17 B a site and log_hom (8 B), writes p1, p2 and is_het
// (17 B); zero is 0.0 from the host, so erfc(0.0) is evaluated on the card
__global__ void __launch_bounds__(kThreads, kLrtMinBlocks)
    quality_finalize_lrt_kernel(const uint2* __restrict__ counts,
                                const uint8_t* __restrict__ alleles,
                                const double* __restrict__ log_het,
                                const double* __restrict__ log_hom, int64_t n,
                                sid::QualityParams p, sid::QualityLrtParams q, double zero,
                                const double* __restrict__ tab, int tab_len,
                                double* __restrict__ p1, double* __restrict__ p2,
                                uint8_t* __restrict__ het, unsigned* __restrict__ misses) {
  const double z = erfc(zero);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint2 c = __ldg(counts + i);
    bool miss;
    double a, b;
    het[i] = sid::quality_lrt_row(c.x, c.y, __ldg(alleles + i), __ldg(log_hom + i),
                                  __ldg(log_het + i), p, q, tab, tab_len, z, &miss, &a, &b);
    p1[i] = a;
    p2[i] = b;
    if (miss) atomicAdd(misses, 1u);
  }
}

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

// The kernels' resident blocks on the whole current device (blocks an SM by
// the occupancy API x SMs); the caller computes them once per device.
int sid_quality_finalize_resident_blocks(int* blocks) {
  return resident_blocks(quality_finalize_kernel, blocks);
}

int sid_quality_finalize_lrt_resident_blocks(int* blocks) {
  return resident_blocks(quality_finalize_lrt_kernel, blocks);
}

// counts: (n, 4) uint16, 8-byte aligned; alleles: n bytes (major | second
// << 2); log_het: n f64; params: ln2, the underflow line, log(prior) (3
// host doubles) and use_prior; tab: (tab_len,) f64; out: n f64; misses: one
// uint32, zeroed here on the stream first; resident:
// sid_quality_finalize_resident_blocks's count. The grid is the resident
// blocks, or fewer where n needs fewer. Returns a cudaError_t.
int sid_quality_finalize_launch(const void* counts, const void* alleles, const void* log_het,
                                int64_t n, const double* params, int use_prior, const void* tab,
                                int tab_len, void* out, void* misses, int resident, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(misses, 0, sizeof(unsigned), s);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  const sid::QualityParams p{params[0], params[1], params[2], use_prior};
  quality_finalize_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint2*>(counts), static_cast<const uint8_t*>(alleles),
      static_cast<const double*>(log_het), n, p, static_cast<const double*>(tab), tab_len,
      static_cast<double*>(out), static_cast<unsigned*>(misses));
  return static_cast<int>(cudaGetLastError());
}

// The full form over the same counts, alleles, log_het, params, table and
// misses as sid_quality_finalize_launch; log_hom: n f64; lrt: log(1 -
// prior), alpha (2 host doubles); out: 17 n bytes, 8-byte aligned: p1 (n
// f64), p2 (n f64), then is_het (n bytes); resident:
// sid_quality_finalize_lrt_resident_blocks's count. Returns a cudaError_t.
int sid_quality_finalize_lrt_launch(const void* counts, const void* alleles, const void* log_het,
                                    const void* log_hom, int64_t n, const double* params,
                                    int use_prior, const double* lrt, const void* tab,
                                    int tab_len, void* out, void* misses, int resident,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(misses, 0, sizeof(unsigned), s);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  const sid::QualityParams p{params[0], params[1], params[2], use_prior};
  const sid::QualityLrtParams q{lrt[0], lrt[1]};
  double* p1 = static_cast<double*>(out);
  quality_finalize_lrt_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint2*>(counts), static_cast<const uint8_t*>(alleles),
      static_cast<const double*>(log_het), static_cast<const double*>(log_hom), n, p, q, 0.0,
      static_cast<const double*>(tab), tab_len, p1, p1 + n,
      reinterpret_cast<uint8_t*>(p1 + 2 * n), static_cast<unsigned*>(misses));
  return static_cast<int>(cudaGetLastError());
}

const char* sid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
