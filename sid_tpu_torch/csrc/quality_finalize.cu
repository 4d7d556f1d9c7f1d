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

}  // namespace

extern "C" {

// The kernel's resident blocks on the whole current device (blocks an SM by
// the occupancy API x SMs); the caller computes it once per device.
int sid_quality_finalize_resident_blocks(int* blocks) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quality_finalize_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * per_sm;
  return 0;
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

const char* sid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
