// The likelihood_ratio method's device LRT and Benjamini-Hochberg step-up
// on Hopper (lrt_bh.cuh).
//
// Replaces sid_tpu's XLA device programs of models/likelihood_ratio.py:49-66
// (the clamp, the -R prior and both LRTs, ops/stats.py:24
// lrt_pvalue_from_logs) and ops/stats.py:78 (adjust_benjamini_hochberg: a
// descending argsort, a scaled running min by associative_scan, a scatter
// and a clamp). No Pallas kernel stood behind either.
//
// lrt_pvalues_kernel: one thread a profile in a grid-stride loop; reads
// log_l_hom and log_l_het (16 B a profile), writes p1 and p2 (16 B). What
// bounds it: the two erfc, each ~100 f64 instructions with a division,
// against 32 B of traffic a profile; the grid is the kernel's resident blocks
// (occupancy API, asked once per device on the host).
//
// BH: the order comes from torch.argsort (a library sort, as sid_tpu leaves
// its sort to XLA); the scan is three passes over tiles of the sorted order,
// kThreads threads of `items` consecutive positions each:
//   bh_block_min_kernel   each tile's min of s (one block a tile);
//   bh_scan_blocks_kernel one block: the exclusive min of the tiles before
//                         each tile;
//   bh_adjust_kernel      each tile again: the threads' exclusive mins by a
//                         shared-memory scan, then each thread walks its
//                         positions, writes out[ord[i]] and, for p2, is_het.
// A single tile needs only the third pass. Every combine keeps the earlier
// operand on the left and min is exact, so the bits are the host BH's for
// any tile size (bh_adjust_kernel's grid). What bounds it: bytes, two
// gathers of p through ord and one scatter of the result (~40 B a profile
// with is_het), the gathers mostly from L2.
//
// Launch: on the caller's stream, no allocation (the torch wrapper passes
// the outputs and the scan's scratch), returns cudaGetLastError() after each
// launch so a refused launch is seen.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lrt_bh.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    lrt_pvalues_kernel(const double* __restrict__ lhom, const double* __restrict__ lhet,
                       int64_t n, sid::LrtParams p, double* __restrict__ p1,
                       double* __restrict__ p2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    double a, b;
    sid::lrt_pair(__ldg(lhom + i), __ldg(lhet + i), p, &a, &b);
    p1[i] = a;
    if (p2 != nullptr) p2[i] = b;
  }
}

// Inclusive scan of v over the block's T threads in thread order; returns
// this thread's value and leaves every thread's in res[0..T).
template <int T>
__device__ double block_scan(double v, double* buf, double* res) {
  const int t = threadIdx.x;
  double* in = buf;
  double* out = buf + T;
  in[t] = v;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    double x = in[t];
    if (t >= d) x = sid::min_first_nan(in[t - d], x);
    out[t] = x;
    __syncthreads();
    double* swap = in;
    in = out;
    out = swap;
  }
  res[t] = in[t];
  __syncthreads();
  return res[t];
}

// the min of s over this thread's `items` positions from `first`
__device__ __forceinline__ double thread_min(const double* p, const int64_t* ord,
                                             int64_t first, int items, int64_t m) {
  double agg = INFINITY;
  for (int k = 0; k < items; ++k) {
    const int64_t i = first + k;
    if (i >= m) break;
    agg = sid::min_first_nan(agg, sid::bh_scaled(__ldg(p + __ldg(ord + i)), i, m));
  }
  return agg;
}

__global__ void __launch_bounds__(kThreads)
    bh_block_min_kernel(const double* __restrict__ p, const int64_t* __restrict__ ord,
                        int64_t m, int items, double* __restrict__ block_min) {
  __shared__ double buf[2 * kThreads];
  __shared__ double res[kThreads];
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * items;
  block_scan<kThreads>(thread_min(p, ord, first, items, m), buf, res);
  if (threadIdx.x == 0) block_min[blockIdx.x] = res[kThreads - 1];
}

__global__ void __launch_bounds__(kScanThreads)
    bh_scan_blocks_kernel(const double* __restrict__ block_min, int64_t n_blocks,
                          double* __restrict__ prefix) {
  __shared__ double buf[2 * kScanThreads];
  __shared__ double res[kScanThreads];
  const int t = threadIdx.x;
  double carry = INFINITY;  // the min of every tile before this chunk
  for (int64_t base = 0; base < n_blocks; base += kScanThreads) {
    const int64_t b = base + t;
    block_scan<kScanThreads>(b < n_blocks ? block_min[b] : INFINITY, buf, res);
    if (b < n_blocks) prefix[b] = sid::min_first_nan(carry, t ? res[t - 1] : INFINITY);
    carry = sid::min_first_nan(carry, res[kScanThreads - 1]);
    __syncthreads();  // res is rewritten by the next chunk's scan
  }
}

__global__ void __launch_bounds__(kThreads)
    bh_adjust_kernel(const double* __restrict__ p, const int64_t* __restrict__ ord, int64_t m,
                    int items, const double* __restrict__ prefix, double alpha,
                    double* __restrict__ out, uint8_t* __restrict__ het) {
  __shared__ double buf[2 * kThreads];
  __shared__ double res[kThreads];
  const int t = threadIdx.x;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kThreads + t) * items;
  block_scan<kThreads>(thread_min(p, ord, first, items, m), buf, res);
  double run = t ? res[t - 1] : INFINITY;
  if (prefix != nullptr) run = sid::min_first_nan(prefix[blockIdx.x], run);
  for (int k = 0; k < items; ++k) {
    const int64_t i = first + k;
    if (i >= m) break;
    const int64_t j = __ldg(ord + i);
    run = sid::min_first_nan(run, sid::bh_scaled(__ldg(p + j), i, m));
    const double r = sid::bh_clamp(run);
    out[j] = r;
    if (het != nullptr) het[j] = r < alpha ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// lrt_pvalues_kernel's resident blocks on the whole current device (blocks
// an SM by the occupancy API x SMs); the caller computes it once per device.
int sid_lrt_resident_blocks(int* blocks) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lrt_pvalues_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * per_sm;
  return 0;
}

// lhom, lhet: n f64; params: the underflow line, log(1 - pi), log(pi) (3
// host doubles) and use_prior; p1: n f64; p2: n f64 or null (not written);
// resident: sid_lrt_resident_blocks's count. Returns a cudaError_t.
int sid_lrt_pvalues_launch(const void* lhom, const void* lhet, int64_t n, const double* params,
                           int use_prior, void* p1, void* p2, int resident, void* stream) {
  if (n <= 0) return 0;
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  const sid::LrtParams lp{params[0], params[1], params[2], use_prior};
  lrt_pvalues_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(lhom), static_cast<const double*>(lhet), n, lp,
      static_cast<double*>(p1), static_cast<double*>(p2));
  return static_cast<int>(cudaGetLastError());
}

// p: m f64; ord: m int64, the descending order of p; items: positions a
// thread (1..64); out: m f64; het: m bytes (p < alpha of the result) or
// null; scratch: 2 x the tiles' count f64 (unused for one tile). One launch
// for one tile, three otherwise. Returns a cudaError_t.
int sid_bh_adjust_launch(const void* p, const void* ord, int64_t m, int items, double alpha,
                         void* out, void* het, void* scratch, void* stream) {
  if (m <= 0) return 0;
  if (items < 1 || items > 64) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* pp = static_cast<const double*>(p);
  const int64_t* oo = static_cast<const int64_t*>(ord);
  const int64_t tile = static_cast<int64_t>(kThreads) * items;
  const int64_t n_blocks = (m + tile - 1) / tile;
  if (n_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_blocks);
  double* prefix = nullptr;
  if (n_blocks > 1) {
    double* block_min = static_cast<double*>(scratch);
    prefix = block_min + n_blocks;
    bh_block_min_kernel<<<grid, kThreads, 0, s>>>(pp, oo, m, items, block_min);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bh_scan_blocks_kernel<<<1, kScanThreads, 0, s>>>(block_min, n_blocks, prefix);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bh_adjust_kernel<<<grid, kThreads, 0, s>>>(pp, oo, m, items, prefix, alpha,
                                            static_cast<double*>(out),
                                            static_cast<uint8_t*>(het));
  return static_cast<int>(cudaGetLastError());
}

const char* sid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
