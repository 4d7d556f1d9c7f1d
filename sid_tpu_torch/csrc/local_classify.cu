// Slim `local` classify on Hopper: per unique profile, the f64 log
// likelihoods (l1 hom at the major allele, l2 het at major + second).
//
// Replaces the TPU kernel sid_tpu/ops/pallas_classify.py
// (local_log_likelihoods_pallas, body _classify_kernel), which emulated f64
// with pairs of f32 (double-single) because the TPU has no f64, and left the
// multinomial's lgamma gathers to XLA. Here the arithmetic is native f64,
// term for term the f64 twin sid_tpu/models/local.py:71-95 (see
// local_classify.cuh), and the lgamma gathers are inside the kernel.
//
// What bounds it: bytes. Per profile it reads 16 B of counts (one int4
// load), 8 B of allele indices and five lgamma-table entries, and writes
// 16 B, against about ten f64 transcendentals (log, log1p) — far below the
// card's f64 rate per byte. So the design is one thread per profile in a
// grid-stride loop with coalesced 16-byte loads, the table read through the
// read-only path (__ldg; it is 8 KB at the 1024-entry floor, up to 2 MB at
// 65535x coverage, so it stays in global memory and lives in L1/L2). On the
// calling path the host<->device copies of those bytes dominate, not the
// kernel.
//
// Launch: on the caller's stream, no allocation (outputs come from the
// torch wrapper), returns cudaGetLastError() so a refused launch is seen.
#include <cuda_runtime.h>
#include <stdint.h>

#include "local_classify.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
    local_classify_kernel(const int4* __restrict__ prof,
                          const int32_t* __restrict__ major,
                          const int32_t* __restrict__ second, double thr,
                          const double* __restrict__ tab, int tab_len,
                          double* __restrict__ l1, double* __restrict__ l2,
                          int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int4 p = prof[i];
    const sid::LogLik2 r = sid::local_log_likelihoods_one(
        p.x, p.y, p.z, p.w, major[i], second[i], thr, tab, tab_len);
    l1[i] = r.l1;
    l2[i] = r.l2;
  }
}

}  // namespace

extern "C" {

// prof: (n, 4) int32, 16-byte aligned; major, second: (n,) int32;
// tab: (tab_len,) f64; l1, l2: (n,) f64. Returns a cudaError_t.
int sid_local_classify_launch(const void* prof, const void* major,
                              const void* second, double thr, const void* tab,
                              int tab_len, void* l1, void* l2, int64_t n,
                              void* stream) {
  if (n <= 0) return 0;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  local_classify_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(prof), static_cast<const int32_t*>(major),
      static_cast<const int32_t*>(second), thr,
      static_cast<const double*>(tab), tab_len, static_cast<double*>(l1),
      static_cast<double*>(l2), n);
  return static_cast<int>(cudaGetLastError());
}

const char* sid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
