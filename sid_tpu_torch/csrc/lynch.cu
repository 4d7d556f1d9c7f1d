// The Lynch fit on Hopper: the compound objective (B2) and the per-profile
// marginals at the fitted error rate (B4).
//
// Replaces the XLA programs of sid_tpu that have no Pallas form:
//   B2  sid_tpu/ops/likelihoods.py:138 compound_neg_log_likelihood, evaluated
//       once per simplex step inside models/lynch.py:73-76 (fit_lynch);
//   B4  sid_tpu/ops/likelihoods.py:40,69 log_het_marginal / log_hom_marginal
//       at the fitted epsilon, models/lynch.py:81-83.
// The per-profile math is lynch.cuh, shared with a g++ host build for the CPU
// tests. The theta-dependent scalars (every log of pi, epsilon and the base
// composition) come in from the host, so the kernel's own transcendentals are
// the 11 exp and 3 log/log1p of the two log-sum-exps and the logaddexp.
//
// What bounds it: per profile 16 B of counts and 8 B of multiplicity in,
// one flag byte out, five lgamma-table reads, against ~14 f64
// transcendentals; at U = 1M that is 25 MB per evaluation, and the f64
// transcendental rate, not bandwidth, is the likelier limit. So the design
// is one thread per profile (a chunk of 4 rows per thread for the
// objective), 16-byte loads, the table through the read-only path.
//
// The objective's sum has a fixed order (lynch.cuh): each chunk of kChunk
// rows reduces in a fixed per-thread order and a fixed shared-memory tree
// into its own partial slot, and a second one-block pass folds the partials
// in a fixed order. Blocks walk chunks grid-stride, so the sum does not
// depend on the grid size or the number of SMs, and there are no atomics:
// the fit's (pi, epsilon) are bitwise repeatable, as a later multi-GPU
// split of the same chunks needs. Rows the long-double range screen flags
// add 0.0 and are counted; the host adds their long-double terms.
//
// Launch: on the caller's stream, no allocation (the wrapper passes every
// buffer), returns cudaGetLastError() so a refused launch is seen.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "lynch.cuh"

namespace {

constexpr int kThreads = sid::kReduceThreads;
constexpr int kBlocksPerSm = 8;

static_assert(sizeof(sid::LynchScalars) == 16 * sizeof(double),
              "LynchScalars must be 16 doubles");

__device__ void tree_fold(double* sh_sum, int* sh_cnt) {
  const int t = threadIdx.x;
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      sh_sum[t] = sh_sum[t] + sh_sum[t + s];
      sh_cnt[t] = sh_cnt[t] + sh_cnt[t + s];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    lynch_nll_chunks(const int32_t* __restrict__ prof,
                     const int64_t* __restrict__ mult, sid::LynchScalars s,
                     const double* __restrict__ tab, int tab_len, int64_t n,
                     int64_t n_chunks, uint8_t* __restrict__ flags,
                     double* __restrict__ part_sum, int* __restrict__ part_cnt) {
  __shared__ double sh_sum[kThreads];
  __shared__ int sh_cnt[kThreads];
  const int t = threadIdx.x;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    int cnt = 0;
    sh_sum[t] = sid::lynch_thread_sum(chunk, t, prof, mult, s, tab, tab_len, n,
                                      flags, &cnt);
    sh_cnt[t] = cnt;
    __syncthreads();
    tree_fold(sh_sum, sh_cnt);
    if (t == 0) {
      part_sum[chunk] = sh_sum[0];
      part_cnt[chunk] = sh_cnt[0];
    }
    __syncthreads();  // the next chunk reuses the shared arrays
  }
}

// one block: out[0] = the sum of the partials, out[1] = the flagged count
__global__ void __launch_bounds__(kThreads)
    lynch_nll_total(const double* __restrict__ part_sum,
                    const int* __restrict__ part_cnt, int64_t n_chunks,
                    double* __restrict__ out) {
  __shared__ double sh_sum[kThreads];
  __shared__ int sh_cnt[kThreads];
  const int t = threadIdx.x;
  double acc = 0.0;
  int cnt = 0;
  for (int64_t base = 0; base < n_chunks; base += kThreads) {
    const int64_t i = base + t;
    acc = acc + (i < n_chunks ? part_sum[i] : 0.0);
    cnt = cnt + (i < n_chunks ? part_cnt[i] : 0);
  }
  sh_sum[t] = acc;
  sh_cnt[t] = cnt;
  __syncthreads();
  tree_fold(sh_sum, sh_cnt);
  if (t == 0) {
    out[0] = sh_sum[0];
    out[1] = static_cast<double>(sh_cnt[0]);
  }
}

__global__ void __launch_bounds__(kThreads)
    lynch_marginals_kernel(const int32_t* __restrict__ prof,
                           sid::LynchScalars s, const double* __restrict__ tab,
                           int tab_len, int64_t n, double* __restrict__ lhom,
                           double* __restrict__ lhet,
                           uint8_t* __restrict__ flags) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int c[4];
    sid::load_profile(prof, i, c);
    const sid::LynchRow r = sid::lynch_row(c[0], c[1], c[2], c[3], s, tab, tab_len);
    lhom[i] = r.lhom;
    lhet[i] = r.lhet;
    flags[i] = r.flag_marginals ? 1 : 0;
  }
}

cudaError_t default_grid(int64_t needed, int* grid) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  *grid = static_cast<int>(needed < cap ? needed : cap);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// rows per objective chunk: part_sum / part_cnt hold ceil(n / chunk) entries
int sid_lynch_chunk_rows() { return sid::kChunk; }

// B2. prof: (n, 4) int32, 16-byte aligned; mult: (n,) int64; scalars: 16
// host doubles (LynchScalars); tab: (tab_len,) f64; flags: (n,) uint8;
// part_sum: (n_chunks,) f64; part_cnt: (n_chunks,) int32; out: (2,) f64.
// grid <= 0 picks min(n_chunks, 8 blocks per SM). Returns a cudaError_t.
int sid_lynch_nll_launch(const void* prof, const void* mult,
                         const double* scalars, const void* tab, int tab_len,
                         int64_t n, void* flags, void* part_sum, void* part_cnt,
                         void* out, int grid, void* stream) {
  sid::LynchScalars s;
  memcpy(&s, scalars, sizeof(s));
  const int64_t n_chunks = (n + sid::kChunk - 1) / sid::kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    if (grid <= 0) {
      const cudaError_t err = default_grid(n_chunks, &grid);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    lynch_nll_chunks<<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(prof), static_cast<const int64_t*>(mult), s,
        static_cast<const double*>(tab), tab_len, n, n_chunks,
        static_cast<uint8_t*>(flags), static_cast<double*>(part_sum),
        static_cast<int*>(part_cnt));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lynch_nll_total<<<1, kThreads, 0, st>>>(
      static_cast<const double*>(part_sum), static_cast<const int*>(part_cnt),
      n_chunks, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// B4. prof: (n, 4) int32, 16-byte aligned; scalars as above (the pi entries
// unused); lhom, lhet: (n,) f64; flags: (n,) uint8. Returns a cudaError_t.
int sid_lynch_marginals_launch(const void* prof, const double* scalars,
                               const void* tab, int tab_len, int64_t n,
                               void* lhom, void* lhet, void* flags,
                               void* stream) {
  if (n <= 0) return 0;
  sid::LynchScalars s;
  memcpy(&s, scalars, sizeof(s));
  int grid = 0;
  const cudaError_t err = default_grid((n + kThreads - 1) / kThreads, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  lynch_marginals_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(prof), s, static_cast<const double*>(tab),
      tab_len, n, static_cast<double*>(lhom), static_cast<double*>(lhet),
      static_cast<uint8_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

const char* sid_lynch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
