// The likelihood_ratio method's device LRT and Benjamini-Hochberg step-up
// on Hopper (lrt_bh.cuh, bh_sort.cuh).
//
// Replaces sid_tpu's XLA device programs of models/likelihood_ratio.py:49-66
// (the clamp, the -R prior and both LRTs, ops/stats.py:24
// lrt_pvalue_from_logs) and ops/stats.py:78 (adjust_benjamini_hochberg: a
// descending argsort, a scaled running min by associative_scan, a scatter
// and a clamp). No Pallas kernel stood behind either.
//
// lrt_pvalues_kernel: reads log_l_hom and log_l_het (16 B a profile),
// writes p1 and p2 (16 B). What bounds it: its erfc, ~100 f64 instructions
// with a division, against 32 B of traffic a profile. The design:
//   - one erfc a profile (lrt_bh.cuh lrt_row): the two p-values take
//     erfc(sqrt(max(0, d))) and erfc(sqrt(max(0, -d))), and at most one of
//     those arguments is positive, so one erfc serves that side and the
//     other takes erfc(0.0), evaluated once a thread from a 0.0 the host
//     passes (the card's own erfc, not a constant 1.0); the bits are the
//     two-erfc form's (lrt_pair_two_erfc);
//   - one profile a thread in a grid-stride loop (a thread taking two in
//     16-byte double2 accesses was 6 % faster at U = 1M and 16 % slower at
//     the likelihood-ratio path's U of ~2,000 profiles; PERF.md);
//   - a launch bound of kLrtMinBlocks blocks an SM and a grid of the
//     kernel's resident blocks (occupancy API, asked once per device on
//     the host). A one-sided call (p2 null) computes the same row and
//     stores p1 alone.
//
// BH, order included, with no library sort and no torch elementwise op:
//   m <= kSmallMax (8,192): bh_small_kernel, one block an array (one launch
//     for p1 and p2 together): p and the positions in shared memory, the
//     key, an 8-bit LSD radix sort in shared memory (digits that are the
//     same in every key skipped), the scan and the scatter;
//   larger m: bh_histogram_kernel (every digit's counts at once; zeroes the
//     look-back state), bh_plan_kernel (bin offsets, the digits to skip),
//     one bh_radix_pass_kernel a digit (a skipped digit's launch returns at
//     once; the first real pass makes the key from p itself) and
//     bh_scan_kernel: a chained scan with decoupled look-back over tiles of
//     the sorted order. Each tile publishes its aggregate, then its
//     inclusive prefix; the flag lives apart from the f64 value (NaN and
//     +inf are values) behind a fence; every combine keeps the earlier tile
//     on the left (sid::min_first_nan). A tile's positions and p values
//     are loaded warp-striped and read back blocked through shared memory
//     (p taken back from the sorted key, gathered only for zeros and NaN),
//     out and is_het are scattered.
// The sort's pairs are 12 B (a 64-bit key, a 32-bit position: m < 2^31);
// its digits, tiles and the scan's are bh_sort.cuh's constants.
// Its tiles and the scan's take their numbers from per-launch counters
// (atomicAdd), so a tile waits only on tiles that have started. min is
// exact and associative with the first NaN winning and ties giving the
// later operand (np.minimum's rule), so the result is the host BH's bits
// for any tiling.
// What bounds it: bytes. The function itself reads p and writes out and
// is_het (17 B a p-value); a radix sort of 12 B pairs reads and writes each
// pair once a pass (8 passes of 8-bit digits). The scatter is staged in
// shared memory in digit order so each bin's run is stored contiguously.
//
// Launch: on the caller's stream, no allocation (the torch wrapper passes
// the outputs and the scratch: sid_bh_scratch_bytes), returns
// cudaGetLastError() after each launch so a refused launch is seen.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bh_sort.cuh"
#include "lrt_bh.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanThreads = 1024;
// look-back words a sort thread reads at once (the fastest of the widths
// timed on the card, and the fewest registers)
constexpr int kLookBack = 4;

// the blocks an SM lrt_pvalues_kernel's launch bound asks for: the fastest
// of the variants timed on the card (chip_smoke.py --lrt-variants builds
// the others by text substitution; PERF.md has the times)
constexpr int kLrtMinBlocks = 4;

__global__ void __launch_bounds__(kThreads, kLrtMinBlocks)
    lrt_pvalues_kernel(const double* __restrict__ lhom, const double* __restrict__ lhet,
                       int64_t n, sid::LrtParams p, double zero, double* __restrict__ p1,
                       double* __restrict__ p2) {
  const double z = erfc(zero);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    double a, b;
    sid::lrt_row(__ldg(lhom + i), __ldg(lhet + i), p, z, &a, &b);
    p1[i] = a;
    if (p2 != nullptr) p2[i] = b;
  }
}

// ---- BH ----

// one multi-block BH's scratch (bh_sort.cuh BhLayout)
struct BhSort {
  uint64_t* keys[2];
  uint32_t* vals[2];
  uint32_t* block_hist;            // [hist_blocks][passes][bins]
  uint32_t* offsets;               // [passes][bins], each digit's exclusive bin offsets
  int* trivial;                    // [passes], 1 where one bin holds every key
  unsigned long long* status;      // [sort_tiles][bins]
  unsigned int* counters;          // [passes]: the passes' tile counters
  unsigned int* scan_counter;      // the scan's tile counter
  int* scan_flag;                  // [scan_tiles]: 0, 1 aggregate, 2 inclusive
  double* scan_agg;                // [scan_tiles]
  double* scan_incl;               // [scan_tiles]
  int hist_blocks, sort_tiles, scan_tiles;
};

BhSort bh_sort_of(void* scratch, const sid::BhLayout& l) {
  char* base = static_cast<char*>(scratch);
  BhSort s;
  for (int b = 0; b < 2; ++b) {
    s.keys[b] = reinterpret_cast<uint64_t*>(base + l.keys[b]);
    s.vals[b] = reinterpret_cast<uint32_t*>(base + l.vals[b]);
  }
  s.block_hist = reinterpret_cast<uint32_t*>(base + l.block_hist);
  s.offsets = reinterpret_cast<uint32_t*>(base + l.offsets);
  s.trivial = reinterpret_cast<int*>(base + l.trivial);
  s.status = reinterpret_cast<unsigned long long*>(base + l.status);
  s.counters = reinterpret_cast<unsigned int*>(base + l.counters);
  s.scan_counter = reinterpret_cast<unsigned int*>(base + l.scan_counter);
  s.scan_flag = reinterpret_cast<int*>(base + l.scan_flag);
  s.scan_agg = reinterpret_cast<double*>(base + l.scan_agg);
  s.scan_incl = reinterpret_cast<double*>(base + l.scan_incl);
  s.hist_blocks = l.hist_blocks;
  s.sort_tiles = l.sort_tiles;
  s.scan_tiles = l.scan_tiles;
  return s;
}

__device__ __forceinline__ unsigned long long load_volatile(const unsigned long long* a) {
  return *reinterpret_cast<const volatile unsigned long long*>(a);
}
__device__ __forceinline__ void store_volatile(unsigned long long* a, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(a) = v;
}
__device__ __forceinline__ int load_volatile(const int* a) {
  return *reinterpret_cast<const volatile int*>(a);
}
__device__ __forceinline__ void store_volatile(int* a, int v) {
  *reinterpret_cast<volatile int*>(a) = v;
}
__device__ __forceinline__ double load_volatile(const double* a) {
  return *reinterpret_cast<const volatile double*>(a);
}

// Exclusive running min (sid::min_first_nan: first NaN, else the later of a tie) of
// v over the block's threads in thread order: a shuffle scan in each warp,
// then one of the warps' totals. Returns this thread's exclusive value and
// sets *total to the block's; slots: kT / 32 doubles of shared memory.
template <int kT>
__device__ __forceinline__ double block_exclusive_min(double v, double* slots, double* total) {
  constexpr int kWarps = kT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = sid::min_first_nan(y, x);
  }
  if (lane == 31) slots[warp] = x;
  __syncthreads();
  if (warp == 0) {
    double w = lane < kWarps ? slots[lane] : INFINITY;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = sid::min_first_nan(y, w);
    }
    if (lane < kWarps) slots[lane] = w;
  }
  __syncthreads();
  double before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = INFINITY;
  *total = slots[kWarps - 1];
  return warp ? sid::min_first_nan(slots[warp - 1], before) : before;
}

// every digit's counts of this block's keys (kPasses x kBins uint32 of
// dynamic shared memory); the look-back state zeroed
__global__ void __launch_bounds__(sid::kSortThreads)
    bh_histogram_kernel(const double* __restrict__ p, int64_t m, BhSort s) {
  constexpr int kBins = sid::kSortBins;
  constexpr int kPasses = sid::kSortPasses;
  extern __shared__ uint32_t hist[];
  const int t = threadIdx.x;
  for (int k = t; k < kPasses * kBins; k += sid::kSortThreads) hist[k] = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * sid::kSortThreads;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * sid::kSortThreads + t;
  const int64_t n_status = static_cast<int64_t>(s.sort_tiles) * kBins;
  for (int64_t k = g; k < n_status; k += stride) s.status[k] = 0;
  for (int64_t k = g; k < s.scan_tiles; k += stride) s.scan_flag[k] = 0;
  if (g < kPasses) s.counters[g] = 0;
  if (g == 0) *s.scan_counter = 0;
  __syncthreads();
  for (int64_t i = g; i < m; i += stride) {
    const uint64_t key = sid::bh_radix_key(__ldg(p + i));
#pragma unroll
    for (int q = 0; q < kPasses; ++q) atomicAdd(hist + q * kBins + sid::radix_digit(key, q, sid::kSortBits), 1u);
  }
  __syncthreads();
  uint32_t* out = s.block_hist + static_cast<int64_t>(blockIdx.x) * kPasses * kBins;
  for (int k = t; k < kPasses * kBins; k += sid::kSortThreads) out[k] = hist[k];
}

// block `pass`: the digit's counts summed over the histogram's blocks, its
// exclusive bin offsets, and whether one bin holds every key
__global__ void __launch_bounds__(kPlanThreads)
    bh_plan_kernel(const double* __restrict__ p, int64_t m, BhSort s) {
  constexpr int kBins = sid::kSortBins;
  constexpr int kPasses = sid::kSortPasses;
  constexpr int kPer = (kBins + kPlanThreads - 1) / kPlanThreads;
  __shared__ uint32_t warp_sum[kPlanThreads / 32];
  const int pass = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned first = sid::radix_digit(sid::bh_radix_key(__ldg(p)), pass, sid::kSortBits);
  uint32_t c[kPer];
  uint32_t local = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = t * kPer + k;
    uint32_t sum = 0;
    if (b < kBins)
      for (int g = 0; g < s.hist_blocks; ++g)
        sum += s.block_hist[(static_cast<int64_t>(g) * kPasses + pass) * kBins + b];
    c[k] = sum;
    local += sum;
  }
  uint32_t x = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  uint32_t run = x - local + (warp ? warp_sum[warp - 1] : 0u);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = t * kPer + k;
    if (b >= kBins) continue;
    s.offsets[pass * kBins + b] = run;
    run += c[k];
    if (b == static_cast<int>(first)) s.trivial[pass] = c[k] == static_cast<uint32_t>(m) ? 1 : 0;
  }
}

// Exclusive sum of v over the block's kT threads in thread order; slots:
// kT / 32 words of shared memory. Returns this thread's exclusive sum.
template <int kT>
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v, uint32_t* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) slots[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += slots[w];
  return before + x - v;
}

// One digit's stable scatter of the (key, position) pairs over tiles of
// kSortTile (bh_sort.cuh); a digit that is the same in every key returns.
// The pairs are staged in shared memory in the tile's digit order, so the
// stores to each bin's run of the output are consecutive (dynamic shared
// memory: sid::kPassSmemBytes).
__global__ void __launch_bounds__(sid::kSortThreads)
    bh_radix_pass_kernel(const double* __restrict__ p, int64_t m, int pass, BhSort s) {
  constexpr int kBits = sid::kSortBits;
  constexpr int kBins = sid::kSortBins;
  constexpr int kOwn = kBins / sid::kSortThreads;  // bins a thread owns, consecutive
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* warp_cnt = reinterpret_cast<uint16_t*>(smem);  // [warps][bins]
  uint64_t* skey = reinterpret_cast<uint64_t*>(smem);      // after the counters: the tile's keys
  uint32_t* sval = reinterpret_cast<uint32_t*>(smem);      // then its positions
  uint32_t* tile_base = reinterpret_cast<uint32_t*>(smem + sid::kPassUnionBytes);
  uint32_t* local_start = tile_base + kBins;
  uint16_t* sdig = reinterpret_cast<uint16_t*>(local_start + kBins);
  __shared__ uint32_t slots[sid::kSortWarps];
  __shared__ unsigned int tile_s;
  if (s.trivial[pass]) return;
  const int k_pass = sid::radix_rank_of_pass(s.trivial, pass);
  // buffers picked by selects, not by an index into the parameter struct
  // (which would copy it to local memory)
  const bool odd = k_pass & 1;
  const uint64_t* kin = k_pass ? (odd ? s.keys[0] : s.keys[1]) : nullptr;
  const uint32_t* vin = k_pass ? (odd ? s.vals[0] : s.vals[1]) : nullptr;
  uint64_t* kout = odd ? s.keys[1] : s.keys[0];
  uint32_t* vout = odd ? s.vals[1] : s.vals[0];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int k = t; k < sid::kSortWarps * kBins; k += sid::kSortThreads) warp_cnt[k] = 0;
  if (t == 0) tile_s = atomicAdd(s.counters + pass, 1u);
  __syncthreads();
  const int tile = static_cast<int>(tile_s);
  // warp-striped: lane `lane` of round k holds position base + 32 k
  const int64_t base = static_cast<int64_t>(tile) * sid::kSortTile + warp * 32 * sid::kSortItems + lane;
  uint64_t key[sid::kSortItems];
  uint32_t val[sid::kSortItems];
  uint32_t rank[sid::kSortItems];
#pragma unroll
  for (int k = 0; k < sid::kSortItems; ++k) {
    const int64_t i = base + 32 * k;
    key[k] = 0;
    val[k] = 0;
    if (i < m) {
      key[k] = kin ? kin[i] : sid::bh_radix_key(__ldg(p + i));
      val[k] = vin ? vin[i] : static_cast<uint32_t>(i);
    }
  }
  // stable ranks within the warp: the rounds in order, in a round the
  // lanes below that share the digit
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < sid::kSortItems; ++k) {
    const bool ok = base + 32 * k < m;
    const unsigned d = ok ? sid::radix_digit(key[k], pass, kBits) : static_cast<unsigned>(kBins);
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned before = ok ? warp_cnt[warp * kBins + d] : 0u;
    rank[k] = before + __popc(peers & below);
    __syncwarp();
    if (ok && (peers & below) == 0) warp_cnt[warp * kBins + d] = static_cast<uint16_t>(before + __popc(peers));
    __syncwarp();
  }
  __syncthreads();
  // each owned bin: the warps' counts made exclusive, the tile's count
  // published; the bins' starts within the tile
  uint32_t own[kOwn];
  uint32_t own_sum = 0;
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int b = t * kOwn + r;
    uint32_t sum = 0;
    for (int w = 0; w < sid::kSortWarps; ++w) {
      const uint32_t c = warp_cnt[w * kBins + b];
      warp_cnt[w * kBins + b] = static_cast<uint16_t>(sum);
      sum += c;
    }
    own[r] = sum;
    own_sum += sum;
    store_volatile(s.status + static_cast<int64_t>(tile) * kBins + b,
                   sid::status_word(pass, tile ? sid::kStatusAggregate : sid::kStatusInclusive, sum));
  }
  uint32_t start = block_exclusive_sum<sid::kSortThreads>(own_sum, slots);
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    local_start[t * kOwn + r] = start;
    start += own[r];
  }
  const unsigned long long tag = static_cast<unsigned long long>(pass + 1);
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int b = t * kOwn + r;
    uint32_t excl = 0;
    if (tile) {
      // the tiles before, kLookBack at a time (their loads in flight
      // together), nearest first, up to the first inclusive count; a tile
      // not yet published is read again
      int j = tile - 1;
      for (bool done = false; !done;) {
        unsigned long long w[kLookBack];
#pragma unroll
        for (int k = 0; k < kLookBack; ++k)
          w[k] = j - k >= 0 ? load_volatile(s.status + static_cast<int64_t>(j - k) * kBins + b) : 0ull;
        int used = 0;
#pragma unroll
        for (int k = 0; k < kLookBack; ++k) {
          if (done || used < k || (w[k] >> 34) != tag) continue;
          excl += static_cast<uint32_t>(w[k]);
          used = k + 1;
          done = ((w[k] >> 32) & 3u) == sid::kStatusInclusive;
        }
        j -= used;
      }
      store_volatile(s.status + static_cast<int64_t>(tile) * kBins + b,
                     sid::status_word(pass, sid::kStatusInclusive, excl + own[r]));
    }
    tile_base[b] = s.offsets[pass * kBins + b] + excl;
  }
  __syncthreads();
  // each pair's place in the tile's digit order
#pragma unroll
  for (int k = 0; k < sid::kSortItems; ++k) {
    if (base + 32 * k >= m) continue;
    const unsigned d = sid::radix_digit(key[k], pass, kBits);
    rank[k] += local_start[d] + warp_cnt[warp * kBins + d];
  }
  __syncthreads();  // the counters' memory now holds the staged pairs
#pragma unroll
  for (int k = 0; k < sid::kSortItems; ++k) {
    if (base + 32 * k >= m) continue;
    skey[rank[k]] = key[k];
    sdig[rank[k]] = static_cast<uint16_t>(sid::radix_digit(key[k], pass, kBits));
  }
  __syncthreads();
  const int64_t left = m - static_cast<int64_t>(tile) * sid::kSortTile;
  const int n_tile = left < sid::kSortTile ? static_cast<int>(left) : sid::kSortTile;
  for (int l = t; l < n_tile; l += sid::kSortThreads) {
    const unsigned d = sdig[l];
    kout[tile_base[d] + (l - local_start[d])] = skey[l];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < sid::kSortItems; ++k)
    if (base + 32 * k < m) sval[rank[k]] = val[k];
  __syncthreads();
  for (int l = t; l < n_tile; l += sid::kSortThreads) {
    const unsigned d = sdig[l];
    vout[tile_base[d] + (l - local_start[d])] = sval[l];
  }
}

// where the scan finds the order: a given int64 order, or the sort's last
// buffers (none: every digit was the same, the identity order)
struct BhOrder {
  const int64_t* ext;
  const uint64_t* keys[2];
  const uint32_t* vals[2];
  const int* trivial;
};

struct BhScan {
  unsigned int* counter;
  int* flag;
  double* agg;
  double* incl;
};

// shared-memory index of a tile position: one pad entry every 16
// positions
__device__ __forceinline__ int padded(int local) { return local + (local >> 4); }

// A tile of the sorted order: positions and p values loaded warp-striped
// (p from the sorted key where the key holds it, else gathered once) and
// read back blocked through shared memory (sid::kScanSmemBytes), each
// thread's running min of s, the block's scan, warp 0's look-back over 32
// tiles at a time, then out and is_het scattered.
__global__ void __launch_bounds__(sid::kScanThreads)
    bh_scan_kernel(const double* __restrict__ p, int64_t m, BhOrder o, BhScan sc, double alpha,
                   double* __restrict__ out, uint8_t* __restrict__ het) {
  constexpr int kItems = sid::kScanItems;
  constexpr int kTile = sid::kScanTile;
  constexpr int kSlots = kTile + kTile / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  double* ps = reinterpret_cast<double*>(smem);
  uint32_t* ord_s = reinterpret_cast<uint32_t*>(ps + kSlots);
  __shared__ double slots[sid::kScanThreads / 32];
  __shared__ double prefix_s;
  __shared__ unsigned int tile_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(sc.counter, 1u);
  const uint32_t* v = nullptr;
  const uint64_t* kv = nullptr;
  if (o.ext == nullptr) {
    const int k = sid::radix_rank_of_pass(o.trivial, sid::kSortPasses);
    if (k) {
      v = (k & 1) ? o.vals[0] : o.vals[1];
      kv = (k & 1) ? o.keys[0] : o.keys[1];
    }
  }
  __syncthreads();
  const int tile = static_cast<int>(tile_s);
  const int64_t first = static_cast<int64_t>(tile) * kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int local = warp * 32 * kItems + 32 * k + lane;
    const int64_t i = first + local;
    if (i >= m) continue;
    const uint32_t j = static_cast<uint32_t>(o.ext ? o.ext[i] : (v ? v[i] : i));
    double x;
    if (kv == nullptr || !sid::bh_p_of_key(kv[i], &x)) x = __ldg(p + j);
    ord_s[padded(local)] = j;
    ps[padded(local)] = x;
  }
  __syncthreads();
  double s[kItems];
  double agg = INFINITY;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int local = t * kItems + k;
    const int64_t i = first + local;
    s[k] = INFINITY;
    if (i < m) {
      s[k] = sid::bh_scaled(ps[padded(local)], i, m);
      agg = sid::min_first_nan(agg, s[k]);
    }
  }
  double tile_agg;
  const double before = block_exclusive_min<sid::kScanThreads>(agg, slots, &tile_agg);
  if (warp == 0) {
    // warp 0 looks back over 32 tiles at once, lane k at tile - 1 - base - k
    double excl = INFINITY;
    if (tile == 0) {
      if (lane == 0) {
        sc.incl[0] = tile_agg;
        __threadfence();
        store_volatile(sc.flag, 2);
      }
    } else {
      if (lane == 0) {
        sc.agg[tile] = tile_agg;
        __threadfence();
        store_volatile(sc.flag + tile, 1);
      }
      for (int base = tile - 1;;) {
        const int j = base - lane;
        int f = j >= 0 ? 2 : 0;
        if (j >= 0) {
          do {
            f = load_volatile(sc.flag + j);
          } while (f == 0);
        }
        __threadfence();
        double v = INFINITY;
        if (j >= 0) v = load_volatile(f == 2 ? sc.incl + j : sc.agg + j);
        // the nearest tile with an inclusive value ends the walk; the
        // tiles beyond it (higher lanes) take no part
        const unsigned inclusive = __ballot_sync(0xffffffffu, j >= 0 && f == 2);
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
        if (lane > stop) v = INFINITY;
        // fold the lanes, a higher lane (an earlier tile) on the left
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const double y = __shfl_down_sync(0xffffffffu, v, d);
          if (lane + d < 32) v = sid::min_first_nan(y, v);
        }
        excl = sid::min_first_nan(__shfl_sync(0xffffffffu, v, 0), excl);
        if (inclusive) break;
        base -= 32;
      }
      if (lane == 0) {
        sc.incl[tile] = sid::min_first_nan(excl, tile_agg);
        __threadfence();
        store_volatile(sc.flag + tile, 2);
      }
    }
    if (lane == 0) prefix_s = excl;
  }
  __syncthreads();
  double run = sid::min_first_nan(prefix_s, before);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int local = t * kItems + k;
    const int64_t i = first + local;
    if (i >= m) continue;
    const uint32_t j = ord_s[padded(local)];
    run = sid::min_first_nan(run, s[k]);
    const double r = sid::bh_clamp(run);
    out[j] = r;
    if (het != nullptr) het[j] = r < alpha ? 1 : 0;
  }
}

// the sorted positions as int64 (the order the scan reads), for checks
__global__ void bh_order_out_kernel(int64_t m, BhOrder o, int64_t* __restrict__ order) {
  const int k = sid::radix_rank_of_pass(o.trivial, sid::kSortPasses);
  const uint32_t* v = k ? ((k & 1) ? o.vals[0] : o.vals[1]) : nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < m; i += stride)
    order[i] = v ? static_cast<int64_t>(v[i]) : i;
}

// the scan's look-back state zeroed, for a scan over a given order
__global__ void bh_zero_scan_kernel(BhScan sc, int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < tiles) sc.flag[i] = 0;
  if (i == 0) *sc.counter = 0;
}

// the one-block path's arrays: block b takes p[b], writes out[b] and, when
// not null, het[b]
struct BhSmall {
  const double* p[2];
  double* out[2];
  uint8_t* het[2];
};

__global__ void __launch_bounds__(sid::kSmallThreads)
    bh_small_kernel(BhSmall a, int m, double alpha) {
  constexpr int kBins = 1 << sid::kSmallBits;
  constexpr int kPasses = (64 + sid::kSmallBits - 1) / sid::kSmallBits;
  constexpr int kT = sid::kSmallThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  double* ps = reinterpret_cast<double*>(smem);
  uint32_t* idx[2] = {reinterpret_cast<uint32_t*>(smem + 8 * static_cast<int64_t>(m)),
                      reinterpret_cast<uint32_t*>(smem + 12 * static_cast<int64_t>(m))};
  uint16_t* cnt = reinterpret_cast<uint16_t*>(smem + 16 * static_cast<int64_t>(m));  // [warps][bins]
  uint32_t* hist = reinterpret_cast<uint32_t*>(cnt + sid::kSmallWarps * kBins);       // [passes][bins]
  uint32_t* bin_off = hist + kPasses * kBins;                                          // [bins]
  double* slots = reinterpret_cast<double*>(bin_off + kBins);                          // [warps]
  const bool second = blockIdx.x != 0;  // selects, not an index into the parameter struct
  const double* p = second ? a.p[1] : a.p[0];
  double* out = second ? a.out[1] : a.out[0];
  uint8_t* het = second ? a.het[1] : a.het[0];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < m; i += kT) {
    ps[i] = __ldg(p + i);
    idx[0][i] = static_cast<uint32_t>(i);
  }
  for (int k = t; k < kPasses * kBins; k += kT) hist[k] = 0;
  __syncthreads();
  for (int i = t; i < m; i += kT) {
    const uint64_t key = sid::bh_radix_key(ps[i]);
#pragma unroll
    for (int q = 0; q < kPasses; ++q) atomicAdd(hist + q * kBins + sid::radix_digit(key, q, sid::kSmallBits), 1u);
  }
  __syncthreads();
  const uint64_t key0 = sid::bh_radix_key(ps[0]);
  // the ranking warps, each a run of whole rounds of 32 positions
  const int warps = sid::small_ranking_warps(m);
  const int seg = sid::small_warp_positions(m);
  const int rounds = seg / 32;
  const unsigned below = (1u << lane) - 1u;
  int cur = 0;
  for (int q = 0; q < kPasses; ++q) {
    if (hist[q * kBins + sid::radix_digit(key0, q, sid::kSmallBits)] == static_cast<uint32_t>(m)) continue;
    for (int k = t; k < warps * kBins; k += kT) cnt[k] = 0;
    __syncthreads();
    const uint32_t* src = idx[cur];
    uint32_t* dst = idx[cur ^ 1];
    uint32_t pos[sid::kSmallItems], rank[sid::kSmallItems];
    unsigned dig[sid::kSmallItems];
#pragma unroll
    for (int r = 0; r < sid::kSmallItems; ++r) {
      if (r >= rounds || warp >= warps) break;
      const int i = warp * seg + 32 * r + lane;
      const bool ok = i < m;
      pos[r] = ok ? src[i] : 0u;
      dig[r] = ok ? sid::radix_digit(sid::bh_radix_key(ps[pos[r]]), q, sid::kSmallBits) : static_cast<unsigned>(kBins);
      const unsigned peers = __match_any_sync(0xffffffffu, dig[r]);
      const unsigned before = ok ? cnt[warp * kBins + dig[r]] : 0u;
      rank[r] = before + __popc(peers & below);
      __syncwarp();
      if (ok && (peers & below) == 0) cnt[warp * kBins + dig[r]] = static_cast<uint16_t>(before + __popc(peers));
      __syncwarp();
    }
    __syncthreads();
    if (t < kBins) {
      uint32_t sum = 0;
      for (int w = 0; w < warps; ++w) {
        const uint32_t c = cnt[w * kBins + t];
        cnt[w * kBins + t] = static_cast<uint16_t>(sum);
        sum += c;
      }
      bin_off[t] = sum;
    }
    __syncthreads();
    if (warp == 0) {  // the bins' exclusive offsets: 8 bins a lane
      constexpr int kPerLane = kBins / 32;
      uint32_t c[kPerLane];
      uint32_t local = 0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        c[k] = bin_off[lane * kPerLane + k];
        local += c[k];
      }
      uint32_t x = local;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      uint32_t run = x - local;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        bin_off[lane * kPerLane + k] = run;
        run += c[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < sid::kSmallItems; ++r) {
      if (r >= rounds || warp >= warps) break;
      if (warp * seg + 32 * r + lane >= m) continue;
      dst[bin_off[dig[r]] + cnt[warp * kBins + dig[r]] + rank[r]] = pos[r];
    }
    __syncthreads();
    cur ^= 1;
  }
  const uint32_t* ord = idx[cur];
  double s[sid::kSmallItems];
  double agg = INFINITY;
#pragma unroll
  for (int k = 0; k < sid::kSmallItems; ++k) {
    const int i = t * sid::kSmallItems + k;
    s[k] = INFINITY;
    if (i < m) {
      s[k] = sid::bh_scaled(ps[ord[i]], i, m);
      agg = sid::min_first_nan(agg, s[k]);
    }
  }
  double total;
  double run = block_exclusive_min<kT>(agg, slots, &total);
#pragma unroll
  for (int k = 0; k < sid::kSmallItems; ++k) {
    const int i = t * sid::kSmallItems + k;
    if (i >= m) continue;
    const uint32_t j = ord[i];
    run = sid::min_first_nan(run, s[k]);
    const double r = sid::bh_clamp(run);
    out[j] = r;
    if (het != nullptr) het[j] = r < alpha ? 1 : 0;
  }
}

cudaError_t launch_scan(const double* p, int64_t m, const BhOrder& o, const BhScan& sc, int tiles,
                        double alpha, double* out, uint8_t* het, cudaStream_t s) {
  const cudaError_t err =
      cudaFuncSetAttribute(bh_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sid::kScanSmemBytes);
  if (err != cudaSuccess) return err;
  bh_scan_kernel<<<tiles, sid::kScanThreads, sid::kScanSmemBytes, s>>>(p, m, o, sc, alpha, out, het);
  return cudaGetLastError();
}

// the radix order's launches: the histogram, the plan, one pass a digit
cudaError_t launch_sort(const double* p, int64_t m, const sid::BhLayout& l, const BhSort& s,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(bh_radix_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sid::kPassSmemBytes);
  if (err != cudaSuccess) return err;
  bh_histogram_kernel<<<l.hist_blocks, sid::kSortThreads, 4 * sid::kSortPasses * sid::kSortBins, st>>>(p, m, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bh_plan_kernel<<<sid::kSortPasses, kPlanThreads, 0, st>>>(p, m, s);
  err = cudaGetLastError();
  for (int pass = 0; pass < sid::kSortPasses && err == cudaSuccess; ++pass) {
    bh_radix_pass_kernel<<<l.sort_tiles, sid::kSortThreads, sid::kPassSmemBytes, st>>>(p, m, pass, s);
    err = cudaGetLastError();
  }
  return err;
}

// the sort's order of its last pass: the buffers the last real pass wrote
// (none: every digit was the same, the identity order)
BhOrder sorted_order(const BhSort& s) {
  return BhOrder{nullptr, {s.keys[0], s.keys[1]}, {s.vals[0], s.vals[1]}, s.trivial};
}

BhScan scan_state(const BhSort& s) { return BhScan{s.scan_counter, s.scan_flag, s.scan_agg, s.scan_incl}; }

cudaError_t launch_small(const BhSmall& a, int arrays, int64_t m, double alpha, cudaStream_t st) {
  const int smem = sid::bh_small_smem(m);
  cudaError_t err = cudaFuncSetAttribute(bh_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sid::bh_small_smem(sid::kSmallMax));
  if (err != cudaSuccess) return err;
  bh_small_kernel<<<arrays, sid::kSmallThreads, smem, st>>>(a, static_cast<int>(m), alpha);
  return cudaGetLastError();
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
      static_cast<const double*>(lhom), static_cast<const double*>(lhet), n, lp, 0.0,
      static_cast<double*>(p1), static_cast<double*>(p2));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch a BH launch takes for m p-values. kind 0:
// sid_bh_adjust_launch with the hand order (none up to kSmallMax, the
// one-block path); 1: sid_bh_adjust_launch over a given order (the scan's
// look-back alone); 2: sid_bh_order_launch.
int64_t sid_bh_scratch_bytes(int64_t m, int kind) {
  if (m <= 0 || (kind == 0 && m <= sid::kSmallMax)) return 0;
  return sid::bh_layout(m, kind != 1).total;
}

// BH over p (m f64, m < 2^31) into out (m f64) and, when not null, het (m
// bytes: out < alpha). ord: null for the hand order, or m int64, the
// descending order of p; scratch: sid_bh_scratch_bytes (kind 0 or 1),
// 16-byte aligned. Launches: for a given order, a zeroing kernel and the
// scan; for the hand order, one bh_small_kernel where m <= kSmallMax, else
// the histogram, the plan, one pass a digit and the scan. Returns a
// cudaError_t.
int sid_bh_adjust_launch(const void* p, const void* ord, int64_t m, double alpha, void* out, void* het,
                         void* scratch, void* stream) {
  if (m <= 0) return 0;
  if (m >= 0x80000000ll) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* pp = static_cast<const double*>(p);
  double* oo = static_cast<double*>(out);
  uint8_t* hh = static_cast<uint8_t*>(het);
  if (ord == nullptr && m <= sid::kSmallMax) {
    const BhSmall a{{pp, nullptr}, {oo, nullptr}, {hh, nullptr}};
    return static_cast<int>(launch_small(a, 1, m, alpha, st));
  }
  const sid::BhLayout l = sid::bh_layout(m, ord == nullptr);
  const BhSort s = bh_sort_of(scratch, l);
  if (ord == nullptr) {
    const cudaError_t err = launch_sort(pp, m, l, s, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_scan(pp, m, sorted_order(s), scan_state(s), l.scan_tiles, alpha, oo, hh, st));
  }
  bh_zero_scan_kernel<<<(l.scan_tiles + 255) / 256, 256, 0, st>>>(scan_state(s), l.scan_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BhOrder o{static_cast<const int64_t*>(ord), {nullptr, nullptr}, {nullptr, nullptr}, nullptr};
  return static_cast<int>(launch_scan(pp, m, o, scan_state(s), l.scan_tiles, alpha, oo, hh, st));
}

// BH over two arrays of m <= kSmallMax p-values in one launch of
// bh_small_kernel (two blocks): p0 into out0 (het0 may be null), p1 into
// out1 (het1 may be null). Returns a cudaError_t.
int sid_bh_small_pair_launch(const void* p0, const void* p1, int64_t m, double alpha, void* out0,
                             void* out1, void* het0, void* het1, void* stream) {
  if (m <= 0) return 0;
  if (m > sid::kSmallMax) return static_cast<int>(cudaErrorInvalidValue);
  const BhSmall a{{static_cast<const double*>(p0), static_cast<const double*>(p1)},
                  {static_cast<double*>(out0), static_cast<double*>(out1)},
                  {static_cast<uint8_t*>(het0), static_cast<uint8_t*>(het1)}};
  return static_cast<int>(launch_small(a, 2, m, alpha, static_cast<cudaStream_t>(stream)));
}

// The hand radix order of p alone (m < 2^31) into order (m int64): the
// sort's launches and one that writes the positions out; scratch:
// sid_bh_scratch_bytes (kind 2). Returns a cudaError_t.
int sid_bh_order_launch(const void* p, int64_t m, void* order, void* scratch, void* stream) {
  if (m <= 0) return 0;
  if (m >= 0x80000000ll) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* pp = static_cast<const double*>(p);
  const sid::BhLayout l = sid::bh_layout(m, true);
  const BhSort s = bh_sort_of(scratch, l);
  const cudaError_t err = launch_sort(pp, m, l, s, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  bh_order_out_kernel<<<256, 256, 0, st>>>(m, sorted_order(s), static_cast<int64_t*>(order));
  return static_cast<int>(cudaGetLastError());
}

// the one-block path's largest m
int sid_bh_small_max() { return sid::kSmallMax; }

const char* sid_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
