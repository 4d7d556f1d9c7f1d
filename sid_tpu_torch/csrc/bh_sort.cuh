// Benjamini-Hochberg's own order on Hopper: the key, the radix digits, the
// plan of the digit passes and the scratch layout, shared by the CUDA
// kernels (lrt_bh.cu) and a g++ host build (lrt_bh_host.cpp) that walks the
// kernels' tiles, warps and lanes so the CPU tests can hold the order and
// the scan against numpy before any card sees them.
//
// The order is ops/stats.py::bh_order's: a stable ascending sort of the key
// -p, with every zero as +0 and every NaN as the positive NaN (so the
// descending order of p, NaN last, numpy's np.argsort(-p, kind="stable")).
// The key's bits are twiddled into an unsigned integer whose order is the
// key's (a negative float has its bits flipped, a positive one its sign bit
// set), and an LSD radix sort of (64-bit key, 32-bit position) pairs that
// starts from the identity order is stable, so its permutation is exactly
// torch.argsort(key, stable=True): ties keep their positions' order, which
// is what the scan's first-NaN and +-0 rules rest on.
//
// The sort's passes, kSortBits bits a digit, low digit first:
//   histogram   every digit's counts at once, per block;
//   plan        the per-block counts summed, each digit's exclusive bin
//               offsets, and the digits that are the same in every key
//               (one bin holds all m), which get no scatter pass;
//   scatter     one pass a remaining digit: tiles of kSortThreads x
//               kSortItems pairs, loaded warp-striped, ranked stably within
//               each warp (the lanes of a round that share a digit, then
//               the rounds in order), the warps' counts scanned within the
//               tile, each bin's count before the tile found by a decoupled
//               look-back over the tiles before it, and scattered.
// The k-th scatter pass (k = 0, 1, ...) reads the key from p itself (k = 0)
// or buffer (k - 1) % 2 and writes buffer k % 2.
//
// Build with contraction off (nvcc --fmad=false, g++ -ffp-contract=off).
#pragma once

#include <stdint.h>
#include <string.h>

#include "lrt_bh.cuh"

namespace sid {

constexpr uint64_t kSignBit = 0x8000000000000000ull;
// the positive quiet NaN, what torch.full_like(p, nan) holds
constexpr uint64_t kPositiveNaN = 0x7ff8000000000000ull;

// The multi-block sort: digits of kSortBits bits, tiles of kSortThreads
// threads of kSortItems pairs, the scatter staged in shared memory in digit
// order. The chained scan: tiles of kScanThreads threads of kScanItems
// positions. The one-block path: up to kSmallMax pairs in one block's
// shared memory, kSmallThreads threads, 8-bit digits, each ranking warp
// taking at least kSmallRows positions (whole rounds of 32). Each was
// chosen by timing its variants on the card over two spreads of keys
// (chip_smoke.py BH_VARIANTS builds them by text substitution; PERF.md has
// their times).
constexpr int kSortBits = 8;
constexpr int kSortBins = 1 << kSortBits;
constexpr int kSortPasses = (64 + kSortBits - 1) / kSortBits;
constexpr int kSortThreads = 256;
constexpr int kSortItems = 16;
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kSortWarps = kSortThreads / 32;
// the histogram kernel's largest grid
constexpr int kHistBlocks = 128;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
// the scan's dynamic shared memory: a tile's positions (uint32) and p
// values (f64), one pad entry every 16 of each
constexpr int kScanSmemBytes = 12 * (kScanTile + kScanTile / 16);
constexpr int kSmallThreads = 1024;
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSmallMax = 8192;
constexpr int kSmallBits = 8;
constexpr int kSmallItems = kSmallMax / kSmallThreads;
constexpr int kSmallRows = 64;

// the one-block path's ranking warps for m p-values: ceil(m / kSmallRows),
// at most the block's; and the positions each takes, whole rounds of 32
// (at most 256 for m <= kSmallMax)
SID_HD int small_ranking_warps(int64_t m) {
  const int64_t w = (m + kSmallRows - 1) / kSmallRows;
  return static_cast<int>(w < 1 ? 1 : w > kSmallWarps ? kSmallWarps : w);
}
SID_HD int small_warp_positions(int64_t m) {
  const int w = small_ranking_warps(m);
  return static_cast<int>(((m + w - 1) / w + 31) / 32 * 32);
}

SID_HD uint64_t f64_bits(double x) {
#ifdef __CUDA_ARCH__
  return static_cast<uint64_t>(__double_as_longlong(x));
#else
  uint64_t b;
  memcpy(&b, &x, sizeof(b));
  return b;
#endif
}

// bh_order's key as bits: 0.0 - p, which is -p exactly but for the zeros
// (+0 either way); a NaN of either sign becomes the positive NaN
SID_HD uint64_t bh_key_bits(double p) {
  if (p != p) return kPositiveNaN;
  if (p == 0.0) return 0;
  return f64_bits(p) ^ kSignBit;
}

// the key's order as an unsigned order: -inf < ... < -0 < +0 < ... < +inf <
// the positive NaN
SID_HD uint64_t radix_twiddle(uint64_t b) { return (b & kSignBit) ? ~b : (b | kSignBit); }

SID_HD uint64_t bh_radix_key(double p) { return radix_twiddle(bh_key_bits(p)); }

SID_HD double f64_of_bits(uint64_t b) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double(static_cast<long long>(b));
#else
  double x;
  memcpy(&x, &b, sizeof(x));
  return x;
#endif
}

// The p a radix key was made from, into *p, unless p was a zero or a NaN,
// whose sign and payload the key dropped (false: read p itself)
SID_HD bool bh_p_of_key(uint64_t key, double* p) {
  const uint64_t b = (key & kSignBit) ? (key ^ kSignBit) : ~key;
  if (b == 0 || b == kPositiveNaN) return false;
  *p = f64_of_bits(b ^ kSignBit);
  return true;
}

SID_HD int radix_passes(int bits) { return (64 + bits - 1) / bits; }

// a scatter pass's dynamic shared memory: the warps' bin counters (uint16),
// whose room then holds the tile's keys and later its positions in digit
// order; the bins' global and tile-local starts; each staged pair's digit
constexpr int kPassCounterBytes = kSortWarps * kSortBins * 2;
constexpr int kPassUnionBytes = kPassCounterBytes > kSortTile * 8 ? kPassCounterBytes : kSortTile * 8;
constexpr int kPassSmemBytes = kPassUnionBytes + 2 * 4 * kSortBins + 2 * kSortTile;

SID_HD unsigned radix_digit(uint64_t key, int pass, int bits) {
  return static_cast<unsigned>(key >> (pass * bits)) & ((1u << bits) - 1u);
}

// the k-th scatter pass before `pass`: how many digits before it are not
// the same in every key
SID_HD int radix_rank_of_pass(const int* trivial, int pass) {
  int k = 0;
  for (int q = 0; q < pass; ++q) k += trivial[q] ? 0 : 1;
  return k;
}

// a look-back status word of the sort: the pass's tag (pass + 1) in bits
// 34-63, the flag in bits 32-33 (1: the tile's own count, 2: the count of
// every tile up to it), the count in bits 0-31; a zeroed word is no pass's
constexpr uint64_t kStatusAggregate = 1;
constexpr uint64_t kStatusInclusive = 2;

SID_HD uint64_t status_word(int pass, uint64_t flag, uint32_t count) {
  return (static_cast<uint64_t>(pass + 1) << 34) | (flag << 32) | count;
}

// The scratch of one multi-block BH over m p-values, in bytes from one
// 16-byte aligned base: with `sort`, both pair buffers, the per-block
// histograms, the bin offsets, the digits' plan, the look-back status and
// the passes' tile counters; then the scan's tile counter and look-back,
// all that a scan over a given order needs.
struct BhLayout {
  int sort_tiles, hist_blocks, scan_tiles;
  int64_t keys[2], vals[2], block_hist, offsets, trivial, status, counters, scan_counter, scan_flag,
      scan_agg, scan_incl, total;
};

inline int64_t align16(int64_t x) { return (x + 15) & ~static_cast<int64_t>(15); }

inline BhLayout bh_layout(int64_t m, bool sort) {
  BhLayout l;
  const int64_t n = sort ? m : 0;  // the pairs sorted
  const int64_t passes = sort ? kSortPasses : 0, bins = sort ? kSortBins : 0;
  l.sort_tiles = static_cast<int>((n + kSortTile - 1) / kSortTile);
  l.hist_blocks = l.sort_tiles < kHistBlocks ? l.sort_tiles : kHistBlocks;
  l.scan_tiles = static_cast<int>((m + kScanTile - 1) / kScanTile);
  int64_t at = 0;
  for (int b = 0; b < 2; ++b) {
    l.keys[b] = at;
    at = align16(at + 8 * n);
  }
  for (int b = 0; b < 2; ++b) {
    l.vals[b] = at;
    at = align16(at + 4 * n);
  }
  l.block_hist = at;
  at = align16(at + 4 * l.hist_blocks * passes * bins);
  l.offsets = at;
  at = align16(at + 4 * passes * bins);
  l.trivial = at;
  at = align16(at + 4 * passes);
  l.status = at;
  at = align16(at + 8 * l.sort_tiles * bins);
  l.counters = at;  // one tile counter a pass
  at = align16(at + 4 * passes);
  l.scan_counter = at;
  at = align16(at + 4);
  l.scan_flag = at;
  at = align16(at + 4 * static_cast<int64_t>(l.scan_tiles));
  l.scan_agg = at;
  at = align16(at + 8 * static_cast<int64_t>(l.scan_tiles));
  l.scan_incl = at;
  at = align16(at + 8 * static_cast<int64_t>(l.scan_tiles));
  l.total = at;
  return l;
}

// the one-block path's dynamic shared memory for m p-values: p, two
// position buffers, the warps' bin counters, the histograms, the bin
// offsets and the warps' scan slots
inline int bh_small_smem(int64_t m) {
  const int bins = 1 << kSmallBits;
  return static_cast<int>(8 * m + 2 * 4 * m + 2 * kSmallWarps * bins +
                          4 * radix_passes(kSmallBits) * bins + 4 * bins + 8 * kSmallWarps + 64);
}

}  // namespace sid
