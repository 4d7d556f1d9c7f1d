#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one CUDA card:

    python3 chip_smoke.py [--parent DIR]
    python3 chip_smoke.py --lane-variants | --b5-variants | --bh-variants | --lrt-variants

``--parent DIR`` names an unpacked tree of the parent commit (git archive
into a git-ignored directory) whose csrc/local_classify.cu (B1, B5),
csrc/lrt_bh.cu (the LRT and BH with its own order) and
csrc/quality_finalize.cu (B6 and its full form) keep their C interfaces;
phase 13 then builds them with this tree's nvcc flags, prints their ptxas
report, holds B5's p1, p2 and byte, the LRT's p1 and p2 (with and without
a prior, and one-sided), BH's out and is_het and B6 full's p1, p2, is_het
and miss count bitwise against this tree's at U = 1M (N = 1M for B6 full)
and at the simulated sites' ~2,000 profiles, and times them, device only
and whole calls, in turns (B1 too).
``--lane-variants`` builds variants of the lane kernels instead
(``LANE_VARIANTS``: a launch bound of 2 blocks an SM, the lane table in
global memory, every lane folded by the last block, four marginals rows
a thread, the slot search unrolled), holds them bitwise against the
committed kernels at phase 11's and phase 12's cohort shapes, times them
in turns, and stops. ``--b5-variants`` (``B5_VARIANTS``),
``--bh-variants`` (``BH_VARIANTS``) and ``--lrt-variants``
(``LRT_VARIANTS``, ``B6_LRT_VARIANTS``) do the same for B5's design
choices (the table staged or not, 5 or 6 blocks an SM), for BH's (the
scatter staged or not, pairs a thread, look-back width, digit width, the
scan's positions a thread, the one-block path's ranking warps) and for
the LRT kernel's and B6 full's (4 to 8 blocks an SM), each a text
substitution on the committed sources.

Drives sid_tpu_torch's main paths (``engine.run`` and
``engine.run_streaming``, what ``./sid-tpu-torch`` and ``./sid-tpu-torch
--stream`` run) on the card and checks them:

1. probe: a CUDA card must be present; prints its name and power limit;
2. build: libsidtpu.so (g++) and the kernel libraries (one nvcc per source,
   all started together, sm_90a) from the sources in this checkout; the
   compiler's register report of every kernel (0 spill bytes asserted for
   every kernel), the Lynch kernels' resident blocks an SM, and, from
   cuobjdump -sass, the f64 instructions that every row of each kernel
   executes, from which the bounds below are computed, and where the Lynch
   kernels' f64 instructions take their operands (constant bank, uniform
   registers) and how many constant and local-memory loads they make;
3. kernel vs plain: the local classify kernel against its plain torch f64
   version on the card at U = 1,000,000 profiles (Poisson(30) bulk, zero
   rows, deep rows up to 65535, ties, capped rows) at -E 0.0, 0.1, 1.0 and
   -0.1: l1 and l2 with identical non-finite positions and |a-b| <= 1e-12
   max(1,|a|); the byte (major, second, range flag) bitwise against the
   plain version and against the host's major_allele_indices_np and
   long_double_range_rows at each -E and priors -1, 1e-3 and 0.999; median
   times of both over distinct inputs, by CUDA events, the device-only
   time, the bound from the kernel's own bytes and the share of the first
   port's 40-byte bound;
4. the -m local path: engine.run on the golden fixture (byte-equal to
   golden_local.csv), the 100k-site real-data-shaped fixture and a
   1,000,000-site simulated ~30x pileup, the last two byte-equal to the CSV
   of the host long-double classifier (no kernel in that path); the
   kernel's launch count must grow; prints sites/s and the device stage's
   share; 4b splits the device stage at U = 1M (torch.profiler: the two
   copies and the kernel) and times classify_profiles_local there against
   the host long-double classifier;
5. the Lynch fit's kernels against their plain torch versions on the
   cov >= 4 rows of phase 3's profiles with seeded multiplicities: the row
   record bitwise; the objective B2 bitwise (sum and flagged count) with
   flags equal row for row at seven thetas (out of the box: DBL_MAX); the
   marginals B4 and flags at three epsilons, identical non-finite positions
   and 1e-12 relative; B2 bitwise repeatable over ten calls and over grid
   sizes, one evaluation one kernel launch (the kernel library's counters);
   per kernel the call time, the device-only time, the plain version's time
   and the bound with the share of it reached; the SM clock while B2 runs
   back to back;
6. the fit's main path: engine.run on golden.pileup for bayes, LR, LR -R
   and local -R under --fit device, --fit auto and --engine exact, each
   byte-equal to its golden CSV, the device fit's diagnostic lines those of
   the goldens' run; B2 launched under --fit device and not under auto;
   the deep-coverage repro of fault C2 byte-equal to --fit exact; every
   kernel of the path launched;
7. the fit at U ~ 1M at the model layer: models.lynch.fit_profiles under
   auto (the device fit) and --fit exact on phase 5's rows up to 1000x;
   wall time, iterations, (pi, eps) of both within the simplex tolerance,
   and how many bayes / LR profile records differ; one evaluation and the
   device fit's wall taken apart; a one-lane LanesObjective against
   DeviceObjective on the same rows (bitwise the same values), the
   kernel alone and the whole call, in turns;
8. the quality finalize kernel (B6) at N = 1,000,000 sites (Poisson(30)
   bulk, zero-coverage sites, ties, deep sites up to 65535, log sums on
   both sides of the 80-bit underflow line, NaN and -inf sums) at priors
   -1, 1e-3 and 0.999: lpp2 bitwise its plain version and sid_tpu's
   finalize_quality_np composition, both p-values and the calls bitwise
   libsidtpu's sidtpu_quality_finalize; the call, device-only and plain
   times and the bound;
9. the -m quality path: engine.run on golden.pileup (byte-equal to
   golden_quality.csv; -R to golden_quality_R.csv; --engine exact), the
   100k-site fixture and 1,000,000 simulated sites with per-read Phred
   qualities from a seed (both byte-equal to the CSV of the fused host
   finalize); the kernel's launch count must be one per device run; sites/s
   and the device stage's share (three runs); the finalize at N = 1M both
   ways: h2d, kernel and d2h by torch.profiler, against
   sidtpu_quality_finalize on the host, p-values bitwise equal;
10. engine.run_streaming on that file with 8 MB chunks for -m local,
   -R -m likelihood_ratio and -m quality, each byte-equal to engine.run
   (B1 and B6 launched); a --checkpoint run and a resume=True rerun that
   skips pass 1; --stream -m local at 10,000,000 simulated sites (~1.1 GB
   on disk, written under .smoke/ and removed) with 64 MB chunks, sites/s
   of two runs, the output's SHA-256 equal to engine.run's;
11. the cohort's lane kernels (population mode) at 100 lanes and ~2,000,000
   rows (an empty, a 1-row and a 1,000,000-row lane; the draws' deep rows,
   which the range screen flags, in most lanes): the lanes' objective
   bitwise the single-lane B2 and its plain version per lane (sum, flagged
   count, flags) at three sets of per-lane thetas (boundary ones included),
   for all lanes, every other lane, one lane and the two smallest, over
   three grids; one call one launch by the library's counters;
   LanesObjective at mixed thetas (out-of-box ones DBL_MAX, no launch)
   bitwise DeviceObjective per lane; the lanes' marginals bitwise the
   single-lane B4 per row, flags equal, 1e-12 to the plain version; the
   call, device-only (the kernel launched again on what the card holds)
   and plain times, the bounds (B2's f64 row count for the objective, B4's
   for the marginals), and one round against 100 single-lane B2 calls;
   the same times and bounds at phase 12's shape (100 lanes of the
   samples' ~1,000 unique profiles, from simulated_counts), where the
   results are held bitwise against the plain version;
12. the population path: 100 seeded ~30x samples of 50,000 sites with
   Phred qualities (pi log-spaced 1e-4..1e-2, eps 1e-2; 0.55 GB under
   .smoke/, removed) through call_population, pooled and independent -m
   bayes (two runs each, sites/s and the device stages' share) and pooled
   -R -m likelihood_ratio, and on 8 of them pooled -m local and -m quality,
   every sample's CSV byte-equal to the same run on the CPU; the LR run
   through call_population_streaming (64 MB chunks) byte-equal to it; the
   lane, row record, local classify and quality finalize kernels launched;
   five lanes' fits bitwise single-lane fits over DeviceObjective; the
   lanes' rounds, launches and evaluations, and the fits' wall against 100
   single-lane fits in turns;
13. the fused on-device LRT (exact_pvalues=False): B5
   (local_classify_lrt_kernel, one erfc a row) at phase 3's profiles, every
   -E and prior: its byte's bits 0-4 bitwise B1's, p1 and p2 within 1e-13
   relative of host libm (glibc erfc) over B1's likelihoods plus the prior
   and of the plain LRT on the card over the same likelihoods (where both
   are >= DBL_MIN; below it together), is_het equal outside the alpha band,
   the whole plain version's largest relative error printed (its logs are
   torch's); the card's erfc(0.0); B6's full form (quality_finalize_lrt_kernel,
   one erfc a site) at phase 8's sites, edge rows planted, against
   libsidtpu's sidtpu_quality_finalize and its plain version; the LRT
   (lrt_pvalues_kernel, one erfc a row) on phase 5's marginals, edge rows
   planted, with and without a prior and one-sided, against host libm and
   its plain version, timed there and at the path's ~2,000 profiles, and
   lrt_benjamini_hochberg at an even and an odd U bitwise the host BH of
   the card's p-values; BH with its own order (csrc/bh_sort.cuh: a radix sort and a chained scan, or one
   block up to 8,192 p-values) on B5's p-values with ties and NaN planted,
   at U = 1M and at the simulated sites' ~2,000 profiles (both arrays and
   is_het in one launch): bitwise adjust_benjamini_hochberg_np, over its
   own order, over torch.argsort's and as its plain version, the hand
   order equal to torch.argsort(key, stable=True); each kernel's call,
   device-only and plain times and bound (BH also by kernel through
   torch.profiler, with torch.argsort's and torch.cummin's times, and at
   the path's shape); with --parent, the parent's B5, B6 full, LRT and BH
   bitwise and in turns; the device LRT's wall against
   the host-libm path at U = 1M, N = 1M and phase 5's U; engine.run with
   exact_pvalues=False for -m local, -m quality and -R -m likelihood_ratio
   on golden and the 1M-site inputs, each within the tolerance of the
   host-libm run and of the CPU run (lines differing in bytes counted),
   every kernel launched; in phase 12, pooled -R -m likelihood_ratio and
   -m local on 8 samples, held the same way;
14. prints a JSON line of kernel results, then the final JSON line
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the final
line. Without a CUDA card it exits 1 at once.
"""

import gzip
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
U_KERNEL = 1_000_000
N_SITES = 1_000_000
THRESHOLDS = (0.0, 0.1, 1.0, -0.1)
PRIORS = (-1.0, 1e-3, 0.999)
RTOL = 1e-12
REPEATS = 20
INPUT_SETS = 5
FIT_THETAS = ((1e-3, 1e-3), (0.05, 0.01), (0.0, 1e-3), (1e-3, 0.0), (1.0, 1.0), (0.5, 0.999), (-0.1, 0.5))
FIT_EPSILONS = (1e-3, 3.85e-11, 0.5)
SIMPLEX_TOL = 1e-5
N_QUALITY = 1_000_000
N_STREAM = 10_000_000
STREAM_CHUNK = 8 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def kernel_profiles(seed: int = 2024) -> np.ndarray:
    """U_KERNEL profiles: Poisson(30) bulk plus the edge cases."""
    rng = np.random.default_rng(seed)
    u = U_KERNEL
    cov = rng.poisson(30, u)
    prof = rng.multinomial(cov, [0.94, 0.03, 0.02, 0.01])
    prof = rng.permuted(prof, axis=1)  # major allele at a random base
    rows = rng.permutation(u)
    zero, deep, tie2, tie4, capped = np.array_split(rows[:20000], 5)
    prof[zero] = 0
    prof[deep, rng.integers(0, 4, deep.size)] = rng.integers(1000, 65536, deep.size)
    k = rng.integers(1, 500, tie2.size)
    prof[tie2] = np.stack([k, k, np.zeros_like(k), np.zeros_like(k)], 1)
    k = rng.integers(1, 200, tie4.size)
    prof[tie4] = k[:, None]
    prof[capped] = rng.integers(0, 40, (capped.size, 4))
    prof[0] = [65535, 65535, 65535, 65535]
    return np.ascontiguousarray(prof.astype(np.int32))


def fit_histogram(prof: np.ndarray, seed: int = 2025):
    """The cov >= 4 rows of ``prof`` with multiplicities drawn from a seed."""
    rows = np.ascontiguousarray(prof[prof.sum(-1) >= 4])
    mult = np.random.default_rng(seed).integers(1, 1000, rows.shape[0]).astype(np.int64)
    return rows, mult


def simulated_counts(n_sites: int, seed: int = 7, pi: float = 1e-3) -> np.ndarray:
    """(n_sites, 4) counts of a ~30x diploid sample (heterozygosity pi,
    eps=1e-2), bench.py's generate; every site has coverage >= 1."""
    rng = np.random.default_rng(seed)
    cov = rng.poisson(30, n_sites).clip(1)
    is_het = rng.uniform(size=n_sites) < pi
    major = rng.integers(0, 4, n_sites)
    counts = np.zeros((n_sites, 4), np.int64)
    n_err = rng.binomial(cov, 0.01)
    counts[np.arange(n_sites), major] = cov - n_err
    het_idx = np.nonzero(is_het)[0]
    second = (major[het_idx] + 1 + rng.integers(0, 3, het_idx.size)) % 4
    half = counts[het_idx, major[het_idx]] // 2
    counts[het_idx, major[het_idx]] -= half
    counts[het_idx, second] += half
    counts[np.arange(n_sites), rng.integers(0, 4, n_sites)] += n_err
    return counts


def _starts(lengths: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)


def phred_pileup(counts: np.ndarray, first_pos: int, seed: int) -> bytes:
    """mpileup lines of ``counts`` (every coverage >= 1): chr1 from position
    ``first_pos``, reference N, the reads as base letters (A, C, G, T in
    turn) and per-read base and mapping qualities drawn from ``seed``
    (Phred 2..41 and 1..60), assembled with numpy."""
    counts = np.asarray(counts, np.int64)
    n = counts.shape[0]
    cov = counts.sum(1)
    pos = np.arange(first_pos, first_pos + n, dtype=np.int64)
    powers = 10 ** np.arange(1, 19, dtype=np.int64)
    digits = lambda x: np.searchsorted(powers, x, side="right") + 1  # noqa: E731
    head_len = 9 + digits(pos) + digits(cov)  # "chr1\t" pos "\tN\t" cov "\t"
    heads = np.frombuffer("".join(f"chr1\t{p}\tN\t{c}\t" for p, c in zip(pos.tolist(), cov.tolist())).encode(),
                          np.uint8)
    line_len = head_len + 3 * cov + 3
    start = _starts(line_len)
    buf = np.empty(int(line_len.sum()), np.uint8)
    buf[np.repeat(start - _starts(head_len), head_len) + np.arange(heads.size)] = heads
    reads = start + head_len  # where each site's bases begin
    site = np.repeat(np.arange(n), cov)
    at = reads[site] + np.arange(site.size) - _starts(cov)[site]
    buf[at] = np.repeat(np.tile(np.frombuffer(b"ACGT", np.uint8), n), counts.ravel())
    rng = np.random.default_rng(seed)
    buf[at + cov[site] + 1] = 33 + rng.integers(2, 42, site.size)
    buf[at + 2 * cov[site] + 2] = 33 + rng.integers(1, 61, site.size)
    buf[reads + cov] = ord("\t")
    buf[reads + 2 * cov + 1] = ord("\t")
    buf[reads + 3 * cov + 2] = ord("\n")
    return buf.tobytes()


def write_phred_pileup(path: str, n_sites: int, seed: int, block: int = 1_000_000) -> int:
    """A Phred-varied simulated pileup of n_sites written in blocks of
    ``block`` sites (each block's counts and qualities from its own seed);
    returns its size in bytes."""
    with open(path, "wb") as f:
        for b, first in enumerate(range(0, n_sites, block)):
            m = min(block, n_sites - first)
            f.write(phred_pileup(simulated_counts(m, seed + 2 * b), first + 1, seed + 2 * b + 1))
        return f.tell()


def finalize_inputs(n: int, seed: int = 2026):
    """The quality finalize's inputs at n sites: (counts uint16, major,
    second, log_hom, log_het) with a Poisson(30) bulk, zero-coverage sites,
    ties, deep sites up to 65535 (one of 65535 x 4), log sums on both
    sides of the 80-bit underflow line and a few NaN and -inf sums."""
    from sid_tpu_torch.models.common import LONG_DOUBLE_UNDERFLOW_LOG, major_allele_indices_np

    rng = np.random.default_rng(seed)
    counts = rng.permuted(rng.multinomial(rng.poisson(30, n), [0.94, 0.03, 0.02, 0.01]), axis=1)
    zero, tie, deep, clamp = np.array_split(rng.permutation(n)[:40000], 4)
    counts[zero] = 0
    k = rng.integers(1, 300, tie.size)
    counts[tie] = np.stack([k, k, np.zeros_like(k), k], 1)
    counts[deep] = rng.integers(0, 65536, (deep.size, 4))
    counts[deep[0]] = 65535
    counts = counts.astype(np.uint16)
    major, second = major_allele_indices_np(counts)
    log_hom = -rng.exponential(60.0, n)
    log_het = -rng.exponential(60.0, n)
    log_het[clamp] = LONG_DOUBLE_UNDERFLOW_LOG + rng.normal(0, 40.0, clamp.size)
    log_hom[clamp[::2]] = LONG_DOUBLE_UNDERFLOW_LOG + rng.normal(0, 40.0, clamp[::2].size)
    log_het[deep] = -rng.uniform(0, 3e5, deep.size)
    log_het[zero[:50]] = np.nan
    log_het[zero[50:100]] = -np.inf
    return counts, major, second, log_hom, log_het


class HashSink:
    """A binary output that keeps only the SHA-256 and the length of what
    is written to it."""

    mode = "wb"

    def __init__(self):
        self.hash = hashlib.sha256()
        self.size = 0

    def write(self, data: bytes) -> int:
        self.hash.update(data)
        self.size += len(data)
        return len(data)


def simulated_pileup(n_sites: int, seed: int = 7) -> bytes:
    """~30x diploid pileup (``simulated_counts``) rendered as plain base
    letters with constant qualities."""
    counts = simulated_counts(n_sites, seed)
    lines = []
    for s, (a, c, g, t) in enumerate(counts.tolist()):
        n = a + c + g + t
        bases = "A" * a + "C" * c + "G" * g + "T" * t
        q = "I" * n
        lines.append(f"chr1\t{s + 1}\tN\t{n}\t{bases}\t{q}\t{q}")
    return ("\n".join(lines) + "\n").encode()


def assert_agree(name, a, b):
    """Identical non-finite positions; finite |a-b| <= RTOL max(1,|a|).
    Returns (max abs error, max relative error) over the finite values."""
    for pred in (np.isnan, np.isposinf, np.isneginf):
        if not np.array_equal(pred(a), pred(b)):
            raise AssertionError(f"{name}: {pred.__name__} positions differ")
    fin = np.isfinite(a)
    err = np.abs(a[fin] - b[fin])
    rel = err / np.maximum(1.0, np.abs(a[fin]))
    if err.size and rel.max() > RTOL:
        i = int(np.argmax(rel))
        raise AssertionError(f"{name}: rel err {rel[i]!r} > {RTOL} ({a[fin][i]!r} vs {b[fin][i]!r})")
    return (float(err.max()), float(rel.max())) if err.size else (0.0, 0.0)


def event_times_ms(torch, fn, sets, repeats=REPEATS) -> list:
    """CUDA-event times of fn over ``repeats`` calls, cycling input sets
    with distinct content (after one warm-up call per set)."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    times = []
    for r in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*sets[r % len(sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_only_ms(torch, launch, sets, k=20, reps=5, hold_cycles=200_000_000) -> float:
    """Device time of one launch: CUDA events around k launches that the
    host enqueued while torch.cuda._sleep held the stream, so the host's
    enqueue cost falls outside the events; median over reps, ms. ``launch``
    must not synchronise."""
    for s in sets:
        launch(*s)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        held.record()
        torch.cuda._sleep(hold_cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(k):
            launch(*sets[i % len(sets)])
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if enqueue_ms >= held.elapsed_time(start):
            raise AssertionError(f"the host took {enqueue_ms:.3f} ms to enqueue, longer than the stream was held")
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


# f64 instructions of the card's FP64 pipe: H100 SXM, 132 SMs x 64 FP64
# lanes x 1.98 GHz boost (NVIDIA data sheet: 34 TFLOP/s FP64 counting an FMA
# as two); memory 3.35 TB/s (the same data sheet); instruction issue: one
# warp-instruction a cycle on each of an SM's 4 sub-partitions
F64_INSTR_PER_S = 132 * 64 * 1.98e9
WARP_ISSUE_PER_S = 132 * 4 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
F64_OPCODES = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"}
SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9]+)\S*\s*([^;]*);")


def ptxas_report(text: str) -> dict:
    """nvcc -Xptxas -v output by kernel: registers, stack frame and spill
    bytes."""
    out = {}
    name = None
    for line in text.splitlines():
        head = re.search(r"Function properties for (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = {"registers": None}
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"), map(int, spill.groups())))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out[name]["registers"] = int(regs.group(1))
    return out


def cuobjdump_path():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    return None


def row_counts(instrs: list) -> dict:
    """What every row of a kernel executes, from its SASS (a list of
    (address, predicated, opcode, operands)). The row's code is the
    innermost loop that holds the kernel's first global load inside a loop
    (the row's own data, or the next row's where a thread loads ahead) and
    holds f64 work (a loop of integer work alone, such as the lane kernels'
    search of a row's lane, is passed over), or
    the whole kernel where no loop holds a global load. An instruction of it is executed by
    every row unless a branch can jump over it once that load has run; a
    predicated f64 instruction may do no work and is not counted. So
    ``f64`` and ``issued`` are lower bounds on the f64 instructions each
    row executes and the instructions each warp issues for a row (the
    profiler's executed counts are out of reach: ncu cannot initialize its
    counters on the card); ``f64_all`` and ``issued_all`` count the row's
    code with every branch arm taken, an upper bound that the fold after
    the row loop does not enter."""
    end = instrs[-1][0] + 16
    jumps = [(ad, int(args.split()[-1].rstrip(","), 16)) for ad, _, op, args in instrs if op == "BRA"]
    jumps += [(ad, end) for ad, pred, op, _ in instrs if op == "EXIT" and pred]
    loads = [ad for ad, _, op, _ in instrs if op == "LDG"]

    def innermost(ad):
        around = [(t, f) for f, t in jumps if t <= ad <= f]
        return max(around) if around else None

    def has_f64(loop):
        return any(loop[0] <= ad <= loop[1] and op in F64_OPCODES for ad, _, op, _ in instrs)

    if not loads:  # a kernel that loads nothing (a zeroing kernel): the whole of it
        loads = [instrs[0][0]]
    looped = [ad for ad in loads if innermost(ad) is not None]
    anchor = ([ad for ad in looped if has_f64(innermost(ad))] or looped or loads)[0]
    loops = [(t, f) for f, t in jumps if t <= anchor <= f]
    lo, hi = max(loops) if loops else (instrs[0][0], end)
    out = dict.fromkeys(("f64", "issued", "f64_all", "issued_all"), 0)
    for ad, pred, op, _ in instrs:
        if not lo <= ad <= hi or op == "NOP":
            continue
        out["f64_all"] += op in F64_OPCODES
        out["issued_all"] += 1
        if any(f < ad < t and not f < anchor < t for f, t in jumps if f < t):
            continue
        out["f64"] += op in F64_OPCODES and not pred
        out["issued"] += 1
    return out


def sass_kernels(lib_path: str) -> dict:
    """Every kernel of a built library as a list of (address, predicated,
    opcode, operands), by mangled name; {} when the toolkit has no
    cuobjdump."""
    tool = cuobjdump_path()
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    kernels = {}
    name = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            kernels[name] = []
            continue
        ins = SASS_LINE.match(line)
        if name and ins:
            kernels[name].append((int(ins.group(1), 16), ins.group(2) is not None, ins.group(3), ins.group(4)))
    return kernels


def operand_counts(instrs: list) -> dict:
    """Where a kernel's f64 instructions take their operands, and its
    constant and local-memory loads: of its f64 instructions, those reading
    the parameter bank (c[0x0]), the bank of its __constant__ data
    (c[0x3]) or a uniform register; its LDC, ULDC, LDL and STL
    instructions."""
    out = dict.fromkeys(("f64", "f64_param", "f64_const", "f64_uniform", "LDC", "ULDC", "LDL", "STL"), 0)
    for _, _, op, args in instrs:
        if op in F64_OPCODES:
            out["f64"] += 1
            out["f64_param"] += "c[0x0]" in args
            out["f64_const"] += "c[0x3]" in args
            out["f64_uniform"] += re.search(r"\bUR\d+", args) is not None
        if op in ("LDC", "ULDC", "LDL", "STL"):
            out[op] += 1
    return out


def kernel_counts(counts: dict, kernel: str) -> dict:
    """The counts of the one kernel whose mangled name holds ``kernel``."""
    hits = [n for name, n in counts.items() if kernel in name]
    if len(hits) != 1:
        raise AssertionError(f"{len(hits)} kernels named {kernel} in the SASS: {sorted(counts)}")
    return hits[0]


def bound_ms(n_bytes: float, f64_instr: float):
    """(least time in ms, what bounds it): bytes over the memory rate or
    f64 instructions over the FP64 rate, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = f64_instr / F64_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def issue_ms(issued: float, rows: int) -> float:
    """Time to issue ``issued`` instructions for each warp of 32 rows."""
    return issued * rows / 32 / WARP_ISSUE_PER_S * 1e3


def fit_wall_split(torch, prof, mult, nt, dev) -> dict:
    """The device fit (models.lynch.fit_lynch) taken apart, wall clock in
    ms: set-up (DeviceObjective: uploads, table, workspace), the
    evaluations (each objective call, launch to fetched result), the host
    simplex (the rest of the minimizer), B4 with its copies."""
    from sid_tpu_torch.exact.lynch_ld import DEFAULT_START, DEFAULT_STEP
    from sid_tpu_torch.exact.nmsimplex import minimize_nmsimplex2
    from sid_tpu_torch.models.lynch import DeviceObjective

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obj = DeviceObjective(prof, mult, nt, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    evals = []

    def timed(theta):
        t = time.perf_counter()
        v = obj(theta)
        evals.append(time.perf_counter() - t)
        return v

    res = minimize_nmsimplex2(timed, DEFAULT_START, DEFAULT_STEP)
    t2 = time.perf_counter()
    obj.marginals(float(res.x[1]))
    t3 = time.perf_counter()
    return {"setup_ms": (t1 - t0) * 1e3, "evaluations_ms": sum(evals) * 1e3, "evaluations": len(evals),
            "simplex_ms": (t2 - t1 - sum(evals)) * 1e3, "marginals_ms": (t3 - t2) * 1e3,
            "wall_ms": (t3 - t0) * 1e3, "x": [float(v) for v in res.x]}


def parent_local_kernel(build, parent: str):
    """A tree's local classify kernel with the first port's interface
    (csrc/local_classify.cu: int32 counts and host-made allele indices in,
    l1 and l2 out), built here with this tree's nvcc flags, with the
    kernel's resident blocks an SM from the occupancy API; for
    scripts/local_classify_variants.py --parent. Returns (ctypes library,
    ptxas report, blocks an SM)."""
    import ctypes

    src = os.path.join(os.path.abspath(parent), "sid_tpu_torch", "csrc", "local_classify.cu")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    wrapper = os.path.join(build.BUILD_DIR, "parent_local_classify.cu")
    with open(wrapper, "w") as f:
        f.write(f'#include "{src}"\n'
                'extern "C" int sid_parent_blocks_per_sm(int* n) {\n'
                '  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
                '      n, local_classify_kernel, kThreads, 0));\n}\n')
    out = os.path.join(build.BUILD_DIR, "libparent_local_classify.so")
    proc = subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
                           "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, wrapper],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"the parent's kernel does not build: {proc.stderr}")
    lib = ctypes.CDLL(out)
    p = ctypes.c_void_p
    lib.sid_local_classify_launch.restype = ctypes.c_int
    lib.sid_local_classify_launch.argtypes = [p, p, p, ctypes.c_double, p, ctypes.c_int, p, p, ctypes.c_int64, p]
    lib.sid_parent_blocks_per_sm.restype = ctypes.c_int
    lib.sid_parent_blocks_per_sm.argtypes = [p]
    per_sm = ctypes.c_int(0)
    if lib.sid_parent_blocks_per_sm(ctypes.byref(per_sm)):
        raise AssertionError("occupancy query of the parent's kernel failed")
    return lib, ptxas_report(proc.stdout + proc.stderr), per_sm.value


def build_sources(build, sources: dict, extra=None) -> dict:
    """Each named .cu source built with the port's nvcc flags (plus
    ``extra``) into sid_tpu_torch/_build/<name>.so, all at once; its
    includes resolve beside it. Returns {name: (library path, ptxas
    report)}."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(build.BUILD_DIR, exist_ok=True)

    def one(name, src):
        out = os.path.join(build.BUILD_DIR, f"{name}.so")
        proc = subprocess.run(build.nvcc_command(src, out, (extra or {}).get(name)), capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"{name} does not build: {proc.stderr}")
        return out, ptxas_report(proc.stdout + proc.stderr)

    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(one, name, src) for name, src in sources.items()}
        return {name: fut.result() for name, fut in futures.items()}


def parent_device_lrt(build, parent: str) -> dict:
    """The parent tree's csrc/local_classify.cu (B1, B5), csrc/lrt_bh.cu
    (the LRT and BH with its own order) and csrc/quality_finalize.cu (B6
    and its full form), whose C interfaces this tree keeps, built with this
    tree's nvcc flags, all at once; their ptxas lines printed. Returns
    {"local_classify", "lrt_bh", "quality_finalize": libraries with their
    types set}, for ``using_library`` over this tree's wrappers."""
    from sid_tpu_torch.ops import local_classify as lc
    from sid_tpu_torch.ops import quality_finalize as qf
    from sid_tpu_torch.ops import stats

    csrc = os.path.join(os.path.abspath(parent), "sid_tpu_torch", "csrc")
    modules = {"local_classify": lc, "lrt_bh": stats, "quality_finalize": qf}
    built = build_sources(build, {f"parent_{name}": os.path.join(csrc, f"{name}.cu") for name in modules})
    for name, (_, report) in built.items():
        for fn, r in report.items():
            log(f"# ptxas {name}: {fn}: {r['registers']} registers, {r['spill_stores']} bytes spill stores, "
                f"{r['spill_loads']} bytes spill loads")
    return {name: mod.load_kernel_library(built[f"parent_{name}"][0]) for name, mod in modules.items()}


class using_library:
    """Run a kernel module's wrappers (ops.local_classify, ops.stats,
    ops.quality_finalize) over another build of its source (its resident
    blocks asked anew) inside a with block."""

    def __init__(self, module, lib):
        self.module, self.lib = module, lib

    def __enter__(self):
        self.saved = self.module._kernel_lib(), dict(self.module._resident)
        self.module._lib, self.module._resident = self.lib, {}

    def __exit__(self, *exc):
        self.module._lib, self.module._resident = self.saved
        return False


def on_library(module, lib, fn):
    """fn run under ``using_library(module, lib)``."""
    def run(*a):
        with using_library(module, lib):
            return fn(*a)
    return run


def in_turns(torch, ways: dict, sets, rounds=2) -> dict:
    """Device-only times of each way's launch over the input sets, in turns
    (a, b, ..., then reversed), ``rounds`` times: {name: [ms, ...]}."""
    out = {}
    for _ in range(rounds):
        for name in list(ways) + list(ways)[::-1]:
            out.setdefault(name, []).append(device_only_ms(torch, ways[name], sets))
    return out


def calls_in_turns(torch, ways: dict, sets) -> dict:
    """CUDA-event times of each way's whole call, in turns (a, b, ...,
    reversed): {name: [ms, ...]} (REPEATS a turn)."""
    out = {}
    for name in list(ways) + list(ways)[::-1]:
        out.setdefault(name, []).extend(event_times_ms(torch, ways[name], sets))
    return out


def readings(times: dict) -> str:
    return "; ".join(f"{name} {statistics.median(v):.4f} ms (min {min(v):.4f}, max {max(v):.4f}, {len(v)} readings)"
                     for name, v in times.items())


def device_time_ms(event) -> float:
    """Device time of one call of a torch.profiler key_averages() entry, ms."""
    total = getattr(event, "device_time_total", None)
    if total is None:
        total = event.cuda_time_total
    return total / event.count / 1e3


def first_difference(a: bytes, b: bytes) -> str:
    la, lb = a.split(b"\n"), b.split(b"\n")
    for k, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return f"line {k}: {x!r} vs {y!r}"
    return f"lengths {len(la)} vs {len(lb)} lines"


def quality_kernel_phase(torch, dev, card, sass) -> dict:
    """Phase 8: the quality finalize kernel at N_QUALITY sites against its
    plain version, sid_tpu's numpy composition and libsidtpu's fused host
    pass, bitwise, at each prior; its times and bound. Returns its row of
    the kernels line (launches are phase 9's)."""
    from sid_tpu_torch.models import quality
    from sid_tpu_torch.ops import quality_finalize as qf
    from sid_tpu_torch.ops import stats
    from sid_tpu_torch.ops.lgamma import lgamma_table

    n = N_QUALITY
    counts, major, second, log_hom, log_het = finalize_inputs(n)
    alleles = qf.pack_alleles(major, second)
    tab = lgamma_table(qf.MAX_TOP2, dev)  # the device stage's table
    tab_np = tab.cpu().numpy()
    c_dev = torch.from_numpy(counts.view(np.int16)).to(dev)
    a_dev = torch.from_numpy(alleles).to(dev)
    h_dev = torch.from_numpy(log_het).to(dev)
    max_abs = 0.0
    for prior in PRIORS:
        k = qf.quality_finalize(c_dev, a_dev, h_dev, tab, prior).cpu().numpy()
        torch.cuda.synchronize()
        p = qf.quality_finalize_ref(c_dev, a_dev, h_dev, tab, prior).cpu().numpy()
        lpp1, lpp2 = quality.finalize_quality_np(counts, major, second, log_hom, log_het, prior, tab_np)
        het, p1, p2 = quality.finalize_quality_native(counts, major, second, log_hom, log_het, prior, 0.05)
        k1 = stats.lrt_pvalue_from_logs_np(k, lpp1)
        k2 = stats.lrt_pvalue_from_logs_np(lpp1, k)
        for what, a, b in (("lpp2 vs the plain version", k, p), ("lpp2 vs finalize_quality_np", k, lpp2),
                           ("p1 vs sidtpu_quality_finalize", k1, p1), ("p2 vs sidtpu_quality_finalize", k2, p2)):
            if not np.array_equal(a.view(np.uint64), b.view(np.uint64)):
                raise AssertionError(f"quality finalize at prior {prior}: {what} differs bitwise")
        with np.errstate(invalid="ignore"):
            if not np.array_equal(het, k2 < 0.05):
                raise AssertionError(f"quality finalize at prior {prior}: het calls differ from the host pass")
        fin = np.isfinite(k)
        max_abs = max(max_abs, float(np.abs(k[fin] - p[fin]).max()))
        log(f"# quality finalize == plain at N={n}, prior {prior}: lpp2 bitwise the plain version and "
            f"finalize_quality_np, both p-values and the calls bitwise sidtpu_quality_finalize "
            f"({int(np.isneginf(k).sum())} sites clamped to -inf, {int(np.isnan(k).sum())} NaN)")
    sets = []
    for j in range(INPUT_SETS):  # distinct content: the same sites rolled
        sets.append(tuple(torch.roll(t, 7919 * j, 0).contiguous() for t in (c_dev, a_dev, h_dev)) + (tab, 1e-3))
    plain = event_times_ms(torch, qf.quality_finalize_ref, sets)
    call = event_times_ms(torch, qf.quality_finalize, sets) + event_times_ms(torch, qf.quality_finalize, sets)
    plain += event_times_ms(torch, qf.quality_finalize_ref, sets)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    misses = torch.empty(1, dtype=torch.int32, device=dev)
    dev_ms = device_only_ms(torch, lambda c, a, h, t, pr: qf.launch(c, a, h, t, pr, out, misses), sets)
    rows = kernel_counts(sass, "quality_finalize_kernel")
    n_bytes = n * qf.BYTES_PER_SITE + tab.shape[0] * 8
    b_ms, b_by = bound_ms(n_bytes, rows["f64"] * n)
    b_all = bound_ms(n_bytes, rows["f64_all"] * n)[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = qf.resident_blocks(dev)
    row = {"name": "quality_finalize", "route": "cuda", "source": "sid_tpu_torch/csrc/quality_finalize.cu",
           "replaces": "sid_tpu/models/quality.py:113", "launches": None, "max_abs_err": max_abs,
           "ms": statistics.median(call), "plain_ms": statistics.median(plain), "device_ms": dev_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"# quality_finalize at N={n}, prior 1e-3: call {row['ms']:.4f} ms (median of {len(call)}, min "
        f"{min(call):.4f}; launch, stream sync, miss count), device only {dev_ms:.4f} ms, plain torch "
        f"{row['plain_ms']:.4f} ms; bound {b_ms:.4f} ms by {b_by} ({n * qf.BYTES_PER_SITE / 1e6:.0f} MB of sites, "
        f"{tab.shape[0] * 8 / 1e6:.1f} MB of table; {rows['f64']} f64 instructions every row executes, "
        f"{rows['f64_all']} with every branch arm: {b_all:.4f} ms), {b_ms / dev_ms:.1%} of the bound; issuing the "
        f"row's instructions {issue_ms(rows['issued'], n):.4f}-{issue_ms(rows['issued_all'], n):.4f} ms "
        f"({rows['issued']}-{rows['issued_all']} a warp); grid {resident} blocks ({resident // sms} an SM x {sms} "
        f"SMs); on {card}")
    return row


def quality_path_phase(torch, dev, card, workdir, golden_src, real_src):
    """Phase 9: -m quality through engine.run on the goldens, the 100k-site
    fixture and N_QUALITY Phred-varied simulated sites (the last two
    byte-equal to the fused host finalize's CSV); sites/s, the stage split,
    and the finalize at N_QUALITY both ways. Returns (kernel launches of the
    path, the simulated file)."""
    from sid_tpu_torch import engine
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.io.pileup import parse_pileup
    from sid_tpu_torch.models import quality
    from sid_tpu_torch.ops import quality_finalize as qf
    from sid_tpu_torch.ops import stats
    from sid_tpu_torch.utils import profiling

    qsrc = os.path.join(workdir, "phred_1m.pileup")
    t0 = time.perf_counter()
    size = write_phred_pileup(qsrc, N_QUALITY, seed=8)
    log(f"# simulated {N_QUALITY} ~30x sites with per-read Phred qualities ({size / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    opts = Options(method="quality")
    want = {}
    for name, src in (("bwa_like_100k", real_src), ("phred", qsrc)):
        batch = parse_pileup(src, True, True, quality_terms_only=True)
        want[name] = quality.call_quality_host(batch, opts).to_csv_bytes()

    qf.LAUNCHES = 0
    for label, kw, golden in (("-m quality", {}, "golden_quality.csv"),
                              ("-R -m quality", {"estimate_prior": True}, "golden_quality_R.csv"),
                              ("-m quality --engine exact", {"engine": "exact"}, "golden_quality.csv")):
        with open(os.path.join(FIXTURES, golden), "rb") as f:
            golden_bytes = f.read()
        got = engine.run(golden_src, Options(method="quality", **kw), binary=True)
        if got != golden_bytes:
            raise AssertionError(f"golden {label}: CSV differs from {golden}: {first_difference(got, golden_bytes)}")
        log(f"# golden.pileup {label}: byte-equal to {golden}")
    got = engine.run(real_src, opts, binary=True)
    if got != want["bwa_like_100k"]:
        raise AssertionError(f"bwa_like_100k -m quality differs: {first_difference(got, want['bwa_like_100k'])}")
    log("# bwa_like_100k -m quality: byte-equal to the fused host finalize's CSV")
    runs = []
    for _ in range(3):
        prof_run = profiling.StageProfile()
        profiling.activate(prof_run)
        t0 = time.perf_counter()
        got = engine.run(qsrc, opts, binary=True)
        wall = time.perf_counter() - t0
        profiling.activate(None)
        if got != want["phred"]:
            raise AssertionError(f"Phred-varied -m quality differs: {first_difference(got, want['phred'])}")
        runs.append((wall, prof_run))
    launches = qf.LAUNCHES
    if launches != 6:  # golden, -R, the 100k fixture and three runs; none under --engine exact
        raise AssertionError(f"the quality path launched the kernel {launches} times, expected 6")
    log(f"# Phred-varied {N_QUALITY} sites -m quality: byte-equal to the fused host finalize's CSV (3 runs); "
        f"kernel launches on the path: {launches}")
    for wall, p in runs:
        stages = ", ".join(f"{name} {s * 1e3:.1f} ms" for name, s in p.stages)
        cuda_ms = p.counters.get("device:finalize_quality_het:cuda_ms", float("nan"))
        log(f"# -m quality: {N_QUALITY / wall:,.0f} sites/s end to end ({wall * 1e3:.1f} ms); device stage "
            f"{profiling.device_seconds(p) / wall:.2%} of wall ({cuda_ms:.3f} ms on the stream); {stages}; on {card}")

    # the finalize at N_QUALITY both ways: the device stage (pinned copies,
    # kernel) with the host hom side and libm LRT, against libsidtpu's fused
    # host pass; in turns
    batch = parse_pileup(qsrc, True, True, quality_terms_only=True)
    args = (batch.counts, batch.q_major, batch.q_second, batch.q_log_hom, batch.q_log_het, -1.0)

    def device_way():
        lpp1, lpp2 = quality.finalize_logs(*args, dev)
        return stats.lrt_pvalue_from_logs_np(lpp2, lpp1), stats.lrt_pvalue_from_logs_np(lpp1, lpp2)

    def host_way():
        return quality.finalize_quality_native(*args, 0.05)[1:]

    walls = {"device stage + host LRT": [], "sidtpu_quality_finalize": []}
    outs = {}
    for name in ("device stage + host LRT", "sidtpu_quality_finalize") * 2 + (
            "sidtpu_quality_finalize", "device stage + host LRT") * 2:
        fn = device_way if name.startswith("device") else host_way
        t0 = time.perf_counter()
        outs[name] = fn()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    for a, b in zip(*outs.values()):
        if not np.array_equal(a.view(np.uint64), b.view(np.uint64)):
            raise AssertionError("the device finalize's p-values differ from sidtpu_quality_finalize's")
    stage = []
    for _ in range(5):
        t0 = time.perf_counter()
        qf.finalize_het(args[0], args[1], args[2], args[4], -1.0, dev)
        stage.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as tp:
        for _ in range(5):
            qf.finalize_het(args[0], args[1], args[2], args[4], -1.0, dev)
    seg = {}
    for ev in tp.key_averages():
        for name, key in (("h2d", "Memcpy HtoD"), ("kernel", "quality_finalize_kernel"), ("d2h", "Memcpy DtoH")):
            if key in ev.key:
                seg[name] = seg.get(name, 0.0) + device_time_ms(ev)
    split = ", ".join(f"{name} {seg[name]:.4f} ms" if name in seg else f"{name} not measured"
                      for name in ("h2d", "kernel", "d2h"))
    log(f"# quality finalize at N={batch.num_sites} (the Phred-varied sites): device stage finalize_het host wall "
        f"{statistics.median(stage):.2f} ms (runs {', '.join(f'{w:.2f}' for w in stage)}); on the device {split} "
        f"(torch.profiler, mean of 5; {qf.BYTES_IN_PER_SITE} B a site in, 8 B out); whole finalize "
        + ", ".join(f"{name} {statistics.median(w):.2f} ms (runs {', '.join(f'{x:.2f}' for x in w)})"
                    for name, w in walls.items())
        + f"; p-values bitwise equal; on {card}")
    return launches, qsrc


def stream_phase(card, workdir, qsrc) -> None:
    """Phase 10: run_streaming on phase 9's file with 8 MB chunks for -m
    local, -R -m likelihood_ratio and -m quality, byte-equal to engine.run;
    a --checkpoint rerun with resume that skips pass 1; --stream -m local
    at N_STREAM simulated sites with the default chunks, its output's hash
    equal to engine.run's."""
    from sid_tpu_torch import engine
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.ops import local_classify
    from sid_tpu_torch.ops import quality_finalize as qf
    from sid_tpu_torch.utils import profiling

    cases = (("-m local", {}), ("-R -m likelihood_ratio", {"method": "likelihood_ratio", "estimate_prior": True}),
             ("-m quality", {"method": "quality"}))
    want = {label: engine.run(qsrc, Options(**kw), binary=True) for label, kw in cases}
    local_classify.LAUNCHES = 0
    qf.LAUNCHES = 0
    for label, kw in cases:
        out = io.BytesIO()
        t0 = time.perf_counter()
        n = engine.run_streaming(qsrc, Options(**kw), out, chunk_bytes=STREAM_CHUNK)
        wall = time.perf_counter() - t0
        if out.getvalue() != want[label]:
            raise AssertionError(f"--stream {label} differs from engine.run: {first_difference(out.getvalue(), want[label])}")
        log(f"# --stream {label}, {STREAM_CHUNK >> 20} MB chunks, {N_QUALITY} sites: byte-equal to engine.run, "
            f"{n} records, {N_QUALITY / wall:,.0f} sites/s ({wall * 1e3:.1f} ms); on {card}")
    launches = {"local classify": local_classify.LAUNCHES, "quality finalize": qf.LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the streaming path was not launched: {launches}")
    log("# kernel launches on the streaming path: " + ", ".join(f"{k} {v}" for k, v in launches.items()))

    label, kw = cases[1]
    ckpt = os.path.join(workdir, "hist")
    engine.run_streaming(qsrc, Options(**kw), io.BytesIO(), chunk_bytes=STREAM_CHUNK, checkpoint=ckpt)
    prof = profiling.StageProfile()
    profiling.activate(prof)
    try:
        again = io.BytesIO()
        engine.run_streaming(qsrc, Options(**kw), again, chunk_bytes=STREAM_CHUNK, checkpoint=ckpt, resume=True)
    finally:
        profiling.activate(None)
    stages = sorted({name for name, _ in prof.stages})
    if "histogram" in stages or again.getvalue() != want[label]:
        raise AssertionError(f"--checkpoint --resume {label}: stages {stages}, byte-equal {again.getvalue() == want[label]}")
    log(f"# --stream {label} --checkpoint, then --resume: pass 1 skipped (stages run: {', '.join(stages)}), "
        f"byte-equal to engine.run")

    big = os.path.join(workdir, "phred_10m.pileup")
    t0 = time.perf_counter()
    size = write_phred_pileup(big, N_STREAM, seed=20)
    log(f"# simulated {N_STREAM} sites ({size / 1e9:.2f} GB on disk) in {time.perf_counter() - t0:.1f} s")
    sinks = []
    for _ in range(2):
        sink = HashSink()
        p = profiling.StageProfile()
        profiling.activate(p)
        t0 = time.perf_counter()
        n = engine.run_streaming(big, Options(), sink)
        wall = time.perf_counter() - t0
        profiling.activate(None)
        sinks.append(sink)
        split = {}
        for name, s in p.stages:
            split[name] = split.get(name, 0.0) + s
        log(f"# --stream -m local, {N_STREAM} sites, 64 MB chunks: {N_STREAM / wall:,.0f} sites/s ({wall:.2f} s), "
            f"{n} records; " + ", ".join(f"{k} {v * 1e3:.0f} ms" for k, v in split.items()) + f"; on {card}")
    whole = engine.run(big, Options(), binary=True)
    digest = hashlib.sha256(whole).hexdigest()
    if any(s.hash.hexdigest() != digest or s.size != len(whole) for s in sinks):
        raise AssertionError("--stream -m local at 10M sites differs from engine.run")
    log(f"# --stream -m local at {N_STREAM} sites: output ({len(whole) / 1e6:.0f} MB) the same SHA-256 as engine.run")


# ---- phase 13: the fused on-device LRT (exact_pvalues=False) ----
DBL_MIN = np.finfo(np.float64).tiny
# p-values through another erfc than the host's (CUDA's, torch's): 1e-13
# relative where both are >= DBL_MIN, below DBL_MIN together
P_RTOL = 1e-13
ALPHA = 0.05


def pvalues_close(name, got, want, rtol=P_RTOL) -> float:
    """The device-LRT tolerance: NaN at the same positions, below DBL_MIN
    together, |got - want| <= rtol * want elsewhere; returns the largest
    relative error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        raise AssertionError(f"{name}: NaN positions differ")
    g, w = got[~nan], want[~nan]
    low = w < DBL_MIN
    if not np.array_equal(g < DBL_MIN, low):
        raise AssertionError(f"{name}: {int(((g < DBL_MIN) != low).sum())} p-values below DBL_MIN on one side only")
    rel = np.abs(g[~low] - w[~low]) / w[~low]
    if rel.size and rel.max() > rtol:
        i = int(np.argmax(rel))
        raise AssertionError(f"{name}: rel err {rel[i]!r} > {rtol} ({g[~low][i]!r} vs {w[~low][i]!r})")
    return float(rel.max()) if rel.size else 0.0


def het_close(name, got, want, p2, alpha=ALPHA) -> int:
    """is_het apart only where p2 lies within P_RTOL * alpha of alpha;
    returns how many rows differ."""
    differ = np.asarray(got, bool) != np.asarray(want, bool)
    if (np.abs(np.asarray(p2)[differ] - alpha) > P_RTOL * alpha).any():
        raise AssertionError(f"{name}: is_het differs away from alpha at {np.flatnonzero(differ)[:5]}")
    return int(differ.sum())


def csv_close(name, got: bytes, want: bytes, alpha=ALPHA) -> int:
    """Two CSVs of p-values held by the tolerance as printed: the same
    sites and confidence type; each p-value equal or one unit of %g's sixth
    digit apart; the call apart only where het_conf prints as alpha.
    Returns the count of lines that differ in bytes."""
    gl, wl = got.split(b"\n"), want.split(b"\n")
    if len(gl) != len(wl):
        raise AssertionError(f"{name}: {len(gl)} vs {len(wl)} lines")
    differ = [k for k, (a, b) in enumerate(zip(gl, wl)) if a != b]
    for k in differ:
        a, b = gl[k].split(b","), wl[k].split(b",")
        ok = a[:2] == b[:2] and a[6:] == b[6:]
        for x, y in zip(a[4:6], b[4:6]):
            fx, fy = float(x), float(y)
            ok &= (np.isnan(fx) and np.isnan(fy)) or abs(fx - fy) <= 1e-5 * max(abs(fx), abs(fy))
        if a[2:4] != b[2:4]:
            ok &= abs(float(b[5]) - alpha) <= 1e-5 * alpha
        if not ok:
            raise AssertionError(f"{name}: line {k}: {gl[k]!r} vs {wl[k]!r}")
    return len(differ)


def lrt_rows_times(torch, label, fn, plain, sets, launch, sass, names, rows, n_bytes, card, extra=""):
    """Call (median of 40, in turns with the plain version), device-only
    time and bound of one device-LRT kernel; returns the kernels line's
    timing keys."""
    plain_t = event_times_ms(torch, plain, sets)
    call_t = event_times_ms(torch, fn, sets) + event_times_ms(torch, fn, sets)
    plain_t += event_times_ms(torch, plain, sets)
    dev_ms = device_only_ms(torch, launch, sets)
    f64 = sum(kernel_counts(sass, k)["f64"] for k in names)
    f64_all = sum(kernel_counts(sass, k)["f64_all"] for k in names)
    b_ms, b_by = bound_ms(n_bytes, f64 * rows)
    b_all = bound_ms(n_bytes, f64_all * rows)[0]
    out = {"ms": statistics.median(call_t), "plain_ms": statistics.median(plain_t), "device_ms": dev_ms,
           "bound_ms": b_ms, "bound_by": b_by, "f64_row": f64, "f64_row_all_arms": f64_all}
    log(f"# {label}: call {out['ms']:.4f} ms (median of {len(call_t)}, min {min(call_t):.4f}), device only "
        f"{dev_ms:.4f} ms, plain torch {out['plain_ms']:.4f} ms; bound {b_ms:.4f} ms by {b_by} ({n_bytes / 1e6:.1f} MB; "
        f"{f64} f64 instructions every row executes, {f64_all} with every branch arm: {b_all:.4f} ms), "
        f"{b_ms / dev_ms:.1%} of the bound{extra}; on {card}")
    return out


def plant_edges(lhom: np.ndarray, lhet: np.ndarray):
    """Copies of two arrays of logs (the LRT's log likelihoods, the quality
    finalize's per-read sums) with every pair of edge values planted at
    rows spread over them: NaN of both signs,
    +-inf, -0 and +0, equal logs, the 80-bit underflow line and its
    neighbours, and the values that the -R prior's logs (pi 0.02) move onto
    the line."""
    from sid_tpu_torch.models.common import LONG_DOUBLE_UNDERFLOW_LOG as line
    from sid_tpu_torch.ops import stats

    lp_hom, lp_het = stats.prior_logs(0.02)
    vals = [np.nan, -np.float64(np.nan), np.inf, -np.inf, -0.0, 0.0, -7.25, line, np.nextafter(line, -np.inf),
            np.nextafter(line, np.inf), line - lp_hom, line - lp_het, np.nextafter(line - lp_het, -np.inf)]
    pairs = np.array([(a, b) for a in vals for b in vals], np.float64)
    at = np.linspace(5, lhom.shape[0] - 5, pairs.shape[0]).astype(np.int64)
    hom, het = np.array(lhom, np.float64), np.array(lhet, np.float64)
    hom[at], het[at] = pairs[:, 0], pairs[:, 1]
    return hom, het


def path_shape_pvalues(prof, dev):
    """BH's input at the likelihood-ratio path's shape: B5's p1 and p2 (-E
    0.1, prior 1e-3) of ``prof`` on the card, with NaN and ties at 0.5, 0
    and 1 planted."""
    import torch

    from sid_tpu_torch.ops import local_classify as lc
    from sid_tpu_torch.ops.lgamma import lgamma_table

    counts_np, hi = lc.narrow_counts(prof)
    counts = torch.from_numpy(counts_np.view(np.int16)).to(dev)
    q1, q2, _ = (x.clone() for x in lc.local_classify_lrt(counts, 0.1, 1e-3, ALPHA, lgamma_table(4 * hi, dev)))
    q2[::97] = 0.5
    q2[::211] = float("nan")
    q2[3::301] = 0.0
    q1[::89] = float("nan")
    q1[5::113] = 1.0
    return q1, q2


def device_lrt_kernel_phase(torch, dev, card, sass, prof_np, marginals, fit_prof, small_prof, parent=None) -> list:
    """Phase 13, the kernels: B5 at phase 3's U profiles, every -E and
    prior; B6's full form at phase 8's N sites; the LRT on phase 5's
    marginals (of ``fit_prof``); BH on B5's p-values with ties and NaN
    planted, at U and at ``small_prof`` (the simulated sites' ~2,000
    profiles, the path's shape). Each held to the host path and its plain
    version, timed, bounded; with ``parent`` (``parent_device_lrt``) B5,
    the LRT and BH bitwise the parent's kernels at both shapes and B6 full
    at N, each timed in turns with the parent's (B1 too); the device LRT's
    wall against the host-libm path. Returns the four kernels' rows of the
    kernels line (launches are the path's)."""
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.models import likelihood_ratio, local, quality
    from sid_tpu_torch.models.common import LONG_DOUBLE_UNDERFLOW_LOG
    from sid_tpu_torch.ops import local_classify as lc
    from sid_tpu_torch.ops import quality_finalize as qf
    from sid_tpu_torch.ops import stats
    from sid_tpu_torch.ops.lgamma import lgamma_table

    t_phase = time.perf_counter()
    u = prof_np.shape[0]
    counts_np, hi = lc.narrow_counts(prof_np)
    counts = torch.from_numpy(counts_np.view(np.int16)).to(dev)
    tab = lgamma_table(4 * hi, dev)
    rows = []

    # B5: the byte bitwise B1's; p1, p2 against host libm over B1's (l1,
    # l2) plus the prior, and against the plain LRT on the card over the
    # same likelihoods; is_het equal outside the alpha band; the whole plain
    # version (torch's logs: 1e-12 on l1, l2) reported
    b5_rel = b5_abs = plain_rel = 0.0
    bh_p = None
    for thr in THRESHOLDS:
        for prior in PRIORS:
            l1, l2, b1 = (t.cpu().numpy().copy() for t in lc.local_classify(counts, thr, prior, tab))
            k1, k2, kb = (t.cpu().numpy().copy() for t in lc.local_classify_lrt(counts, thr, prior, ALPHA, tab))
            torch.cuda.synchronize()
            if not np.array_equal(kb & 31, b1):
                raise AssertionError(f"B5 at -E {thr}, prior {prior}: the byte's bits 0-4 differ from B1's")
            lp_hom, lp_het, _, use_prior = lc.lrt_constants(prior, ALPHA)
            if use_prior:
                l1, l2 = l1 + lp_hom, l2 + lp_het
            h1 = stats.lrt_pvalue_from_logs_np(l2, l1)
            h2 = stats.lrt_pvalue_from_logs_np(l1, l2)
            b5_rel = max(b5_rel, pvalues_close(f"B5 p1 -E {thr} prior {prior} vs host libm", k1, h1),
                         pvalues_close(f"B5 p2 -E {thr} prior {prior} vs host libm", k2, h2))
            with np.errstate(invalid="ignore"):
                het_close(f"B5 is_het -E {thr} prior {prior}", lc.het_flags(kb), (l2 > l1) & (h2 < ALPHA), h2)
            t1, t2 = torch.from_numpy(l1).to(dev), torch.from_numpy(l2).to(dev)
            q1, q2 = stats.lrt_pvalues_ref(t2, t1).cpu().numpy(), stats.lrt_pvalues_ref(t1, t2).cpu().numpy()
            for a, b in ((k1, q1), (k2, q2)):
                pvalues_close(f"B5 -E {thr} prior {prior} vs the plain LRT on the card", a, b)
                fin = np.isfinite(a) & np.isfinite(b)
                b5_abs = max(b5_abs, float(np.abs(a[fin] - b[fin]).max()))
            f1, f2, fb = (t.cpu().numpy() for t in lc.local_classify_lrt_ref(counts, thr, prior, ALPHA, tab))
            if not np.array_equal(fb & 31, b1):
                raise AssertionError(f"B5's plain version at -E {thr}, prior {prior}: the byte differs")
            for a, b in ((f1, k1), (f2, k2)):
                ok = (a >= DBL_MIN) & (b >= DBL_MIN)
                plain_rel = max(plain_rel, float((np.abs(a[ok] - b[ok]) / b[ok]).max()))
            if thr == 0.1 and prior == 1e-3:
                bh_p = k2.copy()
        log(f"# B5 == host at U={u}, -E {thr}: the byte's bits 0-4 bitwise B1's, p1 and p2 within {P_RTOL} of host "
            f"libm over B1's likelihoods and of the plain LRT on the card, is_het equal outside the alpha band, "
            f"at priors {PRIORS}")
    log(f"# B5: max rel err {b5_rel!r} against host libm (bound {P_RTOL}); against the whole plain version on the "
        f"card (torch's logs) {plain_rel!r}")
    sets = [(torch.roll(counts, 7919 * k, 0).contiguous(), 0.1, 1e-3, ALPHA, tab) for k in range(INPUT_SETS)]
    buf = torch.empty(lc.BYTES_PER_ROW * u, dtype=torch.uint8, device=dev)
    times = lrt_rows_times(torch, f"local_classify_lrt (B5) at U={u}, -E 0.1, prior 1e-3", lc.local_classify_lrt,
                           lc.local_classify_lrt_ref, sets,
                           lambda c, thr, pr, a, t: lc._launch(c, thr, pr, t, buf, a), sass,
                           ["local_classify_lrt_kernel"], u, u * (8 + 17) + tab.shape[0] * 8, card,
                           f"; grid {lc.resident_blocks(dev, True)} blocks")
    erfc0 = torch.special.erfc(torch.zeros(1, dtype=torch.float64, device=dev)).item()
    log(f"# erfc(0.0) on the card (torch's CUDA erfc): {erfc0!r} ({np.float64(erfc0).view(np.uint64):#x}); B5 "
        f"evaluates it once a thread from a 0.0 the host passes")
    small_np, small_hi = lc.narrow_counts(small_prof)
    small_counts = torch.from_numpy(small_np.view(np.int16)).to(dev)
    small_tab = lgamma_table(4 * small_hi, dev)
    b5_row = {"name": "local_classify_lrt", "route": "cuda", "source": "sid_tpu_torch/csrc/local_classify.cu",
              "replaces": "sid_tpu/models/local.py:30", "launches": None, "max_abs_err": b5_abs, **times,
              "library_ms": None}
    if parent is not None:
        plib = parent["local_classify"]
        shapes = ((f"U={u}", counts, tab), (f"U={small_prof.shape[0]} (the simulated sites' profiles)",
                                             small_counts, small_tab))
        for label, c, t in shapes:
            for thr in THRESHOLDS:
                for prior in PRIORS:
                    new = [x.cpu() for x in lc.local_classify_lrt(c, thr, prior, ALPHA, t)]
                    with using_library(lc, plib):
                        old = [x.cpu() for x in lc.local_classify_lrt(c, thr, prior, ALPHA, t)]
                    for what, x, y in zip(("p1", "p2", "byte"), new, old):
                        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
                            raise AssertionError(f"B5 at {label}, -E {thr}, prior {prior}: {what} differs from the "
                                                 "parent's kernel")
        log(f"# B5 == the parent's B5 bitwise (p1, p2, byte) at {' and '.join(x[0] for x in shapes)}, every -E "
            f"and prior")
        committed = lc._kernel_lib()

        for label, c, t in shapes:
            n_rows = c.shape[0]
            buf = torch.empty(lc.BYTES_PER_ROW * n_rows, dtype=torch.uint8, device=dev)
            sets = [(torch.roll(c, 7919 * k, 0).contiguous(), 0.1, 1e-3, ALPHA, t) for k in range(INPUT_SETS)]
            b5 = lambda cc, thr, pr, a, tt: lc._launch(cc, thr, pr, tt, buf, a)  # noqa: E731
            b1 = lambda cc, thr, pr, a, tt: lc._launch(cc, thr, pr, tt, buf)  # noqa: E731
            dev_t = in_turns(torch, {"B5": on_library(lc, committed, b5), "parent B5": on_library(lc, plib, b5),
                                     "B1": on_library(lc, committed, b1), "parent B1": on_library(lc, plib, b1)}, sets)
            call_t = calls_in_turns(torch, {"B5": on_library(lc, committed, lc.local_classify_lrt),
                                            "parent B5": on_library(lc, plib, lc.local_classify_lrt)}, sets)
            log(f"# B5 and B1 against the parent's at {label}, -E 0.1, prior 1e-3, in turns: device only "
                f"{readings(dev_t)}; the call {readings(call_t)}; on {card}")
            key = "" if c is counts else "small_"
            b5_row.update({f"{key}parent_device_ms": statistics.median(dev_t["parent B5"]),
                           f"{key}device_ms_in_turns": statistics.median(dev_t["B5"]),
                           f"{key}b1_device_ms": statistics.median(dev_t["B1"]),
                           f"{key}parent_b1_device_ms": statistics.median(dev_t["parent B1"]),
                           f"{key}parent_ms": statistics.median(call_t["parent B5"])})
    rows.append(b5_row)
    del sets, buf

    # B6's full form: against libsidtpu's fused host pass and the plain
    # version on the card, edge rows planted
    n = N_QUALITY
    c_np, ma, se, lh, lt = finalize_inputs(n)
    lh, lt = plant_edges(lh, lt)
    qtab = lgamma_table(qf.MAX_TOP2, dev)
    c_dev = torch.from_numpy(c_np.view(np.int16)).to(dev)
    a_dev = torch.from_numpy(qf.pack_alleles(ma, se)).to(dev)
    lt_dev, lh_dev = torch.from_numpy(lt).to(dev), torch.from_numpy(lh).to(dev)
    q_rel = q_abs = 0.0
    for prior in PRIORS:
        k1, k2, kh = (t.cpu().numpy().copy() for t in qf.quality_finalize_lrt(c_dev, a_dev, lt_dev, lh_dev, qtab,
                                                                              prior, ALPHA))
        h_het, h1, h2 = quality.finalize_quality_native(c_np, ma, se, lh, lt, prior, ALPHA)
        q_rel = max(q_rel, pvalues_close(f"B6 full p1 prior {prior}", k1, h1),
                    pvalues_close(f"B6 full p2 prior {prior}", k2, h2))
        het_close(f"B6 full is_het prior {prior}", kh.astype(bool), h_het, h2)
        p1, p2, ph = (t.cpu().numpy() for t in qf.quality_finalize_lrt_ref(c_dev, a_dev, lt_dev, lh_dev, qtab,
                                                                           prior, ALPHA))
        for a, b in ((k1, p1), (k2, p2)):
            pvalues_close(f"B6 full prior {prior} vs its plain version on the card", a, b)
            fin = np.isfinite(a) & np.isfinite(b)
            q_abs = max(q_abs, float(np.abs(a[fin] - b[fin]).max()))
        het_close(f"B6 full is_het prior {prior} vs plain", kh.astype(bool), ph.astype(bool), p2)
    log(f"# B6 full == host at N={n}, priors {PRIORS}, edge rows planted: p1, p2 within {P_RTOL} of "
        f"sidtpu_quality_finalize (max rel err {q_rel!r}) and of the plain version on the card, is_het equal "
        f"outside the alpha band")
    sets = [tuple(torch.roll(t, 7919 * j, 0).contiguous() for t in (c_dev, a_dev, lt_dev, lh_dev)) + (qtab, 1e-3, ALPHA)
            for j in range(INPUT_SETS)]
    q_out = torch.empty(qf.LRT_BYTES_OUT_PER_SITE * n, dtype=torch.uint8, device=dev)
    misses = torch.empty(1, dtype=torch.int32, device=dev)
    q_launch = lambda c, a, h, hm, t, pr, al: qf.launch_lrt(c, a, h, hm, t, pr, al, q_out, misses)  # noqa: E731
    times = lrt_rows_times(torch, f"quality_finalize_lrt (B6 full) at N={n}, prior 1e-3", qf.quality_finalize_lrt,
                           qf.quality_finalize_lrt_ref, sets, q_launch, sass, ["quality_finalize_lrt_kernel"], n,
                           n * (qf.LRT_BYTES_IN_PER_SITE + qf.LRT_BYTES_OUT_PER_SITE) + qtab.shape[0] * 8, card,
                           f"; grid {qf.resident_blocks(dev, True)} blocks")
    b6_row = {"name": "quality_finalize_lrt", "route": "cuda", "source": "sid_tpu_torch/csrc/quality_finalize.cu",
              "replaces": "sid_tpu/models/quality.py:133", "launches": None, "max_abs_err": q_abs, **times,
              "library_ms": None}
    if parent is not None:
        plib = parent["quality_finalize"]
        short = qtab[:1000]  # deep sites read past it: the miss count

        def full(tab_, prior):
            out = torch.empty(qf.LRT_BYTES_OUT_PER_SITE * n, dtype=torch.uint8, device=dev)
            qf.launch_lrt(c_dev, a_dev, lt_dev, lh_dev, tab_, prior, ALPHA, out, misses)
            return out, int(misses.item())

        for prior in PRIORS:
            for tab_, what in ((qtab, "the whole table"), (short, "a table of 1,000 entries")):
                new, new_misses = full(tab_, prior)
                with using_library(qf, plib):
                    old, old_misses = full(tab_, prior)
                for label, at in (("p1", slice(0, 8 * n)), ("p2", slice(8 * n, 16 * n)), ("is_het", slice(16 * n, None))):
                    if not torch.equal(new[at], old[at]):
                        raise AssertionError(f"B6 full at prior {prior}, {what}: {label} differs from the parent's")
                if new_misses != old_misses or (tab_ is short) != (new_misses > 0):
                    raise AssertionError(f"B6 full at prior {prior}, {what}: {new_misses} misses, "
                                         f"the parent's {old_misses}")
        log(f"# B6 full == the parent's B6 full bitwise (p1, p2, is_het, miss count) at N={n}, priors {PRIORS}, "
            f"edge rows planted, with the whole table and with one of 1,000 entries ({new_misses} misses)")
        dev_t = in_turns(torch, {"B6 full": q_launch, "parent B6 full": on_library(qf, plib, q_launch)}, sets)
        call_t = calls_in_turns(torch, {"B6 full": qf.quality_finalize_lrt,
                                        "parent B6 full": on_library(qf, plib, qf.quality_finalize_lrt)}, sets)
        log(f"# B6 full against the parent's at N={n}, prior 1e-3, in turns: device only {readings(dev_t)}; the call "
            f"{readings(call_t)}; on {card}")
        b6_row.update({"parent_device_ms": statistics.median(dev_t["parent B6 full"]),
                       "device_ms_in_turns": statistics.median(dev_t["B6 full"]),
                       "parent_ms": statistics.median(call_t["parent B6 full"]),
                       "ms_in_turns": statistics.median(call_t["B6 full"])})
    rows.append(b6_row)
    del sets, q_out

    # the LRT on phase 5's marginals with edge rows planted, without and
    # with the -R prior, and the one-sided call
    lhom, lhet = plant_edges(*marginals)
    m = lhom.shape[0]
    hom_dev, het_dev = torch.from_numpy(lhom).to(dev), torch.from_numpy(lhet).to(dev)
    l_rel = l_abs = 0.0
    for pi in (None, 0.02):
        log_priors = None if pi is None else stats.prior_logs(pi)
        k1, k2 = (t.cpu().numpy() for t in stats.lrt_pair(hom_dev, het_dev, log_priors))
        with np.errstate(invalid="ignore"):
            hom, het = np.where(lhom < LONG_DOUBLE_UNDERFLOW_LOG, -np.inf, lhom), \
                np.where(lhet < LONG_DOUBLE_UNDERFLOW_LOG, -np.inf, lhet)
            if pi is not None:
                het = het + np.log(np.float64(pi))
                het = np.where(het < LONG_DOUBLE_UNDERFLOW_LOG, -np.inf, het)
                hom = hom + np.log(np.float64(1.0 - pi))
                hom = np.where(hom < LONG_DOUBLE_UNDERFLOW_LOG, -np.inf, hom)
        l_rel = max(l_rel, pvalues_close(f"LRT p1 prior {pi}", k1, stats.lrt_pvalue_from_logs_np(het, hom)),
                    pvalues_close(f"LRT p2 prior {pi}", k2, stats.lrt_pvalue_from_logs_np(hom, het)))
        p1, p2 = (t.cpu().numpy() for t in stats.lrt_pair_ref(hom_dev, het_dev, log_priors))
        for a, b in ((k1, p1), (k2, p2)):
            pvalues_close(f"LRT prior {pi} vs its plain version on the card", a, b)
            fin = np.isfinite(a) & np.isfinite(b)
            l_abs = max(l_abs, float(np.abs(a[fin] - b[fin]).max()))
    one = stats.lrt_pvalues(het_dev, hom_dev).cpu().numpy()
    pvalues_close("the one-sided LRT vs host libm", one, stats.lrt_pvalue_from_logs_np(lhet, lhom))
    pvalues_close("the one-sided LRT vs its plain version on the card", one,
                  stats.lrt_pvalues_ref(het_dev, hom_dev).cpu().numpy())
    log(f"# LRT == host at U={m} (phase 5's marginals at eps {FIT_EPSILONS[0]}, edge rows planted), without and "
        f"with a prior and one-sided: within {P_RTOL} of host libm (max rel err {l_rel!r}) and of the plain version "
        f"on the card")
    # BH on top of the LRT (lrt_benjamini_hochberg, even and odd U):
    # bitwise the host BH over the card's p-values
    for uu in (m, small_prof.shape[0] - 1):
        lp = stats.prior_logs(0.02)
        is_het, adj1, adj2 = stats.lrt_benjamini_hochberg(lhom[:uu], lhet[:uu], lp, ALPHA, dev)
        q1_, q2_ = (t.cpu().numpy() for t in stats.lrt_pair(hom_dev[:uu], het_dev[:uu], lp))
        w1_, w2_ = stats.adjust_benjamini_hochberg_np(q1_), stats.adjust_benjamini_hochberg_np(q2_)
        with np.errstate(invalid="ignore"):
            ok = (np.array_equal(adj1.view(np.uint64), w1_.view(np.uint64))
                  and np.array_equal(adj2.view(np.uint64), w2_.view(np.uint64)) and np.array_equal(is_het, w2_ < ALPHA))
        if not ok:
            raise AssertionError(f"lrt_benjamini_hochberg at U={uu}: BH differs from the host BH of the card's "
                                 "p-values")
    log(f"# lrt_benjamini_hochberg at U={m} and U={small_prof.shape[0] - 1} (-R prior): adjusted p-values and "
        f"is_het bitwise the host BH of the card's LRT p-values")
    sets = [(torch.roll(hom_dev, 7919 * j, 0).contiguous(), torch.roll(het_dev, 7919 * j, 0).contiguous(),
             stats.prior_logs(0.02)) for j in range(INPUT_SETS)]

    def l_launch(a, b, lp):
        uu = a.shape[0]
        stats.launch_lrt(a, b, lp, LONG_DOUBLE_UNDERFLOW_LOG, lrt_out[:uu], lrt_out[uu:2 * uu])

    lrt_out = torch.empty(2 * m, dtype=torch.float64, device=dev)
    times = lrt_rows_times(torch, f"lrt_pvalues at U={m}, -R prior", stats.lrt_pair, stats.lrt_pair_ref, sets,
                           l_launch, sass, ["lrt_pvalues_kernel"], m, 32 * m, card,
                           f"; grid {stats.resident_blocks(dev)} blocks")
    # and device only at the likelihood-ratio path's U (the simulated
    # sites' ~2,000 profiles)
    us = small_prof.shape[0]
    small_sets = [tuple(t[:us].contiguous() for t in s_[:2]) + (s_[2],) for s_ in sets]
    small_dev_ms = device_only_ms(torch, l_launch, small_sets)
    log(f"# lrt_pvalues at U={us} (the path's shape), -R prior: device only {small_dev_ms:.4f} ms; on {card}")
    lrt_row = {"name": "lrt_pvalues", "route": "cuda", "source": "sid_tpu_torch/csrc/lrt_bh.cu",
               "replaces": "sid_tpu/ops/stats.py:24", "launches": None, "max_abs_err": l_abs, **times,
               "library_ms": None, "small_rows": us, "small_device_ms": small_dev_ms}
    if parent is not None:
        plib = parent["lrt_bh"]
        shapes = ((f"U={m}", hom_dev, het_dev), (f"U={us} (the path's shape)", hom_dev[:us], het_dev[:us]))
        for label, h_, e_ in shapes:
            for lp in (None, stats.prior_logs(0.02)):
                new = stats.lrt_pair(h_, e_, lp)
                with using_library(stats, plib):
                    old = stats.lrt_pair(h_, e_, lp)
                if not all(torch.equal(x.view(torch.int64), y.view(torch.int64)) for x, y in zip(new, old)):
                    raise AssertionError(f"LRT at {label}, prior {lp}: differs from the parent's kernel")
            new = stats.lrt_pvalues(e_, h_)
            with using_library(stats, plib):
                old = stats.lrt_pvalues(e_, h_)
            if not torch.equal(new.view(torch.int64), old.view(torch.int64)):
                raise AssertionError(f"the one-sided LRT at {label}: differs from the parent's kernel")
        log(f"# LRT == the parent's LRT bitwise (p1, p2; one-sided p) at {' and '.join(x[0] for x in shapes)}, edge "
            f"rows planted, without and with a prior")
        for label, h_, e_ in shapes:
            sets_ = [(torch.roll(h_, 7 * j, 0).contiguous(), torch.roll(e_, 7 * j, 0).contiguous(),
                      stats.prior_logs(0.02)) for j in range(INPUT_SETS)]
            dev_t = in_turns(torch, {"LRT": l_launch, "parent LRT": on_library(stats, plib, l_launch)}, sets_)
            call_t = calls_in_turns(torch, {"LRT": stats.lrt_pair,
                                            "parent LRT": on_library(stats, plib, stats.lrt_pair)}, sets_)
            log(f"# LRT against the parent's at {label}, -R prior, in turns: device only {readings(dev_t)}; the call "
                f"{readings(call_t)}; on {card}")
            key = "" if h_ is hom_dev else "small_"
            lrt_row.update({f"{key}parent_device_ms": statistics.median(dev_t["parent LRT"]),
                            f"{key}device_ms_in_turns": statistics.median(dev_t["LRT"]),
                            f"{key}parent_ms": statistics.median(call_t["parent LRT"]),
                            f"{key}ms_in_turns": statistics.median(call_t["LRT"])})
    rows.append(lrt_row)
    del sets, small_sets, lrt_out

    # BH on B5's p2 at U with ties and NaN planted: bitwise the host BH
    # over its own order and torch.argsort's, the hand order equal to
    # torch.argsort's, the plain version too
    p = torch.from_numpy(bh_p).to(dev)
    p[::997] = 0.5
    p[::1999] = float("nan")
    p[3::3001] = 0.0
    p[5::4001] = 1.0
    p_np = p.cpu().numpy()
    want = stats.adjust_benjamini_hochberg_np(p_np)

    def bitwise(label, got, ref):
        if not np.array_equal(got.cpu().numpy().view(np.uint64), ref.view(np.uint64)):
            raise AssertionError(f"BH {label} differs bitwise from the host BH")

    bitwise(f"at U={u}", stats.adjust_benjamini_hochberg(p), want)
    if not torch.equal(stats.bh_radix_order(p), stats.bh_order(p)):
        raise AssertionError(f"the hand order at U={u} differs from torch.argsort(key, stable=True)")
    ordered = torch.empty_like(p)
    stats.launch_bh(p, stats.bh_order(p), ordered)
    bitwise(f"at U={u} over torch.argsort's order", ordered, want)
    bitwise(f"at U={u}, its plain version on the card", stats.adjust_benjamini_hochberg_ref(p), want)
    keys = p_np.view(np.uint64).copy()
    keys[p_np == 0] = 0
    keys[np.isnan(p_np)] = np.uint64(0x7FF8000000000000)
    keys[(p_np != 0) & ~np.isnan(p_np)] ^= np.uint64(1 << 63)
    keys = np.where(keys >> np.uint64(63), ~keys, keys | np.uint64(1 << 63))
    digit = stats.BH_BITS
    passes_run = sum(len(np.unique((keys >> np.uint64(q * digit)) & np.uint64((1 << digit) - 1))) > 1
                     for q in range(-(-64 // digit)))
    log(f"# BH == host at U={u} (B5's p2, {int(np.isnan(p_np).sum())} NaN, ties at 0.5, 0 and 1 planted): bitwise "
        f"adjust_benjamini_hochberg_np with {digit}-bit digits ({passes_run} scatter passes run) over scan tiles of "
        f"{stats.BH_SCAN_THREADS * stats.BH_ITEMS}, over torch.argsort's order and as the plain version; the hand "
        f"order equal to torch.argsort(key, stable=True)")

    # the path's shape: B5's p-values of the simulated sites' profiles,
    # ties and NaN planted; both arrays in one launch
    q1, q2 = path_shape_pvalues(small_prof, dev)
    us = q1.shape[0]
    o1, o2 = torch.empty_like(q1), torch.empty_like(q2)
    h2 = torch.empty(us, dtype=torch.uint8, device=dev)
    before = stats.BH_LAUNCHES
    stats.launch_bh_pair(q1, q2, o1, o2, h2, ALPHA)
    pair_launches = stats.BH_LAUNCHES - before
    if pair_launches > 2:
        raise AssertionError(f"BH of both arrays at U={us} took {pair_launches} launches")
    w1, w2 = stats.adjust_benjamini_hochberg_np(q1.cpu().numpy()), stats.adjust_benjamini_hochberg_np(q2.cpu().numpy())
    bitwise(f"of p1 at U={us}", o1, w1)
    bitwise(f"of p2 at U={us}", o2, w2)
    with np.errstate(invalid="ignore"):
        if not np.array_equal(h2.cpu().numpy().astype(bool), w2 < ALPHA):
            raise AssertionError(f"BH's is_het at U={us} differs from adjusted < alpha")
    bitwise(f"at U={us}, one array", stats.adjust_benjamini_hochberg(q2), w2)
    if not torch.equal(stats.bh_radix_order(q2), stats.bh_order(q2)):
        raise AssertionError(f"the hand order at U={us} differs from torch.argsort(key, stable=True)")
    log(f"# BH == host at U={us} (the simulated sites' profiles, B5's p1 and p2, ties and NaN planted): both "
        f"arrays and is_het in {pair_launches} launch, bitwise adjust_benjamini_hochberg_np; the hand order "
        f"there equal to torch.argsort's")
    plib = parent["lrt_bh"] if parent is not None else None
    if plib is not None:
        het_new, het_old = (torch.empty(u, dtype=torch.uint8, device=dev) for _ in range(2))
        new, old = torch.empty_like(p), torch.empty_like(p)
        stats.launch_bh(p, None, new, het_new, ALPHA)
        p1_old, p2_old, h2_old = torch.empty_like(q1), torch.empty_like(q2), torch.empty_like(h2)
        with using_library(stats, plib):
            stats.launch_bh(p, None, old, het_old, ALPHA)
            stats.launch_bh_pair(q1, q2, p1_old, p2_old, h2_old, ALPHA)
        for label, x, y in ((f"out at U={u}", new, old), (f"is_het at U={u}", het_new, het_old),
                            (f"p1 out at U={us}", o1, p1_old), (f"p2 out at U={us}", o2, p2_old),
                            (f"is_het at U={us}", h2, h2_old)):
            if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
                raise AssertionError(f"BH {label} differs from the parent's kernels")
        log(f"# BH == the parent's BH bitwise (out and is_het) at U={u} and U={us} (both arrays in one launch)")

    # times at U: the whole call (order and scan), device only (and the
    # parent's chain), the plain version, torch.argsort and torch.cummin;
    # each kernel's device time in one call by torch.profiler
    sets = [(torch.roll(p, 7919 * j, 0).contiguous(),) for j in range(INPUT_SETS)]
    bh_out = torch.empty_like(p)
    dev_ways = {"hand order + scan": lambda q: stats.launch_bh(q, None, bh_out)}
    call_ways = {"hand order + scan": stats.adjust_benjamini_hochberg}
    if plib is not None:
        dev_ways["parent: hand order + scan"] = on_library(stats, plib, dev_ways["hand order + scan"])
        call_ways["parent: hand order + scan"] = on_library(stats, plib, stats.adjust_benjamini_hochberg)
    dev_t = in_turns(torch, dev_ways, sets)
    call_t = calls_in_turns(torch, call_ways, sets)
    plain_t = event_times_ms(torch, stats.adjust_benjamini_hochberg_ref, sets)
    argsort_t = event_times_ms(torch, stats.bh_order, sets)
    s_sorted = [(stats._scaled(s_[0][stats.bh_order(s_[0])]),) for s_ in sets]  # what torch.cummin would scan
    cummin_t = event_times_ms(torch, lambda x: torch.cummin(x, 0), s_sorted)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as tp:
        for _ in range(5):
            stats.adjust_benjamini_hochberg(p)
        torch.cuda.synchronize()
    split = {}
    for ev in tp.key_averages():
        for key in ("bh_histogram_kernel", "bh_plan_kernel", "bh_radix_pass_kernel", "bh_scan_kernel"):
            if key in ev.key:
                total = getattr(ev, "device_time_total", None)
                total = ev.cuda_time_total if total is None else total
                split[key] = split.get(key, 0.0) + total / 5 / 1e3
    scan = kernel_counts(sass, "bh_scan_kernel")
    f64_pos = scan["f64_kernel"] / stats.BH_ITEMS  # every instruction of a thread's walk, over its positions
    dev_ms = statistics.median(dev_t["hand order + scan"])
    b_ms, b_by = bound_ms(16 * u, f64_pos * u)
    sort_ms = passes_run * 24 * u / HBM_BYTES_PER_S * 1e3
    scan_bound = 20 * u / HBM_BYTES_PER_S * 1e3
    log(f"# bh_adjust at U={u}, in turns: device only {readings(dev_t)}; the call {readings(call_t)}; plain torch "
        f"{statistics.median(plain_t):.4f} ms; torch.argsort (bh_order) {statistics.median(argsort_t):.4f} ms, "
        f"torch.cummin {statistics.median(cummin_t):.4f} ms; by kernel in one call (torch.profiler, mean of 5): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
        + f"; bound {b_ms:.4f} ms by {b_by} (the function's bytes: p in, out out, {16 * u / 1e6:.0f} MB; "
        f"{f64_pos:.1f} f64 instructions a position), {b_ms / dev_ms:.1%} of it; a radix sort of 12 B pairs "
        f"moves {passes_run} x 24 B a pair at {digit}-bit digits ({sort_ms:.4f} ms); the scan launch's own bytes "
        f"(a position, p gathered, out) {scan_bound:.4f} ms, "
        + (f"{scan_bound / split['bh_scan_kernel']:.1%} of it" if "bh_scan_kernel" in split else "not measured")
        + f"; on {card}")

    # times at the path's shape: both arrays, in turns with the parent's
    # two argsorts and two three-pass runs
    small_sets = [(torch.roll(q1, 7 * j, 0).contiguous(), torch.roll(q2, 7 * j, 0).contiguous())
                  for j in range(INPUT_SETS)]
    so1, so2, sh = torch.empty_like(q1), torch.empty_like(q2), torch.empty_like(h2)
    small_dev_ways = {"one launch, both arrays": lambda a, b_: stats.launch_bh_pair(a, b_, so1, so2, sh, ALPHA)}

    def pair_call(a, b_):
        x, y, z = torch.empty_like(a), torch.empty_like(b_), torch.empty(a.shape[0], dtype=torch.uint8, device=dev)
        stats.launch_bh_pair(a, b_, x, y, z, ALPHA)
        return x, y, z

    small_call_ways = {"one launch, both arrays": pair_call}
    if plib is not None:
        small_dev_ways["parent: one launch"] = on_library(stats, plib, small_dev_ways["one launch, both arrays"])
        small_call_ways["parent: one launch"] = on_library(stats, plib, pair_call)
    small_dev = in_turns(torch, small_dev_ways, small_sets)
    small_call = calls_in_turns(torch, small_call_ways, small_sets)
    log(f"# BH of both arrays at U={us}, in turns: device only {readings(small_dev)}; the call {readings(small_call)}; "
        f"the function's bytes (2 x p in and out, is_het) {bound_ms(33 * us, 0)[0] * 1e3:.3f} us; on {card}")
    bh_row = {"name": "bh_adjust", "route": "cuda", "source": "sid_tpu_torch/csrc/lrt_bh.cu",
              "replaces": "sid_tpu/ops/stats.py:78", "launches": None, "max_abs_err": 0.0,
              "ms": statistics.median(call_t["hand order + scan"]), "plain_ms": statistics.median(plain_t),
              "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": statistics.median(cummin_t), "argsort_ms": statistics.median(argsort_t),
              "sort_bound_ms": sort_ms, "scatter_passes": passes_run, "kernel_ms": split,
              "small_rows": us, "small_launches": pair_launches,
              "small_device_ms": statistics.median(small_dev["one launch, both arrays"]),
              "small_ms": statistics.median(small_call["one launch, both arrays"])}
    if plib is not None:
        bh_row.update({
            "parent_device_ms": statistics.median(dev_t["parent: hand order + scan"]),
            "parent_ms": statistics.median(call_t["parent: hand order + scan"]),
            "small_parent_device_ms": statistics.median(small_dev["parent: one launch"]),
            "small_parent_ms": statistics.median(small_call["parent: one launch"])})
    rows.append(bh_row)
    del sets, s_sorted, small_sets

    # the device LRT's wall against the host-libm path, in turns
    opts_dev, opts_host = Options(exact_pvalues=False), Options()
    walls = {}

    def turns(label, ways):
        for name, fn in (ways + ways[::-1]) * 2:
            t0 = time.perf_counter()
            fn()
            walls.setdefault(label, {}).setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    turns(f"classify_profiles_local at U={u}", (
        ("device LRT (B5)", lambda: local.classify_profiles_local(prof_np, opts_dev, 1e-3)),
        ("host libm (B1 + glibc erfc)", lambda: local.classify_profiles_local(prof_np, opts_host, 1e-3))))
    def quality_host_libm():
        lpp1, lpp2 = quality.finalize_logs(c_np, ma, se, lh, lt, 1e-3, dev)
        return stats.lrt_pvalue_from_logs_np(lpp2, lpp1), stats.lrt_pvalue_from_logs_np(lpp1, lpp2)

    turns(f"the quality finalize at N={n}", (
        ("device LRT (B6 full)", lambda: qf.finalize_lrt(c_np, ma, se, lh, lt, 1e-3, ALPHA, dev)),
        ("host libm (B6 + glibc erfc)", quality_host_libm),
        ("libsidtpu's fused host pass", lambda: quality.finalize_quality_native(c_np, ma, se, lh, lt, 1e-3, ALPHA))))
    opts_lr_dev = Options(method="likelihood_ratio", estimate_prior=True, exact_pvalues=False)
    opts_lr_host = Options(method="likelihood_ratio", estimate_prior=True)
    turns(f"the LR classification at U={m} (-R)", (
        ("device LRT + BH", lambda: likelihood_ratio.lrt_classify(fit_prof, 0.02, *marginals, opts_lr_dev)),
        ("host libm + host BH", lambda: likelihood_ratio.lrt_classify(fit_prof, 0.02, *marginals, opts_lr_host))))
    for label, w in walls.items():
        log(f"# {label}, host clock in turns: " + "; ".join(
            f"{name} {statistics.median(v):.2f} ms (runs {', '.join(f'{x:.2f}' for x in v)})" for name, v in w.items())
            + f"; on {card}")
    log(f"# phase 13's kernels took {time.perf_counter() - t_phase:.1f} s")
    return rows


def device_lrt_path_phase(torch, card, golden_src, synth, qsrc) -> dict:
    """Phase 13, the path: engine.run with exact_pvalues=False for -m local,
    -m quality and -R -m likelihood_ratio on golden and the 1M-site inputs
    (counts set to 0 just before and read just after); each held to the
    same run with the host-libm LRT and to the CPU run of the port by the
    tolerance as printed. Returns the launches of the four kernels."""
    from sid_tpu_torch import engine
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.ops import local_classify as lc
    from sid_tpu_torch.ops import quality_finalize as qf
    from sid_tpu_torch.ops import stats

    cases = (("-m local", {}, synth), ("-m quality", {"method": "quality"}, qsrc),
             ("-R -m likelihood_ratio", {"method": "likelihood_ratio", "estimate_prior": True}, synth))
    runs = []
    lc.LRT_LAUNCHES = qf.LRT_LAUNCHES = stats.LRT_LAUNCHES = stats.BH_LAUNCHES = 0
    for label, kw, big in cases:
        for name, src in (("golden", golden_src), (f"{N_SITES} sites", big)):
            t0 = time.perf_counter()
            got = engine.run(src, Options(exact_pvalues=False, **kw), binary=True)
            runs.append((label, kw, name, src, got, time.perf_counter() - t0))
    launches = {"local_classify_lrt": lc.LRT_LAUNCHES, "quality_finalize_lrt": qf.LRT_LAUNCHES,
                "lrt_pvalues": stats.LRT_LAUNCHES, "bh_adjust": stats.BH_LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the device-LRT path was not launched: {launches}")
    log("# kernel launches on the device-LRT path: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for label, kw, name, src, got, wall in runs:
        t0 = time.perf_counter()
        host = engine.run(src, Options(**kw), binary=True)
        host_wall = time.perf_counter() - t0
        cpu = engine.run(src, Options(platform="cpu", exact_pvalues=False, **kw), binary=True)
        n_host = csv_close(f"{label} {name} vs the host-libm run", got, host)
        n_cpu = csv_close(f"{label} {name} vs the CPU run", got, cpu)
        records = got.count(b"\n") - 1
        log(f"# {label} exact_pvalues=False, {name}: {records} records, {wall * 1e3:.1f} ms (host-libm "
            f"run {host_wall * 1e3:.1f} ms); within the tolerance of the host-libm run ({n_host} lines differ in "
            f"bytes) and of the CPU run ({n_cpu}); on {card}")
    return launches


# lanes of the cohort kernels (phase 11) and the population path (phase 12)
N_LANES = 100
BIG_LANE = 1_000_000
# in-box thetas for the lanes' objective (boundary ones included); the
# lanes' objective wrapper gives the out-of-box ones DBL_MAX without a launch
LANE_THETAS = ((1e-3, 1e-3), (0.05, 0.01), (0.0, 1e-3), (1e-3, 0.0), (1.0, 1.0), (0.5, 0.999), (0.02, 3.85e-11))
OUT_OF_BOX = ((-0.1, 0.5), (0.3, 1.5))
LANE_REPEATS = 10
POP_SAMPLES = 100
# 50,000 sites a sample keeps phase 12 near a minute; every check runs
# at this depth
POP_SITES = 50_000
POP_SUBSET = 8
POP_CHUNK = 64 << 20


def lane_cohort(seed: int = 2028):
    """N_LANES histograms of about 2,000,000 rows in all: the cov >= 4 rows
    of two ``kernel_profiles`` draws with multiplicities, cut into an empty
    lane, a 1-row lane, a BIG_LANE-row lane and lanes of lognormal sizes,
    in a seeded order. The draws' deep rows (up to 65535 a base) fall in
    most lanes, so the range screen flags rows in most lanes."""
    p1, m1 = fit_histogram(kernel_profiles(2024))
    p2, m2 = fit_histogram(kernel_profiles(2027), seed=2029)
    prof = np.concatenate([p1, p2])
    mult = np.concatenate([m1, m2])
    rng = np.random.default_rng(seed)
    rest = prof.shape[0] - BIG_LANE - 1
    w = rng.lognormal(0.0, 1.0, N_LANES - 3)
    sizes = np.floor(w / w.sum() * rest).astype(np.int64)
    sizes[-1] += rest - sizes.sum()
    sizes = np.concatenate([[0, 1, BIG_LANE], sizes])[rng.permutation(N_LANES)]
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return [(np.ascontiguousarray(prof[a:b]), mult[a:b]) for a, b in zip(off[:-1], off[1:])]


def bits_equal(a, b) -> bool:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


def lanes_kernel_phase(torch, dev, card, sass):
    """Phase 11: the lanes' objective and marginals kernels at N_LANES lanes
    and ~2M rows against the single-lane kernels (bitwise, each lane
    alone) and their plain versions, for every set of running lanes and
    three grids; one launch a call by the library's counters; the lanes'
    objective wrapper against DeviceObjective per lane with out-of-box
    thetas; times and bounds; the same times and bounds at phase 12's
    shape, its results held against the plain versions. Returns the two
    rows of the kernels line (launches are phase 12's)."""
    from sid_tpu_torch.models import lynch
    from sid_tpu_torch.ops import likelihoods, lynch_objective as lo
    from sid_tpu_torch.ops.lgamma import lgamma_table
    from sid_tpu_torch.ops.profiles import nucleotide_distribution

    t0 = time.perf_counter()
    hists = lane_cohort()
    sizes = [p.shape[0] for p, _ in hists]
    n = sum(sizes)
    prof = np.concatenate([p for p, _ in hists])
    mult = np.concatenate([m for _, m in hists])
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    nts = [nucleotide_distribution(p, m) for p, m in hists]
    p_dev = torch.from_numpy(prof).to(dev)
    m_dev = torch.from_numpy(mult).to(dev)
    o_dev = torch.from_numpy(off).to(dev)
    tab = lgamma_table(int(prof.sum(-1).max()), dev)
    work = lo.LynchLanesWorkspace(p_dev, m_dev, o_dev, tab)
    singles = [lo.LynchWorkspace(p_dev[a:b], m_dev[a:b], tab) for a, b in zip(off[:-1], off[1:])]
    torch.cuda.synchronize()
    if not torch.equal(work.records.view(torch.int64), lo.lynch_records_ref(p_dev, m_dev, tab).view(torch.int64)):
        raise AssertionError("the cohort's row record differs from its plain version")
    log(f"# lanes: {N_LANES} lanes, {n} rows (sizes {min(sizes)}..{max(sizes)}, an empty and a 1-row lane), "
        f"{len(work.part_sum)} chunks; grids {work.grids}; cohort and workspaces in "
        f"{time.perf_counter() - t0:.1f} s")

    everyone = list(range(N_LANES))
    subsets = {"all": everyone, "every other": everyone[::2], "one (the 1M-row lane)": [sizes.index(BIG_LANE)],
               "the empty and the 1-row lane": sorted([sizes.index(0), sizes.index(1)])}
    max_abs = 0.0
    theta_sets = []
    for shift in range(3):
        thetas = [LANE_THETAS[(k + shift) % len(LANE_THETAS)] for k in range(N_LANES)]
        scal = np.stack([likelihoods.lynch_scalars(th[0], th[1], nt) for th, nt in zip(thetas, nts)])
        theta_sets.append(scal)
        alone = []
        for k, w in enumerate(singles):
            total, cnt = w.nll(scal[k])
            alone.append(([total, cnt], w.flags.clone()))
        plain, plain_flags = lo.lynch_compound_nll_lanes_ref(p_dev, m_dev, off, scal, tab, everyone)
        plain = plain.cpu().numpy()
        flagged = sum(1 for a in alone if a[0][1])
        for name, lanes in subsets.items():
            for grid in (1, 7, work.grids[0]):
                got = work.nll_lanes(scal, lanes, grid=grid)
                for row, k in zip(got, lanes):
                    a, b = int(off[k]), int(off[k + 1])
                    if not bits_equal(row, alone[k][0]) or not bits_equal(row, plain[k]):
                        raise AssertionError(f"lanes' objective, lanes {name}, grid {grid}, lane {k}: {row.tolist()} vs "
                                             f"single-lane {alone[k][0]} vs plain {plain[k].tolist()}")
                    if not (torch.equal(work.flags[a:b], alone[k][1]) and torch.equal(work.flags[a:b], plain_flags[a:b])):
                        raise AssertionError(f"lanes' objective flags, lanes {name}, grid {grid}, lane {k}")
                    max_abs = max(max_abs, abs(float(row[0]) - float(plain[k][0])))
        log(f"# lanes' objective == single-lane B2 == plain, bitwise, thetas shifted {shift}: every lane's sum and "
            f"flagged count and flags for lanes {', '.join(subsets)} and grids 1, 7, {work.grids[0]}; "
            f"{flagged} lanes with flagged rows ({int(sum(a[0][1] for a in alone))} rows)")
    before = lo.kernel_launches()
    work.nll_lanes(theta_sets[0], everyone)
    after = lo.kernel_launches()
    per_call = {k: after[k] - before[k] for k in after}
    if per_call != {"records": 0, "nll": 0, "marginals": 0, "nll_lanes": 1, "marginals_lanes": 0}:
        raise AssertionError(f"one lanes' objective call: launches {per_call}")
    before = lo.kernel_launches()
    work.marginals_lanes_host(theta_sets[0])
    after = lo.kernel_launches()
    per_marg = {k: after[k] - before[k] for k in after}
    if per_marg != {"records": 0, "nll": 0, "marginals": 0, "nll_lanes": 0, "marginals_lanes": 1}:
        raise AssertionError(f"one lanes' marginals call: launches {per_marg}")
    log(f"# one call is one launch (the kernel library's counters): objective {per_call}, marginals {per_marg}")

    # the wrapper: out-of-box lanes DBL_MAX without a launch, the others
    # bitwise DeviceObjective (rows <= 1000x, so no lane needs long double)
    shallow = [(p[p.sum(-1) <= 1000], m[p.sum(-1) <= 1000]) for p, m in hists]
    objective = lynch.LanesObjective(shallow, np.stack(nts), dev)
    points = [np.array((LANE_THETAS + OUT_OF_BOX)[k % (len(LANE_THETAS) + len(OUT_OF_BOX))]) for k in everyone]
    launches = lo.NLL_LANES_LAUNCHES
    values = objective(everyone, points)
    if lo.NLL_LANES_LAUNCHES - launches != 1:
        raise AssertionError("the lanes' objective wrapper did not launch once")
    n_out = 0
    for k, (value, x) in enumerate(zip(values, points)):
        want = lynch.DeviceObjective(shallow[k][0], shallow[k][1], nts[k], dev)(x)
        n_out += value == likelihoods.DBL_MAX
        if not bits_equal(value, want):
            raise AssertionError(f"LanesObjective lane {k} at {tuple(x)}: {value!r} vs DeviceObjective {want!r}")
    only_out = objective([0, 1], [np.array(OUT_OF_BOX[0]), np.array(OUT_OF_BOX[1])])
    if only_out != [likelihoods.DBL_MAX] * 2 or lo.NLL_LANES_LAUNCHES - launches != 1:
        raise AssertionError("out-of-box lanes alone launched the kernel or got another value than DBL_MAX")
    log(f"# LanesObjective at mixed thetas == DeviceObjective per lane, bitwise ({n_out} lanes out of the box: "
        f"DBL_MAX; out-of-box lanes alone launch nothing)")
    del objective

    marg_abs = 0.0
    marg_flagged = 0
    for scal in theta_sets:
        hom, het, flags = work.marginals_lanes(scal)
        p_hom, p_het, p_flags = lo.lynch_marginals_lanes_ref(p_dev, off, scal, tab)
        if not torch.equal(flags, p_flags):
            raise AssertionError("lanes' marginals flags differ from the plain version's")
        for k, w in enumerate(singles):
            a, b = int(off[k]), int(off[k + 1])
            s_hom, s_het, s_flags = w.marginals(scal[k])
            if not (torch.equal(hom[a:b].view(torch.int64), s_hom.view(torch.int64))
                    and torch.equal(het[a:b].view(torch.int64), s_het.view(torch.int64))
                    and torch.equal(flags[a:b], s_flags)):
                raise AssertionError(f"lanes' marginals lane {k} differ from the single-lane B4")
        for what, x, y in (("log L_hom", p_hom, hom), ("log L_het", p_het, het)):
            marg_abs = max(marg_abs, assert_agree(f"lanes' marginals {what}", x.cpu().numpy(), y.cpu().numpy())[0])
        marg_flagged = max(marg_flagged, int(flags.sum()))
    log(f"# lanes' marginals == single-lane B4 per row, bitwise, flags equal, at three sets of epsilons; plain "
        f"version to {RTOL} (max abs err {marg_abs!r}); up to {marg_flagged} rows flagged")

    # times: call (events around the wrapper call), device only (the kernel
    # launched again on what the card holds, no copies, enqueued behind
    # torch.cuda._sleep), the plain version, and the S single-lane B2 calls
    # of one round
    times = lane_times(torch, work, theta_sets, p_dev, m_dev, off, tab)

    def one_round_alone(s):
        for k, w in enumerate(singles):
            w.nll(s[k])

    alone_ms = event_times_ms(torch, one_round_alone, [(s,) for s in theta_sets], 3)
    del singles

    # phase 12's shape: the samples' cov >= 4 unique profiles, ~1,000 rows a
    # lane, held bitwise against the plain version
    t0 = time.perf_counter()
    pop = population_cohort()
    sizes2 = [p.shape[0] for p, _ in pop]
    n2 = sum(sizes2)
    off2 = np.concatenate([[0], np.cumsum(sizes2)]).astype(np.int64)
    p2 = torch.from_numpy(np.concatenate([p for p, _ in pop])).to(dev)
    m2 = torch.from_numpy(np.concatenate([m for _, m in pop])).to(dev)
    tab2 = lgamma_table(int(p2.sum(-1).max()), dev)
    work2 = lo.LynchLanesWorkspace(p2, m2, torch.from_numpy(off2).to(dev), tab2)
    nts2 = [nucleotide_distribution(p, m) for p, m in pop]
    theta_sets2 = [np.stack([likelihoods.lynch_scalars(*LANE_THETAS[(k + shift) % len(LANE_THETAS)], nt)
                             for k, nt in enumerate(nts2)]) for shift in range(3)]
    for scal in theta_sets2:
        got = work2.nll_lanes(scal, everyone)
        want, want_flags = lo.lynch_compound_nll_lanes_ref(p2, m2, off2, scal, tab2, everyone)
        if not bits_equal(got, want.cpu().numpy()) or not torch.equal(work2.flags, want_flags):
            raise AssertionError("lanes' objective at phase 12's shape differs from its plain version")
        hom, het, flags = work2.marginals_lanes(scal)
        w_hom, w_het, w_flags = lo.lynch_marginals_lanes_ref(p2, off2, scal, tab2)
        if not torch.equal(flags, w_flags):
            raise AssertionError("lanes' marginals flags at phase 12's shape differ from the plain version's")
        for what, x, y in (("log L_hom", w_hom, hom), ("log L_het", w_het, het)):
            assert_agree(f"lanes' marginals at phase 12's shape, {what}", x.cpu().numpy(), y.cpu().numpy())
    times2 = lane_times(torch, work2, theta_sets2, p2, m2, off2, tab2)
    log(f"# lanes at phase 12's shape: {N_LANES} lanes, {n2} rows (sizes {min(sizes2)}..{max(sizes2)}), "
        f"{len(work2.part_sum)} chunks; the objective bitwise and the marginals' flags equal to the plain "
        f"versions (marginals to {RTOL}) at three sets of thetas; in {time.perf_counter() - t0:.1f} s")

    blocks = lo.blocks_per_sm(dev)
    rows = []
    # the f64 work of a row, the same whatever implements it: B2's row count
    # (lynch_nll_kernel's SASS) for the objective, B4's (lynch_marginals_kernel)
    # for the marginals
    for name, kernel, row_sass, replaces, err in (
        ("lynch_compound_nll_lanes", "nll_lanes", "lynch_nll_kernel", "sid_tpu/models/population.py:83", max_abs),
        ("lynch_marginals_lanes", "marginals_lanes", "lynch_marginals_kernel", "sid_tpu/models/population.py:298",
         marg_abs),
    ):
        c = kernel_counts(sass, row_sass)
        own = kernel_counts(sass, f"lynch_{kernel}_kernel")
        log(f"# {name}: f64 instructions a row from the SASS of {row_sass}: {c['f64']} ({c['f64_all']} with every "
            f"branch arm); this kernel's own: {own['f64']} ({own['f64_all']}); {blocks[kernel]} blocks an SM")
        shapes = {}
        for shape, w, t in (("phase 11's cohort", work, times), ("phase 12's shape", work2, times2)):
            chunks_w = len(w.part_sum)
            n_bytes = (w.n * (24 + 1) + chunks_w * 12 + w.lanes * (lo.LANE_SLOT.itemsize + 16) if kernel == "nll_lanes"
                       else w.n * (24 + 17) + w.lanes * lo.LANE_SLOT.itemsize)
            call_t, dev_ms, plain_t = t[kernel]
            b_ms, b_by = bound_ms(n_bytes, c["f64"] * w.n)
            b_all = bound_ms(n_bytes, c["f64_all"] * w.n)[0]
            shapes[shape] = {"rows": w.n, "ms": statistics.median(call_t), "plain_ms": statistics.median(plain_t),
                             "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by}
            log(f"# {name} at {shape}, {w.lanes} lanes, {w.n} rows: call {statistics.median(call_t):.4f} ms (median "
                f"of {len(call_t)}, min {min(call_t):.4f}), device only {dev_ms:.4f} ms, plain torch "
                f"{statistics.median(plain_t):.2f} ms; bound {b_ms:.4f} ms by {b_by} ({n_bytes / 1e6:.2f} MB; {c['f64']} f64 instructions every row "
                f"executes), {b_ms / dev_ms:.1%} of the bound ({b_all:.4f} ms, {b_all / dev_ms:.1%}, with every "
                f"branch arm: {c['f64_all']}); issuing the row's instructions {issue_ms(c['issued'], w.n):.4f}-"
                f"{issue_ms(c['issued_all'], w.n):.4f} ms; grid {w.grids[0 if kernel == 'nll_lanes' else 1]} "
                f"blocks; on {card}")
        main = shapes["phase 11's cohort"]
        row = {"name": name, "route": "cuda", "source": "sid_tpu_torch/csrc/lynch.cu", "replaces": replaces,
               "launches": None, "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
               "device_ms": main["device_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
               "library_ms": None, "blocks_per_sm": blocks[kernel],
               "at_population_shape": shapes["phase 12's shape"]}
        rows.append(row)
    log(f"# one round of {N_LANES} lanes: one lanes' objective call {rows[0]['ms']:.4f} ms against "
        f"{statistics.median(alone_ms):.3f} ms for {N_LANES} single-lane B2 calls (median of {len(alone_ms)}); "
        f"on {card}")
    return rows


def lane_times(torch, work, theta_sets, p_dev, m_dev, off, tab) -> dict:
    """The lane kernels' times on a workspace at every lane: by kernel
    ("nll_lanes", "marginals_lanes"), (call times in ms, device-only ms,
    the plain version's times in ms). Calls and the plain version in
    turns."""
    from sid_tpu_torch.ops import lynch_objective as lo

    everyone = list(range(work.lanes))
    out = {}
    for kernel, fn, sets, plain_fn, relaunch in (
        ("nll_lanes", work.nll_lanes, [(s, everyone) for s in theta_sets],
         lambda s, lanes: lo.lynch_compound_nll_lanes_ref(p_dev, m_dev, off, s, tab, lanes),
         work.launch_nll_lanes),
        ("marginals_lanes", work.marginals_lanes, [(s,) for s in theta_sets],
         lambda s: lo.lynch_marginals_lanes_ref(p_dev, off, s, tab), work.launch_marginals_lanes),
    ):
        call = event_times_ms(torch, fn, sets, LANE_REPEATS)
        plain_t = event_times_ms(torch, plain_fn, sets, 3)
        call += event_times_ms(torch, fn, sets, LANE_REPEATS)
        fn(*sets[1])
        out[kernel] = (call, device_only_ms(torch, relaunch, [()]), plain_t)
    return out


def population_cohort():
    """Phase 12's cohort without its pileups: the cov >= 4 unique profiles
    and multiplicities of the POP_SAMPLES samples that write_population
    simulates (the same counts)."""
    from sid_tpu_torch.ops.profiles import filter_min_coverage, unique_profiles

    hists = []
    for k, pi in enumerate(np.logspace(-4, -2, POP_SAMPLES)):
        prof, mult, _ = unique_profiles(simulated_counts(POP_SITES, seed=5000 + 2 * k, pi=float(pi)))
        hists.append(filter_min_coverage(prof, mult, 4)[:2])
    return hists


def write_population(workdir: str):
    """POP_SAMPLES seeded ~30x samples of POP_SITES sites each with per-read
    Phred qualities, heterozygosity log-spaced 1e-4..1e-2, eps 1e-2, under
    workdir; returns (paths, bytes)."""
    os.makedirs(workdir, exist_ok=True)
    pis = np.logspace(-4, -2, POP_SAMPLES)
    paths = []
    size = 0
    for k, pi in enumerate(pis):
        path = os.path.join(workdir, f"s{k:03d}.pileup")
        data = phred_pileup(simulated_counts(POP_SITES, seed=5000 + 2 * k, pi=float(pi)), 1, 5001 + 2 * k)
        with open(path, "wb") as f:
            f.write(data)
        size += len(data)
        paths.append(path)
    return paths, size


def population_csvs(paths, options, mode):
    """Each sample's CSV bytes of the in-memory population path, and the
    wall seconds."""
    from sid_tpu_torch.io.pileup import parse_pileup
    from sid_tpu_torch.models.population import call_population

    reads = options.method == "quality"
    t0 = time.perf_counter()
    batches = [parse_pileup(p, reads, reads, quality_terms_only=reads) for p in paths]
    csvs = [r.to_csv_bytes() for r in call_population(batches, options, mode)]
    return csvs, time.perf_counter() - t0


def population_device_lrt(card, subset) -> dict:
    """Phase 13 on the population path: pooled -R -m likelihood_ratio and
    -m local with exact_pvalues=False on the subset's samples (counts set
    to 0 just before, read just after), each sample's CSV held to the
    host-libm run and the CPU run by the tolerance as printed. Returns the
    launches of the path's device-LRT kernels."""
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.ops import local_classify as lc
    from sid_tpu_torch.ops import stats

    cases = ((f"pooled -R -m likelihood_ratio ({len(subset)} samples)",
              {"method": "likelihood_ratio", "estimate_prior": True}),
             (f"pooled -m local ({len(subset)} samples)", {"method": "local"}))
    lc.LRT_LAUNCHES = stats.LRT_LAUNCHES = stats.BH_LAUNCHES = 0
    runs = {label: population_csvs(subset, Options(exact_pvalues=False, **kw), "pooled") for label, kw in cases}
    launches = {"local_classify_lrt": lc.LRT_LAUNCHES, "lrt_pvalues": stats.LRT_LAUNCHES,
                "bh_adjust": stats.BH_LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"a device-LRT kernel of the population path was not launched: {launches}")
    log("# kernel launches on the population device-LRT path: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for label, kw in cases:
        got, wall = runs[label]
        host, host_wall = population_csvs(subset, Options(**kw), "pooled")
        cpu, _ = population_csvs(subset, Options(platform="cpu", exact_pvalues=False, **kw), "pooled")
        n_host = sum(csv_close(f"population {label} sample {k} vs host libm", g, h)
                     for k, (g, h) in enumerate(zip(got, host)))
        n_cpu = sum(csv_close(f"population {label} sample {k} vs the CPU", g, c)
                    for k, (g, c) in enumerate(zip(got, cpu)))
        log(f"# population {label} exact_pvalues=False: {wall:.2f} s (host-libm run {host_wall:.2f} s); every "
            f"sample within the tolerance of the host-libm run ({n_host} lines differ in bytes) and of the CPU "
            f"run ({n_cpu}); on {card}")
    return launches


def population_run(paths, options, mode, prof=None):
    """The in-memory population path as the CLI runs it: parse each sample,
    call_population, each sample's CSV bytes. Returns (SHA-256 per sample,
    records, wall seconds)."""
    from sid_tpu_torch.io.pileup import parse_pileup
    from sid_tpu_torch.models.population import call_population
    from sid_tpu_torch.utils import profiling

    reads = options.method == "quality"
    profiling.activate(prof)
    try:
        t0 = time.perf_counter()
        batches = [parse_pileup(p, reads, reads, quality_terms_only=reads) for p in paths]
        results = call_population(batches, options, mode)
        digests = [hashlib.sha256(r.to_csv_bytes()).hexdigest() for r in results]
        wall = time.perf_counter() - t0
    finally:
        profiling.activate(None)
    return digests, sum(r.num_records for r in results), wall


def population_phase(torch, dev, card, workdir):
    """Phase 12: the population path at POP_SAMPLES x POP_SITES sites on the
    card: pooled and independent -m bayes (two runs each) and pooled -R -m
    likelihood_ratio, each byte-equal to the same run on the CPU (the plain
    versions); the same LR run streamed (64 MB chunks) byte-equal to it;
    pooled -m local and -m quality on a subset, byte-equal to the CPU;
    five lanes' fits bitwise single-lane fits over DeviceObjective; the
    lanes' rounds and launches, the fits' wall against single-lane fits in
    turns, the device stages' share. Returns the kernel launches of the
    path."""
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.exact.nmsimplex import minimize_nmsimplex2
    from sid_tpu_torch.models import lynch, population as pop
    from sid_tpu_torch.models.population import call_population_streaming
    from sid_tpu_torch.ops import local_classify, lynch_objective as lo
    from sid_tpu_torch.ops import quality_finalize as qf
    from sid_tpu_torch.ops.profiles import nucleotide_distribution
    from sid_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    paths, size = write_population(os.path.join(workdir, "population"))
    n_sites = POP_SAMPLES * POP_SITES
    log(f"# population: {POP_SAMPLES} samples x {POP_SITES} ~30x sites with Phred qualities, pi 1e-4..1e-2 "
        f"log-spaced, eps 1e-2 ({size / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
    subset = paths[:: POP_SAMPLES // POP_SUBSET][:POP_SUBSET]
    cases = [
        ("pooled -m bayes", paths, {"method": "bayes"}, "pooled", 2),
        ("independent -m bayes", paths, {"method": "bayes"}, "independent", 2),
        ("pooled -R -m likelihood_ratio", paths, {"method": "likelihood_ratio", "estimate_prior": True}, "pooled", 1),
        (f"pooled -m local ({POP_SUBSET} samples)", subset, {"method": "local"}, "pooled", 1),
        (f"pooled -m quality ({POP_SUBSET} samples)", subset, {"method": "quality"}, "pooled", 1),
    ]
    names = ("records", "nll_lanes", "marginals_lanes")
    lo.RECORD_LAUNCHES = lo.NLL_LANES_LAUNCHES = lo.MARGINALS_LANES_LAUNCHES = 0
    local_classify.LAUNCHES = 0
    qf.LAUNCHES = 0
    card_runs = {}
    for label, ps, kw, mode, runs in cases:
        for r in range(runs):
            p = profiling.StageProfile()
            card_runs.setdefault(label, []).append(population_run(ps, Options(**kw), mode, p) + (p,))
        digests = {run[0] == card_runs[label][0][0] for run in card_runs[label]}
        if digests != {True}:
            raise AssertionError(f"population {label}: two runs on the card differ")
    stream_opts = Options(method="likelihood_ratio", estimate_prior=True)
    t0 = time.perf_counter()
    counts = call_population_streaming(paths, stream_opts, "pooled", chunk_bytes=POP_CHUNK)
    stream_wall = time.perf_counter() - t0
    launches = {"records": lo.RECORD_LAUNCHES, "nll_lanes": lo.NLL_LANES_LAUNCHES,
                "marginals_lanes": lo.MARGINALS_LANES_LAUNCHES, "local": local_classify.LAUNCHES,
                "quality": qf.LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the population path was not launched: {launches}")
    log("# kernel launches on the population path: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    label = "pooled -R -m likelihood_ratio"
    for path, digest in zip(paths, card_runs[label][0][0]):
        with open(path + ".calls.csv", "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() != digest:
                raise AssertionError(f"--stream {label}: {path}.calls.csv differs from the in-memory run")
    log(f"# --stream {label}, {POP_CHUNK >> 20} MB chunks: every sample's .calls.csv byte-equal to the in-memory "
        f"run, {sum(counts)} records, {n_sites / stream_wall:,.0f} sites/s ({stream_wall:.2f} s); on {card}")
    for label, ps, kw, mode, _ in cases:
        cpu = population_run(ps, Options(platform="cpu", **kw), mode)
        if cpu[0] != card_runs[label][0][0]:
            bad = [k for k, (a, b) in enumerate(zip(cpu[0], card_runs[label][0][0])) if a != b]
            raise AssertionError(f"population {label}: samples {bad} differ between the card and the CPU")
        log(f"# population {label}: every sample's CSV byte-equal to the CPU run (plain versions; {cpu[2]:.1f} s)")
    population_device_lrt(card, subset)
    for label in ("pooled -m bayes", "independent -m bayes"):
        for digests, records, wall, p in card_runs[label]:
            stages = {}
            for name, sec in p.stages:
                stages[name] = stages.get(name, 0.0) + sec
            cuda = ", ".join(f"{k.split(':')[1]} {v:.1f} ms on the stream" for k, v in p.counters.items()
                             if k.endswith(":cuda_ms"))
            log(f"# population {label}: {n_sites / wall:,.0f} sites/s ({wall:.2f} s, {records} records); device "
                f"stages {profiling.device_seconds(p) / wall:.2%} of wall (" + ", ".join(
                    f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()) + f"; {cuda}); on {card}")

    # the fits at the model layer: five lanes bitwise single-lane fits, the
    # lanes' rounds and launches, the fits' wall against single-lane fits
    hists = population_cohort()  # the samples' histograms, from the counts their pileups were written from
    nts = np.stack([nucleotide_distribution(p, m) for p, m in hists])
    fits = {mode: pop.fit_population(hists, mode=mode, device=dev) for mode in ("pooled", "independent")}
    eps_pooled = fits["pooled"][1].eps
    for k in range(0, POP_SAMPLES, POP_SAMPLES // 5)[:5]:
        obj = lynch.DeviceObjective(hists[k][0], hists[k][1], nts[k], dev)
        two = minimize_nmsimplex2(obj, pop.START, pop.STEP)
        one = minimize_nmsimplex2(lambda x: obj((x[0], eps_pooled)), pop.START_PI, pop.STEP_PI)
        ind, pooled_k = fits["independent"][0][k], fits["pooled"][0][k]
        if not (bits_equal([ind.pi, ind.eps], two.x) and ind.converged == two.converged
                and bits_equal(pooled_k.pi, one.x[0]) and pooled_k.converged == one.converged):
            raise AssertionError(f"lane {k}: the lane fits differ from single-lane fits over DeviceObjective")
    log("# five lanes (0, 20, 40, 60, 80): independent (pi, eps) and pooled pi bitwise single-lane "
        "minimize_nmsimplex2 over DeviceObjective")
    u = [p.shape[0] for p, _ in hists]
    walls = {"lanes": [], "single-lane fits": []}
    for turn in ("lanes", "single-lane fits", "single-lane fits", "lanes"):
        torch.cuda.synchronize()
        before = lo.NLL_LANES_LAUNCHES
        t0 = time.perf_counter()
        if turn == "lanes":
            results, obj = pop.fit_lanes(hists, nts, dev, pop.START, pop.STEP)
            stats = (obj.rounds, lo.NLL_LANES_LAUNCHES - before, obj.evaluations,
                     max(r.iterations for r in results), sum(r.converged for r in results))
        else:
            for (p_k, m_k), nt in zip(hists, nts):
                minimize_nmsimplex2(lynch.DeviceObjective(p_k, m_k, nt, dev), pop.START, pop.STEP)
        walls[turn].append(time.perf_counter() - t0)
    log(f"# independent fits of {POP_SAMPLES} samples (U {min(u)}..{max(u)}): {stats[0]} rounds, {stats[1]} lanes' "
        f"objective launches, {stats[2]} lane evaluations, at most {stats[3]} iterations, {stats[4]} converged; "
        f"wall in turns: " + ", ".join(f"{k} {', '.join(f'{w * 1e3:.1f}' for w in v)} ms" for k, v in walls.items())
        + f"; on {card}")
    return launches


def population_phases(torch, dev, card, sass) -> list:
    """Phases 11 and 12 (their files under .smoke/, removed at the end);
    returns the lane kernels' rows of the kernels line, with the launches
    of the population path."""
    workdir = os.path.join(HERE, ".smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        t0 = time.perf_counter()
        rows = lanes_kernel_phase(torch, dev, card, sass)
        t1 = time.perf_counter()
        launches = population_phase(torch, dev, card, workdir)
        log(f"# phase 11 took {t1 - t0:.1f} s, phase 12 {time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rows[0]["launches"] = launches["nll_lanes"]
    rows[1]["launches"] = launches["marginals_lanes"]
    return rows


# --lane-variants: design choices of the lane kernels, each a text
# substitution in csrc/lynch.cu
_MIN_BLOCKS = "constexpr int kLanesMinBlocks = 3;"
_SLOTS = "__constant__ sid::LaneSlot c_slots[kLanesPerLaunch];"
_MARGINALS_ROWS = "constexpr int kMarginalsRowsPerThread = 1;"
_OBJECTIVE = "// The objective of the n_slots running lanes of c_slots."
_NLL_SEARCH = "    const int k = sid::slot_of(c_slots, n_slots, j);\n    const int64_t first_chunk"
_MARGINALS_SEARCH = "    const int k = sid::slot_of(c_slots, n_slots, j);\n    const int64_t first ="
# the slot search in a fixed number of steps with no data-dependent loop:
# the count of slots whose walk ends at or before j
_UNROLLED_SEARCH = """__device__ __forceinline__ int unrolled_slot_of(int count, int64_t j) {
  int k = 0;
#pragma unroll
  for (int step = 256; step >= 1; step >>= 1) {
    if (k + step < count && c_slots[k + step - 1].walk_end <= j) k += step;
  }
  return k;
}

"""
_ELECTED = """    // thread 0 holds the chunk's sum: store it, publish it, count the chunk
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
"""
# every lane folded at the end by the last block to finish, one warp a
# lane: thread t of the block's tree is lane l = t % 32, register q = t / 32
# of the warp, so the tree's levels 128, 64 and 32 add registers q and
# q + 4, 2, 1 of one thread and the levels 16 .. 1 are the same shuffles
_DEFERRED = """    if (t == 0) {
      part_sum[j] = v;
      part_cnt[j] = cnt;
    }
    (void)n_lane_chunks;
  }
  if (t == 0) {
    __threadfence();
    sh_last = atomicAdd(slot_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  const int lane = t % 32;
  for (int k = t / 32; k < n_slots; k += kThreads / 32) {
    const int64_t first_chunk = sid::walk_start(c_slots, k);
    const int64_t n_lane_chunks = c_slots[k].walk_end - first_chunk;
    double v8[kThreads / 32];
    int c8[kThreads / 32];
    for (int q = 0; q < kThreads / 32; ++q) {
      double acc = 0.0;
      int cnt = 0;
      for (int64_t base = 0; base < n_lane_chunks; base += kThreads) {
        const int64_t i = base + lane + 32 * q;
        acc = acc + (i < n_lane_chunks ? __ldcg(part_sum + first_chunk + i) : 0.0);
        cnt = cnt + (i < n_lane_chunks ? __ldcg(part_cnt + first_chunk + i) : 0);
      }
      v8[q] = acc;
      c8[q] = cnt;
    }
    for (int s = kThreads / 64; s >= 1; s >>= 1) {
      for (int q = 0; q < s; ++q) {
        v8[q] = v8[q] + v8[q + s];
        c8[q] = c8[q] + c8[q + s];
      }
    }
    double acc = v8[0];
    int cnt = c8[0];
    for (int s = 16; s > 0; s >>= 1) {
      acc = acc + __shfl_down_sync(0xffffffffu, acc, s);
      cnt = cnt + __shfl_down_sync(0xffffffffu, cnt, s);
    }
    if (lane == 0) {
      out[2 * k] = acc;
      out[2 * k + 1] = static_cast<double>(cnt);
    }
  }
  if (t == 0) *slot_ticket = 0;  // ready for the next launch
}
"""

# name -> [(file, text, replacement)]
_L = "lynch.cu"
LANE_VARIANTS = {
    "as committed": [],
    "2 blocks an SM": [(_L, _MIN_BLOCKS, "constexpr int kLanesMinBlocks = 2;")],
    "slots in global memory": [(_L, _SLOTS, "__device__ sid::LaneSlot c_slots[kLanesPerLaunch];")],
    "lane folds deferred to the last block": [(_L, _ELECTED, _DEFERRED)],
    "marginals 4 rows a thread": [(_L, _MARGINALS_ROWS, "constexpr int kMarginalsRowsPerThread = 4;")],
    "slot search unrolled": [(_L, _OBJECTIVE, _UNROLLED_SEARCH + _OBJECTIVE),
                             (_L, _NLL_SEARCH, _NLL_SEARCH.replace("sid::slot_of(c_slots, n_slots, j)",
                                                                   "unrolled_slot_of(n_slots, j)")),
                             (_L, _MARGINALS_SEARCH, _MARGINALS_SEARCH.replace("sid::slot_of(c_slots, n_slots, j)",
                                                                               "unrolled_slot_of(n_slots, j)"))],
}
LANE_KERNELS = (("nll_lanes", 3, "lynch_nll_lanes_kernel"), ("marginals_lanes", 4, "lynch_marginals_lanes_kernel"))


def variant_texts(csrc: str, main: str, edits) -> dict:
    """csrc/<main> and every file ``edits`` touches, as text, each
    substitution made in turn; a text to replace that is not in its file
    exactly once raises."""
    texts = {}
    for name in [main] + [f for f, _, _ in edits]:
        if name not in texts:
            with open(os.path.join(csrc, name)) as f:
                texts[name] = f.read()
    for name, old, new in edits:
        if texts[name].count(old) != 1:
            raise AssertionError(f"the text to replace is not in {name} once: {old[:60]!r}")
        texts[name] = texts[name].replace(old, new)
    return texts


def build_variants(build, main: str, variants: dict, prefix: str) -> dict:
    """Each variant of csrc/<main> (``variant_texts``) written with the
    files it edits under sid_tpu_torch/_build/<prefix>_<k>/, so its includes
    find an edited header before csrc's, and built with the port's nvcc
    flags, all at once. Returns {name: (library path, ptxas report)}."""
    tags = {}
    for k, (name, edits) in enumerate(variants.items()):
        tag = f"{prefix}_{k}"
        folder = os.path.join(build.BUILD_DIR, tag)
        shutil.rmtree(folder, ignore_errors=True)
        os.makedirs(folder)
        for file, text in variant_texts(build.CSRC, main, edits).items():
            with open(os.path.join(folder, file), "w") as f:
                f.write(text)
        tags[tag] = (name, os.path.join(folder, main))
    built = build_sources(build, {tag: src for tag, (_, src) in tags.items()},
                          {tag: ["-I", build.CSRC] for tag in tags})
    return {name: built[tag] for tag, (name, _) in tags.items()}


def lane_variants(torch) -> int:
    """--lane-variants: the lane kernels' variants (LANE_VARIANTS), each
    sid_tpu_torch/csrc/lynch.cu with one design choice of its lane kernels
    taken out or changed by a text substitution, built with the port's nvcc
    flags into sid_tpu_torch/_build/. For each, the two lane kernels'
    registers and spills, resident blocks an SM and where their f64
    instructions take their operands (operand_counts); on phase 11's cohort
    and at phase 12's shape every lane's objective and flags and every
    row's marginals bitwise the committed kernels'; then the device-only
    time of each kernel (the kernel launched again on what the card holds,
    on the variant's own resident grid) in two rounds, the second in
    reverse order."""
    import ctypes

    from sid_tpu_torch.native import build
    from sid_tpu_torch.ops import likelihoods, lynch_objective as lo
    from sid_tpu_torch.ops.lgamma import lgamma_table
    from sid_tpu_torch.ops.profiles import nucleotide_distribution

    card = card_line()
    print(f"# {card}", flush=True)
    dev = torch.device("cuda")
    built = build_variants(build, "lynch.cu", LANE_VARIANTS, "lanes_variant")
    libs = {}
    for name, (path, report) in built.items():
        lib = libs[name] = lo.load_kernel_library(path)
        sass = sass_kernels(path)
        per_sm = ctypes.c_int(0)
        for kernel, k, fn_name in LANE_KERNELS:
            if lib.sid_lynch_blocks_per_sm(k, ctypes.byref(per_sm)):
                raise AssertionError(f"{name}: occupancy query failed")
            (r,) = [v for fn, v in report.items() if fn_name in fn]
            ops = ", ".join(f"{key} {v}" for key, v in
                            operand_counts([v for fn, v in sass.items() if fn_name in fn][0]).items())
            print(f"# {name}: {kernel}: {r['registers']} registers, {r['spill_stores']} bytes spill stores, "
                  f"{r['spill_loads']} bytes spill loads, {per_sm.value} blocks an SM; sass {ops}", flush=True)

    # a workspace a variant and shape, each made with the variant's library,
    # so its grids and walks are the variant's own
    committed = lo._kernel_lib()
    cohorts = {}
    for shape, hists in (("phase 11's cohort", lane_cohort()), ("phase 12's shape", population_cohort())):
        off = np.concatenate([[0], np.cumsum([p.shape[0] for p, _ in hists])]).astype(np.int64)
        p_dev = torch.from_numpy(np.ascontiguousarray(np.concatenate([p for p, _ in hists]))).to(dev)
        m_dev = torch.from_numpy(np.concatenate([m for _, m in hists])).to(dev)
        tab = lgamma_table(int(p_dev.sum(-1).max()), dev)
        works = {}
        try:
            for name, lib in libs.items():
                lo._lib = lib
                works[name] = lo.LynchLanesWorkspace(p_dev, m_dev, torch.from_numpy(off).to(dev), tab)
        finally:
            lo._lib = committed
        scal = np.stack([likelihoods.lynch_scalars(*LANE_THETAS[(k + 1) % len(LANE_THETAS)],
                                                   nucleotide_distribution(p, m)) for k, (p, m) in enumerate(hists)])
        cohorts[shape] = (works, scal)

    everyone = list(range(N_LANES))
    for shape, (works, scal) in cohorts.items():
        want = None
        for name, work in works.items():
            got = [work.nll_lanes(scal, everyone), work.flags.cpu().numpy()]
            got += [t.cpu().numpy() for t in work.marginals_lanes(scal)]
            if want is None:
                want = got
            elif not all(np.array_equal(a.view(np.uint8), b.view(np.uint8)) for a, b in zip(got, want)):
                raise AssertionError(f"{name} differs from the committed kernels at {shape}")
        print(f"# {shape}: {work.n} rows, {work.lanes} lanes; every variant's objective, flags and marginals "
              f"bitwise the committed kernels'", flush=True)

    for shape, (works, scal) in cohorts.items():
        readings = {}
        for name in list(works) + list(works)[::-1]:
            work = works[name]
            work.nll_lanes(scal, everyone)
            nll = device_only_ms(torch, work.launch_nll_lanes, [()])
            work.marginals_lanes(scal)
            marg = device_only_ms(torch, work.launch_marginals_lanes, [()])
            readings.setdefault(name, []).append((nll, marg))
        for name, rs in readings.items():
            print(f"# {shape}, {name} (grids {works[name].grids}): device only, objective "
                  f"{statistics.median(r[0] for r in rs):.4f} ms (readings {', '.join(f'{r[0]:.4f}' for r in rs)}), "
                  f"marginals {statistics.median(r[1] for r in rs):.4f} ms (readings "
                  f"{', '.join(f'{r[1]:.4f}' for r in rs)}); on {card}", flush=True)
    return 0


# --b5-variants and --bh-variants: design choices of B5
# (csrc/local_classify.cu) and of the BH sort (csrc/lrt_bh.cu,
# csrc/bh_sort.cuh), each a list of text substitutions (file, text,
# replacement) on the committed sources; the empty list is the committed
# design
_B5_GLOBAL_ROWS = """  const sid::GlobalTable table{tab, tab_len};
  for (; i < n; i += stride) {
    const uint2 row = __ldg(counts + i);
"""
_B5_STAGED_ROWS = """  __shared__ double head[kTabHead];
  const int head_len = stage_head(head, tab, tab_len);
  uint2 next = i < n ? __ldg(counts + i) : make_uint2(0u, 0u);
  wait_head();
  const sid::StagedTable table{head, head_len, tab, tab_len};
  for (; i < n; i += stride) {
    const uint2 row = next;
    if (i + stride < n) next = __ldg(counts + i + stride);
"""
_B5_BLOCKS = "constexpr int kLrtMinBlocks = 6;"
_B5_STAGED = ("local_classify.cu", _B5_GLOBAL_ROWS, _B5_STAGED_ROWS)
_B5_5_BLOCKS = ("local_classify.cu", _B5_BLOCKS, "constexpr int kLrtMinBlocks = 5;")
B5_VARIANTS = {
    "global table, 6 blocks an SM (committed)": [],
    "global table, 5 blocks an SM": [_B5_5_BLOCKS],
    "staged table, 6 blocks an SM": [_B5_STAGED],
    "staged table, 5 blocks an SM": [_B5_STAGED, _B5_5_BLOCKS],
}

_BH_STAGED_SCATTER = """  // each pair's place in the tile's digit order
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
"""
_BH_DIRECT_SCATTER = """#pragma unroll
  for (int k = 0; k < sid::kSortItems; ++k) {
    if (base + 32 * k >= m) continue;
    const unsigned d = sid::radix_digit(key[k], pass, kBits);
    const uint32_t at = tile_base[d] + warp_cnt[warp * kBins + d] + rank[k];
    kout[at] = key[k];
    vout[at] = val[k];
  }
"""
_BH_UNION = "constexpr int kPassUnionBytes = kPassCounterBytes > kSortTile * 8 ? kPassCounterBytes : kSortTile * 8;"
_BH_SMEM = "constexpr int kPassSmemBytes = kPassUnionBytes + 2 * 4 * kSortBins + 2 * kSortTile;"
_BH_DIRECT = [("lrt_bh.cu", _BH_STAGED_SCATTER, _BH_DIRECT_SCATTER),
              ("bh_sort.cuh", _BH_UNION, "constexpr int kPassUnionBytes = kPassCounterBytes;"),
              ("bh_sort.cuh", _BH_SMEM, "constexpr int kPassSmemBytes = kPassUnionBytes + 2 * 4 * kSortBins;")]


def _bh_constant(name: str, committed: int, value: int) -> tuple:
    return ("bh_sort.cuh", f"constexpr int {name} = {committed};", f"constexpr int {name} = {value};")


def _look_back(value: int) -> tuple:
    return ("lrt_bh.cu", "constexpr int kLookBack = 4;", f"constexpr int kLookBack = {value};")


BH_VARIANTS = {
    "committed: staged scatter, 16 pairs a thread, look-back 4, 8-bit digits, 4 positions a scan thread, "
    "one-block warps of 64": [],
    "look-back 8": [_look_back(8)],
    "look-back 16": [_look_back(16)],
    "12 pairs a thread": [_bh_constant("kSortItems", 16, 12)],
    "direct scatter": _BH_DIRECT,
    "direct scatter, 8 pairs a thread": _BH_DIRECT + [_bh_constant("kSortItems", 16, 8)],
    "11-bit digits": [_bh_constant("kSortBits", 8, 11)],
    "16 positions a scan thread": [_bh_constant("kScanItems", 4, 16)],
    "one-block warps of 128": [_bh_constant("kSmallRows", 64, 128)],
    "one-block warps of 256": [_bh_constant("kSmallRows", 64, 256)],
}


# the likelihood-ratio path's profiles at phase 13's 1M simulated sites
# (1,976): the LRT variants are also timed at that many rows
PATH_PROFILES = 1976

# the fused LRT's row kernels' committed launch bounds (kLrtMinBlocks of
# csrc/lrt_bh.cu and csrc/quality_finalize.cu, blocks an SM)
LRT_COMMITTED = {"lrt_bh.cu": 4, "quality_finalize.cu": 4}


def _lrt_variants(file: str) -> dict:
    """4 to 8 blocks an SM, each a substitution of the committed launch
    bound of ``file`` (none for the committed one)."""
    blocks0 = LRT_COMMITTED[file]
    return {f"{blocks} blocks an SM" + (" (committed)" if blocks == blocks0 else ""):
            [] if blocks == blocks0 else [(file, f"constexpr int kLrtMinBlocks = {blocks0};",
                                           f"constexpr int kLrtMinBlocks = {blocks};")]
            for blocks in range(4, 9)}


LRT_VARIANTS = _lrt_variants("lrt_bh.cu")
B6_LRT_VARIANTS = _lrt_variants("quality_finalize.cu")


def lrt_marginals(torch, dev):
    """Phase 5's marginals at eps FIT_EPSILONS[0] (B4 over the cov >= 4
    rows of kernel_profiles, with their multiplicities): the LRT's input in
    phase 13, as host arrays."""
    from sid_tpu_torch.ops import likelihoods, lynch_objective
    from sid_tpu_torch.ops.lgamma import lgamma_table
    from sid_tpu_torch.ops.profiles import nucleotide_distribution

    fit_prof, fit_mult = fit_histogram(kernel_profiles())
    nt = nucleotide_distribution(fit_prof, fit_mult)
    p_dev, m_dev = torch.from_numpy(fit_prof).to(dev), torch.from_numpy(fit_mult).to(dev)
    work = lynch_objective.LynchWorkspace(p_dev, m_dev, lgamma_table(int(fit_prof.sum(-1).max()), dev))
    kk = work.marginals(likelihoods.lynch_scalars(0.0, FIT_EPSILONS[0], nt))
    return kk[0].cpu().numpy().copy(), kk[1].cpu().numpy().copy()


def lrt_variants(torch) -> int:
    """--lrt-variants: the LRT kernel's and B6 full's variants
    (LRT_VARIANTS, B6_LRT_VARIANTS: 4 to 8 blocks an SM), built with the
    port's nvcc flags into sid_tpu_torch/_build/. For each, its ptxas line,
    blocks an SM and f64 instructions a row (the row loop's SASS); the LRT
    at phase 13's U (phase 5's marginals, edge rows planted) without and
    with a prior and one-sided, bitwise the committed kernel; B6 full at N = 1M
    (edge rows planted) at every prior, and with a table of 1,000 entries
    (the miss count), bitwise the committed kernel; then device-only times
    at the -R prior / prior 1e-3 in turns (two rounds, the second
    reversed), the LRT also at PATH_PROFILES rows, and stop."""
    from sid_tpu_torch.models.common import LONG_DOUBLE_UNDERFLOW_LOG
    from sid_tpu_torch.native import build
    from sid_tpu_torch.ops import quality_finalize as qf
    from sid_tpu_torch.ops import stats
    from sid_tpu_torch.ops.lgamma import lgamma_table

    card = card_line()
    print(f"# {card}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kinds = (("LRT", stats, "lrt_bh.cu", LRT_VARIANTS, "lrt_pvalues_kernel"),
             ("B6 full", qf, "quality_finalize.cu", B6_LRT_VARIANTS, "quality_finalize_lrt_kernel"))
    libs = {}
    for kind, mod, main, variants, kernel in kinds:
        built = build_variants(build, main, variants, f"{main.split('.')[0]}_variant")
        for name, (path, report) in built.items():
            lib = libs.setdefault(kind, {})[name] = mod.load_kernel_library(path)
            (r,) = [v for fn, v in report.items() if kernel in fn]
            (c,) = [row_counts(v) for fn, v in sass_kernels(path).items() if kernel in fn]
            with using_library(mod, lib):
                blocks = stats.resident_blocks(dev) if mod is stats else qf.resident_blocks(dev, True)
            print(f"# {kind} {name}: {kernel} {r['registers']} registers, {r['stack']} bytes stack frame, "
                  f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads, {blocks // sms} "
                  f"blocks an SM; a row executes at least {c['f64']} f64 instructions, "
                  f"{c['f64_all']} with every branch arm", flush=True)

    def bitwise(a, b) -> bool:
        return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b))

    lhom, lhet = plant_edges(*lrt_marginals(torch, dev))
    m = lhom.shape[0]
    hom, het = torch.from_numpy(lhom).to(dev), torch.from_numpy(lhet).to(dev)
    for name, lib in libs["LRT"].items():
        for lp in (None, stats.prior_logs(0.02)):
            want = stats.lrt_pair(hom, het, lp)
            with using_library(stats, lib):
                got = stats.lrt_pair(hom, het, lp)
            if not bitwise(got, want):
                raise AssertionError(f"LRT {name} differs from the committed kernel (prior {lp})")
        with using_library(stats, lib):
            got = stats.lrt_pvalues(het, hom)
        if not bitwise([got], [stats.lrt_pvalues(het, hom)]):
            raise AssertionError(f"LRT {name}: the one-sided call differs from the committed kernel")
    print(f"# every LRT variant's p1, p2 (without and with a prior) and one-sided p bitwise the committed kernel at "
          f"U={m}, edge rows planted", flush=True)
    n = N_QUALITY
    c_np, ma, se, lh, lt = finalize_inputs(n)
    lh, lt = plant_edges(lh, lt)
    q_in = (torch.from_numpy(c_np.view(np.int16)).to(dev), torch.from_numpy(qf.pack_alleles(ma, se)).to(dev),
            torch.from_numpy(lt).to(dev), torch.from_numpy(lh).to(dev))
    qtab = lgamma_table(qf.MAX_TOP2, dev)
    misses = torch.empty(1, dtype=torch.int32, device=dev)

    def full(tab, prior):
        out = torch.empty(qf.LRT_BYTES_OUT_PER_SITE * n, dtype=torch.uint8, device=dev)
        qf.launch_lrt(*q_in, tab, prior, ALPHA, out, misses)
        return out, misses.clone()

    for prior in PRIORS:
        for tab in (qtab, qtab[:1000]):
            want = full(tab, prior)
            for name, lib in libs["B6 full"].items():
                with using_library(qf, lib):
                    got = full(tab, prior)
                if not bitwise(got, want):
                    raise AssertionError(f"B6 full {name} differs from the committed kernel at prior {prior}, "
                                         f"table of {tab.shape[0]}")
    print(f"# every B6 full variant's p1, p2, is_het and miss count bitwise the committed kernel at N={n}, edge rows "
          f"planted, priors {PRIORS}, with the whole table and one of 1,000 entries", flush=True)
    p_out = torch.empty(2 * m, dtype=torch.float64, device=dev)
    lrt_sets = [(torch.roll(hom, 7919 * j, 0).contiguous(), torch.roll(het, 7919 * j, 0).contiguous(),
                 stats.prior_logs(0.02)) for j in range(INPUT_SETS)]
    q_out = torch.empty(qf.LRT_BYTES_OUT_PER_SITE * n, dtype=torch.uint8, device=dev)
    q_sets = [tuple(torch.roll(t, 7919 * j, 0).contiguous() for t in q_in) for j in range(INPUT_SETS)]
    ways = {
        "LRT": (stats, lrt_sets,
                lambda a, b, lp: stats.launch_lrt(a, b, lp, LONG_DOUBLE_UNDERFLOW_LOG, p_out[:m], p_out[m:]),
                f"U={m}, -R prior"),
        "B6 full": (qf, q_sets, lambda c, a, h, hm: qf.launch_lrt(c, a, h, hm, qtab, 1e-3, ALPHA, q_out, misses),
                    f"N={n}, prior 1e-3"),
    }
    # and the LRT at the likelihood-ratio path's shape (~2,000 profiles),
    # where the grid is a few blocks
    us = PATH_PROFILES
    ways["LRT, the path's shape"] = (
        stats, [tuple(t[:us].contiguous() for t in s_[:2]) + (s_[2],) for s_ in lrt_sets],
        lambda a, b, lp: stats.launch_lrt(a, b, lp, LONG_DOUBLE_UNDERFLOW_LOG, p_out[:us], p_out[us:2 * us]),
        f"U={us}, -R prior")
    for kind, (mod, sets, launch, at) in ways.items():
        lib_kind = kind.split(",")[0]
        times = in_turns(torch, {name: on_library(mod, lib, launch) for name, lib in libs[lib_kind].items()}, sets)
        for name, v in times.items():
            print(f"# {lib_kind} at {at}, {name}: device only {statistics.median(v):.4f} ms (readings "
                  f"{', '.join(f'{x:.4f}' for x in v)}); on {card}", flush=True)
    return 0


def b5_variants(torch) -> int:
    """--b5-variants: B5's variants (B5_VARIANTS: the table's head staged
    with cp.async and the counts prefetched, or both read from global
    memory; 5 or 6 blocks an SM), built with the port's nvcc flags into
    sid_tpu_torch/_build/. For each, B5's registers, spills, blocks an SM
    and f64 instructions a row; at phase 3's U = 1M profiles every -E and
    prior, p1, p2 and the byte bitwise the committed kernel's; then
    device-only times at -E 0.1, prior 1e-3 in turns (two rounds, the
    second reversed), and stop."""
    from sid_tpu_torch.native import build
    from sid_tpu_torch.ops import local_classify as lc
    from sid_tpu_torch.ops.lgamma import lgamma_table

    card = card_line()
    print(f"# {card}", flush=True)
    dev = torch.device("cuda")
    built = build_variants(build, "local_classify.cu", B5_VARIANTS, "b5_variant")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = {}
    for name, (path, report) in built.items():
        lib = libs[name] = lc.load_kernel_library(path)
        (r,) = [v for fn, v in report.items() if "local_classify_lrt_kernel" in fn]
        (c,) = [row_counts(v) for fn, v in sass_kernels(path).items() if "local_classify_lrt_kernel" in fn]
        with using_library(lc, lib):
            blocks = lc.resident_blocks(dev, True)
        print(f"# {name}: local_classify_lrt_kernel {r['registers']} registers, {r['spill_stores']} bytes spill "
              f"stores, {r['spill_loads']} bytes spill loads, {blocks // sms} blocks an SM; a row executes at least "
              f"{c['f64']} f64 instructions, {c['f64_all']} with every branch arm", flush=True)
    prof = kernel_profiles()
    counts_np, hi = lc.narrow_counts(prof)
    counts = torch.from_numpy(counts_np.view(np.int16)).to(dev)
    tab = lgamma_table(4 * hi, dev)
    for thr in THRESHOLDS:
        for prior in PRIORS:
            want = [x.cpu() for x in lc.local_classify_lrt(counts, thr, prior, ALPHA, tab)]
            for name, lib in libs.items():
                with using_library(lc, lib):
                    got = [x.cpu() for x in lc.local_classify_lrt(counts, thr, prior, ALPHA, tab)]
                if not all(torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(got, want)):
                    raise AssertionError(f"{name} differs from the committed B5 at -E {thr}, prior {prior}")
    print(f"# every variant's p1, p2 and byte bitwise the committed B5 at U={prof.shape[0]}, every -E and prior",
          flush=True)
    buf = torch.empty(lc.BYTES_PER_ROW * prof.shape[0], dtype=torch.uint8, device=dev)
    sets = [(torch.roll(counts, 7919 * k, 0).contiguous(),) for k in range(INPUT_SETS)]

    def way(lib):
        def run(c):
            with using_library(lc, lib):
                lc._launch(c, 0.1, 1e-3, tab, buf, ALPHA)
        return run

    times = in_turns(torch, {name: way(lib) for name, lib in libs.items()}, sets)
    for name, v in times.items():
        print(f"# B5 at U={prof.shape[0]}, -E 0.1, prior 1e-3, {name}: device only {statistics.median(v):.4f} ms "
              f"(readings {', '.join(f'{x:.4f}' for x in v)}); on {card}", flush=True)
    return 0


def bh_variants(torch) -> int:
    """--bh-variants: the BH kernels' variants (BH_VARIANTS: the scatter
    staged in shared memory or straight from registers, the pairs a
    thread, the look-back words read at once, the digit width, the scan's
    positions a thread, the one-block path's positions a ranking warp),
    built with the port's nvcc flags into sid_tpu_torch/_build/. For each,
    the scatter pass's, the scan's and the one-block kernel's registers and
    spills; at U = 1M (B5's p2 of phase 3's profiles with ties and NaN, and
    uniform p cubed, whose keys spread over more bins) BH bitwise
    adjust_benjamini_hochberg_np, and B5's p1 and p2 of the 1M simulated
    sites' ~2,000 profiles as the one-block pair (the path's shape, phase
    13's input); the whole BH on the device in turns (two rounds, the second
    reversed); then stop."""
    from sid_tpu_torch.native import build
    from sid_tpu_torch.ops import local_classify as lc
    from sid_tpu_torch.ops import stats
    from sid_tpu_torch.ops.lgamma import lgamma_table

    card = card_line()
    print(f"# {card}", flush=True)
    dev = torch.device("cuda")
    built = build_variants(build, "lrt_bh.cu", BH_VARIANTS, "bh_variant")
    libs = {}
    for name, (path, report) in built.items():
        libs[name] = stats.load_kernel_library(path)
        for fn, r in sorted(report.items()):
            if "bh_radix_pass_kernel" in fn or "bh_scan_kernel" in fn or "bh_small" in fn:
                print(f"# {name}: {fn}: {r['registers']} registers, {r['stack']} bytes stack frame, "
                      f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads", flush=True)
    prof = kernel_profiles()
    counts_np, hi = lc.narrow_counts(prof)
    counts = torch.from_numpy(counts_np.view(np.int16)).to(dev)
    p2 = lc.local_classify_lrt(counts, 0.1, 1e-3, ALPHA, lgamma_table(4 * hi, dev))[1].clone()
    p2[::997] = 0.5
    p2[::1999] = float("nan")
    cubed = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, prof.shape[0]) ** 3).to(dev)
    out = torch.empty_like(p2)
    committed = stats._kernel_lib()

    def way(lib):
        def run(q):
            stats._lib = lib
            try:
                stats.launch_bh(q, None, out)
            finally:
                stats._lib = committed
        return run

    ways = {name: way(lib) for name, lib in libs.items()}
    # the path's shape: both arrays of the simulated sites' profiles in one
    # launch of the one-block kernel
    from sid_tpu_torch.io.pileup import parse_pileup
    from sid_tpu_torch.ops.profiles import unique_profiles

    q1, q2 = path_shape_pvalues(unique_profiles(parse_pileup(simulated_pileup(N_SITES)).counts)[0], dev)
    us = q1.shape[0]
    o1, o2, h2 = torch.empty_like(q1), torch.empty_like(q2), torch.empty(us, dtype=torch.uint8, device=dev)
    w1, w2 = (stats.adjust_benjamini_hochberg_np(q.cpu().numpy()) for q in (q1, q2))

    def pair(lib):
        def run(a, b):
            stats._lib = lib
            try:
                stats.launch_bh_pair(a, b, o1, o2, h2, ALPHA)
            finally:
                stats._lib = committed
        return run

    pairs = {name: pair(lib) for name, lib in libs.items()}
    for name, fn in pairs.items():
        fn(q1, q2)
        if not (np.array_equal(o1.cpu().numpy().view(np.uint64), w1.view(np.uint64))
                and np.array_equal(o2.cpu().numpy().view(np.uint64), w2.view(np.uint64))):
            raise AssertionError(f"BH {name} differs from the host BH at U={us}")
    times = in_turns(torch, pairs, [(torch.roll(q1, 7 * j, 0).contiguous(), torch.roll(q2, 7 * j, 0).contiguous())
                                    for j in range(3)])
    for name, v in times.items():
        print(f"# BH of both arrays at U={us} (the simulated sites' profiles, one launch), {name}: bitwise the host "
              f"BH; device only "
              f"{statistics.median(v):.4f} ms (readings {', '.join(f'{x:.4f}' for x in v)}); on {card}", flush=True)
    for label, p in (("B5's p2", p2), ("uniform p cubed", cubed)):
        want = stats.adjust_benjamini_hochberg_np(p.cpu().numpy())
        for name, fn in ways.items():
            fn(p)
            if not np.array_equal(out.cpu().numpy().view(np.uint64), want.view(np.uint64)):
                raise AssertionError(f"BH {name} differs from the host BH on {label}")
        times = in_turns(torch, ways, [(torch.roll(p, 7919 * j, 0).contiguous(),) for j in range(3)])
        for name, v in times.items():
            print(f"# BH at U={p.shape[0]}, {label}, {name}: bitwise the host BH; device only "
                  f"{statistics.median(v):.4f} ms (readings {', '.join(f'{x:.4f}' for x in v)}); on {card}",
                  flush=True)
    return 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of sid_tpu_torch on one CUDA card.")
    ap.add_argument("--parent", help="an unpacked tree of the parent commit: its B5, LRT, BH and B6 full kernels "
                    "(csrc/local_classify.cu, csrc/lrt_bh.cu, csrc/quality_finalize.cu) bitwise and in turns in "
                    "phase 13")
    ap.add_argument("--b5-variants", action="store_true",
                    help="time B5's design variants (B5_VARIANTS) in turns, and stop")
    ap.add_argument("--bh-variants", action="store_true",
                    help="time the BH sort's design variants (BH_VARIANTS) in turns, and stop")
    ap.add_argument("--lrt-variants", action="store_true",
                    help="time the LRT kernel's and B6 full's variants (LRT_VARIANTS, B6_LRT_VARIANTS) in turns, "
                         "and stop")
    ap.add_argument("--lane-variants", action="store_true",
                    help="time variants of the lane kernels (LANE_VARIANTS) in turns, and stop")
    args = ap.parse_args()

    t_start = time.perf_counter()
    # ---- 1. probe ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from sid_tpu_torch import engine
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.io import native
    from sid_tpu_torch.io.pileup import parse_pileup
    from sid_tpu_torch.models import bayes, likelihood_ratio, local, lynch
    from sid_tpu_torch.models.common import major_allele_indices_np
    from sid_tpu_torch.native import bridge, build
    from sid_tpu_torch.ops import likelihoods, local_classify, lynch_objective
    from sid_tpu_torch.ops.lgamma import lgamma_table
    from sid_tpu_torch.ops.profiles import coverage_of, nucleotide_distribution, unique_profiles
    from sid_tpu_torch.utils import profiling
    from synth import make_pileup_text, simulate_diploid_counts

    if args.lane_variants:
        return lane_variants(torch)
    if args.b5_variants:
        return b5_variants(torch)
    if args.bh_variants:
        return bh_variants(torch)
    if args.lrt_variants:
        return lrt_variants(torch)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"# device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)
    dev = torch.device("cuda")

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.host_library()
    t1 = time.perf_counter()
    libs = build.kernel_libraries()
    t2 = time.perf_counter()
    log(f"# build: libsidtpu.so {t1 - t0:.1f} s (g++), {len(libs)} kernel libraries {t2 - t1:.1f} s "
        f"(one nvcc each, in parallel)")
    sass = {}
    for name in libs:
        with open(build.kernel_paths(name)[1]) as f:
            report = ptxas_report(f.read())
        for fn, r in report.items():
            log(f"# ptxas {name}: {fn}: {r['registers']} registers, {r['stack']} bytes stack frame, "
                f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads")
            if r["spill_stores"] or r["spill_loads"]:
                raise AssertionError(f"ptxas spills registers in {fn}")
        kernels = sass_kernels(libs[name])
        sass.update({fn: {**row_counts(instrs), "f64_kernel": sum(op in F64_OPCODES for _, _, op, _ in instrs)}
                     for fn, instrs in kernels.items()})
        if name != "lynch":
            continue
        for fn, instrs in sorted(kernels.items()):
            c = operand_counts(instrs)
            log(f"# sass operands {fn}: {c['f64']} f64 instructions, {c['f64_param']} reading the parameter "
                f"bank, {c['f64_const']} the constant bank, {c['f64_uniform']} a uniform register; LDC {c['LDC']}, "
                f"ULDC {c['ULDC']}, local loads {c['LDL']}, local stores {c['STL']}")
    log("# Lynch kernels' resident blocks an SM (occupancy API): "
        + ", ".join(f"{k} {v}" for k, v in lynch_objective.blocks_per_sm(dev).items()))
    for fn, c in sorted(sass.items()):
        log(f"# sass: {fn}: a row executes at least {c['f64']} f64 instructions and issues at least "
            f"{c['issued']} instructions a warp; with every branch arm {c['f64_all']} and {c['issued_all']}")
    if not sass:
        raise AssertionError("no cuobjdump: the kernels' f64 instruction counts, and so their bounds, are unknown")
    # ---- 3. kernel vs plain at U = 1M ----
    prof_np = kernel_profiles()
    major_np, second_np = major_allele_indices_np(prof_np)
    cov_np = coverage_of(prof_np)
    counts_np, max_count = local_classify.narrow_counts(prof_np)
    counts = torch.from_numpy(counts_np.view(np.int16)).to(dev)
    tab = lgamma_table(4 * max_count, dev)
    max_abs = 0.0
    max_rel = 0.0
    for thr in THRESHOLDS:
        p1, p2, _ = (t.cpu().numpy() for t in local_classify.local_classify_ref(counts, thr, PRIORS[0], tab))
        flagged = []
        for prior in PRIORS:
            k1, k2, kb = (t.cpu().numpy() for t in local_classify.local_classify(counts, thr, prior, tab))
            torch.cuda.synchronize()
            for name, a, b in (("l1", p1, k1), ("l2", p2, k2)):
                err, rel = assert_agree(f"-E {thr} prior {prior} {name}", a, b)
                max_abs = max(max_abs, err)
                max_rel = max(max_rel, rel)
            pb = local_classify.local_classify_ref(counts, thr, prior, tab)[2].cpu().numpy()
            k_major, k_second, k_flag = local_classify.unpack(kb)
            want_flag = local.long_double_range_rows(cov_np, thr, prior)
            for what, ok in (("byte vs plain", np.array_equal(kb, pb)),
                             ("major vs major_allele_indices_np", np.array_equal(k_major, major_np)),
                             ("second vs major_allele_indices_np", np.array_equal(k_second, second_np)),
                             ("flag vs long_double_range_rows", np.array_equal(k_flag, want_flag))):
                if not ok:
                    raise AssertionError(f"-E {thr} prior {prior}: {what} differs")
            flagged.append(int(k_flag.sum()))
        log(f"# kernel == plain at U={U_KERNEL}, -E {thr}: l1, l2 ok; major, second and range flag bitwise the "
            f"plain version, major_allele_indices_np and long_double_range_rows at priors {PRIORS} "
            f"(rows flagged {flagged})")
    log(f"# kernel vs plain: max abs err {max_abs!r}, max rel err {max_rel!r} (bound {RTOL})")
    # distinct content per repeat: the same rows rolled by different offsets
    sets = [(torch.roll(counts, 7919 * k, 0).contiguous(), 0.1, 1e-3, tab) for k in range(INPUT_SETS)]
    # in turns: plain, kernel, kernel, plain
    plain = event_times_ms(torch, local_classify.local_classify_ref, sets)
    kernel = event_times_ms(torch, local_classify.local_classify, sets)
    kernel += event_times_ms(torch, local_classify.local_classify, sets)
    plain += event_times_ms(torch, local_classify.local_classify_ref, sets)
    plain_ms = statistics.median(plain)
    kernel_ms = statistics.median(kernel)
    local_dev_ms = device_only_ms(torch, local_classify.local_classify, sets)
    # 8 B of counts in, l1, l2 and the byte out (17 B) a row, and the table;
    # the first port moved 40 B a row for the same function
    local_rows = kernel_counts(sass, "local_classify_kernel")
    local_f64 = local_rows["f64"] * U_KERNEL
    local_bound = bound_ms(U_KERNEL * (8 + 17) + tab.shape[0] * 8, local_f64)
    bound_40 = bound_ms(U_KERNEL * 40 + tab.shape[0] * 8, local_f64)[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = local_classify.resident_blocks(dev)
    log(f"# time at U={U_KERNEL}, -E 0.1, median of {len(kernel)} calls: kernel {kernel_ms:.4f} ms "
        f"(min {min(kernel):.4f}, max {max(kernel):.4f}), device only {local_dev_ms:.4f} ms, plain torch "
        f"{plain_ms:.4f} ms (min {min(plain):.4f}, max {max(plain):.4f}); bound {local_bound[0]:.4f} ms by "
        f"{local_bound[1]} ({U_KERNEL * 25 / 1e6:.0f} MB of rows, {tab.shape[0] * 8 / 1e6:.1f} MB of table; "
        f"{local_rows['f64']} f64 instructions every row executes, {local_rows['f64_all']} with every branch "
        f"arm), {local_bound[0] / local_dev_ms:.1%} of the bound; the first port's 40-byte bound "
        f"{bound_40:.4f} ms, {bound_40 / local_dev_ms:.1%}; issuing the row's instructions "
        f"{issue_ms(local_rows['issued'], U_KERNEL):.4f}-{issue_ms(local_rows['issued_all'], U_KERNEL):.4f} ms "
        f"({local_rows['issued']}-{local_rows['issued_all']} a warp); grid {resident} blocks ({resident // sms} an "
        f"SM x {sms} SMs); on {card}")
    del sets, counts

    # ---- 4. main path ----
    golden_src = os.path.join(FIXTURES, "golden.pileup")
    real_src = os.path.join(FIXTURES, "realdata", "bwa_like_100k.pileup.gz")
    t0 = time.perf_counter()
    synth = simulated_pileup(N_SITES)
    log(f"# simulated {N_SITES} sites ({len(synth) / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")
    with open(golden_src.replace(".pileup", "_local.csv"), "rb") as f:
        golden_want = f.read()
    opts = Options()
    ld_want = {}
    for name, src in (("realdata", real_src), ("synth", synth)):
        batch = parse_pileup(src)
        ld_want[name] = local.call_local_ld(batch, opts).to_csv_bytes()
        u = unique_profiles(batch.counts)[0].shape[0]
        log(f"# {name}: {batch.num_sites} sites, {u} unique profiles")

    local_classify.LAUNCHES = 0
    got = engine.run(golden_src, opts, binary=True)
    if got != golden_want:
        raise AssertionError(f"golden CSV differs: {first_difference(got, golden_want)}")
    log("# golden.pileup: CSV byte-equal to golden_local.csv")
    with open(real_src, "rb") as f:
        real_sites = gzip.decompress(f.read()).count(b"\n")
    got = engine.run(real_src, opts, binary=True)
    if got != ld_want["realdata"]:
        raise AssertionError(f"realdata CSV differs: {first_difference(got, ld_want['realdata'])}")
    log(f"# bwa_like_100k: {real_sites} sites, CSV byte-equal to the host long-double path")
    runs = []
    for _ in range(3):
        prof_run = profiling.StageProfile()
        profiling.activate(prof_run)
        t0 = time.perf_counter()
        got = engine.run(synth, opts, binary=True)
        wall = time.perf_counter() - t0
        profiling.activate(None)
        if got != ld_want["synth"]:
            raise AssertionError(f"synth CSV differs: {first_difference(got, ld_want['synth'])}")
        runs.append((wall, prof_run))
    launches = local_classify.LAUNCHES
    if launches != 5:  # one launch per engine.run above
        raise AssertionError(f"the main path launched the kernel {launches} times, expected 5")
    log(f"# synth {N_SITES} sites: CSV byte-equal to the host long-double path (3 runs)")
    for wall, p in runs:
        dev_s = profiling.device_seconds(p)
        stages = ", ".join(f"{n} {s * 1e3:.1f} ms" for n, s in p.stages)
        cuda_ms = p.counters.get("device:local_log_likelihoods:cuda_ms", float("nan"))
        log(f"# main path: {N_SITES / wall:,.0f} sites/s end to end ({wall * 1e3:.1f} ms); "
            f"device stage {dev_s / wall:.2%} of wall ({cuda_ms:.3f} ms on the stream); "
            f"{stages}; on {card}")
    log(f"# kernel launches on the main path: {launches}")

    # ---- 4b. the device stage and both placements at U = 1M profiles ----
    # the stage as classify_profiles_local runs it: host wall, and the two
    # copies and the kernel on the device by torch.profiler
    thr, prior = opts.site_error_threshold, opts.snp_prior
    stage_walls = []
    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    allocs0 = host_stats().get("num_host_alloc") if host_stats else None
    for _ in range(5):
        t0 = time.perf_counter()
        local_classify.classify_profiles(prof_np, thr, prior, dev)
        stage_walls.append((time.perf_counter() - t0) * 1e3)
    allocs = host_stats().get("num_host_alloc") if host_stats else None
    reuse = (f"{allocs - allocs0} new pinned host allocations in 5 calls" if None not in (allocs, allocs0)
             else "pinned allocations not counted")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as tp:
        for _ in range(5):
            local_classify.classify_profiles(prof_np, thr, prior, dev)
    seg = {}
    for ev in tp.key_averages():
        for name, key in (("h2d", "Memcpy HtoD"), ("kernel", "local_classify_kernel"), ("d2h", "Memcpy DtoH")):
            if key in ev.key:
                seg[name] = seg.get(name, 0.0) + device_time_ms(ev)
    split = ", ".join(f"{name} {seg[name]:.4f} ms" if name in seg else f"{name} not measured"
                      for name in ("h2d", "kernel", "d2h"))
    log(f"# device stage at U={U_KERNEL} (classify_profiles, pinned): {split} on the device (torch.profiler, "
        f"mean of 5 calls); 8 B a profile in ({U_KERNEL * 8 / 1e6:.0f} MB), 17 B a profile out "
        f"({U_KERNEL * 17 / 1e6:.0f} MB); host wall {statistics.median(stage_walls):.2f} ms (runs "
        f"{', '.join(f'{w:.2f}' for w in stage_walls)}); {reuse}; on {card}")
    walls = {"device": [], "host_ld": []}
    outs = {}
    for name in ("device", "host_ld", "host_ld", "device", "device", "host_ld"):
        fn = local.classify_profiles_local if name == "device" else local.classify_profiles_local_ld
        t0 = time.perf_counter()
        outs[name] = fn(prof_np, opts, opts.snp_prior)
        walls[name].append((time.perf_counter() - t0) * 1e3)
    (h_d, a_d, b_d, p1_d, p2_d), (h_l, a_l, b_l, p1_l, p2_l) = outs["device"], outs["host_ld"]
    if not (np.array_equal(a_d, a_l) and np.array_equal(b_d, b_l)):
        raise AssertionError("classify_profiles_local's alleles differ from the host long-double path's")
    n_ld_rows = int(local.long_double_range_rows(cov_np, thr, prior).sum())
    diff_g = sum(
        int(np.count_nonzero(np.char.mod("%g", a) != np.char.mod("%g", b)))
        for a, b in ((p1_d, p1_l), (p2_d, p2_l))
    )
    log(f"# classify at U={U_KERNEL}: device path {statistics.median(walls['device']):.1f} ms "
        f"(runs {', '.join(f'{w:.1f}' for w in walls['device'])}), host long double "
        f"{statistics.median(walls['host_ld']):.1f} ms (runs {', '.join(f'{w:.1f}' for w in walls['host_ld'])}); "
        f"het calls differing {int(np.count_nonzero(h_d != h_l))}, %g p-values differing {diff_g} "
        f"of {2 * U_KERNEL}; {n_ld_rows} deep profiles sent to long double by the range screen; "
        f"on {card}")

    del outs, h_d, h_l, a_d, a_l, b_d, b_l, p1_d, p2_d, p1_l, p2_l

    # ---- 5. the Lynch fit's kernels vs their plain versions ----
    fit_prof, fit_mult = fit_histogram(prof_np)
    u_fit = fit_prof.shape[0]
    nt = nucleotide_distribution(fit_prof, fit_mult)
    p_dev = torch.from_numpy(fit_prof).to(dev)
    m_dev = torch.from_numpy(fit_mult).to(dev)
    ftab = lgamma_table(int(fit_prof.sum(-1).max()), dev)
    work = lynch_objective.LynchWorkspace(p_dev, m_dev, ftab)
    rec_plain = lynch_objective.lynch_records_ref(p_dev, m_dev, ftab)
    if not torch.equal(work.records.view(torch.int64), rec_plain.view(torch.int64)):
        raise AssertionError("the row record differs from its plain version")
    log(f"# row record == plain at U={u_fit}, bitwise (m, signed multiplicity, packed counts); "
        f"grids: records {work.grids[0]}, B2 {work.grids[1]}, B4 {work.grids[2]} blocks")
    nll_abs = 0.0
    flagged = {}
    for th in FIT_THETAS:
        if not (0 <= th[0] <= 1 and 0 <= th[1] <= 1):
            obj = lynch.DeviceObjective(fit_prof, fit_mult, nt, dev)
            plain_v = float(likelihoods.compound_neg_log_likelihood(th, p_dev, m_dev, nt, ftab))
            if not obj(th) == plain_v == likelihoods.DBL_MAX:
                raise AssertionError(f"objective outside the box at {th}: {obj(th)!r}, {plain_v!r}")
            del obj
            continue
        s = likelihoods.lynch_scalars(th[0], th[1], nt)
        k_out, k_flags = lynch_objective.lynch_compound_nll(p_dev, m_dev, s, ftab, work=work)
        k_out, k_flags = k_out.cpu().numpy().copy(), k_flags.cpu().numpy().copy()
        p_out, p_flags = lynch_objective.lynch_compound_nll_ref(p_dev, m_dev, s, ftab)
        p_out, p_flags = p_out.cpu().numpy(), p_flags.cpu().numpy()
        if not np.array_equal(k_flags, p_flags):
            raise AssertionError(f"B2 flags differ at {th}: {k_out[1]} vs {p_out[1]} rows")
        if not np.array_equal(k_out.view(np.int64), p_out.view(np.int64)):
            raise AssertionError(f"B2 differs bitwise from plain at {th}: {k_out!r} vs {p_out!r}")
        nll_abs = max(nll_abs, float(abs(k_out[0] - p_out[0])))
        flagged[th] = int(k_out[1])
    log(f"# B2 == plain at U={u_fit} over {len(FIT_THETAS)} thetas: bitwise (max abs err {nll_abs!r}), "
        f"flags equal row for row; rows flagged by the range screen: "
        + ", ".join(f"{th}: {n}" for th, n in flagged.items()))
    s = likelihoods.lynch_scalars(0.05, 0.01, nt)
    first = lynch_objective.lynch_compound_nll(p_dev, m_dev, s, ftab, work=work)[0].cpu().numpy().copy()
    for call in range(10):
        again = lynch_objective.lynch_compound_nll(p_dev, m_dev, s, ftab, work=work)[0].cpu().numpy()
        if not np.array_equal(first, again):
            raise AssertionError(f"B2 call {call} differs bitwise: {again!r} vs {first!r}")
    for grid in (1, 7, 1000, work.grids[1]):
        again = lynch_objective.lynch_compound_nll(p_dev, m_dev, s, ftab, work=work, grid=grid)[0].cpu().numpy()
        if not np.array_equal(first, again):
            raise AssertionError(f"B2 with {grid} blocks differs bitwise: {again!r} vs {first!r}")
    before = lynch_objective.kernel_launches()
    one = work.nll(s)
    after = lynch_objective.kernel_launches()
    per_eval = {k: after[k] - before[k] for k in after}
    if (per_eval != {"records": 0, "nll": 1, "marginals": 0, "nll_lanes": 0, "marginals_lanes": 0}
            or list(one) != first.tolist()):
        raise AssertionError(f"one evaluation: launches {per_eval}, result {one!r} vs {first!r}")
    log(f"# B2 bitwise repeatable: 10 calls and grids of 1, 7, 1000 and {work.grids[1]} (the resident "
        f"blocks) blocks all give {first[0]!r}; one evaluation is {per_eval['nll']} kernel launch "
        f"(the kernel library's counters: {per_eval})")
    marg_abs = marg_rel = 0.0
    for eps in FIT_EPSILONS:
        s = likelihoods.lynch_scalars(0.0, eps, nt)
        kk = [t.cpu().numpy() for t in work.marginals(s)]
        if eps == FIT_EPSILONS[0]:
            lrt_marginals = (kk[0].copy(), kk[1].copy())  # phase 13's LRT input
        pp = [t.cpu().numpy() for t in lynch_objective.lynch_marginals_ref(p_dev, s, ftab)]
        if not np.array_equal(kk[2], pp[2]):
            raise AssertionError(f"B4 flags differ at eps {eps}")
        for name, a, b in (("log L_hom", pp[0], kk[0]), ("log L_het", pp[1], kk[1])):
            err, rel = assert_agree(f"B4 {name} at eps {eps}", a, b)
            marg_abs, marg_rel = max(marg_abs, err), max(marg_rel, rel)
        log(f"# B4 == plain at U={u_fit}, eps {eps}: ok; rows flagged {int(kk[2].sum())}")
    log(f"# B4 vs plain: max abs err {marg_abs!r}, max rel err {marg_rel!r} (bound {RTOL})")

    # times: the call (CUDA events around one wrapper call, its host work
    # included), the device alone (launches enqueued while the stream is
    # held), the plain version; in turns plain, kernel, kernel, plain
    nll_sets = [(p_dev, m_dev, likelihoods.lynch_scalars(th[0], th[1], nt), ftab)
                for th in FIT_THETAS[:4]]
    marg_sets = [(p_dev, likelihoods.lynch_scalars(0.0, e, nt), ftab) for e in FIT_EPSILONS]
    # the plain version takes (profiles, scalars, table); the kernel reads the workspace's record
    rec_sets = [(p_dev, m_dev, ftab)]

    def b2(*a):
        return lynch_objective.lynch_compound_nll(*a, work=work)

    def b4(p, sc, t):
        return work.marginals(sc)

    def records(*a):
        return lynch_objective.LynchWorkspace(*a).records

    n_chunks = -(-u_fit // likelihoods.CHUNK_ROWS)
    t_bytes = ftab.shape[0] * 8
    fit_kernels = {
        # name: (wrapper, plain, input sets, device-only launch, kernel in the SASS, bytes)
        "lynch_records": (records, lynch_objective.lynch_records_ref, rec_sets, lambda *a: work.write_records(),
                          "lynch_records_kernel", u_fit * (16 + 8 + 24) + t_bytes),
        "lynch_compound_nll": (b2, lynch_objective.lynch_compound_nll_ref, nll_sets,
                               lambda p, m, sc, t: work.launch_nll(sc), "lynch_nll_kernel",
                               u_fit * (24 + 1) + n_chunks * 12 + 16),
        "lynch_marginals": (b4, lynch_objective.lynch_marginals_ref, marg_sets, b4, "lynch_marginals_kernel",
                            u_fit * (24 + 17)),
    }
    fit_times = {}
    for name, (fn, plain_fn, sets, launch, sass_name, n_bytes) in fit_kernels.items():
        plain_t = event_times_ms(torch, plain_fn, sets)
        call_t = event_times_ms(torch, fn, sets) + event_times_ms(torch, fn, sets)
        plain_t += event_times_ms(torch, plain_fn, sets)
        dev_ms = device_only_ms(torch, launch, sets)
        c = kernel_counts(sass, sass_name)
        b_ms, b_by = bound_ms(n_bytes, c["f64"] * u_fit)
        b_all = bound_ms(n_bytes, c["f64_all"] * u_fit)[0]
        fit_times[name] = {"ms": statistics.median(call_t), "plain_ms": statistics.median(plain_t),
                           "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"# {name} at U={u_fit}: call {fit_times[name]['ms']:.4f} ms (median of {len(call_t)}, min "
            f"{min(call_t):.4f}), device only {dev_ms:.4f} ms, plain torch {fit_times[name]['plain_ms']:.4f} ms; "
            f"bound {b_ms:.4f} ms by {b_by} ({n_bytes / 1e6:.1f} MB; {c['f64']} f64 instructions every row "
            f"executes), {b_ms / dev_ms:.1%} of the bound ({b_all:.4f} ms, {b_all / dev_ms:.1%}, with every "
            f"branch arm: {c['f64_all']}); issuing the row's instructions {issue_ms(c['issued'], u_fit):.4f}-"
            f"{issue_ms(c['issued_all'], u_fit):.4f} ms ({c['issued']}-{c['issued_all']} a warp); on {card}")
    # the SM clock and power while B2 runs back to back (nvidia-smi samples every 50 ms)
    s = nll_sets[1][2]
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + 2.0
        while time.perf_counter() < t_end:
            for _ in range(200):
                work.launch_nll(s)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples = [ln.split(",") for ln in smi.communicate(timeout=30)[0].splitlines()]
        samples = [[float(v) for v in ln] for ln in samples
                   if len(ln) == 2 and all(re.fullmatch(r"\s*[0-9.]+\s*", v) for v in ln)]
    if samples:
        clocks, watts = zip(*samples)
        log(f"# while B2 runs back to back: SM clock median {statistics.median(clocks):.0f} MHz (min {min(clocks):.0f}, "
            f"max {max(clocks):.0f}), power median {statistics.median(watts):.1f} W, {len(samples)} samples; "
            f"the bounds take 1980 MHz; on {card}")
    walls = []
    for _ in range(41):
        t0 = time.perf_counter()
        work.nll(s)
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"# one B2 evaluation (LynchWorkspace.nll: launch, copy into pinned memory, stream sync), "
        f"host clock: {statistics.median(walls):.4f} ms (median of 41, min {min(walls):.4f}); on {card}")
    del p_dev, m_dev, work, rec_plain, nll_sets, marg_sets, rec_sets

    # ---- 6. the fit's main path ----
    fit_cases = (
        ("bayes", {"method": "bayes"}, "golden_bayes.csv"),
        ("LR", {"method": "likelihood_ratio"}, "golden_likelihood_ratio.csv"),
        ("LR -R", {"method": "likelihood_ratio", "estimate_prior": True}, "golden_likelihood_ratio_R.csv"),
        ("local -R", {"estimate_prior": True}, "golden_local_R.csv"),
    )
    modes = (("--fit device", {"fit_backend": "device"}), ("--fit auto", {}), ("--engine exact", {"engine": "exact"}))
    golden_fit_lines = ["# GSL function minimization converged in 46 iterations.",
                        "# heterozygosity: 5.212459e-02", "# error: 9.672816e-03"]
    deep = {name: make_pileup_text(np.vstack([simulate_diploid_counts(300, coverage=25, pi=0.02, eps=0.01), [row]]),
                                   with_qualities=True)
            for name, row in (("(9000, 9000, 0, 0)", [9000, 9000, 0, 0]), ("(15000, 0, 5000, 0)", [15000, 0, 5000, 0]))}
    local_classify.LAUNCHES = 0
    lynch_objective.RECORD_LAUNCHES = 0
    lynch_objective.NLL_LAUNCHES = 0
    lynch_objective.MARGINALS_LAUNCHES = 0
    t0 = time.perf_counter()
    for label, kw, golden_name in fit_cases:
        with open(os.path.join(FIXTURES, golden_name), "rb") as f:
            want = f.read()
        grew = {}
        for mode, mkw in modes:
            lines = []
            before = lynch_objective.NLL_LAUNCHES
            got = engine.run(golden_src, Options(**kw, **mkw), lines.append, binary=True)
            if got != want:
                raise AssertionError(f"{label} {mode}: CSV differs from {golden_name}: {first_difference(got, want)}")
            grew[mode] = lynch_objective.NLL_LAUNCHES - before
            if mode == "--fit device":
                expect = golden_fit_lines[:1] if label == "local -R" else golden_fit_lines
                if grew[mode] == 0 or [ln for ln in lines if ln in golden_fit_lines] != expect:
                    raise AssertionError(f"{label} {mode}: {grew[mode]} B2 launches, diagnostics {lines}")
            elif grew[mode]:
                raise AssertionError(f"{label} {mode}: B2 launched {grew[mode]} times")
        log(f"# golden.pileup {label}: byte-equal to {golden_name} under "
            + ", ".join(f"{mode} ({n} B2 launches)" for mode, n in grew.items()))
    for name, src in deep.items():
        for label, kw, _ in fit_cases:
            dev_lines, ex_lines = [], []
            got = engine.run(src, Options(fit_backend="device", **kw), dev_lines.append, binary=True)
            want = engine.run(src, Options(fit_backend="exact", **kw), ex_lines.append, binary=True)
            if got != want or dev_lines != ex_lines:
                raise AssertionError(f"C2 repro {name} {label}: --fit device differs from --fit exact: "
                                     f"{first_difference(got, want)}; {dev_lines} vs {ex_lines}")
        log(f"# C2 repro, 300 simulated sites + {name}: --fit device byte-equal to --fit exact "
            f"(bayes, LR, LR -R, local -R; {ex_lines[-1]})")
    fit_launches = {"records": lynch_objective.RECORD_LAUNCHES, "nll": lynch_objective.NLL_LAUNCHES,
                    "marginals": lynch_objective.MARGINALS_LAUNCHES, "local": local_classify.LAUNCHES}
    if not all(fit_launches.values()):
        raise AssertionError(f"a kernel of the fit path was not launched: {fit_launches}")
    log(f"# kernel launches on the fit path ({time.perf_counter() - t0:.1f} s): row record "
        f"{fit_launches['records']}, B2 {fit_launches['nll']}, B4 {fit_launches['marginals']}, local classify "
        f"{fit_launches['local']}")

    # ---- 7. the fit at U ~ 1M at the model layer ----
    opts_auto, opts_exact = Options(), Options(fit_backend="exact")
    if lynch.resolve_fit_backend(opts_auto, u_fit) != "device":
        raise AssertionError(f"auto does not pick the device fit at U={u_fit}")

    def differing(a, b):
        rows = a[0] != b[0]
        for x, y in ((a[3], b[3]), (a[4], b[4])):
            rows |= np.char.mod("%g", x) != np.char.mod("%g", y)
        return int(rows.sum())

    def median_ms(fn, n):
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    # phase 5's rows up to 1000x: no row for the range screen, so no
    # long-double power tables up to the deepest coverage (the whole
    # histogram's one flagged row costs both fits ~37 s: PERF.md section 5)
    shallow = fit_prof.sum(-1) <= 1000
    for hist, (h_prof, h_mult) in (("rows <= 1000x", (fit_prof[shallow], fit_mult[shallow])),):
        u_h = h_prof.shape[0]
        fits = {}
        for name, opts in (("device (auto)", opts_auto), ("exact", opts_exact)):
            lines = []
            before = lynch_objective.NLL_LAUNCHES
            t0 = time.perf_counter()
            pi_hat, eps_hat, lhom, lhet, _ = lynch.fit_profiles(h_prof, h_mult, opts, lines.append)
            wall = time.perf_counter() - t0
            fits[name] = (pi_hat, eps_hat, lhom, lhet)
            log(f"# fit, {hist}, U={u_h}, {name}: {wall:.2f} s; {lines[0]} "
                f"({lynch_objective.NLL_LAUNCHES - before} B2 launches) pi {pi_hat!r}, eps {eps_hat!r}; on {card}")
        (pi_d, eps_d, lh_d, lt_d), (pi_e, eps_e, lh_e, lt_e) = fits["device (auto)"], fits["exact"]
        d_pi, d_eps = abs(pi_d - pi_e), abs(eps_d - eps_e)
        if not (d_pi <= SIMPLEX_TOL and d_eps <= SIMPLEX_TOL):
            raise AssertionError(f"device and exact fits differ: |dpi| {d_pi!r}, |deps| {d_eps!r}")
        n_bayes = differing(bayes.posteriors(h_prof, pi_d, lh_d, lt_d), bayes.posteriors(h_prof, pi_e, lh_e, lt_e))
        n_lr = differing(likelihood_ratio.lrt_classify(h_prof, pi_d, lh_d, lt_d, opts_auto),
                         likelihood_ratio.lrt_classify(h_prof, pi_e, lh_e, lt_e, opts_auto))
        log(f"# device vs exact fit, {hist}: |dpi| {d_pi!r}, |deps| {d_eps!r} (bound {SIMPLEX_TOL}); "
            f"profile records differing: bayes {n_bayes}, LR {n_lr} of {u_h}")
        # one evaluation at the fitted theta, taken apart (wall clock, medians)
        h_nt = nucleotide_distribution(h_prof, h_mult)
        obj = lynch.DeviceObjective(h_prof, h_mult, h_nt, dev)
        theta = (pi_d, eps_d)
        s = likelihoods.lynch_scalars(pi_d, eps_d, h_nt)
        obj.work.nll(s)
        rows = np.nonzero(obj.work.flags.cpu().numpy())[0]
        ld = bridge.NativeLynchLD(native.load(), h_prof, h_mult, h_nt, rows)
        ld_all = bridge.NativeLynchLD(native.load(), h_prof, h_mult, h_nt)
        log(f"# one evaluation, {hist}: DeviceObjective {median_ms(lambda: obj(theta), 9):.3f} ms = host scalars "
            f"{median_ms(lambda: likelihoods.lynch_scalars(pi_d, eps_d, h_nt), 9):.3f} ms + B2 launch and fetch "
            f"{median_ms(lambda: obj.work.nll(s), 9):.3f} ms"
            f" + long double over the {rows.size} flagged rows {median_ms(lambda: ld.objective(theta), 3):.3f} ms; "
            f"the exact fit's evaluation {median_ms(lambda: ld_all.objective(theta), 3):.3f} ms; on {card}")
        # a one-lane LanesObjective on the same rows (ROADMAP B.9): the
        # values bitwise DeviceObjective's and the marginals bitwise B4's;
        # the kernels alone (device only) and the objective's whole call
        # (host clock), in turns
        one_lane = lynch.LanesObjective([(h_prof, h_mult)], h_nt[None], dev)
        at = [np.array(theta)]
        if rows.size or not bits_equal(one_lane([0], at)[0], obj(theta)):
            raise AssertionError(f"one-lane LanesObjective vs DeviceObjective at U={u_h}: {rows.size} flagged rows, "
                                 f"{one_lane([0], at)[0]!r} vs {obj(theta)!r}")
        s_eps = likelihoods.lynch_scalars(0.0, eps_d, h_nt)
        for what, x, y in zip(("log L_hom", "log L_het", "flags"), obj.work.marginals(s_eps),
                              one_lane.work.marginals_lanes(s_eps[None])):
            if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
                raise AssertionError(f"one-lane lanes' marginals vs B4 at U={u_h}: {what} differs")
        pairs = (
            (("B2", lambda: obj.work.launch_nll(s), lambda: obj(theta)),
             ("the lanes' objective", one_lane.work.launch_nll_lanes, lambda: one_lane([0], at))),
            (("B4", lambda: obj.work.marginals(s_eps), None),
             ("the lanes' marginals", one_lane.work.launch_marginals_lanes, None)),
        )
        kernel_t, call_t = {}, {}
        for a, b in pairs:
            for name, launch, call in (a, b, b, a) * 2:
                kernel_t.setdefault(name, []).append(device_only_ms(torch, launch, [()]))
                if call is not None:
                    call_t.setdefault(name, []).append(median_ms(call, 21))
        log(f"# one evaluation at U={u_h}, {hist}, the fitted theta, no flagged rows: a one-lane LanesObjective "
            f"bitwise DeviceObjective and its marginals bitwise B4; in turns, the kernels alone (device only) "
            + ", ".join(f"{name} {statistics.median(t):.4f} ms (readings {', '.join(f'{x:.4f}' for x in t)})"
                        for name, t in kernel_t.items())
            + "; the objective's whole call (host clock, medians of 21) "
            + ", ".join(f"{'DeviceObjective' if name == 'B2' else 'one-lane LanesObjective'} "
                        f"{statistics.median(t):.4f} ms (readings {', '.join(f'{x:.4f}' for x in t)})"
                        for name, t in call_t.items())
            + f"; on {card}")
        del obj, one_lane, fits, lh_d, lt_d, lh_e, lt_e
    # the device fit's wall taken apart, on the rows <= 1000x
    h_prof, h_mult = np.ascontiguousarray(fit_prof[shallow]), fit_mult[shallow]
    for _ in range(3):
        sp = fit_wall_split(torch, h_prof, h_mult, nucleotide_distribution(h_prof, h_mult), dev)
        log(f"# device fit at U={h_prof.shape[0]}, wall {sp['wall_ms']:.3f} ms = set-up {sp['setup_ms']:.3f} ms "
            f"(uploads, table, row record) + {sp['evaluations']} evaluations {sp['evaluations_ms']:.3f} ms "
            f"+ host simplex {sp['simplex_ms']:.3f} ms + B4 with its copies {sp['marginals_ms']:.3f} ms; on {card}")
    # the set-up's largest coverage: the parent's length-4 axis sum against
    # coverage_of's column adds, in turns, the same integers
    cov_walls = {"sum(-1)": [], "coverage_of": []}
    tops = set()
    for name in ("sum(-1)", "coverage_of", "coverage_of", "sum(-1)") * 3:
        t0 = time.perf_counter()
        tops.add(int(h_prof.sum(-1).max()) if name == "sum(-1)" else int(coverage_of(h_prof).max()))
        cov_walls[name].append((time.perf_counter() - t0) * 1e3)
    if len(tops) != 1:
        raise AssertionError(f"coverage_of and sum(-1) disagree: {tops}")
    log(f"# the set-up's largest coverage at U={h_prof.shape[0]} (host clock, medians of 6, in turns): "
        + ", ".join(f"{name} {statistics.median(w):.2f} ms" for name, w in cov_walls.items()) + f"; on {card}")

    # ---- 8-10, 13. the quality finalize kernel, -m quality, --stream, the device LRT ----
    workdir = os.path.join(HERE, ".smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        quality_row = quality_kernel_phase(torch, dev, card, sass)
        quality_row["launches"], qsrc = quality_path_phase(torch, dev, card, workdir, golden_src, real_src)
        stream_phase(card, workdir, qsrc)
        small_prof = unique_profiles(parse_pileup(synth).counts)[0]
        parent = parent_device_lrt(build, args.parent) if args.parent else None
        lrt_rows = device_lrt_kernel_phase(torch, dev, card, sass, prof_np, lrt_marginals, fit_prof, small_prof,
                                           parent)
        lrt_launches = device_lrt_path_phase(torch, card, golden_src, synth, qsrc)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- 11-12. the cohort's lane kernels, the population path ----
    lane_rows = population_phases(torch, dev, card, sass)

    # ---- 14. results ----
    kernel_rows = [{
        "name": "local_log_likelihoods",
        "route": "cuda",
        "source": "sid_tpu_torch/csrc/local_classify.cu",
        "replaces": "sid_tpu/ops/pallas_classify.py:193",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "device_ms": local_dev_ms,
        "bound_ms": local_bound[0],
        "bound_by": local_bound[1],
        "bound_ms_40_bytes": bound_40,
        "library_ms": None,
    }]
    for name, replaces, launches_key, err in (
        ("lynch_records", "sid_tpu/ops/likelihoods.py:33", "records", 0.0),
        ("lynch_compound_nll", "sid_tpu/ops/likelihoods.py:138", "nll", nll_abs),
        ("lynch_marginals", "sid_tpu/ops/likelihoods.py:40", "marginals", marg_abs),
    ):
        kernel_rows.append({"name": name, "route": "cuda", "source": "sid_tpu_torch/csrc/lynch.cu",
                     "replaces": replaces, "launches": fit_launches[launches_key], "max_abs_err": err,
                     **fit_times[name], "library_ms": None})
    kernel_rows.append(quality_row)
    kernel_rows += lane_rows
    for row in lrt_rows:
        row["launches"] = lrt_launches[row["name"]]
    kernel_rows += lrt_rows
    log(f"# chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
