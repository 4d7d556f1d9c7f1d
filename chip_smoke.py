#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one CUDA card: python3 chip_smoke.py

Drives sid_tpu_torch's ``-m local`` main path (``engine.run``, what
``./sid-tpu-torch input.pileup`` runs) on the card and checks it:

1. probe: a CUDA card must be present; prints its name and power limit;
2. build: libsidtpu.so (g++) and the kernel library (nvcc, sm_90a) from the
   sources in this checkout, with the compiler's register report;
3. kernel vs plain: the slim local classify kernel against its plain torch
   f64 version on the card at U = 1,000,000 profiles (Poisson(30) bulk,
   zero rows, deep rows up to 65535, ties, capped rows) at -E 0.0, 0.1 and
   1.0: identical non-finite positions, |a-b| <= 1e-12 max(1,|a|); median
   times of both over distinct inputs, by CUDA events;
4. main path: engine.run on the golden fixture (byte-equal to
   golden_local.csv), the 100k-site real-data-shaped fixture and a
   1,000,000-site simulated ~30x pileup, the last two byte-equal to the CSV
   of the host long-double classifier (no kernel in that path); the
   kernel's launch count must grow; prints sites/s and the device stage's
   share;
5. prints a JSON line of kernel results, then the final JSON line
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the final
line. Without a CUDA card it exits 1 at once.
"""

import gzip
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures")
U_KERNEL = 1_000_000
N_SITES = 1_000_000
THRESHOLDS = (0.0, 0.1, 1.0)
RTOL = 1e-12
REPEATS = 20
INPUT_SETS = 5


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


def simulated_pileup(n_sites: int, seed: int = 7) -> bytes:
    """~30x diploid pileup (pi=1e-3, eps=1e-2), the counts of bench.py's
    generate, rendered as plain base letters with constant qualities."""
    rng = np.random.default_rng(seed)
    cov = rng.poisson(30, n_sites).clip(1)
    is_het = rng.uniform(size=n_sites) < 1e-3
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


def event_times_ms(torch, fn, sets) -> list:
    """CUDA-event times of fn over REPEATS calls, cycling input sets with
    distinct content (after one warm-up call per set)."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    times = []
    for r in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*sets[r % len(sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def first_difference(a: bytes, b: bytes) -> str:
    la, lb = a.split(b"\n"), b.split(b"\n")
    for k, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return f"line {k}: {x!r} vs {y!r}"
    return f"lengths {len(la)} vs {len(lb)} lines"


def main() -> int:
    import torch

    # ---- 1. probe ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from sid_tpu_torch import engine
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.io.pileup import parse_pileup
    from sid_tpu_torch.models import local
    from sid_tpu_torch.models.common import major_allele_indices_np
    from sid_tpu_torch.native import build
    from sid_tpu_torch.ops import local_classify
    from sid_tpu_torch.ops.lgamma import lgamma_table
    from sid_tpu_torch.ops.profiles import unique_profiles
    from sid_tpu_torch.utils import profiling

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"# device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)
    dev = torch.device("cuda")

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.host_library()
    t1 = time.perf_counter()
    build.kernel_library()
    t2 = time.perf_counter()
    log(f"# build: libsidtpu.so {t1 - t0:.1f} s (g++), kernels {t2 - t1:.1f} s (nvcc)")
    with open(build.KERNEL_LOG) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log(f"# ptxas: {line.strip()}")

    # ---- 3. kernel vs plain at U = 1M ----
    prof_np = kernel_profiles()
    major_np, second_np = major_allele_indices_np(prof_np)
    prof = torch.from_numpy(prof_np).to(dev)
    major = torch.from_numpy(major_np).to(dev)
    second = torch.from_numpy(second_np).to(dev)
    tab = lgamma_table(int(prof_np.sum(-1).max()), dev)
    max_abs = 0.0
    max_rel = 0.0
    for thr in THRESHOLDS:
        k1, k2 = local_classify.local_log_likelihoods(prof, major, second, thr, tab)
        torch.cuda.synchronize()
        p1, p2 = local_classify.local_log_likelihoods_ref(prof, major, second, thr, tab)
        torch.cuda.synchronize()
        for name, a, b in (("l1", p1, k1), ("l2", p2, k2)):
            err, rel = assert_agree(f"-E {thr} {name}", a.cpu().numpy(), b.cpu().numpy())
            max_abs = max(max_abs, err)
            max_rel = max(max_rel, rel)
        log(f"# kernel == plain at U={U_KERNEL}, -E {thr}: ok")
    log(f"# kernel vs plain: max abs err {max_abs!r}, max rel err {max_rel!r} (bound {RTOL})")
    # distinct content per repeat: the same rows rolled by different offsets
    sets = [
        (torch.roll(prof, 7919 * k, 0).contiguous(), torch.roll(major, 7919 * k, 0).contiguous(),
         torch.roll(second, 7919 * k, 0).contiguous(), 0.1, tab)
        for k in range(INPUT_SETS)
    ]
    # in turns: plain, kernel, kernel, plain
    plain = event_times_ms(torch, local_classify.local_log_likelihoods_ref, sets)
    kernel = event_times_ms(torch, local_classify.local_log_likelihoods, sets)
    kernel += event_times_ms(torch, local_classify.local_log_likelihoods, sets)
    plain += event_times_ms(torch, local_classify.local_log_likelihoods_ref, sets)
    plain_ms = statistics.median(plain)
    kernel_ms = statistics.median(kernel)
    log(f"# time at U={U_KERNEL}, -E 0.1, median of {len(kernel)} calls: kernel {kernel_ms:.4f} ms "
        f"(min {min(kernel):.4f}, max {max(kernel):.4f}), plain torch {plain_ms:.4f} ms "
        f"(min {min(plain):.4f}, max {max(plain):.4f}); on {card}")
    del sets, prof, major, second, p1, p2, k1, k2

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
    segments = {"h2d": [], "kernel": [], "d2h": []}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        args = [torch.from_numpy(a).to(dev) for a in (prof_np, major_np, second_np)]
        ev[1].record()
        l1, l2 = local_classify.local_log_likelihoods(*args, 0.1, tab)
        ev[2].record()
        l1.cpu(), l2.cpu()
        ev[3].record()
        ev[3].synchronize()
        for k, name in enumerate(segments):
            segments[name].append(ev[k].elapsed_time(ev[k + 1]))
    med = {name: statistics.median(t) for name, t in segments.items()}
    total = sum(med.values())
    log(f"# device stage at U={U_KERNEL} (median of 5, pageable memory): h2d {med['h2d']:.3f} ms "
        f"(24 B/profile), kernel {med['kernel']:.3f} ms, d2h {med['d2h']:.3f} ms (16 B/profile); "
        f"kernel {med['kernel'] / total:.1%} of the stage; on {card}")
    walls = {"device": [], "host_ld": []}
    outs = {}
    for name in ("device", "host_ld", "host_ld", "device", "device", "host_ld"):
        fn = local.classify_profiles_local if name == "device" else local.classify_profiles_local_ld
        t0 = time.perf_counter()
        outs[name] = fn(prof_np, opts, opts.snp_prior)
        walls[name].append((time.perf_counter() - t0) * 1e3)
    (h_d, _, _, p1_d, p2_d), (h_l, _, _, p1_l, p2_l) = outs["device"], outs["host_ld"]
    n_ld_rows = int(local.long_double_range_rows(
        prof_np.sum(-1, dtype=np.int64), opts.site_error_threshold, opts.snp_prior).sum())
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

    # ---- 5. results ----
    print(json.dumps({"kernels": [{
        "name": "local_log_likelihoods",
        "route": "cuda",
        "source": "sid_tpu_torch/csrc/local_classify.cu",
        "replaces": "sid_tpu/ops/pallas_classify.py:193",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
