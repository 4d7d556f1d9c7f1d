#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one CUDA card: python3 chip_smoke.py

Drives sid_tpu_torch's main paths (``engine.run``, what ``./sid-tpu-torch``
runs) on the card and checks them:

1. probe: a CUDA card must be present; prints its name and power limit;
2. build: libsidtpu.so (g++) and the kernel libraries (one nvcc per source,
   all started together, sm_90a) from the sources in this checkout, with
   the compiler's register report;
3. kernel vs plain: the slim local classify kernel against its plain torch
   f64 version on the card at U = 1,000,000 profiles (Poisson(30) bulk,
   zero rows, deep rows up to 65535, ties, capped rows) at -E 0.0, 0.1 and
   1.0: identical non-finite positions, |a-b| <= 1e-12 max(1,|a|); median
   times of both over distinct inputs, by CUDA events;
4. the -m local path: engine.run on the golden fixture (byte-equal to
   golden_local.csv), the 100k-site real-data-shaped fixture and a
   1,000,000-site simulated ~30x pileup, the last two byte-equal to the CSV
   of the host long-double classifier (no kernel in that path); the
   kernel's launch count must grow; prints sites/s and the device stage's
   share; 4b splits the device stage at U = 1M;
5. the Lynch fit's kernels (objective B2, marginals B4) against their plain
   torch f64 versions on the cov >= 4 rows of phase 3's profiles with
   seeded multiplicities: the objective's sum, flagged count and flags at
   seven thetas (out of the box: DBL_MAX), the marginals and flags at three
   epsilons, identical non-finite positions and 1e-12 relative; B2 bitwise
   repeatable over ten calls and over grid sizes; median times;
6. the fit's main path: engine.run on golden.pileup for bayes, LR, LR -R
   and local -R under --fit device, --fit auto and --engine exact, each
   byte-equal to its golden CSV, the device fit's diagnostic lines those of
   the goldens' run; B2 launched under --fit device and not under auto;
   the deep-coverage repro of fault C2 byte-equal to --fit exact;
7. the fit at U ~ 1M at the model layer: models.lynch.fit_profiles under
   auto (the device fit) and --fit exact on phase 5's histogram; wall time,
   iterations, (pi, eps) of both within the simplex tolerance, and how many
   bayes / LR profile records differ;
8. prints a JSON line of kernel results, then the final JSON line
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
FIT_THETAS = ((1e-3, 1e-3), (0.05, 0.01), (0.0, 1e-3), (1e-3, 0.0), (1.0, 1.0), (0.5, 0.999), (-0.1, 0.5))
FIT_EPSILONS = (1e-3, 3.85e-11, 0.5)
SIMPLEX_TOL = 1e-5


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
    from sid_tpu_torch.ops.profiles import nucleotide_distribution, unique_profiles
    from sid_tpu_torch.utils import profiling
    from synth import make_pileup_text, simulate_diploid_counts

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
    for name in libs:
        with open(build.kernel_paths(name)[1]) as f:
            for line in f:
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    log(f"# ptxas {name}: {line.strip()}")

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

    del outs, h_d, h_l, p1_d, p2_d, p1_l, p2_l

    # ---- 5. the Lynch fit's kernels vs their plain versions ----
    fit_prof, fit_mult = fit_histogram(prof_np)
    u_fit = fit_prof.shape[0]
    nt = nucleotide_distribution(fit_prof, fit_mult)
    p_dev = torch.from_numpy(fit_prof).to(dev)
    m_dev = torch.from_numpy(fit_mult).to(dev)
    ftab = lgamma_table(int(fit_prof.sum(-1).max()), dev)
    work = lynch_objective.NllWorkspace(u_fit, dev)
    nll_abs = nll_rel = 0.0
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
        if not (np.array_equal(k_flags, p_flags) and k_out[1] == p_out[1]):
            raise AssertionError(f"B2 flags differ at {th}: {k_out[1]} vs {p_out[1]} rows")
        err, rel = assert_agree(f"B2 at {th}", p_out[:1], k_out[:1])
        nll_abs, nll_rel = max(nll_abs, err), max(nll_rel, rel)
        flagged[th] = int(k_out[1])
    log(f"# B2 == plain at U={u_fit} over {len(FIT_THETAS)} thetas: max abs err {nll_abs!r}, "
        f"max rel err {nll_rel!r} (bound {RTOL}); rows flagged by the range screen: "
        + ", ".join(f"{th}: {n}" for th, n in flagged.items()))
    s = likelihoods.lynch_scalars(0.05, 0.01, nt)
    first = lynch_objective.lynch_compound_nll(p_dev, m_dev, s, ftab, work=work)[0].cpu().numpy().copy()
    for call in range(10):
        again = lynch_objective.lynch_compound_nll(p_dev, m_dev, s, ftab, work=work)[0].cpu().numpy()
        if not np.array_equal(first, again):
            raise AssertionError(f"B2 call {call} differs bitwise: {again!r} vs {first!r}")
    for grid in (1, 7, 1000):
        again = lynch_objective.lynch_compound_nll(p_dev, m_dev, s, ftab, work=work, grid=grid)[0].cpu().numpy()
        if not np.array_equal(first, again):
            raise AssertionError(f"B2 with {grid} blocks differs bitwise: {again!r} vs {first!r}")
    log(f"# B2 bitwise repeatable: 10 calls and grids of 1, 7, 1000 blocks all give {first[0]!r}")
    marg_abs = marg_rel = 0.0
    for eps in FIT_EPSILONS:
        s = likelihoods.lynch_scalars(0.0, eps, nt)
        kk = [t.cpu().numpy() for t in lynch_objective.lynch_marginals(p_dev, s, ftab)]
        pp = [t.cpu().numpy() for t in lynch_objective.lynch_marginals_ref(p_dev, s, ftab)]
        if not np.array_equal(kk[2], pp[2]):
            raise AssertionError(f"B4 flags differ at eps {eps}")
        for name, a, b in (("log L_hom", pp[0], kk[0]), ("log L_het", pp[1], kk[1])):
            err, rel = assert_agree(f"B4 {name} at eps {eps}", a, b)
            marg_abs, marg_rel = max(marg_abs, err), max(marg_rel, rel)
        log(f"# B4 == plain at U={u_fit}, eps {eps}: ok; rows flagged {int(kk[2].sum())}")
    log(f"# B4 vs plain: max abs err {marg_abs!r}, max rel err {marg_rel!r} (bound {RTOL})")
    nll_sets = [(p_dev, m_dev, likelihoods.lynch_scalars(th[0], th[1], nt), ftab)
                for th in FIT_THETAS[:4]]

    def b2(*a):
        return lynch_objective.lynch_compound_nll(*a, work=work)

    nll_plain = event_times_ms(torch, lynch_objective.lynch_compound_nll_ref, nll_sets)
    nll_kernel = event_times_ms(torch, b2, nll_sets)
    nll_kernel += event_times_ms(torch, b2, nll_sets)
    nll_plain += event_times_ms(torch, lynch_objective.lynch_compound_nll_ref, nll_sets)
    marg_sets = [(p_dev, likelihoods.lynch_scalars(0.0, e, nt), ftab) for e in FIT_EPSILONS]
    marg_plain = event_times_ms(torch, lynch_objective.lynch_marginals_ref, marg_sets)
    marg_kernel = event_times_ms(torch, lynch_objective.lynch_marginals, marg_sets)
    marg_kernel += event_times_ms(torch, lynch_objective.lynch_marginals, marg_sets)
    marg_plain += event_times_ms(torch, lynch_objective.lynch_marginals_ref, marg_sets)
    nll_ms, nll_plain_ms = statistics.median(nll_kernel), statistics.median(nll_plain)
    marg_ms, marg_plain_ms = statistics.median(marg_kernel), statistics.median(marg_plain)
    log(f"# time at U={u_fit}, median of {len(nll_kernel)} calls: B2 kernel {nll_ms:.4f} ms "
        f"(min {min(nll_kernel):.4f}, max {max(nll_kernel):.4f}), plain torch {nll_plain_ms:.4f} ms; "
        f"B4 kernel {marg_ms:.4f} ms (min {min(marg_kernel):.4f}, max {max(marg_kernel):.4f}), "
        f"plain torch {marg_plain_ms:.4f} ms; on {card}")
    del p_dev, m_dev, work, nll_sets, marg_sets

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
    fit_launches = {"nll": lynch_objective.NLL_LAUNCHES, "marginals": lynch_objective.MARGINALS_LAUNCHES,
                    "local": local_classify.LAUNCHES}
    if not all(fit_launches.values()):
        raise AssertionError(f"a kernel of the fit path was not launched: {fit_launches}")
    log(f"# kernel launches on the fit path ({time.perf_counter() - t0:.1f} s): B2 {fit_launches['nll']}, "
        f"B4 {fit_launches['marginals']}, local classify {fit_launches['local']}")

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

    # phase 5's histogram, and its rows up to 1000x: no row for the range
    # screen, so no long-double power tables up to the deepest coverage
    shallow = fit_prof.sum(-1) <= 1000
    for hist, (h_prof, h_mult) in (("phase 5 histogram", (fit_prof, fit_mult)),
                                   ("rows <= 1000x", (fit_prof[shallow], fit_mult[shallow]))):
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
        flags = lynch_objective.lynch_compound_nll(obj.prof_dev, obj.mult_dev, s, obj.tab, work=obj.work)[1]
        rows = np.nonzero(flags.cpu().numpy())[0]
        ld = bridge.NativeLynchLD(native.load(), h_prof, h_mult, h_nt, rows)
        ld_all = bridge.NativeLynchLD(native.load(), h_prof, h_mult, h_nt)
        log(f"# one evaluation, {hist}: DeviceObjective {median_ms(lambda: obj(theta), 9):.3f} ms = host scalars "
            f"{median_ms(lambda: likelihoods.lynch_scalars(pi_d, eps_d, h_nt), 9):.3f} ms + B2 launch and fetch "
            f"{median_ms(lambda: lynch_objective.lynch_compound_nll(obj.prof_dev, obj.mult_dev, s, obj.tab, work=obj.work)[0].tolist(), 9):.3f} ms"
            f" + long double over the {rows.size} flagged rows {median_ms(lambda: ld.objective(theta), 3):.3f} ms; "
            f"the exact fit's evaluation {median_ms(lambda: ld_all.objective(theta), 3):.3f} ms; on {card}")
        del obj, fits, lh_d, lt_d, lh_e, lt_e

    # ---- 8. results ----
    print(json.dumps({"kernels": [{
        "name": "local_log_likelihoods",
        "route": "cuda",
        "source": "sid_tpu_torch/csrc/local_classify.cu",
        "replaces": "sid_tpu/ops/pallas_classify.py:193",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "lynch_compound_nll",
        "route": "cuda",
        "source": "sid_tpu_torch/csrc/lynch.cu",
        "replaces": "sid_tpu/ops/likelihoods.py:138",
        "launches": fit_launches["nll"],
        "max_abs_err": nll_abs,
        "ms": nll_ms,
        "plain_ms": nll_plain_ms,
    }, {
        "name": "lynch_marginals",
        "route": "cuda",
        "source": "sid_tpu_torch/csrc/lynch.cu",
        "replaces": "sid_tpu/ops/likelihoods.py:40",
        "launches": fit_launches["marginals"],
        "max_abs_err": marg_abs,
        "ms": marg_ms,
        "plain_ms": marg_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
