"""chip_smoke.py's pieces that run without a card.

The design-variant builds edit the kernel sources by text substitution
(``LANE_VARIANTS``, ``B5_VARIANTS``, ``BH_VARIANTS``, ``LRT_VARIANTS``,
``B6_LRT_VARIANTS``, ``scripts/local_classify_variants.py``); a source edit that moves the text
would only fail on the card, so these hold them here. ``row_counts`` reads
kernels that load nothing (the BH scan's zeroing kernel) as a whole. The scale-out
phases' inputs (chromosomes named by the Phred writer) and their kernel
counters are held here too.
"""

import importlib.util
import os
import re

import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "sid_tpu_torch", "csrc")


def source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def local_variants():
    spec = importlib.util.spec_from_file_location(
        "local_classify_variants", os.path.join(ROOT, "scripts", "local_classify_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VARIANTS


@pytest.mark.parametrize("name", list(chip_smoke.LANE_VARIANTS))
def test_lane_variant_texts_are_in_lynch_cu_once(name):
    src = source("lynch.cu")
    for file, old, _ in chip_smoke.LANE_VARIANTS[name]:
        assert file == "lynch.cu" and src.count(old) == 1
    chip_smoke.variant_texts(CSRC, "lynch.cu", chip_smoke.LANE_VARIANTS[name])


@pytest.mark.parametrize("name", list(local_variants()))
def test_local_classify_variant_texts_are_in_the_source_once(name):
    src = source("local_classify.cu")
    for old, _ in local_variants()[name]:
        assert src.count(old) == 1


VARIANT_TABLES = {"B5_VARIANTS": "local_classify.cu", "BH_VARIANTS": "lrt_bh.cu", "LRT_VARIANTS": "lrt_bh.cu",
                  "B6_LRT_VARIANTS": "quality_finalize.cu", "SHARD_VARIANTS": "lynch.cu"}


@pytest.mark.parametrize("table, name", [(t, n) for t in VARIANT_TABLES for n in getattr(chip_smoke, t)])
def test_variant_texts_are_in_the_sources_once(table, name):
    """Each substitution of a B5, BH, LRT, B6 full or sharded objective variant finds its text once in the
    file it edits (after the variant's earlier substitutions) and changes
    it."""
    edits = getattr(chip_smoke, table)[name]
    texts = chip_smoke.variant_texts(CSRC, VARIANT_TABLES[table], edits)
    for file, old, new in edits:
        assert old != new
        assert new in texts[file]


@pytest.mark.parametrize("table", list(VARIANT_TABLES))
def test_variants_are_distinct(table):
    """No two variants of a table make the same sources, and only the
    committed design makes none."""
    variants = getattr(chip_smoke, table)
    made = {name: chip_smoke.variant_texts(CSRC, VARIANT_TABLES[table], edits) for name, edits in variants.items()}
    keys = [tuple(sorted(texts.items())) for texts in made.values()]
    assert len(set(keys)) == len(variants)
    assert sum(not edits for edits in variants.values()) == 1


def test_committed_b5_design_is_a_variant():
    """B5_VARIANTS holds the committed csrc/local_classify.cu as it is, so
    --b5-variants times the committed design beside the others."""
    assert [] in list(chip_smoke.B5_VARIANTS.values())
    texts = chip_smoke.variant_texts(CSRC, "local_classify.cu", [])
    assert texts == {"local_classify.cu": source("local_classify.cu")}


def test_committed_bh_design_is_a_variant():
    assert [] in list(chip_smoke.BH_VARIANTS.values())
    assert chip_smoke.variant_texts(CSRC, "lrt_bh.cu", []) == {"lrt_bh.cu": source("lrt_bh.cu")}


def test_kernel_sources_hold_no_variant_macros():
    """The variants live in chip_smoke.py's substitutions, not as build
    macros of the kernel sources."""
    for name in ("local_classify.cu", "lrt_bh.cu", "bh_sort.cuh", "quality_finalize.cu"):
        assert not re.findall(r"#if(?:n?def)? SID_(?:B5|BH|LRT)_", source(name))


@pytest.mark.parametrize("file", sorted(chip_smoke.LRT_COMMITTED))
def test_lrt_committed_constants_are_the_sources(file):
    """LRT_COMMITTED holds the row kernels' committed launch bounds, and
    each variant's text asks for its own."""
    blocks = chip_smoke.LRT_COMMITTED[file]
    src = source(file)
    assert src.count(f"constexpr int kLrtMinBlocks = {blocks};") == 1
    table = chip_smoke.LRT_VARIANTS if file == "lrt_bh.cu" else chip_smoke.B6_LRT_VARIANTS
    assert len(table) == 5
    for name, edits in table.items():
        text = chip_smoke.variant_texts(CSRC, file, edits)[file]
        assert f"constexpr int kLrtMinBlocks = {name.split()[0]};" in text
        assert (edits == []) == name.endswith("(committed)")


def test_planted_edges_keep_the_arrays():
    """plant_edges copies both arrays and plants every pair of its 13 edge
    values once, at distinct rows."""
    import numpy as np

    a, b = np.linspace(-10, -1, 1000), np.linspace(-20, -2, 1000)
    x, y = chip_smoke.plant_edges(a, b)
    changed = (x != a) | (y != b) | np.isnan(x) | np.isnan(y)
    assert 13 * 13 - 13 <= changed.sum() <= 13 * 13
    assert np.array_equal(a, np.linspace(-10, -1, 1000))


def test_row_counts_of_a_kernel_that_loads_nothing():
    """A zeroing kernel has no load to anchor a row: the whole kernel."""
    instrs = [(0x00, False, "S2R", "R0, SR_TID.X"), (0x10, True, "STG", "desc[UR4][R2.64], RZ"),
              (0x20, False, "EXIT", ""), (0x30, False, "BRA", "0x30")]
    got = chip_smoke.row_counts(instrs)
    assert got == {"f64": 0, "issued": 4, "f64_all": 0, "issued_all": 4}


def test_row_counts_of_a_row_loop():
    """The loop around the first load is the row; a branch jumping over an
    instruction takes it out of the every-row count."""
    instrs = [(0x00, False, "S2R", ""), (0x10, False, "LDG", ""), (0x20, False, "DADD", ""),
              (0x30, False, "BRA", "0x50"), (0x40, False, "DMUL", ""), (0x50, False, "BRA", "0x10"),
              (0x60, False, "EXIT", "")]
    got = chip_smoke.row_counts(instrs)
    assert (got["f64"], got["f64_all"]) == (1, 2)


def test_phred_pileup_names_its_chromosome():
    from sid_tpu_torch.io.pileup import parse_pileup

    counts = chip_smoke.simulated_counts(300, seed=3, pi=0.01)
    text = chip_smoke.phred_pileup(counts, 7, 4, "chrX_10")
    batch = parse_pileup(text, True, True, backend="python")
    assert batch.chrom_table == ["chrX_10"]
    assert batch.pos.tolist() == list(range(7, 307))
    assert batch.counts.tolist() == counts.tolist()
    assert chip_smoke.phred_pileup(counts, 7, 4) == text.replace(b"chrX_10\t", b"chr1\t")


def test_chromosome_texts_differ_by_seed_and_pi(monkeypatch):
    from sid_tpu_torch.io.pileup import parse_pileup

    monkeypatch.setattr(chip_smoke, "SHARD_SITES", 2000)
    texts = chip_smoke.chromosome_texts()
    batches = [parse_pileup(t) for t in texts]
    assert [b.chrom_table for b in batches] == [[f"chr{k + 1}"] for k in range(chip_smoke.SHARD_CHROMS)]
    assert all(b.num_sites == 2000 for b in batches)
    assert len({b.counts.tobytes() for b in batches}) == chip_smoke.SHARD_CHROMS
    assert chip_smoke.SHARD_PIS[0] == pytest.approx(1e-4) and chip_smoke.SHARD_PIS[-1] == pytest.approx(1e-2)


@pytest.mark.parametrize("kw,fit,want", [
    ({}, "auto", ("local_log_likelihoods",)),
    ({"method": "quality"}, "device", ("quality_finalize",)),
    ({"method": "bayes"}, "auto", ()),
    ({"method": "likelihood_ratio", "estimate_prior": True}, "device",
     ("lynch_records", "lynch_fit_lanes", "lynch_marginals")),
])
def test_path_kernels_are_counters(kw, fit, want):
    assert chip_smoke.path_kernels(kw, fit) == want
    assert set(want) <= set(chip_smoke.kernel_counters())


def test_phase_16_runs_in_main():
    """Phase 16 (--devices) is driven by main, after phases 14-15 and
    before the kernels line, with the shard and chunk counts the issue of
    the slice names."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    at = [src.index(s) for s in ("scale_out_phases(card)", "# ---- 16. --devices ----", "mesh_path_runs(",
                                 "mesh_fit_runs(", "mesh_population_fits(", "shards_kernel_checks(",
                                 'print(json.dumps({"kernels"')]
    assert at == sorted(at)
    assert "population_mesh_runs(" in inspect.getsource(chip_smoke.population_phase)
    assert chip_smoke.MESH_SHARDS == (1, 2, 3, 4, 8)
    assert chip_smoke.MESH_POP_SHARDS == (2, 4)
    assert chip_smoke.MESH_D_SHARDS == (1, 4, 8)
    assert chip_smoke.MESH_MANY_SHARDS > 32
    assert chip_smoke.FOLD_CHUNKS == (1, 2, 255, 256, 257, 973)


def test_mesh_counters_are_the_wrappers():
    from sid_tpu_torch.ops import lynch_objective as lo

    lo.NLL_SHARDS_LAUNCHES, lo.NLL_LAUNCHES = 3, 5
    assert chip_smoke.mesh_counters()["lynch_compound_nll_shards"] == 3
    assert chip_smoke.mesh_counters()["lynch_compound_nll"] == 5
    assert not {"lynch_fold", "lynch_compound_nll_partials"} & set(chip_smoke.mesh_counters())
    chip_smoke.reset_mesh_counters()
    assert set(chip_smoke.mesh_counters().values()) == {0}
    total = {"lynch_compound_nll_shards": 1}
    chip_smoke.add_launches(total, {"lynch_compound_nll_shards": 2, "lynch_records": 1})
    assert total == {"lynch_compound_nll_shards": 3, "lynch_records": 1}


def test_fold_row_of_the_kernels_line(monkeypatch):
    """The sharded objective's row (its launch folds the chunk sums in its
    last block) carries every key of the kernels line; on the CPU (plain
    versions, the timers stubbed, small histograms with deep rows) it runs
    its bitwise checks at every shard count."""
    import torch

    monkeypatch.setattr(chip_smoke, "event_times_ms", lambda torch, fn, sets, repeats=20: [(fn(*sets[0]), 1.0)[1]])
    monkeypatch.setattr(chip_smoke, "device_only_ms", lambda torch, launch, sets, **kw: (launch(*sets[0]), 1.0)[1])
    rng = np.random.default_rng(5)
    prof = rng.multinomial(30, [0.94, 0.03, 0.02, 0.01], 3000).astype(np.int32)
    prof[[5, 2900]] = [9000, 9000, 0, 0]
    mult = rng.integers(1, 100, 3000).astype(np.int64)
    sass = {"_ZN_lynch_nll_shards_kernel": {"f64": 238, "f64_all": 431}}
    row = chip_smoke.shards_kernel_checks(torch, torch.device("cpu"), "cpu", sass, prof, mult, prof[:2500],
                                          mult[:2500])
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    assert keys <= set(row)
    assert row["name"] == "lynch_compound_nll_shards" and row["route"] == "cuda"
    assert row["replaces"] == "sid_tpu/parallel/fit.py:29" and row["source"] == "sid_tpu_torch/csrc/lynch.cu"
    assert row["bound_by"] == "operations" and row["bound_ms"] == pytest.approx(238 * 2500 / (132 * 64 * 1.98e9) * 1e3)
    assert row["library_ms"] is None and row["shards"] == 4 and sorted(row["by_shards"]) == [1, 4, 8]
    # the launches are counted, not assumed: the plain version on the CPU launches nothing
    assert [r["launches_an_evaluation"] for r in row["by_shards"].values()] == [0, 0, 0]


@pytest.mark.parametrize("walls, want", [
    # (size, chunk) -> method -> (pipelined walls, monolithic walls)
    ({(1, 32): {"local": ([1.0], [1.1]), "quality": ([2.0], [2.1])},
      (9, 32): {"local": ([8.0], [9.0]), "quality": ([8.0], [9.0])}}, (1, 32)),
    ({(1, 32): {"local": ([1.0], [1.1]), "quality": ([2.2], [2.1])},
      (9, 32): {"local": ([8.0], [9.0]), "quality": ([8.5], [9.0])},
      (9, 128): {"local": ([7.0], [9.0]), "quality": ([8.0], [9.0])}}, (9, 128)),
    ({(1, 32): {"local": ([1.2, 1.0, 1.3], [1.1, 1.1, 1.1]), "quality": ([2.0], [2.1])}}, (None, None)),
], ids=["smallest-size", "faster-chunk", "nowhere"])
def test_pipeline_gate(walls, want):
    assert chip_smoke.pipeline_gate(walls) == want


def test_pipeline_counters_are_the_wrappers():
    from sid_tpu_torch.ops import local_classify as lc
    from sid_tpu_torch.ops import quality_finalize as qf

    lc.LRT_LAUNCHES, qf.LAUNCHES = 2, 7
    assert chip_smoke.pipeline_counters()["local_classify_lrt"] == 2
    assert chip_smoke.pipeline_counters()["quality_finalize"] == 7
    chip_smoke.reset_pipeline_counters()
    assert set(chip_smoke.pipeline_counters().values()) == {0}
    assert {chip_smoke.pipeline_kernel(m, e) for m in ("local", "quality") for e in (True, False)} == set(
        chip_smoke.pipeline_counters())


def test_phase_10b_runs_in_stream_phase():
    import inspect

    src = inspect.getsource(chip_smoke.stream_phase)
    assert src.index("engine._run_monolithic(big") < src.index("return pipeline_phase(card, workdir, qsrc, big)")
    assert "pipeline_launches = stream_phase(" in inspect.getsource(chip_smoke.main)
    assert chip_smoke.PIPE_CHUNKS == {chip_smoke.N_QUALITY: (32 << 20,),
                                      chip_smoke.N_STREAM: (32 << 20, 128 << 20)}


def test_pipeline_phase_on_the_cpu(monkeypatch, tmp_path):
    """Phase 10b at a tiny size on the CPU: the plain versions launch no
    kernel, so a call of the engine's call_batch stands for one launch; the
    larger file's run at the engine's chunk size goes through engine.run."""
    import torch

    from sid_tpu_torch import engine
    from sid_tpu_torch.config import Options

    monkeypatch.setattr(Options, "device", lambda self: torch.device("cpu"))
    calls = {}
    real_call = engine.call_batch

    def counting_call(batch, options, diag=None):
        kernel = chip_smoke.pipeline_kernel(options.method, options.exact_pvalues)
        calls[kernel] = calls.get(kernel, 0) + 1
        return real_call(batch, options, diag)

    runs = []
    real_run = engine.run
    monkeypatch.setattr(engine, "call_batch", counting_call)
    monkeypatch.setattr(engine, "run", lambda *a, **k: (runs.append(a[0]), real_run(*a, **k))[1])
    monkeypatch.setattr(chip_smoke, "pipeline_counters", lambda: {
        k: calls.get(k, 0) for k in ("local_log_likelihoods", "local_classify_lrt", "quality_finalize",
                                     "quality_finalize_lrt")})
    monkeypatch.setattr(chip_smoke, "reset_pipeline_counters", calls.clear)
    monkeypatch.setattr(chip_smoke, "N_QUALITY", 3_000)
    monkeypatch.setattr(chip_smoke, "N_STREAM", 8_000)
    monkeypatch.setattr(chip_smoke, "PIPE_CHUNKS", {3_000: (64 << 10,), 8_000: (64 << 10, 256 << 10)})
    monkeypatch.setattr(chip_smoke, "PIPE_BAD_LINE", 2_501)
    small, big = str(tmp_path / "small.pileup"), str(tmp_path / "big.pileup")
    chip_smoke.write_phred_pileup(small, 3_000, seed=8)
    size = chip_smoke.write_phred_pileup(big, 8_000, seed=20)
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", size)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", 256 << 10)
    launches = chip_smoke.pipeline_phase("cpu", str(tmp_path), small, big)
    n_small = chip_smoke.count_chunks(small, 64 << 10)
    n_big = [chip_smoke.count_chunks(big, c) for c in (64 << 10, 256 << 10)]
    per_method = 3 * (n_small + sum(n_big))
    assert n_small > 1 and n_big[1] > 1
    assert launches == {"local_log_likelihoods": per_method, "quality_finalize": per_method,
                        "local_classify_lrt": n_small, "quality_finalize_lrt": n_small}
    assert runs == [big] * 6
    assert sorted(os.listdir(tmp_path)) == ["big.pileup", "small.pileup"]


def test_phase_17_runs_in_main():
    """Phase 17 (the fit's loop on the card) is driven by main after phase
    16 and before the kernels line, and its row names B3."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    at = [src.index(s) for s in ("shards_kernel_checks(", "device_loop_phase(", "kernel_rows.append(fit_row)",
                                 'print(json.dumps({"kernels"')]
    assert at == sorted(at)
    assert '"replaces": "sid_tpu/ops/nmsimplex.py:287"' in inspect.getsource(chip_smoke.device_loop_phase)


def test_ulps_and_visits():
    a = np.array([1.0, 2.0, np.nan, -3.0])
    b = np.array([np.nextafter(1.0, 2.0), 2.0, np.nan, np.nextafter(np.nextafter(-3.0, -4.0), -4.0)])
    assert chip_smoke.ulps(a, b).tolist() == [1, 0, 0, 2]
    v = chip_smoke.Visits(3)
    f = v.lanes(lambda lanes, points: [float(k) for k in lanes])
    assert f([0, 2], [np.zeros(2), np.ones(2)]) == [0.0, 2.0]
    assert v.values == [[0.0], [], [2.0]] and len(v.points[2]) == 1
    g = chip_smoke.Visits(1).one(lambda x: 5.0)
    assert g(np.zeros(1)) == 5.0
