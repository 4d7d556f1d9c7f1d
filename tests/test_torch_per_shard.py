"""The port's ``--per-shard-fit`` vs sid_tpu's, on the CPU.

The counterpart of ``tests/test_parallel.py``'s per-shard tests:
per-chromosome semantics (the GNU-parallel fan-out of
scripts/sid-pipeline/parallel-run-sid.sh), the difference from a global
fit, the concatenated class payload; then CSV bytes and diagnostic lines
equal to ``sid_tpu``'s ``--per-shard-fit`` for every method (with and
without -R) under both engines, on a chromosome with no cov >= 4 site and
on an empty input; ``split_ranges`` for k = 1..5; and ``--stream``, which
ignores ``--per-shard-fit`` in both packages (``ROADMAP.md`` C9).

``sid_tpu``'s ``--per-shard-fit -m quality`` fails under the device
engine, whose parse keeps the quality terms and no reads
(``ROADMAP.md`` C10); there the port is held against the concatenation of
``sid_tpu``'s runs over each chromosome alone, which is what the option
means.
"""

import io

import numpy as np
import pytest

pytest.importorskip("torch")

from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.io.pileup import parse_pileup as ref_parse  # noqa: E402
from sid_tpu.parallel import pipeline as ref_pipeline  # noqa: E402
from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.parallel import pipeline  # noqa: E402
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402

CASES = {
    "local": dict(method="local"),
    "local_R": dict(method="local", estimate_prior=True),
    "bayes": dict(method="bayes"),
    "lr": dict(method="likelihood_ratio"),
    "lr_R": dict(method="likelihood_ratio", estimate_prior=True),
    "quality": dict(method="quality"),
    "quality_R": dict(method="quality", estimate_prior=True),
}


def chrom_texts():
    """chr1 and chr2 simulated with different (pi, eps), as
    tests/test_parallel.py:33-39."""
    c1 = simulate_diploid_counts(300, coverage=20, pi=0.02, eps=0.01, seed=1)
    c2 = simulate_diploid_counts(200, coverage=20, pi=0.05, eps=0.02, seed=2)
    return [make_pileup_text(c1, chrom="chr1", with_qualities=True),
            make_pileup_text(c2, chrom="chr2", with_qualities=True, seed=9)]


@pytest.fixture(scope="module")
def texts():
    return chrom_texts()


@pytest.fixture(scope="module")
def two_chrom(texts):
    return b"".join(texts)


@pytest.fixture(scope="module")
def two_chrom_batch(two_chrom):
    return parse_pileup(two_chrom, True, True, backend="python")


def run_port(src, engine_name="device", **kw):
    lines = []
    out = engine.run(src, Options(platform="cpu", engine=engine_name, **kw), lines.append, binary=True)
    return out, lines


def run_ref(src, engine_name="device", **kw):
    lines = []
    out = ref_engine.run(src, RefOptions(engine=engine_name, **kw), lines.append, binary=True)
    return out, lines


def per_chromosome_ref(texts, engine_name, **kw):
    """sid_tpu run on each chromosome alone, the CSVs concatenated."""
    outs, lines = zip(*(run_ref(t, engine_name, **kw) for t in texts))
    return outs[0] + b"".join(o.split(b"\n", 1)[1] for o in outs[1:]), [x for ls in lines for x in ls]


class TestPerShardFit:
    def test_per_chromosome_semantics(self, two_chrom_batch):
        opts = Options(platform="cpu", method="likelihood_ratio", per_shard_fit=True)
        merged = engine.call_batch(two_chrom_batch, opts).to_csv()
        shards = pipeline.split_by_chromosome(two_chrom_batch)
        opts1 = Options(platform="cpu", method="likelihood_ratio")
        parts = [engine.call_batch(s, opts1) for s in shards]
        assert merged == parts[0].to_csv() + parts[1].to_csv(include_header=False)

    def test_differs_from_global_fit(self, two_chrom_batch):
        global_csv = engine.call_batch(two_chrom_batch, Options(platform="cpu", method="bayes")).to_csv()
        per_shard_csv = engine.call_batch(
            two_chrom_batch, Options(platform="cpu", method="bayes", per_shard_fit=True)).to_csv()
        assert global_csv != per_shard_csv


class TestConcatPayload:
    def test_concat_keeps_indexed_class_payload(self, two_chrom_batch):
        shards = pipeline.split_by_chromosome(two_chrom_batch)
        opts = Options(platform="cpu", method="local")
        parts = [engine.call_batch(s, opts) for s in shards]
        merged = pipeline.concat_results(parts)
        assert merged.class_idx is not None
        assert merged.cls_is_het.shape[0] == sum(p.cls_is_het.shape[0] for p in parts)
        row_wise = "".join(p.to_csv(include_header=(i == 0)) for i, p in enumerate(parts))
        assert merged.to_csv() == row_wise
        np.testing.assert_array_equal(merged.cls_is_het[merged.class_idx], merged.is_het)

    def test_concat_without_payload_matches_sid_tpu(self, two_chrom, two_chrom_batch):
        parts = [engine.call_batch(s, Options(platform="cpu", method="quality"))
                 for s in pipeline.split_by_chromosome(two_chrom_batch)]
        assert all(p.class_idx is None for p in parts)
        merged = pipeline.concat_results(parts)
        ref_parts = [ref_engine.call_batch(s, RefOptions(method="quality"))
                     for s in ref_pipeline.split_by_chromosome(ref_parse(two_chrom, True, True, backend="python"))]
        assert merged.class_idx is None
        assert merged.to_csv_bytes() == ref_pipeline.concat_results(ref_parts).to_csv_bytes()


@pytest.mark.parametrize("engine_name", ["device", "exact"])
@pytest.mark.parametrize("case", list(CASES))
def test_csv_equals_sid_tpu_per_shard_fit(two_chrom, texts, case, engine_name):
    kw = CASES[case]
    got, got_lines = run_port(two_chrom, engine_name, per_shard_fit=True, **kw)
    if kw["method"] == "quality" and engine_name == "device":
        with pytest.raises(ValueError):  # C10: sid_tpu's shards have no terms and no reads
            run_ref(two_chrom, engine_name, per_shard_fit=True, **kw)
        want, want_lines = per_chromosome_ref(texts, engine_name, **kw)
    else:
        want, want_lines = run_ref(two_chrom, engine_name, per_shard_fit=True, **kw)
        assert (want, want_lines) == per_chromosome_ref(texts, engine_name, **kw)
    assert got == want
    assert got_lines == want_lines
    if kw["method"] in ("bayes", "likelihood_ratio") or kw.get("estimate_prior"):
        assert got != run_port(two_chrom, engine_name, **kw)[0]  # the fits are per chromosome


@pytest.mark.parametrize("case", ["local_R", "bayes", "lr_R", "quality_R"])
def test_chromosome_without_coverage_4(texts, case):
    """chr2 has no site of coverage >= 4: bayes and LR omit it, the fits
    of -R see no profile there."""
    thin = simulate_diploid_counts(50, coverage=2, pi=0.05, eps=0.02, seed=5)
    thin = thin[thin.sum(1) < 4]
    src = texts[0] + make_pileup_text(thin, chrom="chr2", with_qualities=True, seed=6)
    kw = CASES[case]
    got = run_port(src, per_shard_fit=True, **kw)
    if kw["method"] == "quality":
        want = per_chromosome_ref([texts[0], src[len(texts[0]):]], "device", **kw)
    else:
        want = run_ref(src, per_shard_fit=True, **kw)
    assert got == want


@pytest.mark.parametrize("case", ["local", "bayes", "lr_R", "quality"])
def test_empty_input(case):
    kw = CASES[case]
    assert run_port(b"", per_shard_fit=True, **kw) == run_ref(b"", per_shard_fit=True, **kw)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_split_ranges_match_sid_tpu(two_chrom, k):
    batch = parse_pileup(two_chrom, True, True, backend="python")
    ref_batch = ref_parse(two_chrom, True, True, backend="python")
    shards = pipeline.split_ranges(batch, k)
    ref_shards = ref_pipeline.split_ranges(ref_batch, k)
    assert len(shards) == len(ref_shards) == k
    for s, r in zip(shards, ref_shards):
        for f in ("chrom_id", "pos", "ref_base", "counts", "read_offsets", "read_code", "read_strand",
                  "read_bq", "read_mq"):
            np.testing.assert_array_equal(getattr(s, f), getattr(r, f), err_msg=f)
        assert s.chrom_table == r.chrom_table
    opts = Options(platform="cpu", method="local")
    merged = pipeline.concat_results([engine.call_batch(s, opts) for s in shards])
    assert merged.to_csv() == engine.call_batch(batch, opts).to_csv()


def test_slice_keeps_the_native_quality_terms(two_chrom):
    batch = parse_pileup(two_chrom, True, True, quality_terms_only=True)
    assert batch.read_offsets is None and batch.q_log_hom is not None
    idx = np.nonzero(batch.chrom_id == 1)[0]
    sub = pipeline._slice_batch(batch, idx)
    alone = parse_pileup(chrom_texts()[1], True, True, quality_terms_only=True)  # chr2 called alone
    for f in ("q_log_hom", "q_log_het", "q_major", "q_second", "counts", "pos"):
        np.testing.assert_array_equal(getattr(sub, f), getattr(alone, f), err_msg=f)


@pytest.mark.parametrize("case", ["bayes", "lr_R", "quality_R"])
def test_stream_ignores_per_shard_fit(two_chrom, case):
    """C9: sid_tpu's run_streaming never reads per_shard_fit, so the fit is
    global; the port writes the same bytes."""
    kw = CASES[case]
    buf, ref_buf = io.BytesIO(), io.BytesIO()
    engine.run_streaming(two_chrom, Options(platform="cpu", per_shard_fit=True, **kw), buf,
                         lambda _: None, chunk_bytes=1 << 12)
    ref_engine.run_streaming(two_chrom, RefOptions(per_shard_fit=True, **kw), ref_buf,
                             lambda _: None, chunk_bytes=1 << 12)
    assert buf.getvalue() == ref_buf.getvalue()
    assert buf.getvalue() == run_port(two_chrom, **kw)[0]
    assert buf.getvalue() != run_port(two_chrom, per_shard_fit=True, **kw)[0]


def test_per_shard_options_reach_each_shard(two_chrom_batch):
    seen = []

    def call_one(batch, options, diag):
        seen.append((batch.chrom_table[int(batch.chrom_id[0])], options.per_shard_fit))
        return engine.call_batch(batch, options, diag)

    opts = Options(platform="cpu", method="local", per_shard_fit=True)
    pipeline.call_per_shard(two_chrom_batch, opts, call_one)
    assert seen == [("chr1", False), ("chr2", False)]
    assert opts.per_shard_fit
