"""The port's downstream tools vs sid_tpu's, on the CPU.

The counterpart of ``tests/test_tools.py`` on ``sid_tpu_torch.tools``:
codon translation over all 64 codons, codon windows, exon lookup; then the
whole pipeline (call -> raw.csv.gz -> snps.csv -> exon filter -> nonsyn
labels) against ``sid_tpu.tools.pipeline`` on the same two-chromosome
input, with and without ``--per-chromosome`` (the port's
``--per-shard-fit``) and from gzip input: every artifact equal, the gzip
CSV compared decompressed (its header carries gzip's mtime). Last, the
``SIDTPU_TRACE`` hook writes a ``torch.profiler`` trace, alone and around
a CLI run under ``--profile``.
"""

import gzip
import io
import json
import os
import sys

import pytest

pytest.importorskip("torch")

from sid_tpu.tools import exons as ref_exons  # noqa: E402
from sid_tpu.tools import nonsynonymous as ref_ns  # noqa: E402
from sid_tpu.tools import pipeline as ref_pipeline  # noqa: E402
from sid_tpu_torch.tools import exons  # noqa: E402
from sid_tpu_torch.tools import nonsynonymous as ns  # noqa: E402
from sid_tpu_torch.tools import pipeline  # noqa: E402
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402
from test_tools import STANDARD_CODE, make_raw_csv  # noqa: E402

EXON_HEADER = "chrom,start,end,strand,phase,end_phase,exon_id,gene_id,biotype,coding_start,coding_end\n"


class TestTranslate:
    def test_all_64_codons(self):
        for codon, aa in STANDARD_CODE.items():
            assert ns.translate(codon) == aa == ref_ns.translate(codon), codon

    def test_invalid_codon(self):
        for bad in ("AXG", "AC"):
            with pytest.raises(ValueError):
                ns.translate(bad)

    def test_reverse_complement(self):
        assert ns.reverse_complement(["AC", "GG", "TT"]) == ["AA", "CC", "TG"]
        assert ns.reverse_complement(["A", "T", "G"]) == ["C", "A", "T"]

    def test_all_combinations(self):
        assert ns.all_combinations(["AC", "G", "T"]) == [("A", "G", "T"), ("C", "G", "T")]


@pytest.mark.parametrize("args", [
    ("1", 105, "g", 100, 200, 1, 1, -1), ("1", 105, "g", 100, 200, 1, -1, 2), ("1", 105, "g", 100, 200, 1, -1, -1),
    ("1", 105, "g", 100, 200, -1, 1, -1), ("1", 105, "g", 100, 200, -1, -1, 2), ("1", 105, "g", 100, 200, -1, -1, -1),
    ("1", 105, "g", 100, 200, 0, 1, -1),
])
def test_site_phase_matches_sid_tpu(args):
    assert ns.site_phase_from_exon(*args) == ref_ns.site_phase_from_exon(*args)


@pytest.mark.parametrize("genotypes,records", [
    (["AA", "CC", "GG", "TT", "AA", "CC"], [("1", 102, "gene1", 0, 1)]),
    (["AA", "CC", "GG", "TT", "AA", "CC"], [("1", 102, "gene1", 2, 1)]),
    (["AA", "CG", "TT", "AA", "CC"], [("1", 101, "gene1", 1, 1)]),
    (["AA", "CC", "GG", "TT", "AA"], [("1", 102, "gene1", 0, -1)]),
    (["AA", "CC", "GG", "TT", "AA"], [("1", 102, "geneA", 0, 1), ("1", 102, "geneB", 0, 1)]),
    (["AA", "CC", "GG", "TT", "AA"], [("1", 99, "ghost", 0, 1), ("1", 102, "gene1", 0, 1)]),
    (["AC", "CC"], [("1", 100, "edge", 0, 1)]),
], ids=["phase0", "phase2", "het-nonsyn", "reverse", "duplicates", "unmatched", "truncated"])
def test_site_codons_match_sid_tpu(genotypes, records):
    raw = make_raw_csv(genotypes)
    got = list(ns.generate_site_codons(io.StringIO(raw), [ns.SitePhase(*r) for r in records]))
    want = list(ref_ns.generate_site_codons(io.StringIO(raw), [ref_ns.SitePhase(*r) for r in records]))
    assert [tuple(g) for g in got] == [tuple(w) for w in want]
    assert [ns.format_record(g) for g in got] == [ref_ns.format_record(w) for w in want]


class TestExonTable:
    ROWS = [
        ("1", 100, 200, 1, 0, -1, "e1", "g1", "protein_coding", 110, 190),
        ("1", 300, 400, -1, 1, 2, "e2", "g2", "protein_coding", 300, 400),
        ("2", 100, 200, 1, 0, -1, "e3", "g3", "protein_coding", 100, 200),
    ]

    def test_lookup_respects_coding_bounds(self):
        t = exons.ExonTable([exons.Exon(*r) for r in self.ROWS])
        assert [e.exon_id for e in t.lookup("1", 150)] == ["e1"]
        assert t.lookup("1", 105) == [] and t.lookup("1", 250) == [] and t.lookup("3", 150) == []
        assert [e.exon_id for e in t.lookup("1", 350)] == ["e2"]

    def test_annotate_matches_sid_tpu(self):
        sites = [("1", 150), ("1", 250), ("1", 350), ("2", 100)]
        got, want = io.StringIO(), io.StringIO()
        n = exons.annotate_sites(sites, exons.ExonTable([exons.Exon(*r) for r in self.ROWS]), got)
        ref_exons.annotate_sites(sites, ref_exons.ExonTable([ref_exons.Exon(*r) for r in self.ROWS]), want)
        assert n == 3 and got.getvalue() == want.getvalue()

    def test_sites_from_snp_csv(self):
        data = "# fit\nchrom,pos,label,gt,hom_conf,het_conf,conf_type\n1,5,het,AC,1,0,p_value\n"
        assert list(exons.sites_from_snp_csv(io.StringIO(data))) == [("1", 5)]

    def test_mysql_lookup_without_connector_raises(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "mysql", None)  # the import fails, as without the package
        with pytest.raises(RuntimeError, match="mysql-connector is not installed"):
            exons.ensembl_mysql_lookup([("1", 5)], io.StringIO())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    text = b"".join(
        make_pileup_text(simulate_diploid_counts(250, coverage=25, pi=pi, eps=eps, seed=seed), chrom=chrom)
        for chrom, pi, eps, seed in (("chr1", 0.1, 0.005, 21), ("chr2", 0.03, 0.02, 22)))
    (d / "in.plp").write_bytes(text)
    (d / "in.plp.gz").write_bytes(gzip.compress(text))
    (d / "exons.csv").write_text(
        EXON_HEADER
        + "chr1,1,200,1,0,-1,e1,g1,protein_coding,1,200\n"
        + "chr2,20,180,-1,1,-1,e2,g2,protein_coding,30,170\n")
    return d


@pytest.mark.parametrize("per_chromosome", [False, True], ids=["global", "per-chromosome"])
@pytest.mark.parametrize("name", ["in.plp", "in.plp.gz"])
def test_pipeline_matches_sid_tpu(inputs, tmp_path, name, per_chromosome):
    kw = dict(method="likelihood_ratio", estimate_prior=True, per_chromosome=per_chromosome,
              exon_table=str(inputs / "exons.csv"))
    got_diag, want_diag = [], []
    got = pipeline.run_pipeline(str(inputs / name), str(tmp_path / "port"), diag=got_diag.append,
                                platform="cpu", **kw)
    want = ref_pipeline.run_pipeline(str(inputs / name), str(tmp_path / "ref"), diag=want_diag.append, **kw)
    assert {k: v for k, v in got.items() if k.startswith("n_")} == {
        k: v for k, v in want.items() if k.startswith("n_")}
    assert got["n_snps"] > 0 and got["n_exonic"] > 0 and got["n_labeled"] > 0
    assert got_diag == want_diag
    assert gzip.decompress(open(got["raw"], "rb").read()) == gzip.decompress(open(want["raw"], "rb").read())
    for key in ("snps", "exon_snps", "nonsyn"):
        assert open(got[key], "rb").read() == open(want[key], "rb").read(), key


def test_per_chromosome_differs_from_global(inputs, tmp_path):
    raws = [gzip.decompress(open(pipeline.run_pipeline(
        str(inputs / "in.plp"), str(tmp_path / str(pc)), per_chromosome=pc, diag=lambda _: None,
        platform="cpu")["raw"], "rb").read()) for pc in (False, True)]
    assert raws[0] != raws[1]


def test_pipeline_cli_matches_sid_tpu(inputs, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("SIDTPU_PLATFORM", "cpu")
    args = [str(inputs / "in.plp"), "--per-chromosome", "--exon-table", str(inputs / "exons.csv")]
    assert pipeline.main([*args, "--workdir", str(tmp_path / "port")]) == 0
    assert ref_pipeline.main([*args, "--workdir", str(tmp_path / "ref")]) == 0
    for name in ("snps.csv", "exon_snps.csv", "nonsynonymous_exon_snps.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_extract_snps_matches_sid_tpu(tmp_path):
    raw = tmp_path / "raw.csv"
    raw.write_text(make_raw_csv(["AA", "AC", "GG", "GT", "TT"]))
    assert pipeline.extract_snps(str(raw), str(tmp_path / "a")) == 2
    ref_pipeline.extract_snps(str(raw), str(tmp_path / "b"))
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_sidtpu_trace_writes_a_torch_profiler_trace(tmp_path, monkeypatch):
    import torch

    from sid_tpu_torch.utils.profiling import StageProfile

    monkeypatch.setenv("SIDTPU_TRACE", str(tmp_path / "trace"))
    prof = StageProfile()
    prof.start_device_trace()
    torch.arange(1000, dtype=torch.float64).sum()
    path = prof.stop_device_trace()
    assert os.path.dirname(path) == str(tmp_path / "trace")
    assert "traceEvents" in json.load(open(path))
    assert prof.stop_device_trace() is None
    monkeypatch.delenv("SIDTPU_TRACE")
    quiet = StageProfile()
    quiet.start_device_trace()
    assert quiet.stop_device_trace() is None


@pytest.mark.parametrize("profile", [True, False], ids=["profile", "no_profile"])
def test_cli_profile_writes_trace(tmp_path, monkeypatch, capsys, profile):
    """Under ``--profile`` the CLI brackets its run with the trace hook:
    with SIDTPU_TRACE set, one trace file, named on stderr; without
    ``--profile``, none."""
    from sid_tpu_torch import cli

    src = tmp_path / "in.pileup"
    src.write_bytes(make_pileup_text(simulate_diploid_counts(200, coverage=18, pi=0.03, eps=0.01)))
    trace = tmp_path / "trace"
    monkeypatch.setenv("SIDTPU_TRACE", str(trace))
    argv = ["--platform", "cpu", "--output", str(tmp_path / "out.csv"), str(src)]
    assert cli.main(["--profile"] + argv if profile else argv) == 0
    err = capsys.readouterr().err
    files = sorted(trace.iterdir()) if trace.exists() else []
    assert len(files) == int(profile)
    if profile:
        assert f"# trace: {files[0]}" in err
        assert "traceEvents" in json.load(open(files[0]))
