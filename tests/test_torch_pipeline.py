"""The port's chunk pipeline vs its monolithic run and sid_tpu's pipeline,
and the file's line number on every chunked parse (ROADMAP C15), on the CPU.

The counterpart of ``tests/test_pipeline_overlap.py``: the gate and the
chunk size are set to 1 MB (``engine.PIPELINE_MIN_BYTES`` and
``PIPELINE_CHUNK_BYTES`` here, ``SIDTPU_PIPELINE_MB`` and
``SIDTPU_PIPELINE_CHUNK_MB`` for sid_tpu) over a grammar-rich ~3 MB input,
so the pipeline runs several chunks. Its output must be byte-equal to the
port's monolithic run and to sid_tpu's pipeline for ``local`` and
``quality`` from bytes, a path and a ``.gz`` path, under both
``exact_pvalues`` settings; text mode, empty input, one-site and empty
chunks, the eligibility rules and ``--profile``'s total are checked too.

C15: a malformed line 20,001 of that input is reported as line 20001 by
the pipeline, both passes of ``run_streaming``, population streaming, the
``--multihost`` byte ranges and the CLI, where sid_tpu's chunked paths
report the line within the chunk that holds it.
"""

import gzip
import io
import os

import pytest

pytest.importorskip("torch")

from sid_tpu import cli as ref_cli  # noqa: E402
from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.models import population as ref_population  # noqa: E402
from sid_tpu.parallel import distributed as ref_distributed  # noqa: E402
from sid_tpu.utils.errors import SidParseError as RefParseError  # noqa: E402
from sid_tpu_torch import cli, engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io import stream  # noqa: E402
from sid_tpu_torch.models import population  # noqa: E402
from sid_tpu_torch.parallel import distributed  # noqa: E402
from sid_tpu_torch.utils import profiling  # noqa: E402
from sid_tpu_torch.utils.errors import SidParseError  # noqa: E402
from synth import make_bwa_like_pileup_scaled  # noqa: E402

MB = 1 << 20
HEADER = b"chrom,pos,label,gt,hom_conf,het_conf,conf_type\n"
BAD_LINE = 20_001


@pytest.fixture(scope="module")
def big_text():
    # ~25k grammar-rich sites (~3 MB, 1.7 MB gzipped): indels, ^X/$
    # markers, '*', N refs, Phred variance; three 1 MB chunks
    text = make_bwa_like_pileup_scaled(25_000)
    assert len(text) > 2 * MB and len(gzip.compress(text)) > MB
    return text


@pytest.fixture(scope="module")
def bad_text(big_text):
    lines = big_text.split(b"\n")
    lines[BAD_LINE - 1] = b"not a pileup line"
    return b"\n".join(lines)


@pytest.fixture()
def gate_1mb(monkeypatch):
    """Both packages' pipelines at a 1 MB gate and 1 MB chunks."""
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", MB)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", MB)
    monkeypatch.setenv("SIDTPU_PIPELINE_MB", "1")
    monkeypatch.setenv("SIDTPU_PIPELINE_CHUNK_MB", "1")


def _source(kind, text, tmp_path):
    if kind == "bytes":
        return text
    if kind == "path":
        path = tmp_path / "in.pileup"
        path.write_bytes(text)
    else:
        path = tmp_path / "in.pileup.gz"
        path.write_bytes(gzip.compress(text))
    return str(path)


def _profiled(fn):
    """(fn(), the stage profile it recorded)."""
    prof = profiling.StageProfile()
    profiling.activate(prof)
    try:
        return fn(), prof
    finally:
        profiling.activate(None)


def _stage_names(prof):
    return [name for name, _ in prof.stages]


def _chunk_line(text: bytes, line: int, chunk_bytes: int, start: int = 0) -> int:
    """The number of ``line`` (of ``text``) within the newline-aligned
    chunk that holds it, chunks cut as ``iter_chunks`` cuts them from byte
    ``start`` on: what a parse of that chunk alone reports."""
    before = text[:start].count(b"\n")
    for chunk in stream.iter_chunks(text[start:], chunk_bytes):
        n = chunk.count(b"\n")
        if line - before <= n:
            return line - before
        before += n
    raise AssertionError("line past the end")


@pytest.mark.parametrize("exact_pvalues", [True, False], ids=["host-lrt", "device-lrt"])
@pytest.mark.parametrize("kind", ["bytes", "path", "gz"])
@pytest.mark.parametrize("method", ["local", "quality"])
def test_pipelined_byte_equal(big_text, gate_1mb, tmp_path, method, kind, exact_pvalues):
    src = _source(kind, big_text, tmp_path)
    opts = Options(platform="cpu", method=method, exact_pvalues=exact_pvalues)
    got, prof = _profiled(lambda: engine.run(src, opts, binary=True))
    names = _stage_names(prof)
    assert "pipeline" in names and "parse" not in names
    assert names.count("pipeline:call") == 3  # one call a chunk
    want = engine._run_monolithic(src, opts, None, True)
    assert got == want
    ref_opts = RefOptions(method=method, exact_pvalues=exact_pvalues)
    size = len(src) if isinstance(src, bytes) else os.path.getsize(src)
    assert ref_engine._pipeline_eligible(ref_opts, size)
    assert got == ref_engine.run(src, ref_opts, binary=True)


@pytest.mark.parametrize("method", ["local", "quality"])
def test_pipelined_text_mode(big_text, gate_1mb, method):
    opts = Options(platform="cpu", method=method)
    got = engine.run(big_text, opts)
    assert isinstance(got, str) and got.encode() == engine._run_monolithic(big_text, opts, None, True)
    assert got == ref_engine.run(big_text, RefOptions(method=method))


def test_pipelined_empty_input(monkeypatch):
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 0)
    opts = Options(platform="cpu")
    assert engine._pipeline_eligible(opts, 0)
    assert engine.run(b"", opts, binary=True) == HEADER
    assert engine.run(b"", opts) == HEADER.decode()


@pytest.mark.parametrize("method", ["local", "quality"])
def test_one_site_and_empty_chunks(monkeypatch, method):
    """1-byte chunks: every site in a chunk of its own, and the blank
    lines in chunks with no site, which add nothing."""
    lines = make_bwa_like_pileup_scaled(40, seed=7).split(b"\n")
    text = b"\n".join(lines[:10] + [b"", b""] + lines[10:20] + [b""] + lines[20:])
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 0)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", 1)
    opts = Options(platform="cpu", method=method)
    got, prof = _profiled(lambda: engine.run(text, opts, binary=True))
    assert _stage_names(prof).count("pipeline:call") == 40
    assert _stage_names(prof).count("pipeline:parse_wait") == 43
    assert got == engine._run_monolithic(text, opts, None, True)
    assert got == ref_engine.run(text, RefOptions(method=method), binary=True)


@pytest.mark.parametrize("case, eligible", [
    ({}, True),
    ({"method": "quality"}, True),
    ({"method": "bayes"}, False),
    ({"method": "likelihood_ratio"}, False),
    ({"estimate_prior": True}, False),
    ({"method": "quality", "estimate_prior": True}, False),
    ({"engine": "exact"}, False),
    ({"per_shard_fit": True}, False),
    ({"mesh_devices": 1}, True),
], ids=["local", "quality", "bayes", "lr", "R", "quality-R", "exact", "per-shard-fit", "devices"])
def test_eligibility(gate_1mb, case, eligible):
    assert engine._pipeline_eligible(Options(**case), MB) is eligible
    assert engine._pipeline_eligible(Options(**case), MB - 1) is False
    assert ref_engine._pipeline_eligible(RefOptions(**case), MB) is eligible


def test_file_object_stays_monolithic(big_text, gate_1mb):
    opts = Options(platform="cpu")
    got, prof = _profiled(lambda: engine.run(io.BytesIO(big_text), opts, binary=True))
    assert _stage_names(prof)[:1] == ["parse"] and "pipeline" not in _stage_names(prof)
    assert got == engine.run(big_text, opts, binary=True)


@pytest.mark.parametrize("method", ["local", "quality"])
def test_profile_total_is_the_pipeline_stage(big_text, gate_1mb, method):
    """``total()`` is the top-level stages: the pass and the join after it."""
    _, prof = _profiled(lambda: engine.run(big_text, Options(platform="cpu", method=method), binary=True))
    (pipeline,) = [s for name, s in prof.stages if name == "pipeline"]
    (join,) = [s for name, s in prof.stages if name == "join"]
    assert prof.total() == pipeline + join
    nested = {}
    for name, s in prof.stages:
        if name.startswith("pipeline:"):
            nested[name] = nested.get(name, 0.0) + s
    assert sorted(nested) == ["pipeline:call", "pipeline:parse_wait", "pipeline:read", "pipeline:serialize"]
    assert sum(nested.values()) <= pipeline


# ---- the pipeline's spans, by their records ----

CHUNKS = 3  # big_text in 1 MB chunks
LEAVES = ("pipeline:read", "pipeline:parse_wait", "pipeline:call", "pipeline:serialize")


@pytest.fixture(scope="module", params=["local", "quality"])
def traced(request, big_text, tmp_path_factory):
    """One pipelined run of big_text from a path at 1 MB chunks: (the
    profile, its ``pipeline`` span, the method)."""
    path = tmp_path_factory.mktemp("spans") / "in.pileup"
    path.write_bytes(big_text)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "PIPELINE_MIN_BYTES", MB)
        mp.setattr(engine, "PIPELINE_CHUNK_BYTES", MB)
        _, prof = _profiled(lambda: engine.run(str(path), Options(platform="cpu", method=request.param),
                                               binary=True))
    (pipeline,) = [s for s in prof.spans if s.name == "pipeline"]
    return prof, pipeline, request.param


def _named(prof, name):
    return [s for s in prof.spans if s.name == name]


def test_a_read_and_a_parse_a_chunk(traced):
    """One ``worker:parse`` a chunk; one ``pipeline:read`` a chunk, and
    the one more that finds the input's end."""
    prof, _, _ = traced
    assert len(_named(prof, "worker:parse")) == CHUNKS
    assert len(_named(prof, "pipeline:read")) == CHUNKS + 1
    assert len(_named(prof, "pipeline:call")) == CHUNKS


def test_worker_parse_hangs_under_pipeline_on_another_thread(traced):
    prof, pipeline, _ = traced
    for parse in _named(prof, "worker:parse"):
        assert parse.parent == pipeline.id and parse.thread != pipeline.thread
        assert parse.request == pipeline.request
        assert pipeline.start_ns <= parse.start_ns <= parse.end_ns <= pipeline.end_ns


def test_dedup_and_gather_inside_each_call(traced):
    """``local`` dedups and gathers once a call; ``quality`` calls each
    site and does neither."""
    prof, pipeline, method = traced
    each = 1 if method == "local" else 0
    for call in _named(prof, "pipeline:call"):
        assert call.parent == pipeline.id
        for name in ("call:unique_profiles", "call:gather_result"):
            inner = [s for s in _named(prof, name) if s.parent == call.id]
            assert len(inner) == each
            assert all(s.thread == call.thread and call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
                       for s in inner)
    assert len(_named(prof, "call:unique_profiles")) == len(_named(prof, "call:gather_result")) == each * CHUNKS


def test_join_once_after_pipeline(traced):
    prof, pipeline, _ = traced
    (join,) = _named(prof, "join")
    assert join.parent is None and join.thread == pipeline.thread
    assert join.start_ns >= pipeline.end_ns
    assert {s.request for s in prof.spans} == {pipeline.request}  # one request


def test_output_written_in_place(traced):
    """A growth of the request's output a chunk, each chunk's part filled
    in place (``local``) or, from the per-site writer, copied in
    (``quality``); ``--profile``'s report lists the three counters."""
    prof, _, method = traced
    written = prof.counters["serialize:bytes"]
    copied = written if method == "quality" else 0
    assert prof.counters["serialize:resizes"] == CHUNKS
    assert prof.counters["serialize:copied_bytes"] == copied
    assert prof.counters["serialize:in_place_bytes"] == written - copied
    report = prof.report()
    assert f"# serialize:copied_bytes: {int(copied):,}" in report.splitlines()
    assert f"# serialize:resizes: {CHUNKS}" in report.splitlines()


def test_main_thread_leaves_in_order(traced):
    """This thread reads the first chunk and the next, then, a chunk at a
    time, waits for its parse, calls, serializes and reads again (the
    last read finds the end)."""
    prof, pipeline, _ = traced
    leaves = sorted((s for s in prof.spans if s.parent == pipeline.id and s.thread == pipeline.thread),
                    key=lambda s: s.start_ns)
    names = [s.name for s in leaves]
    assert names == ["pipeline:read"] + ["pipeline:read", "pipeline:parse_wait", "pipeline:call",
                                         "pipeline:serialize"] * CHUNKS
    assert names[-1] != "pipeline:read" and set(names) == set(LEAVES)
    assert all(a.end_ns <= b.start_ns for a, b in zip(leaves, leaves[1:]))


def test_sites_counted_where_parsed(traced, big_text):
    prof, _, _ = traced
    assert prof.counters["sites"] == len(big_text.splitlines())


# ---- C15: the file's line number on every chunked parse ----


def _raises_line(fn, error=SidParseError) -> int:
    with pytest.raises(error) as e:
        fn()
    return e.value.line_number


def test_parse_chunk_counts_lines_only_on_error(bad_text):
    offset = bad_text.index(b"not a pileup line")
    chunk = bad_text[offset:offset + 1000]
    chunk = chunk[: chunk.rindex(b"\n") + 1]
    assert _raises_line(lambda: stream.parse_chunk(bad_text, offset, chunk)) == BAD_LINE
    assert stream.lines_before(bad_text, offset) == BAD_LINE - 1
    assert stream.lines_before(gzip.compress(bad_text), offset) == BAD_LINE - 1
    assert stream.parse_chunk(bad_text, 0, bad_text[:offset]).num_sites == BAD_LINE - 1


@pytest.mark.parametrize("method", ["local", "quality"])
def test_pipeline_reports_the_files_line(bad_text, gate_1mb, tmp_path, method):
    path = _source("path", bad_text, tmp_path)
    assert _raises_line(lambda: engine.run(path, Options(platform="cpu", method=method))) == BAD_LINE
    assert _raises_line(lambda: engine.run(bad_text, Options(platform="cpu", method=method))) == BAD_LINE
    ref = _raises_line(lambda: ref_engine.run(path, RefOptions(method=method)), RefParseError)
    assert ref == _chunk_line(bad_text, BAD_LINE, MB) == 2077


@pytest.mark.parametrize("kw", [{}, {"method": "likelihood_ratio", "estimate_prior": True}, {"method": "quality"}],
                         ids=["local", "lr-R", "quality"])
def test_run_streaming_reports_the_files_line(bad_text, tmp_path, kw):
    """``local`` and ``likelihood_ratio`` meet the line in pass 1's
    histogram, ``quality`` (no pass 1 without -R) in pass 2."""
    path = _source("path", bad_text, tmp_path)
    opts = Options(platform="cpu", **kw)
    assert _raises_line(lambda: engine.run_streaming(path, opts, io.BytesIO(), chunk_bytes=MB)) == BAD_LINE
    ref = _raises_line(lambda: ref_engine.run_streaming(path, RefOptions(**kw), io.BytesIO(), chunk_bytes=MB),
                       RefParseError)
    assert ref == _chunk_line(bad_text, BAD_LINE, MB) == 2077


def test_run_streaming_pass_2_reports_the_files_line(big_text, tmp_path):
    """A line that only pass 2 rejects (no quality columns, -R -m quality:
    pass 1 parses counts alone), in the last chunk."""
    lines = big_text.split(b"\n")
    lines[BAD_LINE - 1] = b"\t".join(lines[BAD_LINE - 1].split(b"\t")[:5])
    path = _source("path", b"\n".join(lines), tmp_path)
    kw = {"method": "quality", "estimate_prior": True}
    got = _raises_line(lambda: engine.run_streaming(path, Options(platform="cpu", **kw), io.BytesIO(),
                                                    chunk_bytes=MB))
    assert got == BAD_LINE
    ref = _raises_line(lambda: ref_engine.run_streaming(path, RefOptions(**kw), io.BytesIO(), chunk_bytes=MB),
                       RefParseError)
    assert ref == _chunk_line(b"\n".join(lines), BAD_LINE, MB) != BAD_LINE


@pytest.mark.parametrize("method, strip_qualities", [("bayes", False), ("quality", True)],
                         ids=["bayes-pass-1", "quality-pass-2"])
def test_population_streaming_reports_the_files_line(big_text, tmp_path, method, strip_qualities):
    """The second sample holds the bad line: a malformed line (pass 1's
    histogram parse) or one without quality columns, which only pass 2's
    quality parse rejects."""
    lines = big_text.split(b"\n")
    bad = lines[BAD_LINE - 1]
    lines[BAD_LINE - 1] = b"\t".join(bad.split(b"\t")[:5]) if strip_qualities else b"not a pileup line"
    texts = [big_text, b"\n".join(lines)]
    got = {}
    for name, run, opts, error in (
            ("port", population.call_population_streaming, Options(platform="cpu", method=method), SidParseError),
            ("ref", ref_population.call_population_streaming, RefOptions(method=method), RefParseError)):
        paths = []
        for k, t in enumerate(texts):
            p = tmp_path / f"{name}{k}.pileup"
            p.write_bytes(t)
            paths.append(str(p))
        got[name] = _raises_line(lambda: run(paths, opts, "pooled", None, MB), error)
    assert got["port"] == BAD_LINE
    assert got["ref"] == _chunk_line(texts[1], BAD_LINE, MB) != BAD_LINE


@pytest.mark.parametrize("method", ["local", "quality"], ids=["local-pass-1", "quality-pass-2"])
def test_multihost_range_reports_the_files_line(bad_text, tmp_path, method):
    """One process, four byte ranges: the bad line lies in a range that
    starts after line 1 (no peer waits in the all-gather)."""
    path = _source("path", bad_text, tmp_path)
    ranges = distributed.byte_ranges(path, 4)
    start = next(s for s, e in ranges if s <= bad_text.index(b"not a pileup line") < e)
    assert start > 0
    out = str(tmp_path / "out.csv")
    got = _raises_line(lambda: distributed.run_multihost(
        path, Options(platform="cpu", method=method, chunk_mb=1), out, ranges_per_process=4))
    assert got == BAD_LINE
    ref = _raises_line(lambda: ref_distributed.run_multihost(
        path, RefOptions(method=method, chunk_mb=1), out, ranges_per_process=4), RefParseError)
    assert ref == _chunk_line(bad_text, BAD_LINE, MB, start) != BAD_LINE


@pytest.mark.parametrize("args", [["--stream", "--chunk-mb", "1"], []], ids=["stream", "pipeline"])
def test_cli_reports_the_files_line(bad_text, gate_1mb, tmp_path, capsys, args):
    """sid_tpu's CLI prints the chunk's line from the pipeline; under
    ``--stream`` it lets the error out uncaught (a traceback, exit 1)."""
    path = _source("path", bad_text, tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", "cpu", *args, path])
    assert e.value.code == 1
    assert capsys.readouterr().err.endswith(f"(line {BAD_LINE})\n")
    want = _chunk_line(bad_text, BAD_LINE, MB)
    if args:
        assert _raises_line(lambda: ref_cli.main([*args, path]), RefParseError) == want
        return
    with pytest.raises(SystemExit) as e:
        ref_cli.main([*args, path])
    assert e.value.code == 1
    assert capsys.readouterr().err.endswith(f"(line {want})\n")
