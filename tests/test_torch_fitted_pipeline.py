"""The port's fitted chunk pipeline (``engine._run_fitted_pipeline``:
``bayes`` and ``likelihood_ratio`` on chunks, one fit between two passes)
against its monolithic run and sid_tpu's run, on the CPU.

The gate and the chunk size are ``test_torch_pipeline.py``'s 1 MB over
its grammar-rich ~3 MB input (three chunks). The CSV and the ``diag``
lines must be byte-equal to ``engine._run_monolithic``'s and to
``sid_tpu.engine.run``'s (which calls these methods monolithic) for
``likelihood_ratio`` with and without -R, under both ``exact_pvalues``
settings, and for ``bayes``, from bytes and a path, in binary and text
mode; the fit must get the monolithic path's rows and weights; a profile
found in one chunk only, a chunk whose every profile has coverage < 4,
chunks without sites, empty input and a parse error are covered; so are
the routing rule, the spans (names, order, nesting, one ``worker:parse``
a chunk, the main thread's leaves covering the request's wall), the
counters in ``--profile``'s report, ``host:lrt_bh`` on the other
``likelihood_ratio`` paths, and the benchmark's reference check on its
own traffic.
"""

import io
import json
import os
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from gpubench import harness  # noqa: E402
from gpubench.reference import check, pileup  # noqa: E402
from gpubench.traffic import generate  # noqa: E402
from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu_torch import cli, engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io import stream  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import likelihood_ratio  # noqa: E402
from sid_tpu_torch.ops.profiles import coverage_of, unique_profiles  # noqa: E402
from sid_tpu_torch.utils import profiling  # noqa: E402
from sid_tpu_torch.utils.errors import SidParseError  # noqa: E402
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402
from test_torch_pipeline import BAD_LINE, HEADER, MB, bad_text, big_text, gate_1mb  # noqa: E402,F401

CHUNKS = 3  # big_text in 1 MB chunks
FITTED = {
    "lr-R": {"method": "likelihood_ratio", "estimate_prior": True},
    "lr": {"method": "likelihood_ratio"},
    "lr-R-device-lrt": {"method": "likelihood_ratio", "estimate_prior": True, "exact_pvalues": False},
    "lr-device-lrt": {"method": "likelihood_ratio", "exact_pvalues": False},
    "bayes": {"method": "bayes"},
}


def _options(case, **kw):
    return Options(platform="cpu", fit_backend="device", **FITTED[case], **kw)


def _sid_tpu(src, case, binary=True, **kw):
    """sid_tpu's run of ``src`` under the same options: (its CSV, its diag
    lines)."""
    diag = []
    out = ref_engine.run(src, RefOptions(platform="cpu", fit_backend="device", **FITTED[case], **kw), diag.append,
                         binary=binary)
    return out, diag


def _profiled(fn):
    """(fn(), the stage profile it recorded)."""
    prof = profiling.StageProfile()
    profiling.activate(prof)
    try:
        return fn(), prof
    finally:
        profiling.activate(None)


def _runs(src, opts, binary=True):
    """(the fitted run's CSV, diag and profile; the monolithic run's CSV
    and diag)."""
    got_diag, want_diag = [], []
    got, prof = _profiled(lambda: engine.run(src, opts, got_diag.append, binary))
    want = engine._run_monolithic(src, opts, want_diag.append, binary)
    return got, got_diag, prof, want, want_diag


def _names(prof):
    return [s.name for s in prof.spans]


@pytest.mark.parametrize("kind", ["bytes", "path"])
@pytest.mark.parametrize("case", sorted(FITTED))
def test_fitted_byte_equal(big_text, gate_1mb, tmp_path, case, kind):
    src = big_text
    if kind == "path":
        src = str(tmp_path / "in.pileup")
        with open(src, "wb") as f:
            f.write(big_text)
    got, got_diag, prof, want, want_diag = _runs(src, _options(case))
    names = _names(prof)
    assert "pipeline" in names and "parse" not in names and "call" not in names
    assert names.count("pipeline:dedup") == names.count("pipeline:gather") == CHUNKS
    assert names.count("fit+classify") == 1
    assert got == want and got.startswith(HEADER) and got.count(b"\n") > 20_000
    assert got_diag == want_diag and got_diag[0].startswith("# unique profiles: ")
    assert _sid_tpu(src, case) == (got, got_diag)


@pytest.mark.parametrize("case", ["lr-R", "bayes"])
def test_fitted_text_mode(big_text, gate_1mb, case):
    got, got_diag, _, want, want_diag = _runs(big_text, _options(case), binary=False)
    assert isinstance(got, str) and got == want and got_diag == want_diag
    assert got.encode("latin1") == engine._run_monolithic(big_text, _options(case), None, True)
    assert _sid_tpu(big_text, case, binary=False) == (got, got_diag)


def test_fitted_over_a_mesh_of_one(big_text, gate_1mb):
    """``--devices`` does not keep the fitted pipeline out."""
    opts = _options("lr-R", mesh_devices=1)
    got, got_diag, prof, want, want_diag = _runs(big_text, opts)
    assert "pipeline:dedup" in _names(prof) and got == want and got_diag == want_diag
    assert _sid_tpu(big_text, "lr-R", mesh_devices=1) == (got, got_diag)


def test_the_fit_gets_the_monolithic_rows_and_weights(big_text, gate_1mb, monkeypatch):
    """``class_table``'s fit over the merged chunk tables gets the
    (profiles, mult) the monolithic path's one dedup gives, bit for bit
    and type for type."""
    given = []
    inner = likelihood_ratio.fit_profiles

    def fit_profiles(profiles, mult, options, diag=None):
        given.append((profiles.copy(), mult.copy()))
        return inner(profiles, mult, options, diag)

    monkeypatch.setattr(likelihood_ratio, "fit_profiles", fit_profiles)
    got, _, prof, want, _ = _runs(big_text, _options("lr-R"))
    assert got == want and "pipeline:dedup" in _names(prof)
    (fitted, monolithic) = given
    for a, b in zip(fitted, monolithic):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (coverage_of(fitted[0]) >= 4).all() and fitted[1].dtype == np.int64


def _odd_chunks_text():
    """A profile found in one chunk only, a run of coverage < 4 sites
    longer than a chunk, and a run of blank lines longer than a chunk,
    between simulated 30x sites."""
    head = make_pileup_text(simulate_diploid_counts(300, seed=3), start_pos=1, seed=1)
    low = np.zeros((400, 4), np.int64)
    low[:, 0] = np.arange(400) % 2 + 1  # coverage 1 to 3
    low[1::2, 2] = 1
    lone = make_pileup_text(np.array([[37, 0, 0, 11]]), start_pos=2_000, seed=4)
    tail = make_pileup_text(simulate_diploid_counts(300, seed=5), chrom="chr2", start_pos=1, seed=2)
    return head + make_pileup_text(low, start_pos=1_000, seed=3) + b"\n" * 5000 + lone + tail


@pytest.mark.parametrize("case", ["lr-R", "lr-device-lrt", "bayes"])
def test_odd_chunks(monkeypatch, case):
    text = _odd_chunks_text()
    chunk_bytes = 2048
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 0)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", chunk_bytes)
    chunks = [parse_pileup(c, False, False) for c in stream.iter_chunks(text, chunk_bytes)]
    assert any(b.num_sites == 0 for b in chunks)
    assert any(b.num_sites and (coverage_of(b.counts) < 4).all() for b in chunks)
    lone = stream.pack_profiles(np.array([[37, 0, 0, 11]]))
    assert sum(lone[0] in stream.pack_profiles(b.counts) for b in chunks) == 1
    got, got_diag, prof, want, want_diag = _runs(text, _options(case))
    assert _names(prof).count("pipeline:dedup") == sum(b.num_sites > 0 for b in chunks)
    assert _names(prof).count("worker:parse") == len(chunks)
    assert got == want and got_diag == want_diag
    assert _sid_tpu(text, case) == (got, got_diag)
    assert b"chr1,2000,het,AT," in got


@pytest.mark.parametrize("case", ["lr-R", "bayes"])
def test_fitted_empty_input(monkeypatch, case):
    """Header only, and the monolithic run's diag lines (a fit over no
    profiles)."""
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 0)
    opts = _options(case)
    assert engine._fitted_pipeline_eligible(opts, 0)
    got, got_diag, prof, want, want_diag = _runs(b"", opts)
    assert got == want == HEADER and got_diag == want_diag
    assert _sid_tpu(b"", case) == (got, got_diag)
    assert "fit+classify" in _names(prof) and "pipeline:dedup" not in _names(prof)
    assert engine.run(b"", opts) == HEADER.decode()


@pytest.mark.parametrize("kind", ["bytes", "path"])
def test_fitted_pipeline_reports_the_files_line(bad_text, gate_1mb, tmp_path, kind):
    src = bad_text
    if kind == "path":
        src = str(tmp_path / "bad.pileup")
        with open(src, "wb") as f:
            f.write(bad_text)
    with pytest.raises(SidParseError) as e:
        engine.run(src, _options("lr-R"))
    assert e.value.line_number == BAD_LINE


@pytest.mark.parametrize("case, size, eligible", [
    ({"method": "likelihood_ratio"}, MB, True),
    ({"method": "likelihood_ratio", "estimate_prior": True}, MB, True),
    ({"method": "bayes"}, MB, True),
    ({"method": "bayes", "estimate_prior": True}, MB, True),
    ({"method": "likelihood_ratio", "estimate_prior": True, "mesh_devices": 1}, MB, True),
    ({"method": "likelihood_ratio", "fit_backend": "exact"}, MB, True),
    ({"method": "likelihood_ratio", "estimate_prior": True}, MB - 1, False),
    ({"method": "likelihood_ratio", "estimate_prior": True, "engine": "exact"}, MB, False),
    ({"method": "likelihood_ratio", "estimate_prior": True, "per_shard_fit": True}, MB, False),
    ({"method": "bayes", "per_shard_fit": True}, MB, False),
    ({}, MB, False),
    ({"estimate_prior": True}, MB, False),
    ({"method": "quality"}, MB, False),
    ({"method": "quality", "estimate_prior": True}, MB, False),
    ({"method": "nonsense"}, MB, False),
], ids=["lr", "lr-R", "bayes", "bayes-R", "devices", "fit-exact", "under-gate", "exact", "per-shard-fit",
        "bayes-per-shard-fit", "local", "local-R", "quality", "quality-R", "unknown"])
def test_fitted_eligibility(gate_1mb, case, size, eligible):
    assert engine._fitted_pipeline_eligible(Options(**case), size) is eligible
    # one chunk path at most for any options
    assert not (eligible and engine._pipeline_eligible(Options(**case), size))


def test_file_object_stays_monolithic(big_text, gate_1mb):
    opts = _options("lr-R")
    got, prof = _profiled(lambda: engine.run(io.BytesIO(big_text), opts, binary=True))
    assert _names(prof)[0] == "parse" and "pipeline" not in _names(prof)
    assert got == engine.run(big_text, opts, binary=True)


@pytest.mark.parametrize("keys, more", [
    ([], [3, 9]), ([1, 4, 7], []), ([1, 4, 7], [0, 4, 8]), ([5], [5]), ([2, 3], [0, 1]),
])
def test_merge_profile_tables(keys, more):
    k1, k2 = np.array(keys, np.uint64), np.array(more, np.uint64)
    m1, m2 = np.arange(1, len(keys) + 1, dtype=np.int64) * 10, np.arange(1, len(more) + 1, dtype=np.int64)
    merged, mult = stream.merge_profile_tables(k1, m1, k2, m2)
    want_keys, inverse = np.unique(np.concatenate([k1, k2]), return_inverse=True)
    want = np.zeros(want_keys.shape[0], np.int64)
    np.add.at(want, inverse, np.concatenate([m1, m2]))
    assert merged.dtype == np.uint64 and mult.dtype == np.int64
    assert np.array_equal(merged, want_keys) and np.array_equal(mult, want)


# ---- the spans, by their records ----

LEAVES = ("pipeline:read", "pipeline:parse_wait", "pipeline:dedup", "fit+classify", "pipeline:gather",
          "pipeline:serialize", "join")


@pytest.fixture(scope="module")
def traced(big_text, tmp_path_factory):
    """One fitted run of big_text (-R -m likelihood_ratio) from a path at 1
    MB chunks: (the profile, its ``pipeline`` span, the request's wall in
    ns, the output)."""
    path = tmp_path_factory.mktemp("fitted") / "in.pileup"
    path.write_bytes(big_text)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "PIPELINE_MIN_BYTES", MB)
        mp.setattr(engine, "PIPELINE_CHUNK_BYTES", MB)
        engine.run(str(path), _options("lr-R"), binary=True)  # warm

        def timed():
            t0 = time.perf_counter_ns()
            out = engine.run(str(path), _options("lr-R"), binary=True)
            return out, time.perf_counter_ns() - t0

        (out, wall), prof = _profiled(timed)
    (pipeline,) = [s for s in prof.spans if s.name == "pipeline"]
    return prof, pipeline, wall, out


def _named(prof, name):
    return [s for s in prof.spans if s.name == name]


def test_main_thread_leaves_in_order(traced):
    """Pass 1 reads, waits for and dedups each chunk; one fit; pass 2
    gathers and writes each held chunk; the join after the pass."""
    prof, pipeline, _, _ = traced
    leaves = sorted((s for s in prof.spans if s.parent == pipeline.id and s.thread == pipeline.thread),
                    key=lambda s: s.start_ns)
    assert [s.name for s in leaves] == (["pipeline:read"]
                                        + ["pipeline:read", "pipeline:parse_wait", "pipeline:dedup"] * CHUNKS
                                        + ["fit+classify"] + ["pipeline:gather", "pipeline:serialize"] * CHUNKS)
    assert all(a.end_ns <= b.start_ns for a, b in zip(leaves, leaves[1:]))
    (join,) = _named(prof, "join")
    assert join.parent is None and join.thread == pipeline.thread and join.start_ns >= pipeline.end_ns
    assert {s.request for s in prof.spans} == {pipeline.request}


def test_a_parse_a_chunk_on_the_worker(traced):
    prof, pipeline, _, _ = traced
    parses = _named(prof, "worker:parse")
    assert len(parses) == CHUNKS
    for parse in parses:
        assert parse.parent == pipeline.id and parse.thread != pipeline.thread
        assert pipeline.start_ns <= parse.start_ns <= parse.end_ns <= pipeline.end_ns


@pytest.mark.parametrize("outer, inner, each", [
    ("pipeline:dedup", "call:unique_profiles", 1),
    ("pipeline:gather", "call:gather_result", 1),
    ("fit+classify", "host:lrt_bh", 1),
    ("fit+classify", "device:fit_lynch", 1),
])
def test_nested_spans(traced, outer, inner, each):
    prof, _, _, _ = traced
    for span in _named(prof, outer):
        got = [s for s in _named(prof, inner) if s.parent == span.id]
        assert len(got) == each
        assert all(s.thread == span.thread and span.start_ns <= s.start_ns <= s.end_ns <= span.end_ns
                   for s in got)
    assert len(_named(prof, inner)) == each * len(_named(prof, outer))


def test_leaves_cover_the_request(traced):
    """The main thread's seven leaves cover at least 97 % of the
    request's wall (what ``engine.unspanned_pct.fitted`` reads)."""
    prof, _, wall, _ = traced
    covered = sum(s.end_ns - s.start_ns for s in prof.spans if s.name in LEAVES)
    assert covered >= 0.97 * wall
    run = harness.Run({"total": 0.0}, [wall * 1e-9], wall * 1e-9, 1, stages=list(prof.stages))
    assert 0.0 <= harness.reader("engine.unspanned_pct.fitted")(run) <= 3.0


def test_counters(traced, big_text):
    prof, _, _, out = traced
    assert prof.counters["sites"] == len(big_text.splitlines())
    profiles, _, _ = unique_profiles(parse_pileup(big_text, False, False).counts)
    assert prof.counters["fitted:profiles"] == int((coverage_of(profiles) >= 4).sum())
    # each site's chromosome, position and int32 row, and the chunks' unique keys
    sites = len(big_text.splitlines())
    assert 12 * sites < prof.counters["fitted:held_bytes"] <= 12 * sites + 8 * CHUNKS * profiles.shape[0]
    assert prof.counters["serialize:bytes"] == len(out) - len(HEADER)
    assert prof.counters["serialize:in_place_bytes"] == len(out) - len(HEADER)
    assert prof.counters["serialize:copied_bytes"] == 0 and prof.counters["serialize:resizes"] == CHUNKS


def test_profile_report_shows_the_counters(big_text, gate_1mb, tmp_path, capsys):
    path = tmp_path / "in.pileup"
    path.write_bytes(big_text)
    out = tmp_path / "out.csv"
    argv = ["--platform", "cpu", "--profile", "-R", "-m", "likelihood_ratio", "--fit", "device", "--output",
            str(out), str(path)]
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    profiles = [line for line in err.splitlines() if line.startswith("# fitted:profiles: ")]
    held = [line for line in err.splitlines() if line.startswith("# fitted:held_bytes: ")]
    assert len(profiles) == len(held) == 1
    assert "# stage pipeline:dedup: " in err and "# stage pipeline:gather: " in err
    assert out.read_bytes() == engine._run_monolithic(big_text, _options("lr-R"), None, True)


@pytest.mark.parametrize("path", ["monolithic", "stream"])
@pytest.mark.parametrize("exact_pvalues", [True, False], ids=["host-lrt", "device-lrt"])
def test_host_lrt_bh_span(big_text, path, exact_pvalues):
    """``host:lrt_bh`` on the monolithic and ``--stream`` paths of
    ``likelihood_ratio``: inside the call or the stream's fit; none where
    the LRT runs on the device."""
    opts = _options("lr-R", exact_pvalues=exact_pvalues)
    if path == "monolithic":
        _, prof = _profiled(lambda: engine.run(big_text, opts, binary=True))
        parent = "call"
    else:
        _, prof = _profiled(lambda: engine.run_streaming(big_text, opts, io.BytesIO(), chunk_bytes=MB))
        parent = "fit+classify"
    spans = _named(prof, "host:lrt_bh")
    if not exact_pvalues:
        assert spans == [] and _named(prof, "device:classify_lr")
        return
    (span,) = spans
    (outer,) = _named(prof, parent)
    assert span.parent == outer.id


def test_reference_check_on_the_cells_traffic(monkeypatch):
    """The fitted path on the cell's own traffic at 40,000 sites (three 1
    MB chunks) against the benchmark's plain reference: correct by every
    limit of the cell's configuration."""
    cell = harness.find_cell(harness.load_spec(), "lrR.chrom17M")
    traffic = dict(cell["traffic"], sites=40_000, body_sites=20_000, distinct_bodies=2)
    text = generate.make_pileup(traffic, 2**31 + 29)
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", MB)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", MB)
    options = cell["config"]["options"]
    diag = []
    out, prof = _profiled(lambda: engine.run(text, Options(platform="cpu", **options), diag.append, True))
    assert _names(prof).count("pipeline:dedup") >= 3
    numbers = check.compare(out, diag, check.expected(options, *pileup.parse(text)))
    limits = cell["config"]["limits"]
    assert set(limits) == {"rows_bad", "calls_bad", "conf_gap", "fit_gap"}
    assert numbers["rows_bad"] == 0 and numbers["calls_bad"] == 0
    assert all(numbers[k] <= limits[k] for k in limits), numbers


def test_the_configuration_states_the_deployment():
    with open(os.path.join(harness.ROOT, "gpubench", "configs", "chrom30x-lrR-devfit.json")) as f:
        config = json.load(f)
    assert config["options"] == {"method": "likelihood_ratio", "estimate_prior": True, "fit_backend": "device"}
    assert engine._fitted_pipeline_eligible(Options(**config["options"]), engine.PIPELINE_MIN_BYTES)
