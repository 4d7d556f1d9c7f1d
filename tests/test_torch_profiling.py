"""The port's stage spans (``sid_tpu_torch/utils/profiling.py``) on the CPU:
the report's total and self times on a fake clock, spans and counters from
many threads, the spans in the ``SIDTPU_TRACE`` Chrome trace (one range a
span, the pipeline's worker included), and the CLI's rate from the sites
the engine parsed, its output never scanned."""

import contextlib
import json
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from sid_tpu_torch import cli, engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.utils import profiling  # noqa: E402
from synth import make_bwa_like_pileup_scaled  # noqa: E402

MS = 1_000_000  # nanoseconds


def _fake_clock(times_ms):
    ticks = iter(t * MS for t in times_ms)
    return lambda: next(ticks)


def _two_level_profile():
    """pipeline [0, 100] holding call [10, 40] and serialize [50, 70] on
    this thread and a worker's parse [5, 60] on another; join [100, 130]
    after it. The clock reads in the order the spans open and close (four
    readings spare)."""
    prof = profiling.StageProfile(clock=_fake_clock([0, 5, 60, 10, 40, 50, 70, 100, 100, 130, 200, 210, 220, 230]))
    with prof.stage("pipeline"):
        adopt = prof.handover()

        def parse():
            with adopt(), prof.stage("worker:parse"):
                pass

        worker = threading.Thread(target=parse)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with prof.stage("pipeline:call"):
            pass
        with prof.stage("pipeline:serialize"):
            pass
    with prof.stage("join"):
        pass
    prof.count("sites", 1300)
    return prof


def test_self_time_is_exact_on_a_two_level_tree():
    prof = _two_level_profile()
    got = {name: (t.count, t.ns // MS, t.self_ns // MS) for name, t in prof.summary().items()}
    assert got == {
        "pipeline": (1, 100, 50),  # less call and serialize; the worker's parse runs beside it
        "worker:parse": (1, 55, 55),
        "pipeline:call": (1, 30, 30),
        "pipeline:serialize": (1, 20, 20),
        "join": (1, 30, 30),
    }
    assert all(t.ns % MS == t.self_ns % MS == 0 for t in prof.summary().values())
    assert list(got) == ["pipeline", "worker:parse", "pipeline:call", "pipeline:serialize", "join"]
    assert prof.total() == 100 * MS * 1e-9 + 30 * MS * 1e-9 and prof.wall() == 130 * MS * 1e-9
    assert prof.stages == [(name, ms * MS * 1e-9) for name, ms in (
        ("worker:parse", 55), ("pipeline:call", 30), ("pipeline:serialize", 20), ("pipeline", 100), ("join", 30))]


def test_spans_carry_parent_thread_and_request():
    prof = _two_level_profile()
    spans = {s.name: s for s in prof.spans}
    pipeline = spans["pipeline"]
    assert pipeline.parent is None and spans["join"].parent is None
    assert spans["worker:parse"].parent == spans["pipeline:call"].parent == pipeline.id
    assert spans["worker:parse"].thread != pipeline.thread == spans["pipeline:call"].thread
    # two roots outside a request: two requests, the worker's in the pipeline's
    assert spans["worker:parse"].request == pipeline.request != spans["join"].request
    with prof.request():
        with prof.stage("a"):
            pass
        with prof.stage("b"):
            pass
    a, b = prof.spans[-2:]
    assert a.parent is None and b.parent is None and a.request == b.request


def test_report_gives_total_self_and_the_rate_over_the_wall():
    lines = []
    text = _two_level_profile().report(log=lines.append)
    assert text.splitlines() == lines == [
        "# stage pipeline: 100.0 ms, self 50.0 ms, 1 span (77% of the wall)",
        "# stage worker:parse: 55.0 ms, self 55.0 ms, 1 span (42% of the wall)",
        "# stage pipeline:call: 30.0 ms, self 30.0 ms, 1 span (23% of the wall)",
        "# stage pipeline:serialize: 20.0 ms, self 20.0 ms, 1 span (15% of the wall)",
        "# stage join: 30.0 ms, self 30.0 ms, 1 span (23% of the wall)",
        "# throughput: 10,000 sites/s over 1300 sites in 130.0 ms",
    ]


def test_report_gives_a_byte_counter_with_its_stages_rate():
    """``serialize:bytes`` over the stages named ``*:serialize`` (20 ms)."""
    prof = _two_level_profile()
    prof.count("serialize:bytes", 30_000_000)
    prof.count("serialize:bytes", 10_000_000)
    prof.count("unstaged:bytes", 7)
    lines = prof.report().splitlines()
    assert lines[5:] == [
        "# serialize:bytes: 40,000,000, 2.00 GB/s over its stages",
        "# unstaged:bytes: 7",
        "# throughput: 10,000 sites/s over 1300 sites in 130.0 ms",
    ]


def test_a_disabled_profile_records_nothing():
    prof = profiling.StageProfile(enabled=False)
    with prof.request(), prof.stage("x"), prof.handover()():
        prof.count("sites", 3)
    assert prof.spans == [] and prof.stages == [] and prof.counters == {}
    profiling.activate(None)
    with profiling.maybe_stage("x"), profiling.handover()():
        profiling.count("sites", 1)


def test_spans_and_counts_from_many_threads():
    """Threads that open nested spans, hand work to others and count at
    once: every span is kept with its own id and parent, and no count is
    lost."""
    prof = profiling.StageProfile()
    threads, rounds = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(rounds):
                with prof.stage(f"outer{k}"):
                    adopt = prof.handover()
                    helper = threading.Thread(target=lambda: _inner(prof, adopt, k))
                    helper.start()
                    with prof.stage(f"mid{k}"):
                        prof.count("n", 1)
                    helper.join(timeout=30)

        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert len(prof.spans) == len(prof.stages) == 3 * threads * rounds
    assert prof.counters["n"] == 2 * threads * rounds
    by_id = {s.id: s for s in prof.spans}
    assert len(by_id) == len(prof.spans)
    for s in prof.spans:
        if s.name.startswith("outer"):
            assert s.parent is None and s.request == s.id
        else:
            parent = by_id[s.parent]
            k = s.name[len("mid"):] if s.name.startswith("mid") else s.name[len("inner"):]
            assert parent.name == "outer" + k and s.request == parent.id
            assert (s.thread == parent.thread) == s.name.startswith("mid")


def _inner(prof, adopt, k):
    with adopt(), prof.stage(f"inner{k}"):
        prof.count("n", 1)


# ---- the spans in the SIDTPU_TRACE trace ----


@pytest.fixture()
def small_pipeline(monkeypatch, tmp_path):
    """A ~240 KB pileup file that the chunk pipeline calls in 64 KB chunks."""
    path = tmp_path / "in.pileup"
    path.write_bytes(make_bwa_like_pileup_scaled(2000, seed=3))
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 0)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", 64 << 10)
    return str(path)


def _ranges(path):
    """Each ``stage:`` range of a Chrome trace: {name: [thread ids]}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    got = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith("stage:"):
            got.setdefault(name[len("stage:"):], []).append(e["tid"])
    return got


def _spans_by_name(prof):
    got = {}
    for s in prof.spans:
        got.setdefault(s.name, []).append(s)
    return got


def test_the_trace_holds_every_span_once(small_pipeline, tmp_path, monkeypatch):
    monkeypatch.setenv("SIDTPU_TRACE", str(tmp_path / "trace"))
    prof = profiling.StageProfile()
    profiling.activate(prof)
    try:
        prof.start_device_trace()
        engine.run(small_pipeline, Options(platform="cpu"), binary=True)
    finally:
        profiling.activate(None)
        path = prof.stop_device_trace()
    ranges = _ranges(path)
    for name in ("pipeline:read", "worker:parse", "call:gather_result", "call:unique_profiles", "join"):
        assert name in ranges
    spans = _spans_by_name(prof)
    assert {k: len(v) for k, v in ranges.items()} == {k: len(v) for k, v in spans.items()}
    assert len(spans["pipeline"]) == 1 and len(spans["worker:parse"]) >= 3
    assert len(set(ranges["worker:parse"])) == 1 and ranges["worker:parse"][0] != ranges["pipeline"][0]


def test_a_profile_whose_trace_is_not_recording_opens_no_range(small_pipeline, tmp_path, monkeypatch):
    """A subclass that adds its own range to each stage, as the
    benchmark's does, under a profiler of its own: one range a span."""

    class Annotated(profiling.StageProfile):
        @contextlib.contextmanager
        def stage(self, name):
            with torch.profiler.record_function("stage:" + name), super().stage(name):
                yield

    monkeypatch.setenv("SIDTPU_TRACE", str(tmp_path / "unused"))
    prof = Annotated()
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    profiling.activate(prof)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    experimental_config=config) as outer:
            engine.run(small_pipeline, Options(platform="cpu"), binary=True)
    finally:
        profiling.activate(None)
    path = str(tmp_path / "outer.json")
    outer.export_chrome_trace(path)
    counts = {k: len(v) for k, v in _ranges(path).items()}
    assert counts == {k: len(v) for k, v in _spans_by_name(prof).items()}
    assert counts["worker:parse"] >= 3 and not (tmp_path / "unused").exists()


# ---- the CLI's rate ----


class _Unscannable(bytes):
    """An output that fails the run if anything counts in it."""

    def count(self, *args):
        raise AssertionError("the CLI scanned its output")


@pytest.mark.parametrize("profile", [True, False], ids=["profile", "no_profile"])
def test_the_cli_never_scans_its_output(small_pipeline, tmp_path, monkeypatch, capsys, profile):
    """With or without ``--profile`` the output is written unscanned; the
    report's rate counts the sites the engine parsed over the run's wall."""
    run = engine.run
    monkeypatch.setattr(engine, "run", lambda *a, **k: _Unscannable(run(*a, **k)))
    out = tmp_path / "out.csv"
    argv = ["--platform", "cpu", "--output", str(out), small_pipeline]
    assert cli.main(["--profile"] + argv if profile else argv) == 0
    assert out.read_bytes() == engine._run_monolithic(small_pipeline, Options(platform="cpu"), None, True)
    err = capsys.readouterr().err
    assert ("# throughput:" in err) == profile
    if profile:
        assert "over 2000 sites in " in err and "# stage pipeline:read: " in err
