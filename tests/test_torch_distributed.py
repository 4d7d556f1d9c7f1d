"""The port's ``--multihost`` (torch.distributed, gloo) vs sid_tpu's, on the CPU.

The counterpart of ``tests/test_distributed.py`` and
``tests/test_distributed_multiproc.py``: ``byte_ranges`` equal to
sid_tpu's; one process's ``run_multihost`` byte-equal to ``engine.run``
and to sid_tpu's ``run_multihost`` for every method (and ``quality``
with -R); stale parts ignored, completed parts reused; the CLI entry and
its ``--output`` rule; the three ``initialize`` failure rules; and real
process groups: two processes over gloo on the CPU byte-equal to one
process, and, marked slow as in sid_tpu's tests, three processes, tiny
chunks, and a ``--checkpoint`` / ``--resume`` pair.
"""

import io
import logging
import os
import socket
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.parallel import distributed as ref_distributed  # noqa: E402
from sid_tpu_torch import cli, engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.parallel import distributed  # noqa: E402
from sid_tpu_torch.utils.checkpoint import input_fingerprint  # noqa: E402
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ["local", "bayes", "likelihood_ratio", "quality"]
# the subprocesses' own limit: this sandbox's pytest has no timeout plugin
PROCESS_TIMEOUT = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def pileup_file(tmp_path_factory):
    """400 simulated sites and 400 uniform ones: the processes' byte
    ranges give histograms of different sizes (the all-gather's padding)."""
    counts = np.concatenate([simulate_diploid_counts(400, coverage=22, pi=0.03, eps=0.012),
                             np.tile(np.array([[20, 0, 0, 0]]), (400, 1))])
    path = tmp_path_factory.mktemp("mh") / "in.pileup"
    path.write_bytes(make_pileup_text(counts, with_qualities=True))
    return str(path)


class TestByteRanges:
    @pytest.mark.parametrize("n", range(1, 10))
    def test_equal_to_sid_tpu(self, tmp_path, n):
        p = tmp_path / "f.txt"
        p.write_bytes(b"".join(b"line%d\n" % i for i in range(1000)))
        ranges = distributed.byte_ranges(str(p), n)
        assert ranges == ref_distributed.byte_ranges(str(p), n)
        assert ranges[0][0] == 0 and ranges[-1][1] == p.stat().st_size
        data = p.read_bytes()
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c and data[b - 1:b] == b"\n"

    def test_empty_file(self, tmp_path):
        p = tmp_path / "e.txt"
        p.write_bytes(b"")
        assert distributed.byte_ranges(str(p), 4) == ref_distributed.byte_ranges(str(p), 4) == [(0, 0)]

    @pytest.mark.parametrize("n", [2, 3, 7])
    def test_no_trailing_newline(self, tmp_path, n):
        p = tmp_path / "t.txt"
        p.write_bytes(b"a\tb\n" * 50 + b"last line")
        assert distributed.byte_ranges(str(p), n) == ref_distributed.byte_ranges(str(p), n)


def test_allgather_histogram_single_process():
    p = np.array([[2, 0, 0, 0], [1, 0, 0, 0], [2, 0, 0, 0]], np.int32)
    prof, mult = distributed.allgather_histogram(p, np.array([3, 4, 1], np.int64))
    assert prof.tolist() == [[1, 0, 0, 0], [2, 0, 0, 0]] and mult.tolist() == [4, 4]


@pytest.mark.parametrize("kw", [dict(method=m) for m in METHODS] + [dict(method="quality", estimate_prior=True),
                                                                     dict(method="likelihood_ratio",
                                                                          estimate_prior=True)],
                         ids=METHODS + ["quality_R", "lr_R"])
def test_single_process_matches_batch_and_sid_tpu(tmp_path, kw):
    counts = simulate_diploid_counts(1500, coverage=18, pi=0.03, eps=0.01)
    text = make_pileup_text(counts, with_qualities=True)
    src = tmp_path / "in.pileup"
    src.write_bytes(text)
    out, ref_out = str(tmp_path / "out.csv"), str(tmp_path / "ref.csv")
    got_diag, want_diag = [], []
    assert distributed.run_multihost(str(src), Options(platform="cpu", **kw), out, got_diag.append,
                                     ranges_per_process=4) == out
    ref_distributed.run_multihost(str(src), RefOptions(**kw), ref_out, want_diag.append, ranges_per_process=4)
    got = open(out, "rb").read()
    assert got == engine.run(text, Options(platform="cpu", **kw), binary=True)
    assert got == open(ref_out, "rb").read()
    assert got_diag == want_diag
    assert sorted(os.listdir(tmp_path)) == ["in.pileup", "out.csv", "ref.csv"]  # no part left


def test_ignores_stale_parts(tmp_path):
    text = make_pileup_text(simulate_diploid_counts(400, coverage=18, pi=0.03, eps=0.01, seed=4))
    src = tmp_path / "in.pileup"
    src.write_bytes(text)
    out = str(tmp_path / "out.csv")
    with open(out + ".part" + "9" * 16, "w") as f:  # a part of an aborted run with other ranges
        f.write("STALE,1,hom,AA,1,0,p_value\n")
    distributed.run_multihost(str(src), Options(platform="cpu"), out, ranges_per_process=2)
    assert "STALE" not in open(out).read()
    assert open(out, "rb").read() == engine.run(text, Options(platform="cpu"), binary=True)


def test_part_resume_reuses_completed_ranges(pileup_file, tmp_path):
    """A part whose .done marker holds the input's fingerprint and the
    range's end is reused verbatim; a stale fingerprint or another end
    (a range of a run split otherwise, C11) is called again."""
    opts = Options(platform="cpu", method="local", resume=True, output="ignored")
    start, end = distributed.byte_ranges(pileup_file, 2)[1]
    fp = input_fingerprint(pileup_file)
    sentinel = b"SENTINEL-REUSED\n"
    for name, marker, reused in (("a.csv", f"{fp} {end}", True),
                                 ("b.csv", f"stale:fingerprint {end}", False),
                                 ("c.csv", f"{fp} {end - 1}", False)):
        out = tmp_path / name
        part = f"{out}.part{start:016d}"
        with open(part, "wb") as f:
            f.write(sentinel)
        with open(part + ".done", "w") as f:
            f.write(marker)
        distributed.run_multihost(pileup_file, opts, str(out), ranges_per_process=2)
        assert (sentinel in out.read_bytes()) == reused


@pytest.mark.parametrize("before,after", [(4, 2), (2, 4)], ids=["4to2", "2to4"])
def test_resume_with_other_ranges(pileup_file, tmp_path, monkeypatch, before, after):
    """C11: a run aborted in its merge leaves every part and marker; resumed
    with another split, the parts whose start matches a new range but whose
    end does not are called again, so no site is lost or written twice.
    sid_tpu's marker holds only the fingerprint, and its output does not
    match."""
    import shutil

    want = engine.run(open(pileup_file, "rb").read(), Options(platform="cpu"), binary=True)
    copy = shutil.copyfileobj

    def abort(*a, **kw):
        raise OSError("merge aborted")

    for run, opts, name in ((distributed.run_multihost, Options(platform="cpu", resume=True), "port.csv"),
                            (ref_distributed.run_multihost, RefOptions(resume=True), "ref.csv")):
        out = str(tmp_path / name)
        monkeypatch.setattr(shutil, "copyfileobj", abort)
        with pytest.raises(OSError, match="merge aborted"):
            run(pileup_file, opts, out, ranges_per_process=before)
        monkeypatch.setattr(shutil, "copyfileobj", copy)
        run(pileup_file, opts, out, ranges_per_process=after)
    assert (tmp_path / "port.csv").read_bytes() == want
    assert (tmp_path / "ref.csv").read_bytes() != want


def test_checkpoint_resume_skips_pass_1(pileup_file, tmp_path):
    from sid_tpu_torch.utils import profiling

    ckpt = str(tmp_path / "hist.npz")
    opts = dict(platform="cpu", method="likelihood_ratio", estimate_prior=True, checkpoint=ckpt)
    stages = []
    for name, resume in (("first.csv", False), ("resumed.csv", True)):
        prof = profiling.StageProfile()
        profiling.activate(prof)
        try:
            distributed.run_multihost(pileup_file, Options(resume=resume, **opts), str(tmp_path / name))
        finally:
            profiling.activate(None)
        stages.append([n for n, _ in prof.stages])
    assert "histogram" in stages[0] and "histogram" not in stages[1]
    assert (tmp_path / "first.csv").read_bytes() == (tmp_path / "resumed.csv").read_bytes()


@pytest.mark.parametrize("kw,fits", [(dict(method="local"), True),
                                     (dict(method="likelihood_ratio", estimate_prior=True), True),
                                     (dict(method="quality"), False),
                                     (dict(method="quality", estimate_prior=True), False)],
                         ids=["local", "lr_R", "quality", "quality_R"])
def test_fit_classify_stage_only_where_a_fit_or_classify_runs(pileup_file, tmp_path, kw, fits):
    """The pass-1 table shared by --stream and --multihost opens the
    ``fit+classify`` stage for the methods that fit or classify; quality's
    -R prior stays outside it, as in the streaming engine before."""
    from sid_tpu_torch.utils import profiling

    for run in (lambda o: engine.run_streaming(pileup_file, o, io.BytesIO()),
                lambda o: distributed.run_multihost(pileup_file, o, str(tmp_path / "m.csv"))):
        prof = profiling.StageProfile()
        profiling.activate(prof)
        try:
            run(Options(platform="cpu", **kw))
        finally:
            profiling.activate(None)
        assert ("fit+classify" in [n for n, _ in prof.stages]) == fits


def test_cli_entry(tmp_path, capsys):
    text = make_pileup_text(simulate_diploid_counts(500, coverage=18, pi=0.03, eps=0.01, seed=5))
    src = tmp_path / "in.pileup"
    src.write_bytes(text)
    out = str(tmp_path / "out.csv")
    assert cli.main(["--platform", "cpu", "--multihost", "--output", out, str(src)]) == 0
    assert open(out, "rb").read() == engine.run(text, Options(platform="cpu"), binary=True)
    assert f"# wrote {out}" in capsys.readouterr().err


def test_cli_requires_output(tmp_path, capsys, monkeypatch):
    src = tmp_path / "in.pileup"
    src.write_bytes(b"chr1\t1\tA\t1\t.\n")
    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", "cpu", "--multihost", str(src)])
    assert e.value.code == 1
    # the environment alone selects the multihost path, which needs --output
    monkeypatch.setenv("SIDTPU_NUM_PROCESSES", "2")
    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", "cpu", str(src)])
    assert e.value.code == 1
    assert "sid: --multihost requires --output PATH" in capsys.readouterr().err


class TestInitializeFailures:
    """Bring-up failures surface (tests/test_distributed.py:126-160)."""

    @staticmethod
    def boom(*a, **kw):
        raise ValueError("bad coordinator")

    def test_no_arguments_warns_single_process(self, monkeypatch, caplog):
        monkeypatch.delenv("SIDTPU_NUM_PROCESSES", raising=False)
        monkeypatch.setattr(distributed.dist, "init_process_group", self.boom)
        with caplog.at_level(logging.WARNING, logger="sid_tpu_torch.distributed"):
            distributed.initialize()
        assert any("auto-initialization failed" in r.message for r in caplog.records)
        assert distributed.process_count() == 1 and distributed.process_index() == 0

    def test_no_arguments_fatal_when_multiprocess_requested(self, monkeypatch):
        monkeypatch.setenv("SIDTPU_NUM_PROCESSES", "2")
        with pytest.raises(RuntimeError, match="SIDTPU_NUM_PROCESSES=2"):
            distributed.initialize()

    def test_explicit_args_failure_is_fatal(self, monkeypatch):
        monkeypatch.setattr(distributed.dist, "init_process_group", self.boom)
        with pytest.raises(RuntimeError, match="coordinator"):
            distributed.initialize("127.0.0.1:1", 2, 0)


def _env(extra):
    env = dict(os.environ)
    env["SIDTPU_PLATFORM"] = "cpu"
    env.update(extra)
    return env


def _spawn_multihost(args, n, extra=None):
    """n processes of ``./sid-tpu-torch --multihost`` on a free port;
    returns their stderr."""
    port = _free_port()
    procs = [
        subprocess.Popen(
            [os.path.join(REPO, "sid-tpu-torch"), "--multihost", *args],
            env=_env({"SIDTPU_COORDINATOR": f"127.0.0.1:{port}", "SIDTPU_NUM_PROCESSES": str(n),
                      "SIDTPU_PROCESS_ID": str(pid), **(extra or {})}),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(n)
    ]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=PROCESS_TIMEOUT)
            errs.append(err.decode())
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-2000:]
    return errs


# the CLI's flags and the same options
CLI_CASES = {
    "lr_R": (["-R", "-m", "likelihood_ratio"], dict(method="likelihood_ratio", estimate_prior=True)),
    "quality_R": (["-R", "-m", "quality"], dict(method="quality", estimate_prior=True)),
    "bayes": (["-m", "bayes"], dict(method="bayes")),
    "local": (["-m", "local"], dict(method="local")),
}


def _one_process(tmp_path, case, pileup_file):
    """sid_tpu's single-process run_multihost, equal to the port's
    engine.run."""
    opts = CLI_CASES[case][1]
    ref = str(tmp_path / "ref.csv")
    ref_distributed.run_multihost(pileup_file, RefOptions(**opts), ref)
    want = open(ref, "rb").read()
    assert want == engine.run(pileup_file, Options(platform="cpu", **opts), binary=True)
    return want


def test_two_processes_byte_equal(pileup_file, tmp_path):
    multi = tmp_path / "multi.csv"
    errs = _spawn_multihost([*CLI_CASES["lr_R"][0], "--profile", "--output", str(multi), pileup_file], 2)
    assert multi.read_bytes() == _one_process(tmp_path, "lr_R", pileup_file)
    assert all("# stage histogram" in e for e in errs)
    assert f"# wrote {multi}" in errs[0] and "# wrote" not in errs[1]


@pytest.mark.slow
@pytest.mark.parametrize("case", ["quality_R", "bayes", "local"])
def test_two_processes_other_methods(pileup_file, tmp_path, case):
    multi = tmp_path / "multi.csv"
    _spawn_multihost([*CLI_CASES[case][0], "--output", str(multi), pileup_file], 2)
    assert multi.read_bytes() == _one_process(tmp_path, case, pileup_file)


@pytest.mark.slow
def test_three_processes_uneven_ranges(pileup_file, tmp_path):
    multi = tmp_path / "multi.csv"
    _spawn_multihost([*CLI_CASES["bayes"][0], "--output", str(multi), pileup_file], 3)
    assert multi.read_bytes() == _one_process(tmp_path, "bayes", pileup_file)


@pytest.mark.slow
def test_two_processes_tiny_chunks(pileup_file, tmp_path):
    multi = tmp_path / "multi.csv"
    _spawn_multihost([*CLI_CASES["lr_R"][0], "--output", str(multi), pileup_file], 2, {"SIDTPU_CHUNK_BYTES": "4096"})
    assert multi.read_bytes() == _one_process(tmp_path, "lr_R", pileup_file)


@pytest.mark.slow
def test_checkpoint_resume_two_processes(pileup_file, tmp_path):
    """--checkpoint keeps the merged histogram; --resume skips pass 1 in
    every process; the output is unchanged."""
    ckpt = tmp_path / "hist.npz"
    args = ["-R", "-m", "likelihood_ratio", "--profile", "--checkpoint", str(ckpt)]
    first = _spawn_multihost([*args, "--output", str(tmp_path / "first.csv"), pileup_file], 2)
    assert ckpt.exists() and all("# stage histogram" in e for e in first)
    resumed = _spawn_multihost([*args, "--resume", "--output", str(tmp_path / "resumed.csv"), pileup_file], 2)
    assert not any("# stage histogram" in e for e in resumed)
    assert (tmp_path / "resumed.csv").read_bytes() == (tmp_path / "first.csv").read_bytes()
