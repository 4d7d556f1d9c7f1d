"""``./sid-tpu-torch`` vs ``./sid-tpu`` as processes: same stdout, stderr and
exit code for the same arguments (sid.cpp:11-110 behavior).

Both run with ``--platform cpu``. For ``-h`` the reference part of the help
(the usage line and the six reference flags) must match; the long options
describe each package's own framework. ``--population`` writes
``<input>.calls.csv`` beside each input, so each tool runs each population
case on its own copy of the samples, in a directory of its own, and the
files it writes must be equal too. Every process of the module is started
once, a few at a time, by the ``results`` fixture: each one spends seconds
importing its framework.
"""

import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")

from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = "not yet ported in sid_tpu_torch"

CASES = {
    "normal": ["in.pileup"],
    "flags": ["-r", "1e-3", "-E", "0.2", "-p", "0.01", "in.pileup"],
    "help": ["-h"],
    "no-file": [],
    "missing-file": ["/nonexistent/file.pileup"],
    "malformed": ["bad.pileup"],
    "unknown-flag": ["-z", "in.pileup"],
    "unknown-method": ["-m", "bogus", "in.pileup"],
    "bayes": ["-m", "bayes", "in.pileup"],
    "R": ["-R", "in.pileup"],
    "R-lr": ["-R", "-m", "likelihood_ratio", "in.pileup"],
    "engine-exact": ["--engine", "exact", "-R", "-m", "likelihood_ratio", "in.pileup"],
    "stream": ["--stream", "in.pileup"],
    "quality": ["-m", "quality", "in.pileup"],
    "quality-R": ["-R", "-m", "quality", "in.pileup"],
    "quality-exact": ["--engine", "exact", "-m", "quality", "in.pileup"],
    "stream-quality-R": ["--stream", "--chunk-mb", "1", "-R", "-m", "quality", "in.pileup"],
    "stream-R-lr": ["--stream", "-R", "-m", "likelihood_ratio", "in.pileup"],
}
UNPORTED = {"devices": ["--devices", "2"], "per-shard-fit": ["--per-shard-fit"]}
POP_SAMPLES = ["s0.pileup", "s1.pileup", "s2.pileup"]
POPULATION = {
    "pooled-bayes": ["--population", "pooled", "-m", "bayes"] + POP_SAMPLES,
    "independent-bayes": ["--population", "independent", "-m", "bayes"] + POP_SAMPLES,
    "pooled-R-lr": ["--population", "pooled", "-R", "-m", "likelihood_ratio"] + POP_SAMPLES,
    "independent-R-lr": ["--population", "independent", "-R", "-m", "likelihood_ratio"] + POP_SAMPLES,
    "pooled-local": ["--population", "pooled"] + POP_SAMPLES,
    "independent-local": ["--population", "independent", "-m", "local"] + POP_SAMPLES,
    "stream-pooled-bayes": ["--population", "pooled", "--stream", "--chunk-mb", "1", "-m", "bayes"] + POP_SAMPLES,
    "stream-independent-R-lr": ["--population", "independent", "--stream", "-R", "-m", "likelihood_ratio"]
    + POP_SAMPLES,
    "stream-pooled-local": ["--population", "pooled", "--stream"] + POP_SAMPLES,
    "missing-file": ["--population", "pooled", "s0.pileup", "/nonexistent/file.pileup"],
}
PROFILE = ["--profile", "--output", "out.csv", "in.pileup"]


def _run(tool, args, cwd):
    proc = subprocess.run(
        [os.path.join(REPO, tool), "--platform", "cpu"] + args,
        capture_output=True, cwd=cwd, timeout=300,
    )
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    counts = simulate_diploid_counts(200, coverage=20, pi=0.05, eps=0.01, seed=9)
    (d / "in.pileup").write_bytes(make_pileup_text(counts, with_qualities=True))
    (d / "bad.pileup").write_bytes(b"chr1\t1\tA\t1\t.\nnot a pileup line\n")
    # population cases: one directory per case and tool, each with the samples
    for case in POPULATION:
        for tool in ("sid-tpu", "sid-tpu-torch"):
            pd = d / "population" / case / tool
            pd.mkdir(parents=True)
            for k, name in enumerate(POP_SAMPLES):
                counts = simulate_diploid_counts(300, coverage=20, pi=0.01 * (k + 1), eps=0.01, seed=40 + k)
                (pd / name).write_bytes(make_pileup_text(counts, with_qualities=True))
    return d


@pytest.fixture(scope="module")
def results(workdir):
    jobs = {}
    for case, args in CASES.items():
        jobs[("sid-tpu", case)] = args
        jobs[("sid-tpu-torch", case)] = args
    for case, args in UNPORTED.items():
        jobs[("sid-tpu-torch", case)] = args + ["in.pileup"]
    jobs[("sid-tpu-torch", "profile")] = PROFILE
    cwd = {}
    for case, args in POPULATION.items():
        for tool in ("sid-tpu", "sid-tpu-torch"):
            jobs[(tool, "population-" + case)] = args
            cwd[(tool, "population-" + case)] = workdir / "population" / case / tool
    with ThreadPoolExecutor(4) as ex:
        futures = {key: ex.submit(_run, key[0], args, cwd.get(key, workdir)) for key, args in jobs.items()}
        return {key: fut.result() for key, fut in futures.items()}


@pytest.mark.parametrize("case", [c for c in CASES if c != "help"])
def test_same_answer_as_sid_tpu(results, case):
    assert results[("sid-tpu-torch", case)] == results[("sid-tpu", case)]


def test_help(results):
    rc_w, out_w, err_w = results[("sid-tpu", "help")]
    rc_g, out_g, err_g = results[("sid-tpu-torch", "help")]
    assert (rc_g, err_g) == (rc_w, err_w) == (1, b"No file name given!\n")
    assert out_g.splitlines()[:7] == out_w.splitlines()[:7]


@pytest.mark.parametrize("case", list(UNPORTED))
def test_not_yet_ported_exits_1(results, case):
    rc, out, err = results[("sid-tpu-torch", case)]
    assert rc == 1 and out == b""
    assert NOT_PORTED in err.decode()


def test_output_file_and_profile(results, workdir):
    rc, out, err = results[("sid-tpu-torch", "profile")]
    assert rc == 0 and out == b""
    assert (workdir / "out.csv").read_bytes() == results[("sid-tpu-torch", "normal")][1]
    text = err.decode()
    assert "# stage parse:" in text and "# stage device:local_log_likelihoods:" in text
    assert "# throughput:" in text and "over 200 sites" in text


@pytest.mark.parametrize("case", list(POPULATION))
def test_population_same_answer_as_sid_tpu(results, workdir, case):
    """Exit code, stdout and stderr (the pooled fit's lines and one
    ``# wrote`` line a sample), and every sample's .calls.csv, byte for
    byte."""
    got = results[("sid-tpu-torch", "population-" + case)]
    rc, out, err = results[("sid-tpu", "population-" + case)]
    # sid_tpu's jitted fits make XLA log its CPU-feature lines here
    want = (rc, out, b"".join(ln for ln in err.splitlines(True) if b"cpu_aot_loader" not in ln))
    assert got == want
    rc, out, err = got
    base = workdir / "population" / case
    if case == "missing-file":
        assert (rc, out, err) == (1, b"", b"Could not open file: /nonexistent/file.pileup\n")
        assert not (base / "sid-tpu-torch" / "s0.pileup.calls.csv").exists()
        return
    assert rc == 0 and out == b""
    assert err.count(b"# wrote ") == len(POP_SAMPLES)
    assert (b"# pooled error: " in err) == ("pooled" in case)
    for name in POP_SAMPLES:
        got_csv = (base / "sid-tpu-torch" / (name + ".calls.csv")).read_bytes()
        assert got_csv == (base / "sid-tpu" / (name + ".calls.csv")).read_bytes()
        assert got_csv.startswith(b"chrom,pos,label,gt,hom_conf,het_conf,conf_type\n") and got_csv.count(b"\n") > 100
