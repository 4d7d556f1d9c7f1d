"""``./sid-tpu-torch`` vs ``./sid-tpu`` as processes: same stdout, stderr and
exit code for the same arguments (sid.cpp:11-110 behavior).

Both run with ``--platform cpu``. For ``-h`` the reference part of the help
(the usage line and the six reference flags) must match; the long options
describe each package's own framework. Every process of the module is
started once, a few at a time, by the ``results`` fixture: each one spends
seconds importing its framework.
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
UNPORTED = {"population": ["--population", "pooled"], "devices": ["--devices", "2"],
            "per-shard-fit": ["--per-shard-fit"]}
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
    with ThreadPoolExecutor(4) as ex:
        futures = {key: ex.submit(_run, key[0], args, workdir) for key, args in jobs.items()}
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
