"""The port's Lynch-fit slice end to end vs sid_tpu's, byte for byte.

``sid_tpu_torch.engine.run`` on the CPU must write the same CSV bytes and the
same diagnostic lines (``# unique profiles``, the GSL convergence line,
``# heterozygosity``, ``# error``) as ``sid_tpu.engine.run`` for bayes,
likelihood_ratio, likelihood_ratio -R and local -R, under each fit backend
(auto, exact, device) and under ``--engine exact``, on the golden fixture,
the 100k real-data-shaped fixture and the arrays of
tests/test_methods_parity.py.

Two kinds of input hold the port's device fit to sid_tpu's *exact* fit
instead of its device fit, because there sid_tpu's device fit parts from the
reference (ROADMAP.md queue C): the deep-coverage inputs of fault C2, where
sid_tpu's f64 log-space objective weighs rows the reference's long doubles
skip, and the degenerate boundary-epsilon input (C3), where sid_tpu's device
trajectory drifts in the 4th printed digit and the port's does not.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import lynch  # noqa: E402
from sid_tpu_torch.ops import likelihoods  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from sid_tpu_torch.ops.profiles import (  # noqa: E402
    filter_min_coverage,
    nucleotide_distribution,
    unique_profiles,
)
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

METHODS = {
    "bayes": {"method": "bayes"},
    "lr": {"method": "likelihood_ratio"},
    "lr-R": {"method": "likelihood_ratio", "estimate_prior": True},
    "local-R": {"method": "local", "estimate_prior": True},
}
MODES = {
    "auto": {},
    "fit-exact": {"fit_backend": "exact"},
    "fit-device": {"fit_backend": "device"},
    "engine-exact": {"engine": "exact"},
}
# (input, mode) whose bar is sid_tpu's exact fit (module docstring)
EXACT_BAR = {("deep", "fit-device"), ("deep-mixture", "fit-device"), ("degenerate", "fit-device")}

DEEP_ROWS = {"deep": [9000, 9000, 0, 0], "deep-mixture": [15000, 0, 5000, 0]}


def _read(*parts):
    with open(os.path.join(FIXTURES, *parts), "rb") as f:
        return f.read()


def deep_input(row):
    """Fault C2's repro: 300 simulated ~25x sites and one deep site."""
    counts = simulate_diploid_counts(300, coverage=25, pi=0.02, eps=0.01)
    return make_pileup_text(np.vstack([counts, [row]]), with_qualities=True)


@pytest.fixture(scope="module")
def inputs():
    arrays = {
        # tests/test_methods_parity.py
        "edge": [[0, 0, 0, 0], [1, 0, 0, 0], [5, 5, 0, 0], [3, 3, 3, 3], [200, 3, 0, 1],
                 [15, 14, 1, 0], [0, 0, 0, 9], [2, 2, 2, 0], [30, 0, 0, 0], [0, 0, 0, 0]],
        "extreme": [[20, 1, 0, 0], [10, 10, 0, 0], [3000, 2800, 0, 0], [6000, 0, 0, 0],
                    [2500, 2500, 100, 0], [25, 0, 1, 0], [1, 2, 3000, 2900]] * 4,
        "degenerate": [[5, 0, 0, 0], [5, 0, 0, 0], [4, 0, 0, 0], [2, 2, 0, 0], [6, 0, 0, 0]],
        "near-flat": [[4, 0, 0, 0], [2, 2, 0, 0], [5, 0, 0, 0], [3, 3, 0, 0], [0, 4, 0, 0],
                      [0, 2, 2, 0], [6, 1, 0, 0], [3, 2, 1, 0]],
    }
    out = {name: make_pileup_text(np.array(a), with_qualities=name != "extreme")
           for name, a in arrays.items()}
    out["golden"] = _read("golden.pileup")
    out["realdata"] = _read("realdata", "bwa_like_100k.pileup.gz")
    out["sim"] = make_pileup_text(
        simulate_diploid_counts(600, coverage=25, pi=0.02, eps=0.01), with_qualities=True
    )
    for name, row in DEEP_ROWS.items():
        out[name] = deep_input(row)
    return out


def _run_both(src, kw, ref_kw):
    ref_diag, diag = [], []
    want = ref_engine.run(src, RefOptions(**ref_kw), ref_diag.append, binary=True)
    got = engine.run(src, Options(platform="cpu", **kw), diag.append, binary=True)
    return (got, diag), (want, ref_diag)


def _assert_same(got, want):
    (g_csv, g_diag), (w_csv, w_diag) = got, want
    if g_csv != w_csv:
        g, w = g_csv.split(b"\n"), w_csv.split(b"\n")
        k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        pytest.fail(f"first differing line {k}: port {g[k:k+1]!r} vs sid_tpu {w[k:k+1]!r}")
    assert g_diag == w_diag


INPUTS = ["golden", "realdata", "sim", "edge", "extreme", "degenerate", "near-flat"]


def _cases():
    for name in INPUTS + list(DEEP_ROWS):
        for method in METHODS:
            for mode in MODES:
                # the deep inputs hold the device fit to the exact fit, which
                # every other mode runs
                if name not in DEEP_ROWS or mode == "fit-device":
                    yield name, method, mode


@pytest.mark.parametrize("name,method,mode", list(_cases()))
def test_same_bytes_and_diagnostics_as_sid_tpu(inputs, name, method, mode):
    kw = {**METHODS[method], **MODES[mode]}
    ref_kw = dict(kw, fit_backend="exact") if (name, mode) in EXACT_BAR else kw
    _assert_same(*_run_both(inputs[name], kw, ref_kw))


@pytest.mark.parametrize("name", list(DEEP_ROWS))
def test_c2_repro_parts_sid_tpu_device_fit_from_the_reference(inputs, name):
    """Why the deep inputs' bar is the exact fit: sid_tpu's own device fit
    differs from it in every bayes row, the port's equals it."""
    kw = {"method": "bayes", "fit_backend": "device"}
    (got, _), (exact, _) = _run_both(inputs[name], kw, dict(kw, fit_backend="exact"))
    sid_device = ref_engine.run(inputs[name], RefOptions(**kw), binary=True)
    assert got == exact
    differing = sum(a != b for a, b in zip(sid_device.split(b"\n"), exact.split(b"\n")))
    assert differing == 301  # every record of the 301 sites


def _fit_inputs(src):
    batch = parse_pileup(src)
    profiles, mult, _ = unique_profiles(batch.counts)
    profiles, mult, _ = filter_min_coverage(profiles, mult, 4)
    return profiles, mult, nucleotide_distribution(profiles, mult)


@pytest.mark.parametrize("name", ["realdata", "deep", "deep-mixture"])
def test_device_objective(inputs, name):
    """The device fit's objective is sid_tpu's log-space objective where the
    screen flags nothing (bitwise the plain version), and adds the
    long-double terms of the rows it flags."""
    profiles, mult, nt = _fit_inputs(inputs[name])
    objective = lynch.DeviceObjective(profiles, mult, nt, torch.device("cpu"))
    tab = lgamma_table(int(profiles.sum(-1).max()), "cpu")
    for theta in [(1e-3, 1e-3), (0.01, 0.01), (0.2, 0.05)]:
        got = objective(theta)
        plain = float(likelihoods.compound_neg_log_likelihood(
            theta, torch.from_numpy(profiles), torch.from_numpy(mult), nt, tab
        ))
        if name == "realdata":
            assert got == plain
        else:
            assert np.isfinite(got) and got != plain
    assert objective.flagged == (0 if name == "realdata" else 1)
    assert objective((-0.1, 0.5)) == likelihoods.DBL_MAX


def test_auto_fits_on_the_host_up_to_500k_profiles():
    opts = Options(platform="cpu")
    assert lynch.resolve_fit_backend(opts, 500_000) == "exact"
    assert lynch.resolve_fit_backend(opts, 500_001) == "device"
    assert lynch.resolve_fit_backend(Options(fit_backend="device"), 4) == "device"
    assert lynch.resolve_fit_backend(Options(fit_backend="exact"), 10**7) == "exact"


def test_golden_files(inputs):
    for kw, name in [
        ({"method": "bayes"}, "golden_bayes.csv"),
        ({"method": "likelihood_ratio"}, "golden_likelihood_ratio.csv"),
        ({"method": "likelihood_ratio", "estimate_prior": True}, "golden_likelihood_ratio_R.csv"),
        ({"estimate_prior": True}, "golden_local_R.csv"),
    ]:
        for fit in ("auto", "exact", "device"):
            got = engine.run(inputs["golden"], Options(platform="cpu", fit_backend=fit, **kw), binary=True)
            assert got == _read(name), (name, fit)
