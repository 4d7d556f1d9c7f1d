"""The ``lrR.chrom17M`` cell's readers and roofline model on made-up runs,
the model's hook on a real fit, and faults of the fitted chunk pipeline
that the check must catch (runs on the CPU at a small size, as
``test_gpubench_faults.py`` runs them)."""

import types

import numpy as np
import pytest

from gpubench import harness, rooflines
from gpubench.tests.test_gpubench_faults import _half_left_out
from sid_tpu_torch import engine

SITES = 40_000
PER_MSITE = {
    "dedup_ms_per_Msite.fitted": "pipeline:dedup",
    "gather_ms_per_Msite.fitted": "pipeline:gather",
}
LEAVES = [("pipeline:read", 0.4), ("pipeline:parse_wait", 0.1), ("pipeline:dedup", 0.5), ("fit+classify", 0.05),
          ("pipeline:gather", 0.3), ("pipeline:serialize", 0.35), ("join", 0.2)]


def _run(stages, walls=(1.0, 1.0)):
    """Two requests of 2M sites each."""
    return harness.Run({"total": 1.0}, list(walls), sum(walls), 2_000_000, stages=list(stages))


@pytest.mark.parametrize("name", sorted(PER_MSITE))
def test_per_msite_reader(name):
    read = harness.reader(name)
    assert read(_run([("pipeline", 1.8), ("call:unique_profiles", 0.2), ("call:gather_result", 0.1)])) is None
    stage = PER_MSITE[name]
    # 0.25 + 0.15 s over two requests of 2M sites: 100 ms a Msite
    assert read(_run([(stage, 0.25), ("pipeline", 1.8), (stage, 0.15)])) == pytest.approx(100.0)


def test_fit_classify_ms_is_a_requests_share():
    read = harness.reader("fit_classify_ms")
    assert read(_run([("call", 1.0), ("device:fit_lynch", 0.004)])) is None
    assert read(_run([("fit+classify", 0.003), ("fit+classify", 0.005)])) == pytest.approx(4.0)


def test_unspanned_pct_fitted_reads_nothing_without_the_dedup_stage():
    read = harness.reader("engine.unspanned_pct.fitted")
    # the chunk pipeline's leaves, and the monolithic path's stages
    assert read(_run([("pipeline:read", 0.4), ("pipeline:call", 0.8), ("join", 0.2)])) is None
    assert read(_run([("parse", 0.6), ("call", 0.8), ("serialize", 0.4)])) is None


def test_unspanned_pct_fitted_is_exact_and_falls_as_leaves_are_added():
    read = harness.reader("engine.unspanned_pct.fitted")
    # 2 s of walls; the leaves sum to 1.9 s: 5 %; nested stages are not leaves
    assert read(_run(LEAVES + [("pipeline", 1.7), ("worker:parse", 0.9), ("call:unique_profiles", 0.4),
                               ("host:lrt_bh", 0.01)])) == pytest.approx(5.0)
    dedup_first = [LEAVES[2]] + LEAVES[:2] + LEAVES[3:]
    values = [read(_run(dedup_first[:k])) for k in range(1, len(LEAVES) + 1)]
    assert values == sorted(values, reverse=True) and len(set(values)) == len(values)
    assert values[0] == pytest.approx(75.0) and values[-1] == pytest.approx(5.0)


def _fit(lane_rows, evaluations):
    """A stand-in for a fit's workspace after its run."""
    offsets = np.concatenate([[0], np.cumsum(lane_rows)])
    return types.SimpleNamespace(offsets=offsets, last=types.SimpleNamespace(evaluations=np.array(evaluations)))


def test_lynch_fit_roofline_on_a_made_up_trace():
    read = harness.reader("lynch_fit_roofline")
    model = rooflines.model("lynch_fit")
    run = _run([])
    assert read(run) is None  # no trace
    run.device = {"kernels": {"lynch_fit_lanes_kernel": [2, 1e-4]}}
    assert read(run) is None  # no recorded call
    run.calls["lynch_fit"] = [_fit([2_000], [90]), _fit([1_000, 500], [80, 70]),
                              types.SimpleNamespace(offsets=np.array([0, 9]), last=None)]
    row_evaluations = 2_000 * 90 + 1_000 * 80 + 500 * 70
    assert model.work(run.calls["lynch_fit"]) == (24 * row_evaluations, 93 * row_evaluations)
    assert read(run) == pytest.approx(rooflines.share(24 * row_evaluations, 93 * row_evaluations, 1e-4))
    run.device = {"kernels": {"lynch_marginals_kernel": [2, 1e-4]}}
    assert read(run) is None  # another kernel's time is not the fit's


def test_the_model_records_the_fits_of_a_run(monkeypatch):
    """In a traced run the harness wraps ``models.lynch.run_fit``; the
    device fit looks it up at call time, so each fit is recorded, and its
    evaluations are read once it has run."""
    from gpubench.traffic import generate
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.models import lynch

    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 1 << 20)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", 1 << 20)
    cell = harness.find_cell(harness.load_spec(), "lrR.chrom17M")
    traffic = dict(cell["traffic"], sites=SITES, body_sites=SITES // 2, distinct_bodies=1)
    text = generate.make_pileup(traffic, 5)
    run = _run([])
    inner = lynch.run_fit
    with harness.recording(run):
        assert lynch.run_fit is not inner
        engine.run(text, Options(platform="cpu", **cell["config"]["options"]), None, True)
    assert lynch.run_fit is inner
    (fit,) = run.calls["lynch_fit"]
    rows = int(fit.offsets[-1])
    evaluations = int(fit.last.evaluations.sum())
    assert rows > 100 and evaluations > 10
    model = rooflines.model("lynch_fit")
    assert model.work(run.calls["lynch_fit"]) == (24 * rows * evaluations, 93 * rows * evaluations)


# ---- faults of the fitted chunk pipeline ----


def _cell():
    cell = harness.find_cell(harness.load_spec(), "lrR.chrom17M")
    cell["traffic"] = dict(cell["traffic"], sites=SITES, body_sites=SITES // 2, distinct_bodies=1,
                           min_pipeline_ratio=None)
    return cell


def _sites_left_out(monkeypatch):
    """Each chunk loses every other site after its parse."""
    _half_left_out(monkeypatch, "lrR.chrom17M")


def _chunks_left_out_of_the_table(monkeypatch):
    """The fit's table takes the multiplicities of a request's first
    chunk alone."""
    inner = engine.merge_profile_tables

    def merge(keys, mult, more_keys, more_mult):
        return inner(keys, mult, more_keys, more_mult * (len(keys) == 0))
    monkeypatch.setattr(engine, "merge_profile_tables", merge)


def _sites_off_their_rows(monkeypatch):
    """Each chunk holds each site's row one site late."""
    inner = engine._HeldChunk

    def held(chrom_id, chrom_table, pos, keys, inverse):
        return inner(chrom_id, chrom_table, pos, keys, np.roll(inverse, 1))
    monkeypatch.setattr(engine, "_HeldChunk", held)


@pytest.fixture
def small_pipeline(monkeypatch):
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 1 << 20)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", 1 << 20)


def test_a_sound_fitted_run_is_correct_and_takes_the_fitted_path(small_pipeline, monkeypatch):
    taken = []
    inner = engine._run_fitted_pipeline
    monkeypatch.setattr(engine, "_run_fitted_pipeline", lambda *a: (taken.append(1), inner(*a))[1])
    result = harness.run_cell(_cell(), 2**31 + 17, 0.01, False)
    assert result["correct"], result["checks"]
    assert taken and set(result["checks"]) == {"rows_bad", "calls_bad", "conf_gap", "fit_gap"}


@pytest.mark.parametrize("fault", [_sites_left_out, _chunks_left_out_of_the_table, _sites_off_their_rows])
def test_a_fitted_fault_is_not_correct(fault, small_pipeline, monkeypatch):
    fault(monkeypatch)
    result = harness.run_cell(_cell(), 2**31 + 17, 0.01, False)
    assert not result["correct"], result["checks"]
