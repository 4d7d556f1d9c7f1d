"""A ``-m quality`` cell through ``harness.run_cell`` on the CPU, built here
from the ``chrom12M.mq`` traffic (seven columns) at 40,000 sites and not
listed in BENCHMARK.json: a sound run is correct, and a run with the timed
path broken underneath, or the float32 control, is not. The chunk
pipeline's gate and chunk are lowered, so that the run calls its input in
chunks, as ``test_gpubench_faults.py`` does."""

import dataclasses

import numpy as np
import pytest

from gpubench import control, harness
from gpubench.tests.test_gpubench_faults import _half_left_out
from sid_tpu_torch import engine

SITES = 40_000
LIMITS = {"rows_bad": 0, "calls_bad": 0, "conf_gap": 4.0}  # as wgs30x-local's


def _cell(sites=SITES):
    traffic = harness.load_json(harness.ROOT, "gpubench", "traffic", "chrom12M.mq.json")
    return {"cell": {"name": "quality.chrom12M.mq", "config": "quality", "traffic": "chrom12M.mq", "chips": 1},
            "config": {"options": {"method": "quality"}, "limits": LIMITS},
            "traffic": dict(traffic, sites=sites, body_sites=sites // 2, distinct_bodies=1, min_pipeline_ratio=None)}


@pytest.fixture
def small_pipeline(monkeypatch):
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 1 << 20)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", 1 << 20)


def _run():
    return harness.run_cell(_cell(), 2**31 + 23, 0.01, False)


def _mapping_quality_ignored(monkeypatch):
    """Each chunk parsed without its mapping-quality column: every read's
    mapping quality taken as 1."""
    inner = engine.parse_chunk

    def parse_chunk(src, offset, chunk, parse_bq, parse_mq, **kwargs):
        return inner(src, offset, chunk, parse_bq, False, **kwargs)
    monkeypatch.setattr(engine, "parse_chunk", parse_chunk)


def _confidence_moved(monkeypatch):
    """In each call (a chunk), one site's hom confidence, the smallest
    positive, moved by 1e-3."""
    inner = engine.call_batch

    def call_batch(batch, options, diag=None):
        result = inner(batch, options, diag)
        p1 = np.array(result.conf_hom, np.float64)
        p1[np.argmin(np.where(p1 > 0, p1, np.inf))] *= 1.001
        return dataclasses.replace(result, conf_hom=p1)
    monkeypatch.setattr(engine, "call_batch", call_batch)


def test_a_sound_quality_run_is_correct_on_the_chunk_pipeline(small_pipeline, monkeypatch):
    taken, parsed = [], []
    inner, inner_parse = engine._run_pipelined_single_pass, engine.parse_chunk
    monkeypatch.setattr(engine, "_run_pipelined_single_pass", lambda *a: (taken.append(1), inner(*a))[1])
    monkeypatch.setattr(engine, "parse_chunk", lambda *a, **k: (parsed.append(1), inner_parse(*a, **k))[1])
    result = _run()
    assert result["correct"], result["checks"]
    assert taken and len(parsed) >= 3 * len(taken)
    assert result["checks"]["conf_gap"]["value"] <= 1.0


@pytest.mark.parametrize("fault", [_half_left_out, _mapping_quality_ignored, _confidence_moved])
def test_a_quality_fault_is_not_correct(fault, small_pipeline, monkeypatch):
    if fault is _half_left_out:
        fault(monkeypatch, "quality.chrom12M.mq")
    else:
        fault(monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_quality_float32_control_is_not_correct():
    cell = _cell(100_000)
    numbers = control.readings(cell, 3)
    assert any(numbers[k] > LIMITS[k] for k in LIMITS), numbers
