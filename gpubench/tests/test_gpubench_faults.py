"""A run with the timed path broken underneath comes out not correct, and
the float32 control (the reference in the port's place) does too.

The runs skip the harness's look for a card and drive the rest of a run on
the CPU, where the port takes its kernels' plain versions, at a small size:
the chunk pipeline's gate and chunk lowered so that the ``local`` cell still
calls its input in chunks. One cell, one card: no exchange between chips can
be left out.
"""

import dataclasses
import os

import numpy as np
import pytest

from gpubench import control, harness
from sid_tpu_torch import engine
from sid_tpu_torch.models import common, lynch

SITES = 40_000
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def _cell(workload):
    cell = harness.find_cell(harness.load_spec(), workload)
    cell["traffic"] = dict(cell["traffic"], sites=SITES, body_sites=SITES // 2, distinct_bodies=1,
                           min_pipeline_ratio=None)
    return cell


@pytest.fixture
def small_pipeline(monkeypatch):
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 1 << 20)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", 1 << 20)


def _run(workload):
    return harness.run_cell(_cell(workload), 2**31 + 17, 0.01, False)


def _state_unchanged(monkeypatch, workload):
    if _cell(workload)["config"]["options"].get("method") == "likelihood_ratio":
        # the fit's simplex never leaves its start
        def minimize(self, start, step):
            x = np.asarray(start, np.float64)
            return lynch.MinimizeResult(x, float(self(x)), True, 0)
        monkeypatch.setattr(lynch.DeviceObjective, "minimize", minimize)
    else:  # every call gets the first call's calls (a chunk's, an input's)
        inner, first = engine.call_batch, []

        def call_batch(batch, options, diag=None):
            first.append(first[0] if first else inner(batch, options, diag))
            return first[-1]
        monkeypatch.setattr(engine, "call_batch", call_batch)


def sites_kept(batch, keep):
    """``batch`` with the sites ``keep`` alone: every per-site field sliced
    (the quality terms too), and the reads of those sites where it has them."""
    n = batch.num_sites
    fields = {}
    for f in dataclasses.fields(batch):
        value = getattr(batch, f.name)
        if isinstance(value, np.ndarray) and value.shape[:1] == (n,):
            fields[f.name] = value[keep]
    if batch.read_offsets is not None:
        reads = np.repeat(keep, np.diff(batch.read_offsets))
        for name in ("read_code", "read_strand", "read_bq", "read_mq"):
            fields[name] = getattr(batch, name)[reads]
        fields["read_offsets"] = np.concatenate([[0], np.cumsum(np.diff(batch.read_offsets)[keep])])
    return dataclasses.replace(batch, **fields)


def _half_left_out(monkeypatch, workload):
    """Every chunk loses every other site after its parse, on every chunk path."""
    inner = engine.parse_chunk

    def parse_chunk(*args, **kwargs):
        batch = inner(*args, **kwargs)
        return sites_kept(batch, np.arange(batch.num_sites) % 2 == 0)
    monkeypatch.setattr(engine, "parse_chunk", parse_chunk)


def _answer_altered(monkeypatch, workload):
    inner = common.gather_result

    def gather_result(batch, conf_type, inverse, is_het, major, second, p1, p2, keep_u=None):
        p1 = np.array(p1, np.float64)
        p1[np.argmin(np.where(p1 > 0, p1, np.inf))] *= 1.001
        return inner(batch, conf_type, inverse, is_het, major, second, p1, p2, keep_u)
    monkeypatch.setattr(common, "gather_result", gather_result)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, small_pipeline):
    result = _run(workload)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_is_not_correct(workload, fault, small_pipeline, monkeypatch):
    fault(monkeypatch, workload)
    result = _run(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_float32_control_is_not_correct(workload):
    cell = _cell(workload)
    cell["traffic"]["sites"] = cell["traffic"]["body_sites"] = 100_000
    numbers = control.readings(cell, 3)
    limits = cell["config"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_is_handed_a_file_that_is_removed_after_the_run(workload, small_pipeline, monkeypatch):
    handed = []
    inner = engine.run

    def run(src, *args, **kwargs):
        handed.append(src)
        return inner(src, *args, **kwargs)
    monkeypatch.setattr(engine, "run", run)
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert handed and all(isinstance(src, str) and src == handed[0] for src in handed)
    assert not os.path.exists(handed[0])


def test_an_output_that_differs_at_a_probe_is_checked_whole(small_pipeline, monkeypatch):
    inner, n = engine.run, []

    def run(src, options, diag=None, binary=False):
        out = inner(src, options, diag, binary)
        n.append(1)
        if len(n) == 3:  # the window's second request: one row's call altered
            at = out.rindex(b",hom,") + 1
            out = out[:at] + b"het" + out[at + 3:]
        return out
    monkeypatch.setattr(engine, "run", run)
    result = harness.run_cell(_cell("local.chrom17M"), 2**31 + 17, 1.5, False)
    assert result["attempted"] >= 2 and not result["correct"], result["checks"]
