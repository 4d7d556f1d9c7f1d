"""The chunk paths' output written in place (``engine._Output``), on the
CPU.

Both chunk paths grow one ``bytes`` object a chunk and have each chunk's
writer fill its rows there; nothing is joined after the pass. Over many
small chunks (many growths) the output must be byte-equal to
``engine._run_monolithic``'s, as ``bytes`` in binary mode and ``str`` in
text mode, for ``local``, ``quality`` (whose per-site writer's parts are
copied in), ``likelihood_ratio -R`` and ``bayes``, with the counters
``serialize:in_place_bytes``, ``serialize:copied_bytes`` and
``serialize:resizes`` saying which happened. The writer's two steps
(``bridge.csv_plan``) must write at an offset into a larger buffer exactly
what ``write_csv_indexed`` gives, and no byte beside it; an index outside
its table raises before the output grows, and a later run is still right.
"""

import ctypes
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io import native  # noqa: E402
from sid_tpu_torch.models.common import CSV_HEADER  # noqa: E402
from sid_tpu_torch.native import bridge  # noqa: E402
from sid_tpu_torch.utils import profiling  # noqa: E402
from synth import make_bwa_like_pileup_scaled  # noqa: E402
from test_torch_csv_writer import CASES  # noqa: E402

HEADER = (CSV_HEADER + "\n").encode()
CHUNK_BYTES = 16 << 10  # ~350 KB of input: ~22 chunks, a growth each

METHODS = {
    "local": ({"method": "local"}, "pipeline:call"),
    "quality": ({"method": "quality"}, "pipeline:call"),
    "lr-R": ({"method": "likelihood_ratio", "estimate_prior": True, "fit_backend": "device"}, "pipeline:gather"),
    "bayes": ({"method": "bayes", "fit_backend": "device"}, "pipeline:gather"),
}


@pytest.fixture(scope="module")
def text():
    return make_bwa_like_pileup_scaled(3_000, seed=5)


@pytest.fixture()
def small_chunks(monkeypatch):
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", 0)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", CHUNK_BYTES)


def _profiled(fn):
    prof = profiling.StageProfile()
    profiling.activate(prof)
    try:
        return fn(), prof
    finally:
        profiling.activate(None)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
@pytest.mark.parametrize("case", sorted(METHODS))
def test_chunk_paths_equal_the_monolithic_run(text, small_chunks, case, binary):
    kw, per_chunk = METHODS[case]
    opts = Options(platform="cpu", **kw)
    got, prof = _profiled(lambda: engine.run(text, opts, binary=binary))
    want = engine._run_monolithic(text, opts, None, True)
    if binary:
        assert type(got) is bytes and got == want
        assert sys.getrefcount(got) == 2  # the caller's reference alone
    else:
        assert type(got) is str and got.encode("latin1") == want
    assert hash(got) == hash(want if binary else want.decode("latin1"))
    chunks = sum(name == per_chunk for name, _ in prof.stages)
    assert chunks >= 10
    counters = prof.counters
    body = len(want) - len(HEADER)
    copied = body if case == "quality" else 0  # the per-site writer has no plan
    assert counters["serialize:copied_bytes"] == copied
    assert counters["serialize:in_place_bytes"] == body - copied
    assert counters["serialize:bytes"] == body
    assert counters["serialize:resizes"] == chunks  # every chunk here has rows
    assert sum(name == "join" for name, _ in prof.stages) == 1


@pytest.mark.parametrize("include_header", [True, False], ids=["header", "no-header"])
@pytest.mark.parametrize("case", ["empty", "one-row", "chromosomes", "classes-65536"])
def test_plan_then_fill_at_an_offset(case, include_header):
    """The plan's size is the array's; filled at an odd offset into a
    larger buffer, the bytes are the array's and the canaries on both
    sides stay."""
    res = CASES[case]()
    want = bridge.write_csv_indexed(native.load(), native.csv_writer(), res, include_header)
    offset = 4_099
    with res.csv_plan(include_header) as (size, fill):
        assert size == want.shape[0]
        buf = np.full(offset + size + 64, 0xA5, np.uint8)
        fill(buf.ctypes.data + offset)
    assert buf[offset:offset + size].tobytes() == want.tobytes()
    assert (buf[:offset] == 0xA5).all() and (buf[offset + size:] == 0xA5).all()


def test_a_bad_index_raises_before_the_output_grows(text, small_chunks, monkeypatch):
    """The output keeps what it held; on the chunk path the request
    raises after one chunk's growth, and the next run is byte-equal to
    the monolithic one."""
    good, bad = CASES["chromosomes"](), CASES["one-row"]()
    bad.class_idx[0] = 1  # of one class
    with engine._Output() as out:
        out.write(good)
        size = out._size
        with pytest.raises(ValueError, match="outside its table"):
            out.write(bad)
        assert out._size == size
        got = out.take(True)
    assert got == HEADER + good.to_csv_bytes(include_header=False)

    opts = Options(platform="cpu")
    call_batch = engine.call_batch
    calls = []

    def second_call_bad(batch, options, diag=None):
        result = call_batch(batch, options, diag)
        calls.append(result)
        if len(calls) == 2:
            result.class_idx[0] = result.is_het.shape[0]
        return result

    monkeypatch.setattr(engine, "call_batch", second_call_bad)
    prof = profiling.StageProfile()
    profiling.activate(prof)
    try:
        with pytest.raises(ValueError, match="outside its table"):
            engine.run(text, opts, binary=True)
    finally:
        profiling.activate(None)
    assert len(calls) == 2 and prof.counters["serialize:resizes"] == 1
    assert prof.counters["serialize:in_place_bytes"] == len(calls[0].to_csv_bytes(include_header=False))
    monkeypatch.setattr(engine, "call_batch", call_batch)
    assert engine.run(text, opts, binary=True) == engine._run_monolithic(text, opts, None, True)


def test_the_output_holds_one_reference_while_it_grows():
    """``_PyBytes_Resize`` needs the object's one reference: many growths
    over blocks of every size, each filled, give the bytes written. The
    block stays in one mapping (huge-page advice on part of it would split
    it, and glibc would copy it at every growth)."""
    parts = [bytes([65 + k % 26]) * n for k, n in enumerate([1, 7, 4096, 3 << 20, 5, 9 << 20, 1, 5 << 20])]
    with engine._Output() as out:
        for part in parts:
            end = out._grow(len(part)) + len(part)
            ctypes.memmove(end - len(part), part, len(part))
            lo, hi = engine._mapping_of(out._ob.value)
            assert lo <= out._ob.value and end <= hi
        got = out.take(True)
    assert got == HEADER + b"".join(parts) and sys.getrefcount(got) == 2
