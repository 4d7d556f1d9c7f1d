"""The port's in-place indexed CSV writer (``csrc/host/csv_writer.cpp``,
libsidtpu_csv) against libsidtpu's ``sidtpu_write_csv_indexed``, byte for
byte, on the CPU.

libsidtpu's indexed writer (the port's copy of ``sid_tpu/native``'s) stays
in the library as the oracle. The cases cover empty, one-row and
fewer-rows-than-threads results, the header on and off, chromosome names
of any bytes, the int32 position extremes, the ``%g`` edge values, one
class and 65,536 classes, both ``conf_type`` spellings, and thread counts
that leave parts too small for the writer's block copies; a canary past
the planned size checks that no thread writes beyond it, and an index
outside its table raises before anything is written. The chunk
pipeline, which has each chunk's writer fill its rows into the request's
output, must equal the monolithic run, and its ``serialize:bytes`` counter
the bytes after the header.
"""

import ctypes

import numpy as np
import pytest

pytest.importorskip("torch")

from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io import native  # noqa: E402
from sid_tpu_torch.models.common import CSV_HEADER, CallResult  # noqa: E402
from sid_tpu_torch.native import bridge  # noqa: E402
from sid_tpu_torch.utils import profiling  # noqa: E402
from synth import make_bwa_like_pileup_scaled  # noqa: E402

HEADER = (CSV_HEADER + "\n").encode()
NAN = float("nan")
EDGE_CONFS = [
    1.0, 0.0, -0.0, NAN, -NAN, float("inf"), float("-inf"), 5e-324, -5e-324,
    2.2250738585072009e-308, 2.2250738585072014e-308, 1.7976931348623157e308,
    1e-5, 9.999995e-6, 1e-4, 9.9999949e-5, 0.0001000001, 999999.5, 999999.4, 1e6, 0.5, 1 / 3,
]
INT32 = np.iinfo(np.int32)
EDGE_POS = [0, -1, 1, 9, 10, 99, 100, 999_999_999, 1_000_000_000, -1_000_000_000,
            INT32.min, INT32.min + 1, INT32.max, INT32.max - 1, 27_000_000]


def _result(n, u, seed=0, chroms=("chr1",), pos=None, confs=None):
    """A result of n rows over u classes: rows' chromosomes, positions and
    classes drawn from the seed, the classes' confidences from ``confs``
    (cycled) or drawn over the whole double range."""
    rng = np.random.default_rng(seed)
    if pos is None:
        pos = rng.integers(INT32.min, INT32.max, n, endpoint=True)
    pos = np.resize(np.asarray(pos, np.int64), n).astype(np.int32)
    if confs is None:
        conf_hom = 10.0 ** rng.uniform(-320, 308, u) * rng.choice([-1.0, 1.0], u)
        conf_het = np.where(rng.random(u) < 0.2, 1.0, rng.random(u) ** 8)
    else:
        conf_hom = np.resize(np.asarray(confs, np.float64), u)
        conf_het = np.roll(conf_hom, 3)
    return CallResult(
        chrom_id=rng.integers(0, len(chroms), n).astype(np.int32), chrom_table=list(chroms), pos=pos,
        is_het=rng.integers(0, 2, u).astype(np.uint8), major=rng.integers(0, 4, u).astype(np.int32),
        second=rng.integers(0, 4, u).astype(np.int32), conf_hom=conf_hom, conf_het=conf_het,
        conf_type="p_value", class_idx=rng.integers(0, u, n).astype(np.int32),
    )


CASES = {
    "empty": lambda: _result(0, 1),
    "one-row": lambda: _result(1, 1),
    "below-threads": lambda: _result(3, 2),
    "chromosomes": lambda: _result(
        5_000, 40, seed=1,
        chroms=["chr1", "a,b", "chr\xe9", "", "\t \x00\xff", "scaffold_" + "x" * 300, "2"]),
    "positions": lambda: _result(4_000, 30, seed=2, pos=EDGE_POS),
    "confidences": lambda: _result(3_000, len(EDGE_CONFS), seed=3, confs=EDGE_CONFS),
    "one-class": lambda: _result(20_000, 1, seed=4, pos=np.arange(10_000_001, 10_020_001)),
    "classes-65536": lambda: _result(200_000, 65_536, seed=5),
}


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _arrays(res):
    return dict(
        chrom_id=np.ascontiguousarray(res.chrom_id, np.int32), pos=np.ascontiguousarray(res.pos, np.int32),
        class_idx=np.ascontiguousarray(res.class_idx, np.int32),
        is_het=np.ascontiguousarray(res.is_het, np.uint8),
        major=np.ascontiguousarray(res.major, np.int32),
        second=np.ascontiguousarray(res.second, np.int32),
        hom=np.ascontiguousarray(res.conf_hom, np.float64),
        het=np.ascontiguousarray(res.conf_het, np.float64),
    )


def _row_args(res, a):
    blob = bridge.encode_chrom_blob(res.chrom_table)
    i32, f64 = ctypes.c_int32, ctypes.c_double
    return (blob, len(blob), _p(a["chrom_id"], i32), _p(a["pos"], i32), _p(a["class_idx"], i32),
            res.num_records, _p(a["is_het"], ctypes.c_uint8), _p(a["major"], i32), _p(a["second"], i32),
            _p(a["hom"], f64), _p(a["het"], f64), a["hom"].shape[0], res.conf_type.encode())


def oracle(res, include_header: bool) -> bytes:
    """libsidtpu's indexed writer's bytes."""
    lib = native.load()
    a = _arrays(res)
    out = ctypes.POINTER(ctypes.c_char)()
    n = lib.sidtpu_write_csv_indexed(*_row_args(res, a), int(include_header), 0, ctypes.byref(out))
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.sidtpu_buffer_free(out)


@pytest.mark.parametrize("include_header", [True, False], ids=["header", "no-header"])
@pytest.mark.parametrize("conf_type", ["p_value", "probability"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_byte_equal_to_libsidtpu(case, conf_type, include_header):
    res = CASES[case]()
    res.conf_type = conf_type
    got = res.to_csv_buffer(include_header)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.ndim == 1
    want = oracle(res, include_header)
    assert got.tobytes() == want
    assert want.startswith(HEADER) == include_header
    assert want.count(b"\n") == res.num_records + include_header


@pytest.mark.parametrize("n_threads", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("n", [0, 1, 5, 200, 30_000])
def test_every_thread_count_writes_inside_its_plan(n, n_threads):
    """Parts from one row to thousands, each thread's rows at its offset,
    with the block copies' room at every part's end; 64 canary bytes past
    the planned size stay as they were."""
    res = _result(n, 50, seed=n + n_threads, chroms=["chr1", "x" * 70, "c"], pos=EDGE_POS)
    lib, csv = native.load(), native.csv_writer()
    a = _arrays(res)
    plan = csv.sidtpu_csv_plan(*_row_args(res, a), 1, n_threads, ctypes.cast(lib.sidtpu_format_g, ctypes.c_void_p))
    try:
        total = csv.sidtpu_csv_total(plan)
        buf = np.full(total + 64, 0xA5, np.uint8)
        assert csv.sidtpu_csv_fill(plan, buf.ctypes.data_as(ctypes.c_void_p)) == total
    finally:
        csv.sidtpu_csv_free(plan)
    assert buf[:total].tobytes() == oracle(res, True)
    assert (buf[total:] == 0xA5).all()


@pytest.mark.parametrize("field, value", [
    ("class_idx", -1), ("class_idx", 50), ("chrom_id", -1), ("chrom_id", 3),
])
def test_an_index_outside_its_table_raises(field, value):
    """The plan checks every row's chromosome and class against their
    tables (3 names, 50 classes) before anything is written."""
    res = _result(1_000, 50, chroms=["a", "b", "c"])
    getattr(res, field)[777] = value
    with pytest.raises(ValueError, match="outside its table"):
        res.to_csv_buffer()


@pytest.mark.parametrize("include_header", [True, False], ids=["header", "no-header"])
def test_buffer_and_bytes_agree(include_header):
    res = CASES["chromosomes"]()
    buf = res.to_csv_buffer(include_header)
    got = res.to_csv_bytes(include_header)
    assert type(got) is bytes and got == buf.tobytes()
    assert res.to_csv(include_header) == got.decode("latin1")
    assert b"".join([HEADER, buf, buf]) == HEADER + got + got


@pytest.fixture()
def pipelined(tmp_path, monkeypatch):
    """A path over the (lowered) pipeline gate, cut into 64 KB chunks."""
    text = make_bwa_like_pileup_scaled(4_000, seed=11)
    path = tmp_path / "in.pileup"
    path.write_bytes(text)
    monkeypatch.setattr(engine, "PIPELINE_MIN_BYTES", len(text) // 2)
    monkeypatch.setattr(engine, "PIPELINE_CHUNK_BYTES", 64 << 10)
    return str(path), text


def _profiled(fn):
    prof = profiling.StageProfile()
    profiling.activate(prof)
    try:
        return fn(), prof
    finally:
        profiling.activate(None)


@pytest.mark.parametrize("method", ["local", "quality"])
def test_pipeline_of_buffers_equals_the_monolithic_run(pipelined, method):
    """Each chunk's rows are written into the request's output, which is
    returned as bytes equal to the monolithic run's, and
    ``serialize:bytes`` counts every byte after the header."""
    path, text = pipelined
    opts = Options(platform="cpu", method=method)
    got, prof = _profiled(lambda: engine.run(path, opts, binary=True))
    calls = [name for name, _ in prof.stages if name == "pipeline:call"]
    assert len(calls) >= 4  # several chunks
    assert type(got) is bytes and got == engine._run_monolithic(path, opts, None, True)
    assert prof.counters["serialize:bytes"] == len(got) - len(HEADER)
    assert "# serialize:bytes: " in prof.report()


def test_text_mode_counts_the_same_bytes(pipelined):
    path, _ = pipelined
    got, prof = _profiled(lambda: engine.run(path, Options(platform="cpu")))
    assert isinstance(got, str)
    assert got.encode("latin1") == engine._run_monolithic(path, Options(platform="cpu"), None, True)
    assert prof.counters["serialize:bytes"] == len(got) - len(HEADER)
