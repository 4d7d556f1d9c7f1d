"""The chunk pipeline's reads as views, on the CPU.

``io.stream.chunk_views`` gives ``iter_chunks``' chunks at its offsets as
``memoryview`` slices of plain bytes or of a plain file's read-only map,
and ``iter_chunks``' bytes for gzip; the native parser reads any
contiguous byte buffer in place. Held here: the same chunks at the same
offsets, the same CSV from a path, bytes, a gzip path and a file object
(the monolithic run) for ``local``, ``quality`` and ``-R -m
likelihood_ratio``, the file's line on a parse error, every view released
and the file unmapped and closed on each way out of the read loop, no
batch over its input, and the ``read:view_bytes`` / ``read:copied_bytes``
counters.
"""

import gzip
import io
import os
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from sid_tpu_torch import cli, engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io import native, stream  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.native import bridge  # noqa: E402
from sid_tpu_torch.utils import profiling  # noqa: E402
from sid_tpu_torch.utils.errors import ErrorChannel, SidParseError  # noqa: E402
from test_torch_pipeline import MB, big_text, gate_1mb  # noqa: E402,F401

METHODS = {
    "local": {"method": "local"},
    "quality": {"method": "quality"},
    "lr-R": {"method": "likelihood_ratio", "estimate_prior": True, "fit_backend": "device"},
}
BATCH_ARRAYS = ("chrom_id", "pos", "ref_base", "counts", "read_offsets", "read_code", "read_strand", "read_bq",
                "read_mq", "q_log_hom", "q_log_het", "q_major", "q_second")


def _options(method):
    return Options(platform="cpu", **METHODS[method])


def _profiled(fn):
    """(fn(), the stage profile it recorded)."""
    prof = profiling.StageProfile()
    profiling.activate(prof)
    try:
        return fn(), prof
    finally:
        profiling.activate(None)


def _write(tmp_path, data, name="in.pileup"):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _held_by_this_process(path):
    """This process's open descriptors of ``path`` and its maps of it."""
    real = os.path.realpath(path)
    fds = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            if os.readlink(f"/proc/self/fd/{fd}") == real:
                fds.append(fd)
        except OSError:  # the listing's own descriptor, closed by now
            pass
    with open("/proc/self/maps") as f:
        maps = [line for line in f if line.rstrip("\n").endswith(" " + real)]
    return fds, maps


def _released(view) -> bool:
    try:
        view.tobytes()
    except ValueError:
        return True
    return False


@pytest.fixture()
def seen_chunks(monkeypatch):
    """The chunks the engine hands to ``parse_chunk``, in order, each with
    what its parse gave (a batch or the exception). Every parse but the
    first starts 0.2 s late, so the worker holds a view while the caller
    moves on."""
    seen = []
    inner = engine.parse_chunk

    def parse_chunk(src, offset, chunk, *args, **kwargs):
        entry = [chunk, None]
        seen.append(entry)
        if len(seen) > 1:
            time.sleep(0.2)
        try:
            entry[1] = inner(src, offset, chunk, *args, **kwargs)
        except Exception as e:  # noqa: BLE001 - recorded for the test, and raised on
            entry[1] = e
            raise
        return entry[1]

    monkeypatch.setattr(engine, "parse_chunk", parse_chunk)
    return seen


@pytest.fixture(scope="module")
def texts(big_text):
    return {"pileup": big_text, "no-final-newline": big_text.rstrip(b"\n"), "empty": b""}


@pytest.mark.parametrize("chunk_bytes", [1, 4 << 10, MB, 4 * MB], ids=["1B", "4KiB", "1MB", "past-the-end"])
@pytest.mark.parametrize("text_kind", ["pileup", "no-final-newline", "empty"])
@pytest.mark.parametrize("kind", ["path", "bytes"])
def test_same_chunks_at_the_same_offsets(texts, tmp_path, kind, text_kind, chunk_bytes):
    text = texts[text_kind]
    src = _write(tmp_path, text) if kind == "path" else text
    want = list(stream.with_offsets(stream.iter_chunks(src, chunk_bytes)))
    with stream.chunk_views(src, chunk_bytes) as views:
        located = list(stream.with_offsets(views))
        assert all(isinstance(view, memoryview) for _, view in located)
        got = [(offset, bytes(view)) for offset, view in located]
    assert got == want
    assert b"".join(chunk for _, chunk in got) == text


@pytest.mark.parametrize("kind", ["path", "bytes"])
def test_views_are_of_the_text_itself(big_text, tmp_path, kind):
    src = _write(tmp_path, big_text) if kind == "path" else big_text
    with stream.chunk_views(src, MB) as views:
        chunks = list(views)
        assert len(chunks) == 3 and all(isinstance(c, memoryview) and c.readonly for c in chunks)
        if kind == "bytes":
            assert all(c.obj is big_text for c in chunks)
    assert all(_released(c) for c in chunks)


@pytest.mark.parametrize("kind", ["gz-path", "gz-bytes", "file-object"])
def test_streamed_inputs_give_iter_chunks_bytes(big_text, tmp_path, kind):
    gz = gzip.compress(big_text)
    src = {"gz-path": lambda: _write(tmp_path, gz, "in.pileup.gz"), "gz-bytes": lambda: gz,
           "file-object": lambda: io.BytesIO(big_text)}[kind]
    with stream.chunk_views(src(), MB) as views:
        got = list(views)
    assert all(isinstance(c, bytes) for c in got)
    assert got == list(stream.iter_chunks(src(), MB))
    assert b"".join(got) == big_text


@pytest.fixture()
def fifo(tmp_path):
    """A FIFO's path and a function that starts a thread writing a text
    into it (the thread waits for a reader to open it)."""
    path = str(tmp_path / "in.fifo")
    os.mkfifo(path)
    writers = []

    def feed(text):
        def write():
            with open(path, "wb") as w:
                w.write(text)

        writers.append(threading.Thread(target=write, daemon=True))
        writers[-1].start()

    yield path, feed
    for w in writers:
        w.join(timeout=30)
        assert not w.is_alive()


def _read_iter_chunks(src, chunk_bytes):
    return list(stream.iter_chunks(src, chunk_bytes))


def _read_chunk_views(src, chunk_bytes):
    with stream.chunk_views(src, chunk_bytes) as views:
        return [bytes(chunk) for chunk in views]


@pytest.mark.parametrize("read", [_read_iter_chunks, _read_chunk_views], ids=["iter_chunks", "chunk_views"])
@pytest.mark.parametrize("chunk_bytes", [4 << 10, MB])
def test_a_fifo_is_streamed_whole(big_text, fifo, read, chunk_bytes):
    """A pipe's path is streamed from its first byte: no byte is taken from
    it to tell what it is."""
    path, feed = fifo
    feed(big_text)
    chunks = read(path, chunk_bytes)
    assert b"".join(chunks) == big_text
    assert all(chunk.endswith(b"\n") for chunk in chunks)


def test_streaming_quality_from_a_fifo(big_text, fifo):
    """``--stream -m quality`` reads its input once (no pass 1), so a pipe's
    path gives the whole CSV."""
    path, feed = fifo
    feed(big_text)
    out = io.BytesIO()
    engine.run_streaming(path, _options("quality"), out=out, chunk_bytes=MB)
    assert out.getvalue() == engine.run(big_text, _options("quality"), binary=True)


@pytest.fixture(scope="module")
def monolithic(big_text):
    """Each method's CSV from a file object: the monolithic run."""
    return {method: engine.run(io.BytesIO(big_text), _options(method), binary=True) for method in METHODS}


@pytest.mark.parametrize("kind", ["path", "bytes", "gz-path"])
@pytest.mark.parametrize("method", list(METHODS))
def test_same_csv_from_every_input(big_text, monolithic, gate_1mb, tmp_path, method, kind):
    src = {"path": lambda: _write(tmp_path, big_text), "bytes": lambda: big_text,
           "gz-path": lambda: _write(tmp_path, gzip.compress(big_text), "in.pileup.gz")}[kind]()
    got, prof = _profiled(lambda: engine.run(src, _options(method), binary=True))
    assert [name for name, _ in prof.stages].count("pipeline:serialize") == 3  # the chunk path, 3 chunks
    assert got == monolithic[method]


def _line_in_chunk(text, k):
    """The number of a line inside the k-th (from 0) 1 MB chunk of ``text``."""
    offsets = [offset for offset, _ in stream.with_offsets(stream.iter_chunks(text, MB))]
    return text.count(b"\n", 0, offsets[k]) + 7


def _with_bad_line(text, line):
    lines = text.split(b"\n")
    lines[line - 1] = b"not a pileup line"
    return b"\n".join(lines)


@pytest.mark.parametrize("kind", ["path", "bytes", "gz-path"])
@pytest.mark.parametrize("method", ["local", "lr-R"])
def test_parse_error_names_the_files_line(big_text, gate_1mb, tmp_path, method, kind):
    line = _line_in_chunk(big_text, 2)
    bad = _with_bad_line(big_text, line)
    src = {"path": lambda: _write(tmp_path, bad), "bytes": lambda: bad,
           "gz-path": lambda: _write(tmp_path, gzip.compress(bad), "in.pileup.gz")}[kind]()
    with pytest.raises(SidParseError) as err:
        engine.run(src, _options(method), binary=True)
    assert err.value.line_number == line


def _parsed(seen_chunks):
    """The seen chunks' parses that gave a batch."""
    return [chunk for chunk, outcome in seen_chunks if not isinstance(outcome, Exception)]


def test_early_close_releases_and_unmaps(big_text, tmp_path, seen_chunks):
    path = _write(tmp_path, big_text)
    batches = engine._parsed_chunks(path, _options("local"), MB)
    assert next(batches).num_sites > 0 and _held_by_this_process(path)[1]  # mapped while it runs
    assert not any(_released(chunk) for chunk, _ in seen_chunks)
    batches.close()  # while the worker is to parse the second chunk
    assert len(seen_chunks) == 2 and len(_parsed(seen_chunks)) == 2  # parsed before its view went
    assert _held_by_this_process(path) == ([], [])
    assert all(isinstance(chunk, memoryview) and _released(chunk) for chunk, _ in seen_chunks)


@pytest.mark.parametrize("kind", ["path", "bytes"])
def test_parse_error_releases_and_unmaps(big_text, tmp_path, seen_chunks, kind):
    line = _line_in_chunk(big_text, 0)
    bad = _with_bad_line(big_text, line)
    src = _write(tmp_path, bad) if kind == "path" else bad
    with pytest.raises(SidParseError) as err:
        for _ in engine._parsed_chunks(src, _options("local"), MB):
            pass
    assert err.value.line_number == line
    # the first chunk's error is raised while the second one's parse runs
    assert len(seen_chunks) == 2 and _parsed(seen_chunks) == [seen_chunks[1][0]]
    assert all(_released(chunk) for chunk, _ in seen_chunks)
    if kind == "path":
        assert _held_by_this_process(src) == ([], [])


def test_a_full_pass_releases_and_unmaps(big_text, tmp_path, seen_chunks):
    path = _write(tmp_path, big_text)
    sites = sum(b.num_sites for b in engine._parsed_chunks(path, _options("quality"), MB))
    assert sites == len(big_text.splitlines())
    assert len(_parsed(seen_chunks)) == 3 and all(_released(chunk) for chunk, _ in seen_chunks)
    assert _held_by_this_process(path) == ([], [])


def test_an_array_left_over_a_view_is_an_error(big_text, tmp_path):
    """The map is not closed under a live array: the exit raises."""
    path = _write(tmp_path, big_text)
    with pytest.raises(BufferError):
        with stream.chunk_views(path, MB) as views:
            kept = np.frombuffer(next(views), np.uint8)
    assert kept[0] == big_text[0]  # the map is still there
    del kept


@pytest.mark.parametrize("method", list(METHODS))
def test_no_batch_refers_to_its_input(big_text, method):
    whole = np.frombuffer(big_text, np.uint8)
    with stream.chunk_views(big_text, MB) as views:  # the check sees a view of the input
        assert np.shares_memory(np.frombuffer(next(views), np.uint8), whole)
    for batch in engine._parsed_chunks(big_text, _options(method), MB):
        for name in BATCH_ARRAYS:
            arr = getattr(batch, name)
            if arr is not None:
                assert not np.shares_memory(arr, whole), name


@pytest.mark.parametrize("kind", ["path", "bytes", "gz-path", "gz-bytes", "empty-path"])
def test_read_counters(big_text, gate_1mb, tmp_path, kind):
    gz = gzip.compress(big_text)
    src = {"path": lambda: _write(tmp_path, big_text), "bytes": lambda: big_text,
           "gz-path": lambda: _write(tmp_path, gz, "in.pileup.gz"), "gz-bytes": lambda: gz,
           "empty-path": lambda: _write(tmp_path, b"")}[kind]()
    _, prof = _profiled(lambda: list(engine._parsed_chunks(src, _options("local"), MB)))
    size = 0 if kind == "empty-path" else len(big_text)
    viewed, copied = (0, size) if kind.startswith("gz") else (size, 0)
    assert prof.counters["read:view_bytes"] == viewed
    assert prof.counters["read:copied_bytes"] == copied


def test_profile_report_prints_the_read_counters(big_text, gate_1mb, tmp_path, capsys):
    path = _write(tmp_path, big_text)
    out = tmp_path / "out.csv"
    assert cli.main(["--platform", "cpu", "--profile", "--output", str(out), path]) == 0
    err = capsys.readouterr().err.splitlines()
    assert f"# read:view_bytes: {len(big_text):,}" in err
    assert "# read:copied_bytes: 0" in err


def _buffers(text):
    """The same text as bytes, a bytearray, a memoryview and a numpy
    uint8 view, each referenced by the caller alone."""
    return {
        "bytes": bytes(text),
        "bytearray": bytearray(text),
        "memoryview": memoryview(bytes(text)),
        "numpy": np.frombuffer(bytes(text), np.uint8),
    }


def _fields(batch):
    return {name: getattr(batch, name) for name in ("chrom_table", *BATCH_ARRAYS)}


def _assert_same_fields(got, want):
    assert got.keys() == want.keys()
    for name, value in want.items():
        if isinstance(value, np.ndarray):
            assert np.array_equal(got[name], value), name
            assert got[name].dtype == value.dtype, name
        else:
            assert got[name] == value, name


@pytest.mark.parametrize("quality", [False, True], ids=["counts", "reads"])
def test_bridge_parses_any_buffer_in_place(big_text, quality):
    text = big_text[: big_text.index(b"\n", 200_000) + 1]
    lib = native.load()
    want = bridge.parse(lib, text, quality, quality, ErrorChannel())
    for kind, buf in _buffers(text).items():
        got = bridge.parse(lib, buf, quality, quality, ErrorChannel())
        _assert_same_fields(got, want)
        for name, arr in got.items():
            if isinstance(arr, np.ndarray):
                assert not np.shares_memory(arr, np.frombuffer(buf, np.uint8)), (kind, name)
        if kind == "bytearray":
            buf.extend(b"x")  # no export of it is left: it can grow
        if kind == "memoryview":
            buf.release()  # raises BufferError while one is left


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("quality", [False, True], ids=["counts", "reads"])
def test_parse_pileup_takes_any_buffer(big_text, backend, quality):
    text = big_text[: big_text.index(b"\n", 200_000) + 1]
    want = _fields(parse_pileup(text, quality, quality, backend=backend))
    for kind, buf in _buffers(text).items():
        batch = parse_pileup(buf, quality, quality, backend=backend)
        _assert_same_fields(_fields(batch), want)
        for name in BATCH_ARRAYS:
            arr = getattr(batch, name)
            if arr is not None:
                assert not np.shares_memory(arr, np.frombuffer(buf, np.uint8)), (kind, name)
        if kind == "memoryview":
            buf.release()
    gz = gzip.compress(text)
    for buf in (memoryview(gz), np.frombuffer(gz, np.uint8)):
        _assert_same_fields(_fields(parse_pileup(buf, quality, quality, backend=backend)), want)


def test_parse_of_a_strided_view_is_refused(big_text):
    with pytest.raises((BufferError, ValueError)):
        bridge.parse(native.load(), memoryview(big_text)[::2], False, False, ErrorChannel())
