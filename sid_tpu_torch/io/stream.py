"""Chunked streaming input: newline-aligned byte chunks + histogram pass
(sid_tpu/io/stream.py, over the port's parser).

The reference materializes the whole pileup in RAM (call.cpp:11-20). For
whole-genome runs ``engine.run_streaming`` streams instead: pass 1 folds
each chunk into the unique-profile histogram (the Lynch fit's sufficient
statistic); pass 2 re-parses chunk by chunk, classifies, and appends CSV —
memory is bounded by the chunk size, not the genome. A chunk is parsed
with its offset in the input (``parse_chunk``), so a malformed line is
reported by its line in the file, not in the chunk. The chunk pipeline
takes the same chunks as views of the text (``chunk_views``), parsed in
place.
"""

from __future__ import annotations

import contextlib
import gzip
import io as _io
import mmap
import os
import stat
from typing import Iterator, Tuple, Union

import numpy as np

from sid_tpu_torch.io.pileup import PileupBatch, parse_pileup
from sid_tpu_torch.utils import profiling
from sid_tpu_torch.utils.errors import SidParseError

DEFAULT_CHUNK_BYTES = 64 << 20

GZIP_MAGIC = b"\x1f\x8b"


def _maybe_gzip(stream: _io.IOBase) -> _io.IOBase:
    """Wrap a binary stream in a gzip decompressor if it starts with the
    gzip magic. Detection is by content, not extension, so renamed files
    and piped data work; non-peekable unseekable streams pass through
    undetected (stdin pipes go through BufferedReader, which peeks)."""
    try:
        if hasattr(stream, "peek"):
            head = stream.peek(2)[:2]
        elif stream.seekable():
            pos = stream.tell()
            head = stream.read(2)
            stream.seek(pos)
        else:
            return stream
    except (OSError, ValueError):
        return stream
    if head == GZIP_MAGIC:
        return gzip.GzipFile(fileobj=stream)
    return stream


def iter_chunks(
    src: Union[str, os.PathLike, _io.IOBase, bytes],
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> Iterator[bytes]:
    """Yield newline-aligned byte chunks from a path, stream, or buffer.

    Gzip input (detected by magic bytes) is decompressed transparently —
    the reference's pipelines zcat externally
    (scripts/sid-pipeline/run-sid.sh); here `.gz` is a first-class input.
    Plain bytes and regular files (mapped) are cut in place (``_in_place``):
    one copy a chunk, the chunks of the stream loop (``_streamed``).
    """
    with contextlib.ExitStack() as stack:
        text = _in_place(src, stack)
        if text is not None:
            yield from _cut(text, chunk_bytes)
            return
    yield from _streamed(src, chunk_bytes)


def _streamed(src, chunk_bytes: int) -> Iterator[bytes]:
    """The stream loop: newline-aligned chunks of ``src`` read
    ``chunk_bytes`` at a time, gzip decompressed."""
    raw = None
    if isinstance(src, bytes):
        stream: _io.IOBase = _maybe_gzip(_io.BytesIO(src))
        close = False
    elif isinstance(src, (str, os.PathLike)):
        raw = open(src, "rb")  # BufferedReader: peek-able for _maybe_gzip
        stream = _maybe_gzip(raw)
        close = True
    else:
        stream = _maybe_gzip(src)
        close = False
    try:
        carry = b""
        while True:
            block = stream.read(chunk_bytes)
            if not block:
                if carry:
                    yield carry
                return
            if isinstance(block, str):
                block = block.encode()
            data = carry + block
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            yield data[: cut + 1]
            carry = data[cut + 1 :]
    finally:
        if close:
            stream.close()
            if raw is not None and raw is not stream:
                raw.close()


def _spans(buf, chunk_bytes: int) -> Iterator[Tuple[int, int]]:
    """(start, end) of the stream loop's chunks of a whole buffer (bytes
    or a mapped file), cut where it cuts them: after the last newline of
    the bytes read so far, ``chunk_bytes`` a read, and the rest at the end."""
    n = len(buf)
    start = read = 0
    while read < n:
        read = min(read + chunk_bytes, n)
        cut = buf.rfind(b"\n", start, read)
        if cut >= 0:
            yield start, cut + 1
            start = cut + 1
    if start < n:
        yield start, n


def _cut(buf, chunk_bytes: int) -> Iterator[bytes]:
    """``_spans``' chunks of a whole buffer, each copied out as bytes."""
    for start, end in _spans(buf, chunk_bytes):
        yield buf[start:end]


def _in_place(src, stack: contextlib.ExitStack):
    """The whole text of ``src`` where it can be read in place: plain
    bytes, or a read-only map of a regular non-empty file, entered on
    ``stack``. None where the text has to be streamed: gzip input, a file
    object, an empty file, a path that is no regular file (a FIFO,
    ``/dev/stdin``), which is told by its ``stat`` before it is opened,
    so no byte of a pipe is read here."""
    if isinstance(src, bytes):
        return None if src[:2] == GZIP_MAGIC else src
    if not isinstance(src, (str, os.PathLike)):
        return None
    st = os.stat(src)
    if not (stat.S_ISREG(st.st_mode) and st.st_size):
        return None
    with open(src, "rb") as f:  # the map holds a descriptor of its own
        if f.peek(2)[:2] == GZIP_MAGIC:
            return None
        return stack.enter_context(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))


@contextlib.contextmanager
def chunk_views(
    src: Union[str, os.PathLike, _io.IOBase, bytes],
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> Iterator[Iterator[Union[memoryview, bytes]]]:
    """``iter_chunks``' chunks of ``src``, at its offsets, without a copy
    where the text is already whole: entered, it gives an iterator of the
    chunks, ``memoryview`` slices of plain bytes or of a regular non-empty
    file's read-only map (opened and mapped on the first chunk); gzip input
    and file objects give the stream loop's bytes. The request's counters
    ``read:view_bytes`` and ``read:copied_bytes`` add the bytes of each
    kind, once, at the exit.

    The views, and the map, live until the exit, which releases every view
    it gave and then unmaps the file. So a caller ends each parse of a view
    before it exits, and keeps no array over a view: the exit raises
    ``BufferError`` where one is left."""
    counts = {"read:view_bytes": 0, "read:copied_bytes": 0}
    with contextlib.ExitStack() as stack:

        def chunks():
            text = _in_place(src, stack)
            if text is None:
                for chunk in stack.enter_context(contextlib.closing(_streamed(src, chunk_bytes))):
                    counts["read:copied_bytes"] += len(chunk)
                    yield chunk
                return
            whole = stack.enter_context(memoryview(text))
            for start, end in _spans(text, chunk_bytes):
                counts["read:view_bytes"] += end - start
                yield stack.enter_context(whole[start:end])  # released before the map closes

        try:
            yield chunks()
        finally:
            for name, n in counts.items():
                profiling.count(name, n)


def with_offsets(chunks: Iterator[bytes], start: int = 0) -> Iterator[Tuple[int, bytes]]:
    """(offset, chunk) of consecutive chunks of a text, the first at ``start``."""
    for chunk in chunks:
        yield start, chunk
        start += len(chunk)


def lines_before(src, offset: int) -> int:
    """Newlines in the first ``offset`` bytes of ``src``'s text (a path or
    bytes, gzip decompressed)."""
    n = 0
    for chunk in iter_chunks(src):
        if len(chunk) >= offset:
            return n + chunk.count(b"\n", 0, offset)
        n += chunk.count(b"\n")
        offset -= len(chunk)
    return n


def parse_chunk(src, offset: int, chunk, *args, **kwargs) -> PileupBatch:
    """``parse_pileup(chunk, *args, **kwargs)`` of a chunk (bytes or a
    view) that starts ``offset`` bytes into ``src``'s text: a malformed
    line's number counts from the start of ``src``. The lines before the
    chunk are counted only when the parse fails, so a clean parse costs
    nothing more."""
    try:
        return parse_pileup(chunk, *args, **kwargs)
    except SidParseError as e:
        e.line_number += lines_before(src, offset)
        raise


def pack_profiles(profiles: np.ndarray) -> np.ndarray:
    """(U,4) counts -> order-preserving uint64 keys."""
    c = np.asarray(profiles, np.uint64)
    return (c[:, 0] << 48) | (c[:, 1] << 32) | (c[:, 2] << 16) | c[:, 3]


def unpack_profiles(keys: np.ndarray) -> np.ndarray:
    prof = np.empty((keys.shape[0], 4), np.int32)
    prof[:, 0] = (keys >> 48) & 0xFFFF
    prof[:, 1] = (keys >> 32) & 0xFFFF
    prof[:, 2] = (keys >> 16) & 0xFFFF
    prof[:, 3] = keys & 0xFFFF
    return prof


def iter_range_chunks(
    path: Union[str, os.PathLike],
    start: int,
    end: int,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> Iterator[bytes]:
    """Yield newline-aligned chunks of one byte range of a plain file.

    The range endpoints themselves must already be newline-aligned (what
    parallel.distributed.byte_ranges produces); inner cuts are re-aligned
    here. Memory is bounded by chunk_bytes regardless of range size.
    """
    with open(path, "rb") as f:
        f.seek(start)
        remaining = end - start
        carry = b""
        while remaining > 0:
            block = f.read(min(chunk_bytes, remaining))
            if not block:
                break
            remaining -= len(block)
            data = carry + block
            if remaining <= 0:
                carry = b""
                if data:
                    yield data
                return
            cut = data.rfind(b"\n")
            if cut < 0:
                carry = data
                continue
            yield data[: cut + 1]
            carry = data[cut + 1 :]
        if carry:
            yield carry


def accumulate_histogram_chunks(
    src,
    chunks: Iterator[Tuple[int, bytes]],
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Merge per-chunk unique-profile histograms over explicit (offset,
    chunk) pairs of ``src``'s text. Returns (profiles (U,4) sorted, mult
    (U,), total_sites)."""
    keys_acc, mult_acc = np.zeros(0, np.uint64), np.zeros(0, np.int64)
    total = 0
    for offset, chunk in chunks:
        batch = parse_chunk(src, offset, chunk, backend=backend)
        total += batch.num_sites
        if batch.num_sites == 0:
            continue
        uniq, mult = np.unique(pack_profiles(batch.counts), return_counts=True)
        keys_acc, mult_acc = merge_profile_tables(keys_acc, mult_acc, uniq, mult)
    return unpack_profiles(keys_acc), mult_acc, total


def merge_profile_tables(keys: np.ndarray, mult: np.ndarray, more_keys: np.ndarray, more_mult: np.ndarray):
    """Two sorted tables of unique packed profiles (``pack_profiles``) and
    their multiplicities as one sorted table, the multiplicities of a
    profile in both added (int64)."""
    merged = np.union1d(keys, more_keys)
    total = np.zeros(merged.shape[0], np.int64)
    total[np.searchsorted(merged, keys)] += mult
    total[np.searchsorted(merged, more_keys)] += more_mult
    return merged, total


def accumulate_histogram(
    src,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pass 1: merge per-chunk unique-profile histograms.

    Returns (profiles (U,4) sorted, mult (U,), total_sites).
    """
    return accumulate_histogram_chunks(src, with_offsets(iter_chunks(src, chunk_bytes)), backend)
