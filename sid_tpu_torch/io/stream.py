"""Chunked streaming input: newline-aligned byte chunks + histogram pass
(sid_tpu/io/stream.py, over the port's parser).

The reference materializes the whole pileup in RAM (call.cpp:11-20). For
whole-genome runs ``engine.run_streaming`` streams instead: pass 1 folds
each chunk into the unique-profile histogram (the Lynch fit's sufficient
statistic); pass 2 re-parses chunk by chunk, classifies, and appends CSV —
memory is bounded by the chunk size, not the genome.
"""

from __future__ import annotations

import gzip
import io as _io
import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from sid_tpu_torch.io.pileup import parse_pileup

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
    """
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
    chunks: Iterator[bytes],
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Merge per-chunk unique-profile histograms over an explicit chunk
    iterator. Returns (profiles (U,4) sorted, mult (U,), total_sites)."""
    keys_acc: Optional[np.ndarray] = None
    mult_acc: Optional[np.ndarray] = None
    total = 0
    for chunk in chunks:
        batch = parse_pileup(chunk, backend=backend)
        total += batch.num_sites
        if batch.num_sites == 0:
            continue
        keys = pack_profiles(batch.counts)
        uniq, mult = np.unique(keys, return_counts=True)
        if keys_acc is None:
            keys_acc, mult_acc = uniq, mult.astype(np.int64)
        else:
            merged = np.concatenate([keys_acc, uniq])
            weights = np.concatenate([mult_acc, mult.astype(np.int64)])
            keys_acc, inv = np.unique(merged, return_inverse=True)
            mult_acc = np.zeros(keys_acc.shape[0], np.int64)
            np.add.at(mult_acc, inv, weights)
    if keys_acc is None:
        return np.zeros((0, 4), np.int32), np.zeros(0, np.int64), 0
    return unpack_profiles(keys_acc), mult_acc, total


def accumulate_histogram(
    src,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pass 1: merge per-chunk unique-profile histograms.

    Returns (profiles (U,4) sorted, mult (U,), total_sites).
    """
    return accumulate_histogram_chunks(iter_chunks(src, chunk_bytes), backend)
