"""sid's mpileup counting (pileup.cpp), vectorised in NumPy.

A line is ``chrom pos ref cov bases [bq] [mq]``, its fields split on runs of
spaces and tabs. The first five fields give the counts (the ``local`` and
``likelihood_ratio`` methods read no qualities): ``pos`` is C's ``atoi``;
in ``bases`` a letter A/C/G/T in either case is a read of that base, ``.``
and ``,`` are a read of the reference base (dropped where it is not one of
ACGT), ``^`` skips the mapping-quality character after it, ``+N``/``-N``
skip an indel of N characters, and every other character is dropped. The
counts wrap as 16-bit integers. Empty lines are skipped.

``parse(..., reads=dtype)`` also reads both quality columns, as
``readFile(in, true, true)`` does for ``-m quality``: Phred+33 bytes, taken
modulo 256 and clamped to at least 1 (pileup.cpp:159-163), the j-th read
of a site paired with the j-th byte of each column (1 past a column's
end), and each read's error 10^(-min(bq, mq)/10) (call.cpp:291-372). The
reads are reduced to two sums a site inside each parse block, against the
site's top-2 bases (``Reads``), so no array of the whole input's reads is
made.

Lines of the common shape (tab-separated, no indel in the bases, each
``^`` followed by a mapping quality other than ``^``, a plain decimal
position; with reads, seven fields and a quality a read in each quality
column) are counted a block at a time with ``np.add.reduceat``, blocks on
threads; every other line goes through ``parse_line``, the same grammar
written out character by character.
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Tuple

import numpy as np

from gpubench.reference import calls

_BLOCK_BYTES = 64 << 20
# with reads: smaller blocks, so that the reads of the blocks on threads
# take a few hundred MB
_READS_BLOCK_BYTES = 16 << 20

# the reads of A, C, G, T and of '.'/',' in 12-bit lanes of a 64-bit word
_LANES = np.zeros(256, np.uint64)
for _i, _c in enumerate(b"ACGT"):
    _LANES[_c] = _LANES[_c + 32] = np.uint64(1) << np.uint64(12 * _i)
_LANES[ord(".")] = _LANES[ord(",")] = np.uint64(1) << np.uint64(48)
_CODE = np.full(256, -1, np.int64)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _CODE[_c + 32] = _i
_CODE8 = _CODE.astype(np.int8)


class Reads(NamedTuple):
    """What ``-m quality`` needs of each site's reads, each read's error
    e = 10^(-min(bq, mq)/10): ``log_hom`` sums ln(1-e) over the reads of
    the site's major base and ln(e) over the others, ``log_het`` ln(1-2e/3)
    over the reads of its top-2 bases and ln(2e/3) over the others
    (call.cpp:330-342), in the dtype asked for."""

    log_hom: np.ndarray
    log_het: np.ndarray


def _phred(b: np.ndarray) -> np.ndarray:
    """Quality bytes decoded: (byte - 33) modulo 256, at least 1."""
    return np.maximum(np.asarray(b, np.uint8) - np.uint8(33), np.uint8(1))


def read_sums(counts: np.ndarray, code: np.ndarray, q: np.ndarray, nreads: np.ndarray, dtype) -> Reads:
    """The ``Reads`` of sites with ``counts`` whose ``nreads`` reads, in
    order, are bases ``code`` (0..3) of decoded qualities ``q``: each
    read's term looked up and summed per site by ``np.add.reduceat``."""
    major, second = calls.top_two(counts)
    code = np.asarray(code, np.int8)
    is_major = code == np.repeat(major.astype(np.int8), nreads)
    # [ln(1-e), ln(e)] and [ln(1-2e/3), ln(2e/3)] by 2 q + (not a match)
    terms = calls.phred_terms(dtype)
    at = np.asarray(q, np.int16) * 2
    at += ~is_major
    hom = terms[:, :2].ravel()[at]
    at -= ~is_major
    at += ~(is_major | (code == np.repeat(second.astype(np.int8), nreads)))
    het = terms[:, 2:].ravel()[at]
    del at
    sums = Reads(np.zeros(len(nreads), dtype), np.zeros(len(nreads), dtype))
    filled = nreads > 0
    if hom.size:
        first = (np.cumsum(nreads) - nreads)[filled]
        sums.log_hom[filled] = np.add.reduceat(hom, first)
        sums.log_het[filled] = np.add.reduceat(het, first)
    return sums


def _atoi(tok: bytes) -> int:
    """C's atoi: leading white space, an optional sign, the leading digits."""
    tok = tok.lstrip()
    sign = -1 if tok[:1] == b"-" else 1
    if tok[:1] in (b"-", b"+"):
        tok = tok[1:]
    n = 0
    while n < len(tok) and 48 <= tok[n] <= 57:
        n += 1
    return sign * int(tok[:n]) if n else 0


def parse_line(line: bytes, reads: bool = False):
    """(chrom, pos, counts) of one line, character by character; with
    ``reads`` also its reads' bases and decoded qualities, min(bq, mq)."""
    toks = [t for t in re.split(rb"[ \t]+", line) if t]
    if len(toks) < (7 if reads else 5) or len(toks[2]) != 1:
        raise ValueError(f"malformed pileup line: {line[:80]!r}")
    ref = toks[2][0]
    counts = [0, 0, 0, 0]
    codes = []
    bases, i = toks[4], 0
    while i < len(bases):
        b = bases[i]
        if b in (46, 44):  # '.', ','
            b = ref
        code = _CODE[b]
        if code >= 0:
            counts[code] = (counts[code] + 1) & 0xFFFF
            codes.append(code)
        elif b == 94:  # '^': the next character is a mapping quality
            i += 1
        elif b in (43, 45) and i + 1 < len(bases) and 48 <= bases[i + 1] <= 57:
            j = i + 1
            while j < len(bases) and 48 <= bases[j] <= 57:
                j += 1
            i = j + int(bases[i + 1 : j]) - 1
        i += 1
    if not reads:
        return toks[0], _atoi(toks[1]), counts
    # the j-th read takes the j-th byte of each quality column, 1 past its end
    bq, mq = (np.ones(len(codes), np.uint8) for _ in range(2))
    for column, tok in ((bq, toks[5]), (mq, toks[6])):
        k = min(len(codes), len(tok))
        column[:k] = _phred(np.frombuffer(tok[:k], np.uint8))
    return toks[0], _atoi(toks[1]), counts, codes, np.minimum(bq, mq)


def _parse_block(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray, reads=None):
    """Counts, positions and chromosome fields of the lines [starts, ends)
    of ``buf``, and with ``reads`` (a dtype) their ``Reads``; ``slow``
    marks the lines this shape does not cover."""
    n = starts.shape[0]
    blanks = np.flatnonzero(buf <= 32)  # tabs, newlines, and the rest of the white space
    kind = buf[blanks]
    tabs = blanks[kind == 9]
    first = np.searchsorted(tabs, starts)
    n_tabs = np.searchsorted(tabs, ends) - first
    slow = (n_tabs != 6) if reads is not None else (n_tabs < 4) | (n_tabs > 6)
    other = blanks[(kind != 9) & (kind != 10)]
    slow[np.searchsorted(starts, other, side="right") - 1] = True
    ok = np.flatnonzero(~slow)
    sums = None if reads is None else Reads(np.zeros(n, reads), np.zeros(n, reads))
    if ok.size == 0:
        return np.zeros((n, 4), np.int64), np.zeros(n, np.int64), np.zeros(0, np.int64), ok, slow, sums
    t = [tabs[np.minimum(first[ok] + j, tabs.size - 1)] for j in range(5)]
    t[4] = np.where(n_tabs[ok] > 4, t[4], ends[ok])  # five fields: bases run to the line's end
    # an empty field shifts the tokens; the reference is one character
    empty = (t[0] == starts[ok]) | (t[2] - t[1] != 2)
    for j in (0, 2, 3):
        empty |= t[j + 1] == t[j] + 1
    slow[ok[empty]] = True

    # bases: the lines' bases fields cut out into one array, then per line
    # the reads of each base and of '.'/',' in 12-bit lanes of a word
    blen = t[4] - t[3] - 1
    slow[ok[blen > 0xFFF]] = True  # a lane could carry
    lens = np.empty(2 * ok.size + 1, np.int64)
    lens[0:-1:2] = t[3] + 1 - np.concatenate([[0], t[4][:-1]])
    lens[1::2] = blen
    lens[-1] = buf.size - t[4][-1]
    kinds = np.zeros(lens.size, bool)
    kinds[1::2] = True
    bases = buf[np.repeat(kinds, lens)]
    at = np.concatenate([[0], np.cumsum(blen)[:-1]])
    # a read start '^' and its mapping-quality character count nothing; a
    # '^' that is its field's last character or is followed by another
    # '^', and an indel, take the line-by-line grammar
    caret = np.flatnonzero(bases == 94)
    caret_line = np.searchsorted(at, caret, side="right") - 1
    mq = caret + 1
    odd = mq >= at[caret_line] + blen[caret_line]
    odd[~odd] = bases[mq[~odd]] == 94
    slow[ok[caret_line[odd]]] = True
    bases[mq[~odd]] = 0
    lanes = np.zeros(ok.size, np.uint64)
    filled = blen > 0
    if bases.size:
        lanes[filled] = np.add.reduceat(_LANES[bases], at[filled])
    marks = np.flatnonzero((bases == 43) | (bases == 45))
    slow[ok[np.searchsorted(at, marks, side="right") - 1]] = True
    counts = np.zeros((n, 4), np.int64)
    for i in range(5):
        lane = ((lanes >> np.uint64(12 * i)) & np.uint64(0xFFF)).astype(np.int64)
        if i < 4:
            counts[ok, i] = lane
        else:
            ref_code = _CODE[buf[t[1] + 1]]
            has_ref = ref_code >= 0
            counts[ok[has_ref], ref_code[has_ref]] += lane[has_ref]
    counts &= 0xFFFF
    if reads is not None:
        _block_reads(buf, bases, at, blen, ok, slow, counts, tabs[np.minimum(first[ok] + 5, tabs.size - 1)],
                     t, ends[ok], reads, sums)
    del bases

    # positions: plain decimal fields of up to 18 digits
    pos = np.zeros(n, np.int64)
    width = t[1] - t[0] - 1
    digits_ok = (width >= 1) & (width <= 18)
    for w in np.unique(width[digits_ok]):
        rows = np.flatnonzero(width == w)
        d = buf[t[0][rows, None] + 1 + np.arange(w)].astype(np.int64) - 48
        pos[ok[rows]] = d @ 10 ** np.arange(w - 1, -1, -1, dtype=np.int64)
        digits_ok[rows] = ((d >= 0) & (d <= 9)).all(1)
    slow[ok[~digits_ok]] = True
    return counts, pos, t[0], ok, slow, sums


def _block_reads(buf, bases, at, blen, ok, slow, counts, t5, t, ends, dtype, sums: Reads) -> None:
    """The ``Reads`` of the lines ``ok`` into ``sums``: ``bases`` is their
    bases fields cut out (a ``^``'s mapping quality zeroed), ``at`` and
    ``blen`` where each starts and its length, ``t`` and ``t5`` their
    first six tabs; a line whose quality columns do not hold a byte a
    read is marked ``slow``."""
    code = _CODE8[bases]
    dots = np.flatnonzero((bases == 46) | (bases == 44))
    if dots.size:
        code[dots] = _CODE8[buf[t[1] + 1]][np.searchsorted(at, dots, side="right") - 1]
    is_read = code >= 0
    nreads = np.zeros(ok.size, np.int64)
    filled = blen > 0
    if bases.size:
        nreads[filled] = np.add.reduceat(is_read, at[filled], dtype=np.int64)
    code = code[is_read]
    del is_read
    bq_lo, mq_lo = t[4] + 1, t5 + 1
    slow[ok[(t5 - bq_lo != nreads) | (ends - mq_lo != nreads)]] = True
    # the j-th read's bytes: its line's column start + j, in one gather each
    first = np.cumsum(nreads) - nreads
    idx = np.repeat(bq_lo - first, nreads)
    idx += np.arange(idx.size)
    np.minimum(idx, buf.size - 1, out=idx)
    bq = _phred(buf[idx])
    idx += np.repeat(mq_lo - bq_lo, nreads)
    np.minimum(idx, buf.size - 1, out=idx)
    q = np.minimum(bq, _phred(buf[idx]))
    del idx, bq
    got = read_sums(counts[ok], code, q, nreads, dtype)
    sums.log_hom[ok] = got.log_hom
    sums.log_het[ok] = got.log_het


def _parse_range(buf: np.ndarray, lo: int, hi: int, reads=None):
    """The lines of buf[lo:hi] (whole lines): their starts and ends in
    ``buf``, counts, positions, which need ``parse_line``, the runs of
    their chromosome names (first line of each run, its name) and, with
    ``reads``, their ``Reads``."""
    block = buf[lo:hi]
    nl = np.flatnonzero(block == 10)
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [block.size]])
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    counts, pos, chrom_end, ok, slow, sums = _parse_block(block, starts, ends, reads)
    fast = ok[~slow[ok]]
    runs: List[Tuple[int, bytes]] = []
    if fast.size:
        width = chrom_end[~slow[ok]] - starts[fast]
        w = int(width.max())
        names = np.zeros((fast.size, w), np.uint8)
        cols = np.arange(w)
        inside = cols < width[:, None]
        names[inside] = block[(starts[fast, None] + cols)[inside]]
        change = np.ones(fast.size, bool)
        change[1:] = (names[1:] != names[:-1]).any(1) | (width[1:] != width[:-1])
        runs = [(int(fast[r]), bytes(names[r, : width[r]])) for r in np.flatnonzero(change)]
    return starts + lo, ends + lo, counts, pos, slow, runs, sums


def parse(data, threads: int = 8, reads=None) -> Tuple:
    """(chrom_id, chrom_table, pos, counts) of every non-empty line of
    ``data`` (bytes or a uint8 array), in order: chrom_id indexes the
    table of chromosome names in order of first appearance; counts is
    (N, 4) int64 over A, C, G, T. With ``reads`` (a dtype) each line
    needs both quality columns, and a fifth item gives its ``Reads`` in
    that dtype."""
    buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else data
    block_bytes = _BLOCK_BYTES if reads is None else _READS_BLOCK_BYTES
    cuts = [0]
    while cuts[-1] < buf.size:
        at = cuts[-1] + block_bytes
        if at >= buf.size:
            cuts.append(buf.size)
            break
        nl = np.flatnonzero(buf[at : at + (1 << 20)] == 10)
        cuts.append(at + int(nl[0]) + 1 if nl.size else min(at + (1 << 20), buf.size))
    with ThreadPoolExecutor(threads) as pool:
        parts = list(pool.map(lambda r: _parse_range(buf, *r, reads), zip(cuts[:-1], cuts[1:])))
    starts = np.concatenate([p[0] for p in parts] or [np.zeros(0, np.int64)])
    ends = np.concatenate([p[1] for p in parts] or [np.zeros(0, np.int64)])
    counts = np.concatenate([p[2] for p in parts] or [np.zeros((0, 4), np.int64)])
    pos = np.concatenate([p[3] for p in parts] or [np.zeros(0, np.int64)])
    slow = np.concatenate([p[4] for p in parts] or [np.zeros(0, bool)])
    n = starts.shape[0]
    sums = None if reads is None else Reads(*(np.concatenate([p[6][k] for p in parts] or [np.zeros(0, reads)])
                                              for k in range(2)))

    # chromosome ids: a run's lines up to the next run's or slow line's
    index: dict = {}
    chrom_id = np.full(n, -1, np.int64)
    base = 0
    for part in parts:
        for line, name in part[5]:
            chrom_id[base + line] = index.setdefault(name, len(index))
        base += part[0].shape[0]
    slow_lines = np.flatnonzero(slow)
    slow_reads = []
    for i in slow_lines:
        name, p, c, *line_reads = parse_line(bytes(buf[starts[i] : ends[i]]), reads is not None)
        chrom_id[i] = index.setdefault(name, len(index)) + (1 << 40)  # not carried forward
        pos[i] = p
        counts[i] = c
        slow_reads.append(line_reads)
    if reads is not None and slow_lines.size:
        got = read_sums(counts[slow_lines], np.concatenate([np.asarray(c, np.int8) for c, _ in slow_reads]),
                        np.concatenate([q for _, q in slow_reads]),
                        np.array([len(c) for c, _ in slow_reads], np.int64), reads)
        sums.log_hom[slow_lines] = got.log_hom
        sums.log_het[slow_lines] = got.log_het
    # fill each fast line from the run start before it
    marked = chrom_id >= 0
    last = np.maximum.accumulate(np.where(marked & (chrom_id < (1 << 40)), np.arange(n), -1))
    fast_lines = ~slow & ~marked
    chrom_id[fast_lines] = chrom_id[last[fast_lines]]
    chrom_id[chrom_id >= (1 << 40)] -= 1 << 40

    # table order: first appearance in the file
    first = [int(np.argmax(chrom_id == k)) for k in range(len(index))]
    order = np.argsort(first, kind="stable")
    remap = np.empty(len(index), np.int64)
    remap[order] = np.arange(len(order))
    by_id = {v: k for k, v in index.items()}
    parsed = remap[chrom_id], [by_id[int(k)] for k in order], pos, counts
    return parsed if reads is None else (*parsed, sums)
