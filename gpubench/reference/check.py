"""What decides ``correct``: a program's CSV (and its diagnostics) against
the calls the reference works out from the same input.

``expected`` derives, from the parsed input, the rows sid emits (every site
for ``local`` and ``quality``; the sites of coverage >= 4 for
``likelihood_ratio``), each row's class (a profile; a site for the per-site
``quality``), and per class the call and its two confidences; each
method's derivation is ``reference/methods/<method>.py``, found by name, and
a method that reads the quality columns says so (``READS = True``), so that
``parse`` reads them for it alone. ``compare`` reads a CSV against that, in
bulk (byte columns and NumPy, no loop over classes or rows):

- ``rows_bad``: lines that differ from ``chrom,pos,`` of the expected row
  followed by the text the CSV gives that row's class on its first row (so
  the parse, the row order across chunk joins, the coverage filter and the
  join of classes onto sites), plus the difference in line counts;
- ``calls_bad``: classes whose label, genotype or confidence type differ
  from the reference's, plus a wrong count of unique profiles;
- ``conf_gap``: the largest distance of a printed confidence from the
  reference's value, in half units of its sixth significant digit (``%g``):
  a correctly rounded print of the reference's double reads at most 1;
- ``fit_gap`` (``likelihood_ratio``): the same for the printed
  heterozygosity and error of the fit (``%.6e``, seven digits).
"""

from __future__ import annotations

import importlib.util
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from gpubench.reference import calls, pileup

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HEADER = b"chrom,pos,label,gt,hom_conf,het_conf,conf_type"


class Expected(NamedTuple):
    chrom_table: List[bytes]
    chrom_id: np.ndarray  # (M,) of the emitted rows
    pos: np.ndarray
    cls: np.ndarray  # (M,) class of each emitted row
    first: np.ndarray  # each class's first emitted row
    classes: calls.Classes
    conf_type: str
    fit: Optional[calls.Fit]


def method(name: str, root: str = ROOT):
    """The reference of method ``name``, ``gpubench/reference/methods/<name>.py``."""
    path = os.path.join(root, "gpubench", "reference", "methods", name + ".py")
    if not os.path.exists(path):
        raise NotImplementedError(f"no reference for method {name!r} ({path})")
    spec = importlib.util.spec_from_file_location("gpubench_reference_method_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def needs_reads(options: dict, root: str = ROOT) -> bool:
    """Whether the method of ``options`` reads the quality columns."""
    return getattr(method(options.get("method", "local"), root), "READS", False)


def parse(options: dict, data, dtype=np.float64, root: str = ROOT) -> tuple:
    """(chrom_id, chrom_table, pos, counts, reads) of ``data`` as the method
    of ``options`` needs it: ``reads`` the parse's ``pileup.Reads`` in
    ``dtype`` for a method that reads the quality columns, else None."""
    if needs_reads(options, root):
        return pileup.parse(data, reads=dtype)
    return (*pileup.parse(data), None)


def expected(options: dict, chrom_id, chrom_table, pos, counts, reads=None, dtype=np.float64,
             root: str = ROOT) -> Expected:
    """The rows and per-class calls sid gives the input under ``options``
    (the port's ``Options`` fields that differ from their defaults): the
    ``expected`` of ``reference/methods/<method>.py``, handed ``reads``
    where it reads the quality columns."""
    name = options.get("method", "local")
    module = method(name, root)
    if not getattr(module, "READS", False):
        return module.expected(options, chrom_id, chrom_table, pos, counts, dtype)
    if reads is None:
        raise ValueError(f"the reference of method {name!r} needs the parse's reads (check.parse)")
    return module.expected(options, chrom_id, chrom_table, pos, counts, dtype, reads)


class Texts(NamedTuple):
    """Each class's ``label,gt,hom_conf,het_conf,conf_type``: class c's is
    ``data[lo[c]:hi[c]]``."""

    data: np.ndarray  # uint8
    lo: np.ndarray
    hi: np.ndarray


def _g(x: np.ndarray) -> np.ndarray:
    """``std::cout << x`` of each double: printf's %g, NaN as glibc prints it."""
    x = np.asarray(x, np.float64)
    out = np.char.mod(b"%g", x) if x.size else np.zeros(0, "S1")
    return np.where(np.isnan(x) & np.signbit(x), b"-nan", out)


def _joined(columns) -> Texts:
    """Texts whose text c is the concatenation of each column's c-th
    bytes (a column is an ``S`` array, or bytes the same in every text)."""
    n = max((c.shape[0] for c in columns if isinstance(c, np.ndarray)), default=0)
    cells, present = [], []
    for col in columns:
        if not isinstance(col, np.ndarray):
            col = np.full(n, col, f"S{max(len(col), 1)}")
        col = np.ascontiguousarray(col)
        m = col.view(np.uint8).reshape(n, col.dtype.itemsize)
        cells.append(m)
        present.append(m != 0)
    cells, present = np.concatenate(cells, 1), np.concatenate(present, 1)
    hi = np.cumsum(present.sum(1))
    return Texts(cells[present], hi - present.sum(1), hi)


def class_text(classes: calls.Classes, conf_type: str) -> Texts:
    """Each class's ``label,gt,hom_conf,het_conf,conf_type`` as sid prints it."""
    het = np.asarray(classes.is_het, bool)
    base = np.array([b"A", b"C", b"G", b"T"])
    major = np.asarray(classes.major)
    return _joined([np.where(het, b"het", b"hom"), b",", base[major],
                    base[np.where(het, np.asarray(classes.second), major)], b",", _g(classes.hom_conf), b",",
                    _g(classes.het_conf), b",", conf_type.encode()])


def _table(items: List[bytes]):
    """(rows, present): the byte strings as rows of a uint8 matrix, and
    which of its cells they fill."""
    width = max([len(b) for b in items] + [1])
    rows = np.zeros((len(items), width), np.uint8)
    for i, b in enumerate(items):
        rows[i, : len(b)] = np.frombuffer(b, np.uint8)
    lengths = np.array([len(b) for b in items], np.int64)
    return rows, np.arange(width) < lengths[:, None]


def _spans(lo: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """lo[i], lo[i] + 1, ..., lo[i] + lengths[i] - 1 for each i, concatenated."""
    idx = np.repeat(lo - (np.cumsum(lengths) - lengths), lengths)
    idx += np.arange(idx.size)
    return idx


def _gather(src: np.ndarray, lo: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """src[lo[i] : lo[i] + lengths[i]] for each i, concatenated."""
    return src[_spans(lo, lengths)]


def render(exp: Expected, texts: Texts, rows: Optional[slice] = None) -> bytes:
    """``chrom,pos,<text of the row's class>\n`` for the expected rows
    (``rows`` of them): ``chrom,pos,`` a row of a byte matrix, its unfilled
    cells dropped by one boolean index, and each line put together from
    that and its class's text by gathers."""
    rows = rows or slice(0, exp.pos.shape[0])
    chrom_id, pos, cls = exp.chrom_id[rows], exp.pos[rows], exp.cls[rows]
    if pos.shape[0] == 0:
        return b""
    names, name_in = _table([c + b"," for c in exp.chrom_table])
    digits = np.searchsorted(10 ** np.arange(1, 19, dtype=np.int64), np.abs(pos), side="right") + 1
    width = int(digits.max()) + 1
    num = np.zeros((pos.shape[0], width + 1), np.uint8)
    p = np.abs(pos)
    for j in range(width, 0, -1):
        num[:, j] = 48 + p % 10
        p //= 10
    num[:, 0] = ord("-")
    num_in = np.arange(width + 1) >= width + 1 - digits[:, None]
    num_in[:, 0] = pos < 0
    cells = np.concatenate([names[chrom_id], num, np.full((pos.shape[0], 1), ord(","), np.uint8)], 1)
    present = np.concatenate([name_in[chrom_id], num_in, np.ones((pos.shape[0], 1), bool)], 1)
    head_len = present.sum(1)
    text_lo, text_len = texts.lo[cls], texts.hi[cls] - texts.lo[cls]
    line_len = head_len + text_len + 1
    at = np.cumsum(line_len) - line_len
    out = np.empty(int(line_len.sum()), np.uint8)
    out[_spans(at, head_len)] = cells[present]
    out[_spans(at + head_len, text_len)] = _gather(texts.data, text_lo, text_len)
    out[at + line_len - 1] = 10
    return out.tobytes()


def print_gap(text: bytes, ref: float, digits: int) -> float:
    """Distance of a printed number from ``ref`` in half units of its
    ``digits``-th significant digit; inf where it is no number or the
    wrong one of 0, inf and NaN."""
    try:
        v = float(text)
    except ValueError:
        return math.inf
    if ref == 0 or not math.isfinite(ref):
        same = (v == ref) or (math.isnan(v) and math.isnan(ref))
        return 0.0 if same else math.inf
    if not math.isfinite(v):
        return math.inf
    k = math.floor(math.log10(abs(ref))) - digits + 1
    half = 0.5 * 10.0 ** k
    # past the subnormals' last digit the half unit is 0: scale both by 1e300
    return abs(v - ref) / half if half else abs(v - ref) * 1e300 / (0.5 * 10.0 ** (k + 300))


# 10.0 ** k as Python works it out, for every k a double's digit can have
_POW10_LO = -340
_POW10 = np.array([10.0 ** k for k in range(_POW10_LO, 309)])


def print_gaps(texts: np.ndarray, ref: np.ndarray, digits: int) -> np.ndarray:
    """``print_gap`` of each of ``texts`` (an ``S`` array) against ``ref``,
    in bulk: the texts parsed to float64 as ``float`` parses them, the
    digit of each ``ref`` found by ``math.log10``'s floor (NumPy's log10
    checked by ``math.log10`` where it lies near a whole number)."""
    ref = np.asarray(ref, np.float64)
    try:
        v = texts.astype(np.float64)
        parsed = np.ones(v.shape, bool)
    except ValueError:  # some text is no number: each parsed alone
        v = np.zeros(texts.shape)
        parsed = np.zeros(texts.shape, bool)
        for i, t in enumerate(texts.tolist()):
            try:
                v[i], parsed[i] = float(t), True
            except ValueError:
                pass
    gap = np.full(ref.shape, np.inf)
    special = (ref == 0) | ~np.isfinite(ref)
    gap[parsed & special & ((v == ref) | (np.isnan(v) & np.isnan(ref)))] = 0.0
    normal = np.flatnonzero(parsed & ~special & np.isfinite(v))
    with np.errstate(divide="ignore"):
        lg = np.log10(np.abs(ref[normal]))
    exponent = np.floor(lg)
    # log10(1) is 0 (C99 F.9.3.8); elsewhere a log10 within rounding of a
    # whole number is math.log10's
    near = np.flatnonzero((np.abs(lg - np.round(lg)) < 1e-9) & (np.abs(ref[normal]) != 1.0))
    exponent[near] = [math.floor(math.log10(abs(r))) for r in ref[normal[near]].tolist()]
    k = exponent.astype(np.int64) - digits + 1
    half = 0.5 * _POW10[k - _POW10_LO]
    diff = np.abs(v[normal] - ref[normal])
    tiny = half == 0  # as print_gap: both scaled by 1e300
    with np.errstate(divide="ignore", invalid="ignore"):
        diff /= half
    diff[tiny] = np.abs(v[normal[tiny]] - ref[normal[tiny]]) * 1e300 / (0.5 * _POW10[k[tiny] + 300 - _POW10_LO])
    gap[normal] = diff
    return gap


class _Lines(NamedTuple):
    """Where lines of a CSV start and end, how many commas each has and
    where its first six are (-1 past the last)."""

    starts: np.ndarray
    ends: np.ndarray
    n_commas: np.ndarray
    commas: np.ndarray  # (k, 6)


def _lines(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> _Lines:
    """The commas of the lines [starts, ends) of ``buf``, from one gather
    of their bytes."""
    lengths = ends - starts
    line_at = np.cumsum(lengths) - lengths
    span = _gather(buf, starts, lengths)
    at = np.flatnonzero(span == 44)
    line = np.searchsorted(line_at, at, side="right") - 1
    # a line of no bytes starts where the next does: a comma there is the last such line's
    n_commas = np.bincount(line, minlength=starts.size)
    first = np.cumsum(n_commas) - n_commas
    commas = np.full((starts.size, 6), -1, np.int64)
    for j in range(6):
        has = n_commas > j
        commas[has, j] = at[first[has] + j] - line_at[has] + starts[has]
    return _Lines(starts, ends, n_commas, commas)


def _field_is(buf: np.ndarray, lo: np.ndarray, hi: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Whether each field buf[lo:hi] is the bytes of ``want`` (an ``S``
    array of one width, or bytes), compared as byte columns."""
    want = np.ascontiguousarray(np.broadcast_to(np.asarray(want, "S"), lo.shape))
    width = want.dtype.itemsize
    cols = want.view(np.uint8).reshape(lo.size, width)
    same = hi - lo == width
    for j in range(width):
        same &= buf[np.minimum(lo + j, buf.size - 1)] == cols[:, j]
    return same


def _field_texts(buf: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The fields buf[lo:hi] as an ``S`` array (bytes past a field's end
    zero; a field with a zero byte or of more than 64 bytes is read as no
    number)."""
    lengths = hi - lo
    width = int(min(lengths.max(initial=1), 64))
    cells = np.zeros((lo.size, width), np.uint8)
    for j in range(width):
        inside = lengths > j
        cells[inside, j] = buf[lo[inside] + j]
    odd = (lengths > 64) | ((cells == 0) & (np.arange(width) < lengths[:, None])).any(1)
    cells[odd] = 0
    cells[odd, 0] = ord("x")
    return cells.view(f"S{width}").ravel()


def _class_numbers(buf: np.ndarray, lines: _Lines, classes: calls.Classes, conf_type: str):
    """(calls_bad, conf_gap) of the classes whose first rows are ``lines``."""
    five = lines.n_commas == 6  # label, gt, two confidences, the type
    c = lines.commas[five]
    het = np.asarray(classes.is_het, bool)[five]
    major = np.asarray(classes.major)[five]
    second = np.where(het, np.asarray(classes.second)[five], major)
    base = np.frombuffer(b"ACGT", np.uint8)
    gt = np.stack([base[major], base[second]], 1).copy().view("S2").ravel()
    good = (_field_is(buf, c[:, 1] + 1, c[:, 2], np.where(het, b"het", b"hom"))
            & _field_is(buf, c[:, 2] + 1, c[:, 3], gt)
            & _field_is(buf, c[:, 5] + 1, lines.ends[five], np.bytes_(conf_type.encode())))
    gap = 0.0 if five.all() else math.inf
    if five.any():
        gap = max(gap, float(print_gaps(_field_texts(buf, c[:, 3] + 1, c[:, 4]), classes.hom_conf[five], 6).max()),
                  float(print_gaps(_field_texts(buf, c[:, 4] + 1, c[:, 5]), classes.het_conf[five], 6).max()))
    return int((~five).sum() + (~good).sum()), gap


def _lines_differ(got: np.ndarray, got_len: np.ndarray, want: np.ndarray, want_len: np.ndarray) -> int:
    """How many of the lines of ``got`` and ``want`` (their bytes and the
    length of each) differ."""
    differ = got_len != want_len
    same_len = np.flatnonzero(~differ)
    lengths = got_len[same_len]
    ne = (_gather(got, (np.cumsum(got_len) - got_len)[same_len], lengths)
          != _gather(want, (np.cumsum(want_len) - want_len)[same_len], lengths))
    if ne.size:
        filled = lengths > 0
        differ[same_len[filled]] |= np.add.reduceat(ne, (np.cumsum(lengths) - lengths)[filled]) > 0
    return int(differ.sum())


def compare(csv: bytes, diag: List[str], exp: Expected, block_rows: int = 1 << 17,
            threads: int = 8) -> Dict[str, float]:
    """The numbers that decide ``correct`` for one CSV output."""
    out = {"rows_bad": 0, "calls_bad": 0, "conf_gap": 0.0} | _fit_numbers(diag, exp)
    buf = np.frombuffer(csv, np.uint8)
    nl = np.flatnonzero(buf == 10)
    m = exp.pos.shape[0]
    if nl.size == 0 or csv[: nl[0]] != HEADER:
        out["rows_bad"] = m + 1
        return out
    starts = nl[:-1] + 1
    ends = nl[1:]
    if starts.size != m:
        out["rows_bad"] = abs(starts.size - m) + min(starts.size, m)
        return out

    # each class's first row: its commas, its text after the second, and its calls
    def class_block(lo: int):
        hi = min(lo + block_rows, exp.first.size)
        first = exp.first[lo:hi]
        lines = _lines(buf, starts[first], ends[first])
        two = lines.n_commas >= 2
        text_lo = np.where(two, lines.commas[:, 1] + 1, lines.ends)
        part = calls.Classes(*(np.asarray(a)[lo:hi] for a in exp.classes))
        return text_lo, _class_numbers(buf, lines, part, exp.conf_type)

    with ThreadPoolExecutor(threads) as pool:
        blocks = list(pool.map(class_block, range(0, exp.first.size, block_rows)))
    texts = Texts(buf, np.concatenate([b[0] for b in blocks] or [np.zeros(0, np.int64)]), ends[exp.first])
    out["calls_bad"] += sum(b[1][0] for b in blocks)
    out["conf_gap"] = max([b[1][1] for b in blocks], default=0.0)

    # every row against chrom,pos and its class's text, a block at a time
    def block_bad(lo: int) -> int:
        hi = min(lo + block_rows, m)
        want = render(exp, texts, slice(lo, hi))
        got = csv[starts[lo] : ends[hi - 1] + 1]
        if got == want:
            return 0
        want_buf = np.frombuffer(want, np.uint8)
        want_nl = np.flatnonzero(want_buf == 10)
        return _lines_differ(np.frombuffer(got, np.uint8), ends[lo:hi] + 1 - starts[lo:hi], want_buf,
                             np.diff(want_nl, prepend=-1))

    with ThreadPoolExecutor(threads) as pool:
        out["rows_bad"] = sum(pool.map(block_bad, range(0, m, block_rows)))
    return out


def fit_lines(exp: Expected) -> List[str]:
    """The diagnostic lines sid prints for a fit (call.cpp:72-80)."""
    if exp.fit is None:
        return []
    return [f"# unique profiles: {len(exp.classes.major)}", f"# heterozygosity: {exp.fit.pi:.6e}",
            f"# error: {exp.fit.eps:.6e}"]


def _fit_numbers(diag: List[str], exp: Expected) -> Dict[str, float]:
    """``fit_gap`` from the fit's diagnostic lines, and ``calls_bad`` 1
    where they give another count of unique profiles; nothing without a
    fit."""
    if exp.fit is None:
        return {}
    values = {}
    for line in diag:
        key, _, value = line.lstrip("# ").partition(": ")
        values[key] = value.strip()
    gap = max(print_gap(values.get("heterozygosity", "").encode(), exp.fit.pi, 7),
              print_gap(values.get("error", "").encode(), exp.fit.eps, 7))
    return {"calls_bad": int(values.get("unique profiles") != str(len(exp.classes.major))), "fit_gap": gap}
