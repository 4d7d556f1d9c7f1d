"""What decides ``correct``: a program's CSV (and its diagnostics) against
the calls the reference works out from the same input.

``expected`` derives, from the parsed input, the rows sid emits (every site
for ``local``; the sites of coverage >= 4 for ``likelihood_ratio``), each
row's profile class, and per class the call and its two confidences; each
method's derivation is ``reference/methods/<method>.py``, found by name.
``compare`` reads a CSV against that:

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

from gpubench.reference import calls

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


def expected(options: dict, chrom_id, chrom_table, pos, counts, dtype=np.float64, root: str = ROOT) -> Expected:
    """The rows and per-class calls sid gives the input under ``options``
    (the port's ``Options`` fields that differ from their defaults): the
    ``expected`` of ``reference/methods/<method>.py``."""
    return method(options.get("method", "local"), root).expected(options, chrom_id, chrom_table, pos, counts, dtype)


def method(name: str, root: str = ROOT):
    """The reference of method ``name``, ``gpubench/reference/methods/<name>.py``."""
    path = os.path.join(root, "gpubench", "reference", "methods", name + ".py")
    if not os.path.exists(path):
        raise NotImplementedError(f"no reference for method {name!r} ({path})")
    spec = importlib.util.spec_from_file_location("gpubench_reference_method_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def class_text(classes: calls.Classes, conf_type: str) -> List[bytes]:
    """Each class's ``label,gt,hom_conf,het_conf,conf_type`` as sid prints it."""
    out = []
    for het, a, b, p1, p2 in zip(classes.is_het.tolist(), classes.major.tolist(), classes.second.tolist(),
                                 classes.hom_conf.tolist(), classes.het_conf.tolist()):
        gt = "ACGT"[a] + ("ACGT"[b] if het else "ACGT"[a])
        out.append(f"{'het' if het else 'hom'},{gt},{_g(p1)},{_g(p2)},{conf_type}".encode())
    return out


def _g(x: float) -> str:
    """``std::cout << x``: printf's %g; NaN as glibc prints it."""
    if math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    return "%g" % x


def _table(items: List[bytes]):
    """(rows, present): the byte strings as rows of a uint8 matrix, and
    which of its cells they fill."""
    width = max([len(b) for b in items] + [1])
    rows = np.zeros((len(items), width), np.uint8)
    for i, b in enumerate(items):
        rows[i, : len(b)] = np.frombuffer(b, np.uint8)
    lengths = np.array([len(b) for b in items], np.int64)
    return rows, np.arange(width) < lengths[:, None]


def render(exp: Expected, texts: List[bytes], rows: Optional[slice] = None) -> bytes:
    """``chrom,pos,<text of the row's class>\n`` for the expected rows
    (``rows`` of them): each line a row of a byte matrix, the unfilled
    cells dropped by one boolean index."""
    rows = rows or slice(0, exp.pos.shape[0])
    chrom_id, pos, cls = exp.chrom_id[rows], exp.pos[rows], exp.cls[rows]
    if pos.shape[0] == 0:
        return b""
    names, name_in = _table([c + b"," for c in exp.chrom_table])
    text, text_in = _table([t + b"\n" for t in texts])
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
    cells = np.concatenate([names[chrom_id], num, np.full((pos.shape[0], 1), ord(","), np.uint8), text[cls]], 1)
    present = np.concatenate([name_in[chrom_id], num_in, np.ones((pos.shape[0], 1), bool), text_in[cls]], 1)
    return cells[present].tobytes()


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
    half = 0.5 * 10.0 ** (math.floor(math.log10(abs(ref))) - digits + 1)
    return abs(v - ref) / half if math.isfinite(v) else math.inf


def compare(csv: bytes, diag: List[str], exp: Expected, block_rows: int = 1 << 20,
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
    # each class's text as the CSV gives it on the class's first row
    texts: List[bytes] = []
    for r in exp.first.tolist():
        line = csv[starts[r] : ends[r]]
        texts.append(line.split(b",", 2)[2] if line.count(b",") >= 2 else b"")
    ref_texts = class_text(exp.classes, exp.conf_type)
    gap = 0.0
    bad = 0
    for c, (got, want) in enumerate(zip(texts, ref_texts)):
        g, w = got.split(b","), want.split(b",")
        if len(g) != 5:
            bad += 1
            gap = math.inf
            continue
        if g[0] != w[0] or g[1] != w[1] or g[4] != w[4]:
            bad += 1
        gap = max(gap, print_gap(g[2], float(exp.classes.hom_conf[c]), 6),
                  print_gap(g[3], float(exp.classes.het_conf[c]), 6))
    out["calls_bad"] += bad
    out["conf_gap"] = gap
    # every row against chrom,pos and its class's text, a block at a time
    def block_bad(lo: int) -> int:
        hi = min(lo + block_rows, m)
        want = render(exp, texts, slice(lo, hi))
        got = csv[starts[lo] : ends[hi - 1] + 1]
        if got == want:
            return 0
        return sum(a != b for a, b in zip(got.split(b"\n"), want.split(b"\n")))

    with ThreadPoolExecutor(threads) as pool:
        rows_bad = sum(pool.map(block_bad, range(0, m, block_rows)))
    out["rows_bad"] = rows_bad
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
