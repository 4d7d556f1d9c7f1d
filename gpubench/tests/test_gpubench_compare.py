"""``check.compare`` and ``check.render`` work in bulk; the loops over
classes and rows they replaced are kept here as their oracle, and the bulk
numbers must be the loop's exactly, on sound outputs and faulty ones."""

import math
import os

import numpy as np
import pytest

from gpubench import harness
from gpubench.reference import check
from gpubench.traffic import generate

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "fixtures")


def _loop_g(x: float) -> str:
    if math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    return "%g" % x


def loop_class_text(classes, conf_type):
    out = []
    for het, a, b, p1, p2 in zip(classes.is_het.tolist(), classes.major.tolist(), classes.second.tolist(),
                                 classes.hom_conf.tolist(), classes.het_conf.tolist()):
        gt = "ACGT"[a] + ("ACGT"[b] if het else "ACGT"[a])
        out.append(f"{'het' if het else 'hom'},{gt},{_loop_g(p1)},{_loop_g(p2)},{conf_type}".encode())
    return out


def loop_render(exp, texts):
    return b"".join(exp.chrom_table[c] + b"," + str(p).encode() + b"," + texts[k] + b"\n"
                    for c, p, k in zip(exp.chrom_id.tolist(), exp.pos.tolist(), exp.cls.tolist()))


def loop_compare(csv, diag, exp):
    """``check.compare`` as a loop over classes and rows."""
    out = {"rows_bad": 0, "calls_bad": 0, "conf_gap": 0.0} | check._fit_numbers(diag, exp)
    nl = [i for i, b in enumerate(csv) if b == 10]
    m = exp.pos.shape[0]
    if not nl or csv[: nl[0]] != check.HEADER:
        out["rows_bad"] = m + 1
        return out
    starts, ends = [i + 1 for i in nl[:-1]], nl[1:]
    if len(starts) != m:
        out["rows_bad"] = abs(len(starts) - m) + min(len(starts), m)
        return out
    texts = []
    for r in exp.first.tolist():
        line = csv[starts[r] : ends[r]]
        texts.append(line.split(b",", 2)[2] if line.count(b",") >= 2 else b"")
    gap, bad = 0.0, 0
    for c, (got, want) in enumerate(zip(texts, loop_class_text(exp.classes, exp.conf_type))):
        g, w = got.split(b","), want.split(b",")
        if len(g) != 5:
            bad += 1
            gap = math.inf
            continue
        if g[0] != w[0] or g[1] != w[1] or g[4] != w[4]:
            bad += 1
        gap = max(gap, check.print_gap(g[2], float(exp.classes.hom_conf[c]), 6),
                  check.print_gap(g[3], float(exp.classes.het_conf[c]), 6))
    out["calls_bad"] += bad
    out["conf_gap"] = gap
    want = loop_render(exp, texts).split(b"\n")
    out["rows_bad"] = sum(csv[s:e] != w for s, e, w in zip(starts, ends, want))
    return out


OPTIONS = {"local": {}, "lrR": {"method": "likelihood_ratio", "estimate_prior": True}, "quality": {"method": "quality"}}
TRAFFIC = {"local": "chrom17M", "lrR": "chrom17M", "quality": "chrom12M.mq"}


def _case(kind):
    traffic = harness.load_json(harness.ROOT, "gpubench", "traffic", TRAFFIC[kind] + ".json")
    text = generate.make_pileup(dict(traffic, sites=6_000, body_sites=3_000, distinct_bodies=2), 2**31 + 3)
    options = OPTIONS[kind]
    exp = check.expected(options, *check.parse(options, text))
    csv = check.HEADER + b"\n" + loop_render(exp, loop_class_text(exp.classes, exp.conf_type))
    return exp, csv, check.fit_lines(exp)


def _line_of_class(csv, exp, c):
    lines = csv.split(b"\n")
    return lines, 1 + int(exp.first[c])


def _moved(csv, exp):
    """A class's printed hom confidence moved by 1e-3."""
    c = int(np.flatnonzero(np.asarray(exp.classes.hom_conf) > 0)[0])
    lines, i = _line_of_class(csv, exp, c)
    f = lines[i].split(b",")
    f[4] = b"%g" % (float(f[4]) * 1.001)
    lines[i] = b",".join(f)
    return b"\n".join(lines)


def _label_flipped_later(csv, exp):
    """The last row's label and genotype changed (for a per-profile method
    not its class's first row)."""
    lines = csv.split(b"\n")
    f = lines[-2].split(b",")
    f[2] = b"het" if f[2] == b"hom" else b"hom"
    lines[-2] = b",".join(f)
    return b"\n".join(lines)


def _broken_first_rows(csv, exp):
    """Class 0's first row loses a comma, class 1's gets no number and a
    NaN, class 2's a text past any %g, a row's position is off by one."""
    lines = csv.split(b"\n")
    for c, edit in enumerate([lambda f: f[:4] + [f[4] + f[5]] + f[6:],
                              lambda f: f[:4] + [b"abc", b"-nan"] + f[6:],
                              lambda f: f[:4] + [b" 0.5e-3 "] + f[5:6] + [b"p_value" * 12]]):
        i = 1 + int(exp.first[c])
        lines[i] = b",".join(edit(lines[i].split(b",")))
    f = lines[3].split(b",")
    f[1] = str(int(f[1]) + 1).encode()
    lines[3] = b",".join(f)
    return b"\n".join(lines)


@pytest.mark.parametrize("fault", [None, _moved, _label_flipped_later, _broken_first_rows])
@pytest.mark.parametrize("kind", sorted(OPTIONS))
def test_bulk_compare_is_the_loop(kind, fault):
    exp, csv, diag = _case(kind)
    assert check.HEADER + b"\n" + check.render(exp, check.class_text(exp.classes, exp.conf_type)) == csv
    if fault is not None:
        csv = fault(csv, exp)
    got, want = check.compare(csv, diag, exp, block_rows=1_000), loop_compare(csv, diag, exp)
    assert got == want
    assert (got["rows_bad"] + got["calls_bad"] == 0 and got["conf_gap"] <= 1.0) == (fault is None)


@pytest.mark.parametrize("golden, options", [
    ("golden_local.csv", {}),
    ("golden_likelihood_ratio_R.csv", {"method": "likelihood_ratio", "estimate_prior": True}),
    ("golden_quality.csv", {"method": "quality"}),
])
def test_bulk_compare_is_the_loop_on_sids_csv(golden, options):
    with open(os.path.join(FIXTURES, "golden.pileup"), "rb") as f:
        exp = check.expected(options, *check.parse(options, f.read()))
    with open(os.path.join(FIXTURES, golden), "rb") as f:
        csv = f.read()
    diag = check.fit_lines(exp)
    assert check.compare(csv, diag, exp) == loop_compare(csv, diag, exp)
    assert check.compare(_moved(csv, exp), diag, exp) == loop_compare(_moved(csv, exp), diag, exp)


def test_print_gaps_is_print_gap():
    rng = np.random.default_rng(11)
    ref = np.concatenate([rng.random(500) ** 40, 10.0 ** np.arange(-300, 300, 7), [1.0, 0.1, 1e-5, 0.0, np.inf,
                                                                                  np.nan, -np.nan, 1e-320]])
    ref = np.concatenate([ref, np.nextafter(ref, 0), np.nextafter(ref, 1)])
    texts = [b"%g" % v for v in ref] + [b"%g" % (float(v) * 1.0003) for v in ref] + [b"nan", b"inf", b"0", b"x", b""] * 3
    ref = np.concatenate([ref, ref, np.resize([0.0, np.inf, np.nan, 1.0, 2.0], 15)])
    got = check.print_gaps(np.array(texts), ref, 6)
    want = [check.print_gap(t, float(r), 6) for t, r in zip(texts, ref)]
    assert got.tolist() == want
