"""The plain reference against sid's own output (the golden CSVs, written
by the reference sid on tests/fixtures/golden.pileup) and its parts
against their plain loops."""

import os

import numpy as np
import pytest

from gpubench.reference import calls, check, nmsimplex, pileup

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "fixtures")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("golden, options", [
    ("golden_local.csv", {}),
    ("golden_likelihood_ratio_R.csv", {"method": "likelihood_ratio", "estimate_prior": True}),
    ("golden_likelihood_ratio.csv", {"method": "likelihood_ratio"}),
    ("golden_quality.csv", {"method": "quality"}),
])
def test_reference_writes_sids_csv(golden, options):
    exp = check.expected(options, *check.parse(options, _read("golden.pileup")))
    csv = check.HEADER + b"\n" + check.render(exp, check.class_text(exp.classes, exp.conf_type))
    assert csv == _read(golden)
    numbers = check.compare(_read(golden), check.fit_lines(exp), exp)
    assert numbers["rows_bad"] == 0 and numbers["calls_bad"] == 0
    assert numbers["conf_gap"] <= 1.0


def test_vectorised_parse_matches_the_line_grammar():
    lines = [
        b"chr1\t1\tA\t9\t.,^]AcG$*tT-2ACg\tIIIIIIIII\tJJJJJJJJJ",
        b"chr1\t2\tg\t6\t..,,+1Aa\tIIIIII\tJJJJJJ",
        b"chr2 3  C 4 acgt IIII JJJJ",
        b"chr2\t4\tN\t3\t.,A",
        b"chr1\t5\tT\t5\tTTTTt\t+++++\t-----",
        b"chrM\t+6\tT\t1\t^",
        b"chr1\t00017\tA\t2\t.n\t##\t##",
        b"chr1\t18\tN\t5\t^+a^-C$^.g^AT\tIIIII",
        b"chr1\t19\tN\t3\tA^^c$t\tIII",
        b"chr1\t20\tN\t2\tgA^\tII",
        b"chr1\t21\tN\t2\t^$a$^\"c\tII",
    ]
    data = b"\n".join(lines) + b"\n\n"
    chrom_id, table, pos, counts = pileup.parse(data, threads=2)
    want = [pileup.parse_line(line) for line in lines]
    assert [table[i] for i in chrom_id] == [w[0] for w in want]
    assert pos.tolist() == [w[1] for w in want]
    assert counts.tolist() == [w[2] for w in want]
    assert counts.tolist()[:2] == [[3, 1, 2, 2], [1, 0, 4, 0]]


def test_only_a_method_that_reads_qualities_parses_them():
    data = _read("golden.pileup")
    assert check.parse({}, data)[4] is None and check.parse({"method": "likelihood_ratio"}, data)[4] is None
    reads = check.parse({"method": "quality"}, data, np.float32)[4]
    assert isinstance(reads, pileup.Reads) and reads.log_hom.dtype == np.float32
    with pytest.raises(ValueError, match="needs the parse's reads"):
        check.expected({"method": "quality"}, *pileup.parse(data))


def test_the_reads_of_a_block_match_the_line_grammar():
    """The blocks' sums equal ``parse_line``'s reads summed, on lines of
    every shape: reads dropped or skipped, indels, columns short or long,
    bytes under 33, a site of no reads."""
    lines = [
        b"chr1\t1\tA\t9\t.,^]AcG$*tT-2ACg\tIIIIIIIII\tJJJJJJJJJ",
        b"chr1\t2\tg\t6\t..,,+1Aa\tI5I+II\tJ]JJ;J",
        b"chr1\t3\tN\t4\t.,At\tIIII\t!!!!",
        b"chr1\t4\tC\t4\tacgt\tII\tJJJJJJ",
        b"chr1\t5\tT\t3\tTTt\t\x01+5\t-\x7f~",
        b"chr1\t6\tT\t0\t*\t*\t*",
        b"chr1\t7\tG\t5\tGgGgA\tABCDE\t^^^^^",
        b"chr2 8  C 4 acgt IIII JJJJ",
        b"chr2\t9\tA\t3\t^I.^J,^Kc\t#$%\t&'(",
    ]
    data = b"\n".join(lines) + b"\n"
    *_, counts, reads = pileup.parse(data, threads=2, reads=np.float64)
    parsed = [pileup.parse_line(line, True) for line in lines]
    want = pileup.read_sums(np.array([p[2] for p in parsed]), np.concatenate([p[3] for p in parsed]),
                            np.concatenate([p[4] for p in parsed]), np.array([len(p[3]) for p in parsed]),
                            np.float64)
    assert counts.tolist() == [p[2] for p in parsed]
    assert np.array_equal(reads.log_hom, want.log_hom) and np.array_equal(reads.log_het, want.log_het)
    # positional pairing, 1 past a column's end, bytes modulo 256 at least 1
    assert pileup.parse_line(lines[3], True)[4].tolist() == [40, 40, 1, 1]
    assert pileup.parse_line(lines[4], True)[4].tolist() == [12, 10, 20]  # min(224, 12), min(10, 94), min(20, 93)
    assert [int(c) for c in pileup.parse_line(lines[0], True)[3]] == [0, 0, 0, 1, 2, 3, 3, 2]
    with pytest.raises(ValueError):
        pileup.parse(b"chr1\t1\tA\t2\tAA\tII\n", reads=np.float64)


def test_benjamini_hochberg_matches_its_loop():
    rng = np.random.default_rng(5)
    p = np.concatenate([rng.uniform(size=200), np.ones(20), rng.uniform(size=10) * 1e-9])
    order = np.argsort(-p, kind="stable")
    want = np.empty_like(p)
    running = p[order[0]]
    want[order[0]] = running
    for i in range(1, p.size):
        running = min(running, p[order[i]] * p.size / (p.size - i))
        want[order[i]] = running
    assert np.array_equal(calls.benjamini_hochberg(p), np.minimum(want, 1.0))


def test_nmsimplex_finds_a_quadratic_minimum():
    res = nmsimplex.minimize(lambda x: (x[0] - 0.3) ** 2 + 2 * (x[1] + 0.1) ** 2 + 1, (0.0, 0.0), (0.1, 0.1))
    assert res.converged
    assert np.allclose(res.x, [0.3, -0.1], atol=1e-4)
