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
])
def test_reference_writes_sids_csv(golden, options):
    exp = check.expected(options, *pileup.parse(_read("golden.pileup")))
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
