"""The port's GSL nmsimplex2 loop vs sid_tpu's NumPy spec, bitwise.

``sid_tpu_torch.exact.nmsimplex.minimize_nmsimplex2`` drives both Lynch fits
of the port. On the objectives of tests/test_nmsimplex.py (smooth, with a
box-penalty plateau, with NaN and inf regions, unbounded, and the
long-double Lynch objective) it must reach the same x, fval and iteration
count as ``sid_tpu.exact.nmsimplex.minimize_nmsimplex2``, bit for bit, and
log the same diagnostic lines.

``minimize_nmsimplex2_lanes`` runs many minimizations in lockstep (the
population fits): each lane must take the points, and reach the result,
that ``minimize_nmsimplex2`` takes and reaches for its objective alone,
whatever the other lanes do (converge early, never converge, return NaN,
+-inf or DBL_MAX).
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from sid_tpu.exact import lynch_ld as ref_lynch_ld  # noqa: E402
from sid_tpu.exact.nmsimplex import minimize_nmsimplex2 as ref_minimize  # noqa: E402
from sid_tpu_torch.exact.nmsimplex import minimize_nmsimplex2, minimize_nmsimplex2_lanes  # noqa: E402
from sid_tpu_torch.io import native  # noqa: E402
from sid_tpu_torch.native import bridge  # noqa: E402
from sid_tpu_torch.ops.profiles import nucleotide_distribution  # noqa: E402

DBL_MAX = float(np.finfo(np.float64).max)


def _box(x):
    if abs(x[0]) > 1 or abs(x[1]) > 1:
        return DBL_MAX
    return float(x[0] ** 2 + x[1] ** 2 + 1.0)


OBJECTIVES = {
    # (objective, x0, step) as tests/test_nmsimplex.py runs them
    "quadratic": (lambda x: float((x[0] - 3.0) ** 2 + 2.0 * (x[1] + 1.0) ** 2), [0.0, 0.0], [0.1, 0.1]),
    "rosenbrock": (lambda x: float((1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2), [-1.2, 1.0], [0.1, 0.1]),
    "box_penalty": (_box, [0.9, 0.9], [0.05, 0.05]),
    "bowl": (lambda x: float(x[0] ** 2 + x[1] ** 2), [1.0, 1.0], [0.1, 0.1]),
    "unbounded": (lambda x: float(x[0] + x[1]), [0.0, 0.0], [1.0, 1.0]),
    # the lean-loop objectives, from the fit's start
    "rosenbrock_lynch_start": (
        lambda th: float((1 - th[0]) ** 2 + 100 * (th[1] - th[0] ** 2) ** 2), [1e-3, 1e-3], [1e-4, 1e-4]),
    "shifted_quadratic": (
        lambda th: float(np.sum((np.asarray(th) - [0.3, -0.7]) ** 2)), [1e-3, 1e-3], [1e-4, 1e-4]),
    "abs": (lambda th: float(np.sum(np.abs(np.asarray(th) - 0.12345))), [1e-3, 1e-3], [1e-4, 1e-4]),
    "nan_region": (
        lambda th: float("nan") if th[1] < -0.001 else float(np.sum((np.asarray(th) - 0.2) ** 2)),
        [1e-3, 1e-3], [1e-4, 1e-4]),
    "inf_penalty": (
        lambda th: float("inf") if abs(th[0]) > 0.05 else float(np.sum(np.asarray(th) ** 2)),
        [1e-3, 1e-3], [1e-4, 1e-4]),
}


def _same(a, b, lines_a, lines_b):
    assert np.array_equal(a.x, b.x)
    assert a.x.dtype == b.x.dtype == np.float64
    assert (a.fval == b.fval) or (np.isnan(a.fval) and np.isnan(b.fval))
    assert (a.iterations, a.converged) == (b.iterations, b.converged)
    assert lines_a == lines_b and len(lines_a) == 1


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_bitwise_equal_to_sid_tpu(name):
    f, x0, step = OBJECTIVES[name]
    calls_a, calls_b = [], []
    lines_a, lines_b = [], []
    a = minimize_nmsimplex2(lambda x: calls_a.append(np.array(x)) or f(x), x0, step, log=lines_a.append)
    b = ref_minimize(lambda x: calls_b.append(np.array(x)) or f(x), x0, step, log=lines_b.append)
    _same(a, b, lines_a, lines_b)
    # the same evaluation points, in the same order
    assert len(calls_a) == len(calls_b)
    assert all(np.array_equal(p, q) for p, q in zip(calls_a, calls_b))


def test_unbounded_stops_at_1000_iterations():
    lines = []
    res = minimize_nmsimplex2(OBJECTIVES["unbounded"][0], [0.0, 0.0], [1.0, 1.0], log=lines.append)
    assert not res.converged and res.iterations == 1000
    assert lines == ["# Error: GSL function minimization did not converge in 1000 iterations!"]


@pytest.mark.parametrize("deep", [False, True])
def test_bitwise_equal_on_long_double_lynch_objective(deep):
    rng = np.random.default_rng(17)
    profiles = rng.multinomial(25, [0.9, 0.05, 0.03, 0.02], (700,)).astype(np.int32)
    if deep:
        profiles[:2] = [[9000, 9000, 0, 0], [15000, 0, 5000, 0]]
    mult = rng.integers(1, 200, 700).astype(np.int64)
    nt = nucleotide_distribution(profiles, mult)
    port = bridge.NativeLynchLD(native.load(), profiles, mult, nt)
    ref = ref_lynch_ld.NativeLynchLD(profiles, mult, nt)
    lines_a, lines_b = [], []
    a = minimize_nmsimplex2(port.objective, [1e-3, 1e-3], [1e-4, 1e-4], log=lines_a.append)
    b = ref_minimize(ref.objective, [1e-3, 1e-3], [1e-4, 1e-4], log=lines_b.append)
    _same(a, b, lines_a, lines_b)
    for x, y in zip(port.marginals(float(a.x[1])), ref.marginals(float(b.x[1]))):
        assert np.array_equal(x, y, equal_nan=True)


def _lanes_vs_alone(fs, x0s, steps, max_iterations=1000):
    """Run fs as lanes and each alone; check every lane against its run
    alone (points, x, fval, iterations, converged) and that each round
    passes the running lanes in increasing order. Returns the results and
    the number of rounds."""
    calls = [[] for _ in fs]
    rounds = []

    def f_lanes(lanes, points):
        rounds.append(list(lanes))
        assert lanes == sorted(set(lanes))
        out = []
        for k, x in zip(lanes, points):
            calls[k].append(np.array(x))
            out.append(fs[k](x))
        return out

    got = minimize_nmsimplex2_lanes(f_lanes, x0s, steps, max_iterations=max_iterations)
    for k, f in enumerate(fs):
        alone = []
        want = minimize_nmsimplex2(lambda x: alone.append(np.array(x)) or f(x), x0s[k], steps[k],
                                   max_iterations=max_iterations)
        assert np.array_equal(got[k].x, want.x) and got[k].x.dtype == np.float64
        assert (got[k].fval == want.fval) or (np.isnan(got[k].fval) and np.isnan(want.fval))
        assert (got[k].iterations, got[k].converged) == (want.iterations, want.converged)
        assert len(calls[k]) == len(alone)
        assert all(np.array_equal(p, q, equal_nan=True) for p, q in zip(calls[k], alone))
    # a lane leaves the rounds when it stops: the rounds are as many as the
    # longest lane's evaluations
    assert len(rounds) == max(len(c) for c in calls)
    return got, len(rounds)


def test_lanes_are_each_lane_alone_2d():
    names = sorted(OBJECTIVES)
    fs = [OBJECTIVES[n][0] for n in names]
    got, n_rounds = _lanes_vs_alone(fs, [OBJECTIVES[n][1] for n in names], [OBJECTIVES[n][2] for n in names])
    iterations = {n: r.iterations for n, r in zip(names, got)}
    # the lanes stop at different rounds; "unbounded" runs to the limit
    assert len(set(iterations.values())) > 3
    assert iterations["unbounded"] == 1000 and not got[names.index("unbounded")].converged


@pytest.mark.parametrize("max_iterations", [0, 1, 7, 1000])
def test_lanes_are_each_lane_alone_1d(max_iterations):
    fs = [
        lambda x: float((x[0] - 0.3) ** 2),
        lambda x: float("nan") if x[0] > 0.0015 else float(x[0] ** 2),
        lambda x: DBL_MAX if x[0] < 0 else float(abs(x[0] - 0.02)),
        lambda x: float(-x[0]),  # unbounded below
        lambda x: float("-inf") if x[0] > 0.01 else float(x[0]),
    ]
    got, _ = _lanes_vs_alone(fs, [[1e-3]] * 5, [[1e-4]] * 5, max_iterations=max_iterations)
    assert all(r.iterations <= max_iterations for r in got)


def test_lanes_lynch_objectives():
    """Six long-double Lynch objectives (one with a deep row) as 2-D lanes
    and as 1-D pi lanes at a fixed epsilon, from the population fits'
    starts."""
    rng = np.random.default_rng(5)
    objs = []
    for k in range(6):
        profiles = rng.multinomial(25, [0.9, 0.05, 0.03, 0.02], (300,)).astype(np.int32)
        if k == 2:
            profiles[0] = [9000, 9000, 0, 0]
        mult = rng.integers(1, 50, 300).astype(np.int64)
        objs.append(bridge.NativeLynchLD(native.load(), profiles, mult, nucleotide_distribution(profiles, mult)))
    _lanes_vs_alone([o.objective for o in objs], [[1e-3, 1e-3]] * 6, [[1e-4, 1e-4]] * 6)
    _lanes_vs_alone([lambda x, o=o: o.objective((x[0], 0.01)) for o in objs], [[1e-3]] * 6, [[1e-4]] * 6)


def test_lanes_reject_mismatched_starts_and_values():
    with pytest.raises(ValueError, match="starting points"):
        minimize_nmsimplex2_lanes(lambda lanes, pts: [0.0] * len(lanes), [[0.0]], [[0.1], [0.1]])
    with pytest.raises(ValueError, match="values for"):
        minimize_nmsimplex2_lanes(lambda lanes, pts: [0.0], [[0.0], [1.0]], [[0.1], [0.1]])


_SPECIAL = st.sampled_from([float("nan"), float("inf"), float("-inf"), DBL_MAX, -DBL_MAX])


@settings(max_examples=30, deadline=None)
@given(
    centers=st.lists(st.tuples(st.floats(-2, 2), st.floats(-2, 2)), min_size=1, max_size=6),
    cut=st.floats(0.0, 1.0),
    special=_SPECIAL,
    scale=st.floats(1e-3, 1.0),
)
def test_lanes_hypothesis(centers, cut, special, scale):
    """Random quadratic bowls, each with a region where it returns NaN,
    +-inf or DBL_MAX, from random steps: every lane is its run alone."""
    def bowl(c):
        def f(x):
            if x[0] > c[0] + cut:
                return special
            return float((x[0] - c[0]) ** 2 + 3.0 * (x[1] - c[1]) ** 2)
        return f

    fs = [bowl(c) for c in centers]
    steps = [[scale * (k + 1), scale] for k in range(len(fs))]
    _lanes_vs_alone(fs, [[0.0, 0.0]] * len(fs), steps, max_iterations=300)
