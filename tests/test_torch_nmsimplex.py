"""The port's GSL nmsimplex2 loop vs sid_tpu's NumPy spec, bitwise.

``sid_tpu_torch.exact.nmsimplex.minimize_nmsimplex2`` drives both Lynch fits
of the port. On the objectives of tests/test_nmsimplex.py (smooth, with a
box-penalty plateau, with NaN and inf regions, unbounded, and the
long-double Lynch objective) it must reach the same x, fval and iteration
count as ``sid_tpu.exact.nmsimplex.minimize_nmsimplex2``, bit for bit, and
log the same diagnostic lines.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from sid_tpu.exact import lynch_ld as ref_lynch_ld  # noqa: E402
from sid_tpu.exact.nmsimplex import minimize_nmsimplex2 as ref_minimize  # noqa: E402
from sid_tpu_torch.exact.nmsimplex import minimize_nmsimplex2  # noqa: E402
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
