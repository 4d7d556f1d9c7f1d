"""GSL-faithful Nelder-Mead (nmsimplex2 variant), NumPy float64.

Reimplements the update rule of ``gsl_multimin_fminimizer_nmsimplex2`` (the
minimizer the reference instantiates at optimization.hpp:46) from the
documented algorithm, so the fitted (pi, epsilon) trajectory matches the
reference's: simplex of P = N+1 corners; each iteration reflects the worst
corner through the running center of all corners (coeff -1), tries expansion
(coeff -2) when the reflection is a new best, one-dimensional contraction
(coeff +0.5) when the reflection is still worse than the second-worst, and
full contraction toward the best corner as last resort; size is the RMS
corner-to-center distance maintained incrementally; convergence when
size < tol (the reference passes 1e-5; max 1000 iterations,
optimization.hpp:26,66-67).

A port of sid_tpu's NumPy spec (``sid_tpu/exact/nmsimplex.py``), operation
for operation, so trajectories, results and diagnostic lines are bitwise
sid_tpu's. It drives both Lynch fits of this package: the long-double host
objective and the device objective, one f64 scalar fetched per evaluation
(sid_tpu's ``lax.while_loop`` form exists to bound XLA trace size and has no
counterpart here). NumPy f64 contracts nothing into a fused multiply-add,
so the spec's operation order is the order executed.

The loop is a generator (``_minimize``) that yields each point it needs and
receives its value, so one copy of the rule serves two loops:
``minimize_nmsimplex2`` evaluates a scalar objective point by point, and
``minimize_nmsimplex2_lanes`` advances many independent minimizations in
lockstep, one pending point of every running lane per call of a lane-batched
objective. That is how sid_tpu's population fits run (a vmapped
``lax.while_loop`` whose batching masks finished lanes, one objective
evaluation per lane per trip: ``sid_tpu/ops/nmsimplex.py:287``); each lane
takes the points and the decisions it would take alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Generator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class MinimizeResult:
    x: np.ndarray
    fval: float
    converged: bool
    iterations: int


# a generator that yields the points to evaluate and is sent their values
_Steps = Generator[np.ndarray, float, None]


class _State:
    __slots__ = ("x1", "y1", "center", "S2", "P", "N")

    def __init__(self, x0: np.ndarray):
        N = x0.shape[0]
        P = N + 1
        self.N, self.P = N, P
        self.x1 = np.zeros((P, N), np.float64)
        self.y1 = np.zeros(P, np.float64)
        self.center = np.zeros(N, np.float64)

    def start(self, x0: np.ndarray, step: np.ndarray) -> _Steps:
        """The initial simplex: x0 and one step along each axis."""
        self.x1[0] = x0
        self.y1[0] = yield x0
        for i in range(self.N):
            xt = x0.copy()
            xt[i] += step[i]
            self.x1[i + 1] = xt
            self.y1[i + 1] = yield xt
        self._compute_center()
        self._compute_size()

    def _compute_center(self):
        c = np.zeros(self.N, np.float64)
        for i in range(self.P):  # sequential accumulation, GSL order
            c += self.x1[i]
        self.center = c * (1.0 / self.P)

    def _compute_size(self) -> float:
        ss = 0.0
        for i in range(self.P):
            d = self.x1[i] - self.center
            t = np.sqrt(np.dot(d, d))
            ss += t * t
        self.S2 = ss / self.P
        return np.sqrt(self.S2)

    def try_corner_move(self, coeff: float, corner: int) -> np.ndarray:
        # xc = alpha*center + beta*x_corner with the running center of ALL
        # corners; alpha = (1-coeff)P/(P-1), beta = (coeff*P - 1)/(P-1).
        P = self.P
        alpha = (1.0 - coeff) * P / (P - 1.0)
        beta = (coeff * P - 1.0) / (P - 1.0)
        return alpha * self.center + beta * self.x1[corner]

    def update_point(self, i: int, x: np.ndarray, val: float):
        P = self.P
        delta = x - self.x1[i]
        xmc = self.x1[i] - self.center
        # incremental RMS size update
        d = np.sqrt(np.dot(delta, delta))
        xmcd = np.dot(xmc, delta)
        self.S2 += (2.0 / P) * xmcd + ((P - 1.0) / P) * (d * d / P)
        # incremental center update: c += (x - x_old)/P
        self.center = self.center - (1.0 / P) * self.x1[i] + (1.0 / P) * x
        self.x1[i] = x
        self.y1[i] = val

    def contract_by_best(self, best: int) -> _Steps:
        for i in range(self.P):
            if i != best:
                self.x1[i] = 0.5 * (self.x1[i] + self.x1[best])
                self.y1[i] = yield self.x1[i]
        self._compute_center()
        self._compute_size()

    def size(self) -> float:
        if self.S2 > 0:
            return np.sqrt(self.S2)
        return self._compute_size()


def _iterate(state: _State) -> _Steps:
    y1 = state.y1
    n = state.P
    # highest, second-highest, lowest — GSL's exact initialization quirk:
    # dhi/dlo start at y[0], ds_hi at y[1], loop from i=1
    dhi = dlo = y1[0]
    hi = lo = 0
    ds_hi = y1[1]
    s_hi = 1
    for i in range(1, n):
        val = y1[i]
        if val < dlo:
            dlo = val
            lo = i
        elif val > dhi:
            ds_hi = dhi
            s_hi = hi
            dhi = val
            hi = i
        elif val > ds_hi:
            ds_hi = val
            s_hi = i

    xc = state.try_corner_move(-1.0, hi)
    val = yield xc

    if np.isfinite(val) and val < y1[lo]:
        # reflected point is a new best: try expansion
        xc2 = state.try_corner_move(-2.0, hi)
        val2 = yield xc2
        if np.isfinite(val2) and val2 < y1[lo]:
            state.update_point(hi, xc2, val2)
        else:
            state.update_point(hi, xc, val)
    elif (not np.isfinite(val)) or val > y1[s_hi]:
        # reflection doesn't improve enough
        if np.isfinite(val) and val <= y1[hi]:
            state.update_point(hi, xc, val)
        xc2 = state.try_corner_move(0.5, hi)
        val2 = yield xc2
        if np.isfinite(val2) and val2 <= state.y1[hi]:
            state.update_point(hi, xc2, val2)
        else:
            yield from state.contract_by_best(lo)
    else:
        state.update_point(hi, xc, val)


def _minimize(x0, step, tol: float, max_iterations: int) -> Generator[np.ndarray, float, MinimizeResult]:
    """The whole minimization as a generator: yields each point to
    evaluate, is sent its value, returns the result."""
    x0 = np.asarray(x0, np.float64)
    step = np.asarray(step, np.float64)
    state = _State(x0)
    yield from state.start(x0, step)

    i = 0
    converged = False
    while i < max_iterations:
        i += 1
        yield from _iterate(state)
        size = state.size()
        if size < tol:
            converged = True
            break

    lo = int(np.argmin(state.y1))
    return MinimizeResult(
        x=state.x1[lo].copy(),
        fval=float(state.y1[lo]),
        converged=converged,
        iterations=i,
    )


def minimize_nmsimplex2(
    f: Callable[[np.ndarray], float],
    x0: Sequence[float],
    step: Sequence[float],
    tol: float = 1e-5,
    max_iterations: int = 1000,
    log: Optional[Callable[[str], None]] = None,
) -> MinimizeResult:
    """Minimize f from x0 with the nmsimplex2 rule (optimization.hpp:51-82).

    ``log`` receives the reference's convergence diagnostics verbatim
    (optimization.hpp:69-77).
    """
    steps = _minimize(x0, step, tol, max_iterations)
    try:
        x = next(steps)
        while True:
            x = steps.send(f(x))
    except StopIteration as done:
        res = done.value
    if log:
        if res.converged:
            log(f"# GSL function minimization converged in {res.iterations} iterations.")
        else:
            log(f"# Error: GSL function minimization did not converge in {res.iterations} iterations!")
    return res


def minimize_nmsimplex2_lanes(
    f_lanes: Callable[[List[int], List[np.ndarray]], Sequence[float]],
    x0s: Sequence[Sequence[float]],
    steps: Sequence[Sequence[float]],
    tol: float = 1e-5,
    max_iterations: int = 1000,
) -> List[MinimizeResult]:
    """Minimize S objectives in lockstep, one lane each, with the nmsimplex2
    rule; lane k starts at x0s[k] with steps[k].

    Each round collects the one pending point of every lane still running
    and calls ``f_lanes(lanes, points)`` once: ``lanes`` the running lanes'
    indices in increasing order, ``points`` their points; it returns their
    values in that order. A lane stops at size < tol or at max_iterations
    on its own, and its result is bitwise what ``minimize_nmsimplex2``
    gives for its objective alone. No diagnostic line is written (sid_tpu's
    population fits write none).
    """
    if len(x0s) != len(steps):
        raise ValueError(f"{len(x0s)} starting points but {len(steps)} steps")
    runs = [_minimize(x0, st, tol, max_iterations) for x0, st in zip(x0s, steps)]
    results: List[Optional[MinimizeResult]] = [None] * len(runs)
    pending = {k: next(run) for k, run in enumerate(runs)}
    while pending:
        lanes = sorted(pending)
        values = f_lanes(lanes, [pending[k] for k in lanes])
        if len(values) != len(lanes):
            raise ValueError(f"f_lanes returned {len(values)} values for {len(lanes)} lanes")
        for k, val in zip(lanes, values):
            try:
                pending[k] = runs[k].send(val)
            except StopIteration as done:
                results[k] = done.value
                del pending[k]
    return results
