"""A plain Nelder-Mead minimiser with the rules of GSL's nmsimplex2, the
minimiser sid instantiates (optimization.hpp:46-82: tolerance 1e-5 on the
simplex size, at most 1000 iterations).

Each iteration ranks the corners as GSL does (the highest, second highest
and lowest values, the scan seeded with corners 0 and 1), reflects the
highest corner through the centre of all corners, expands a reflection that
is a new lowest, contracts along one dimension a reflection that is no
better than the second highest, and otherwise shrinks the simplex towards
its lowest corner. The size is the RMS distance of the corners from their
centre. The centre and the size are worked out anew each time here (GSL
updates them incrementally), so points agree with GSL's to rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np


class Result(NamedTuple):
    x: np.ndarray
    value: float
    iterations: int
    converged: bool


def minimize(f: Callable[[np.ndarray], float], x0: Sequence[float], step: Sequence[float],
             tol: float = 1e-5, max_iterations: int = 1000) -> Result:
    x0 = np.asarray(x0, np.float64)
    n = x0.shape[0]
    p = n + 1
    x = np.array([x0] + [x0 + np.eye(n)[i] * step[i] for i in range(n)])
    y = np.array([f(v) for v in x])

    def corner_move(coeff: float, corner: int) -> np.ndarray:
        center = x.mean(0)
        return (1.0 - coeff) * p / (p - 1.0) * center + (coeff * p - 1.0) / (p - 1.0) * x[corner]

    iterations, converged = 0, False
    while iterations < max_iterations:
        iterations += 1
        hi = lo = 0
        s_hi = 1
        for i in range(1, p):
            if y[i] < y[lo]:
                lo = i
            elif y[i] > y[hi]:
                s_hi, hi = hi, i
            elif y[i] > y[s_hi]:
                s_hi = i
        xr = corner_move(-1.0, hi)
        vr = f(xr)
        if np.isfinite(vr) and vr < y[lo]:
            xe = corner_move(-2.0, hi)
            ve = f(xe)
            x[hi], y[hi] = (xe, ve) if np.isfinite(ve) and ve < y[lo] else (xr, vr)
        elif not np.isfinite(vr) or vr > y[s_hi]:
            if np.isfinite(vr) and vr <= y[hi]:
                x[hi], y[hi] = xr, vr
            xc = corner_move(0.5, hi)
            vc = f(xc)
            if np.isfinite(vc) and vc <= y[hi]:
                x[hi], y[hi] = xc, vc
            else:
                for i in range(p):
                    if i != lo:
                        x[i] = 0.5 * (x[i] + x[lo])
                        y[i] = f(x[i])
        else:
            x[hi], y[hi] = xr, vr
        size = np.sqrt(((x - x.mean(0)) ** 2).sum(1).mean())
        if size < tol:
            converged = True
            break
    lo = int(np.argmin(y))
    return Result(x[lo].copy(), float(y[lo]), iterations, converged)
