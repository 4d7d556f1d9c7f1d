"""Host-exact statistics: libm LRT on long-double likelihoods and the
reference-loop Benjamini-Hochberg (stats.cpp:29-80), as sid_tpu's
``exact/stats_ld.py`` computes them (math.erfc is glibc's erfc)."""

from __future__ import annotations

import math

import numpy as np

LD = np.longdouble


def lrt_pvalue_ld(l_h0, l_h1) -> np.ndarray:
    """likelihoodRatioTest on linear long-double likelihoods (stats.cpp:29-37):
    chisq = -2 (ln l0 - ln max(l0, l1)), p = erfc(sqrt(chisq/2)); l0 == 0
    gives 0 (gsl_cdf_chisq_Q(DBL_MAX, 1) underflows)."""
    l_h0 = np.asarray(l_h0, LD)
    l_h1 = np.asarray(l_h1, LD)
    out = np.empty(l_h0.shape, np.float64)
    flat0, flat1, flat_out = l_h0.ravel(), l_h1.ravel(), out.ravel()
    for k in range(flat0.size):
        a, b = flat0[k], flat1[k]
        if a != 0:
            chisq = float(-2 * (np.log(a) - np.log(max(a, b))))
            flat_out[k] = math.erfc(math.sqrt(chisq * 0.5))
        else:
            flat_out[k] = 0.0
    return out


def adjust_benjamini_hochberg_np(p_values) -> np.ndarray:
    """adjustBenjaminiHochberg (stats.cpp:68-80), the literal loop: Python's
    min keeps the running value over a NaN p, unlike the vectorized
    ``ops.stats`` version."""
    p = np.asarray(p_values, np.float64)
    m = p.size
    if m == 0:
        return p.copy()
    order = np.argsort(-p, kind="stable")
    adj = np.empty_like(p)
    adj[order[0]] = p[order[0]]
    for i in range(1, m):
        adj[order[i]] = min(adj[order[i - 1]], p[order[i]] * float(m) / float(m - i))
    adj[adj > 1] = 1.0
    return adj
