"""LRT p-values on the host, through glibc libm.

``Q_chisq(x, df=1) = erfc(sqrt(x/2))`` (gsl_cdf_chisq_Q at stats.cpp:33)
runs in libsidtpu with the libm erfc the long-double oracle uses, so CSV
parity never depends on a device erfc. Benjamini-Hochberg (stats.cpp:68-80)
is the host path of sid_tpu's ``ops/stats.py``.
"""

from __future__ import annotations

import numpy as np

from sid_tpu_torch.io import native
from sid_tpu_torch.native import bridge


def lrt_pvalue_from_logs_np(log_l0, log_l1) -> np.ndarray:
    """likelihoodRatioTest (stats.cpp:29-37) on log-likelihoods:
    chisq = 2 max(0, ln l1 - ln l0), p = erfc(sqrt(chisq/2)); a log_l0 of
    -inf (l0 == 0) gives 0."""
    return bridge.lrt_pvalues_libm(native.load(), log_l0, log_l1)


def adjust_benjamini_hochberg_np(p_values) -> np.ndarray:
    """Benjamini-Hochberg, reference semantics (stats.cpp:68-80): sort
    descending; adjusted[sorted[i]] = running min of p*m/(m-i), the i = 0
    entry the raw p; values > 1 clamp to 1. The running min propagates NaN
    (sid_tpu/ops/stats.py:99, element for element)."""
    p_values = np.asarray(p_values, np.float64)
    m = p_values.shape[0]
    if m == 0:
        return p_values
    order = np.argsort(-p_values, kind="stable")
    sorted_p = p_values[order]
    i = np.arange(m, dtype=np.float64)
    scaled = sorted_p * np.float64(m) / (np.float64(m) - i)
    scaled[0] = sorted_p[0]
    adj = np.minimum.accumulate(scaled)
    out = np.empty_like(p_values)
    out[order] = adj
    return np.where(out > 1.0, 1.0, out)
