"""LRT p-values on the host, through glibc libm.

``Q_chisq(x, df=1) = erfc(sqrt(x/2))`` (gsl_cdf_chisq_Q at stats.cpp:33)
runs in libsidtpu with the libm erfc the long-double oracle uses, so CSV
parity never depends on a device erfc. Benjamini-Hochberg comes with the
likelihood_ratio slice.
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
