"""Integer log-gamma lookup table.

The reference memoizes ``gsl_sf_lngamma`` at non-negative integer arguments
(lynch.hpp:11-31), including the quirk that ``lngamma(0)`` is defined as 0.
Here it is a precomputed f64 table (scipy ``gammaln``, the same values as
``sid_tpu.ops.lgamma``) gathered by integer index, covering every argument
the kernels can request (up to max coverage + 1).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln


def lgamma_int_table(max_arg: int) -> np.ndarray:
    """Table ``t`` with ``t[k] = lngamma(k)`` for k in [0, max_arg], t[0] = 0
    (the reference's ``log_gamma(0) == 0``, lynch.hpp:20-21)."""
    ks = np.arange(max_arg + 1, dtype=np.float64)
    t = gammaln(ks)
    t[0] = 0.0
    return t


def table_size(max_arg: int, minimum: int = 1024) -> int:
    """Power-of-two length, floored at ``minimum``, covering max_arg + 2."""
    need = max_arg + 2
    b = minimum
    while b < need:
        b *= 2
    return b


def lgamma_table(max_cov: int, device) -> torch.Tensor:
    """The f64 table for profiles of coverage up to ``max_cov``, on
    ``device``: ``lgamma_int_table(table_size(max_cov))``, sid_tpu's table
    for the same data."""
    tab = lgamma_int_table(table_size(max_cov))
    return torch.from_numpy(tab).to(device)
