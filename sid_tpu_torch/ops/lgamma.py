"""Integer log-gamma lookup table.

The reference memoizes ``gsl_sf_lngamma`` at non-negative integer arguments
(lynch.hpp:11-31), including the quirk that ``lngamma(0)`` is defined as 0.
Here it is a precomputed f64 table (scipy ``gammaln``, the same values as
``sid_tpu.ops.lgamma``) gathered by integer index, covering every argument
the kernels can request (up to max coverage + 1), kept per size and device.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch
from scipy.special import gammaln

_tables: Dict[Tuple[int, str], torch.Tensor] = {}
_tables_lock = threading.Lock()


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
    for the same data. Built once per (size, device) and kept, so callers
    must not write to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (table_size(max_cov), str(device))
    with _tables_lock:
        tab = _tables.get(key)
        if tab is None:
            tab = _tables[key] = torch.from_numpy(lgamma_int_table(key[0])).to(device)
        return tab
