"""The exact Lynch fit: nmsimplex2 over the long-double objective.

estimateProfileGenotypeLikelihoods (lynch.cpp:17-35) in the reference's
precision: start (1e-3, 1e-3), step 1e-4 (lynch.cpp:8-10), the objective
and the per-profile likelihoods at the fitted epsilon from libsidtpu's
long-double kernels. The fit's trajectory and result are bitwise sid_tpu's
``exact.lynch_ld.estimate_profile_genotype_likelihoods_ld`` with its native
library; the port requires that library and has no numpy fallback.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from sid_tpu_torch.exact.nmsimplex import minimize_nmsimplex2
from sid_tpu_torch.io import native
from sid_tpu_torch.native import bridge

DEFAULT_START = (1e-3, 1e-3)
DEFAULT_STEP = (1e-4, 1e-4)


def estimate_profile_genotype_likelihoods_ld(
    profiles: np.ndarray,
    mult: np.ndarray,
    nt: np.ndarray,
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """The Lynch fit on (filtered) profiles: (pi, epsilon, L_hom, L_het),
    the likelihoods as numpy longdouble. ``log`` gets the minimizer's
    convergence line (optimization.hpp:69-77)."""
    ld = bridge.NativeLynchLD(native.load(), profiles, mult, nt)
    res = minimize_nmsimplex2(ld.objective, DEFAULT_START, DEFAULT_STEP, log=log)
    pi, eps = float(res.x[0]), float(res.x[1])
    l_hom, l_het = ld.marginals(eps)
    return pi, eps, l_hom, l_het
