"""The work of ``csrc/lynch.cu`` ``lynch_fit_lanes_kernel`` (B3): sid's
Nelder-Mead fit of (pi, epsilon) (lynch.cpp:17-35, nmsimplex2) over the
compound objective of U unique profiles (lynch.cpp:37-61), one launch for
each call of ``models/lynch.py::run_fit``, which runs every evaluation of
the fit's lanes on the card.

The evaluations a fit makes are known only once it has run, so ``record``
keeps the fit's workspace (``LynchFitWorkspace``) and ``work`` reads its
lanes' rows and the evaluations each lane ran (``last.evaluations``).
An evaluation reads each row's record once (three f64 planes: the log
multinomial coefficient, the multiplicity and the packed counts, 24
bytes). Its f64 operations a row: the four hom terms, c_i log(1 - e) +
(cov - c_i) log(e / 3) + log nt_i, two products and two sums each, 16;
the six het terms, n log((1 - 2 e / 3) / 2) + (cov - n) log(e / 3) +
log(nt_i nt_j), 24; the log-sum-exp of the four, three maxima, four
differences, four exp, three sums, a log and the shift added back, 16,
and of the six, 24; the marginals, m + the hom sum and m + the het sum -
log(1 - sum nt^2), 3; the mixture, log(1 - pi) + L_hom and log pi +
L_het, then their log-add-exp (a maximum, a difference, its magnitude,
exp, log1p, a sum), 8; the term, log_mix times the multiplicity and its
add into the sum, 2. The simplex's step is a few scalar operations an
evaluation, left out. The marginals at the fitted error rate are not this
kernel's work: they run in ``lynch_marginals_kernel``, a launch of their
own.
"""

import numpy as np

KERNEL = "lynch_fit_lanes_kernel"
WRAPS = "sid_tpu_torch.models.lynch:run_fit"
BYTES_PER_ROW = 3 * 8
FLOPS_PER_ROW = 16 + 24 + 16 + 24 + 3 + 8 + 2


def record(fit, *args, **kwargs):
    """The fit's workspace: its lanes' rows now, its evaluations once it
    has run."""
    return fit


def work(records):
    """(bytes, f64 operations) of the launches over the fits ``records``:
    each lane's rows times the evaluations it ran."""
    row_evaluations = 0
    for fit in records:
        if fit.last is not None:
            rows = np.diff(np.asarray(fit.offsets, np.int64))
            row_evaluations += int((rows * np.asarray(fit.last.evaluations, np.int64)).sum())
    return BYTES_PER_ROW * row_evaluations, FLOPS_PER_ROW * row_evaluations
