"""The Lynch (2008) genome-wide model fit: (pi, epsilon) and the per-profile
marginal likelihoods at the fitted epsilon.

estimateProfileGenotypeLikelihoods (lynch.cpp:17-35) runs as one of two fits:

- the exact fit (``exact/lynch_ld.py``): the long-double objective on the
  host, the reference's arithmetic;
- the device fit (``fit_lynch``): the same host nmsimplex2 loop over the
  compound objective on the options' device (the CUDA kernel B2 of
  ``ops/lynch_objective.py`` on a card), then the marginals at the fitted
  epsilon (kernel B4). The profiles, their multiplicities and the lgamma
  table are uploaded once; each evaluation sends the theta scalars and
  fetches one (sum, flagged count) pair.

The reference multiplies linear long doubles, so at deep coverage a row's
factors can leave the 80-bit range, where log space does not (fault C2,
ROADMAP.md): mc overflows to inf and the row's NaN term is skipped, or the
dominant term's powers underflow to 0. The kernels' range screen flags such
rows; the device fit adds their long-double objective terms and takes their
long-double marginals from libsidtpu, so both fits follow the reference.

``resolve_fit_backend`` picks between them: "auto" fits on the host up to
EXACT_FIT_MAX_U unique profiles, where it is cheap and byte-exact by
construction, and on the device above.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sid_tpu_torch.config import Options
from sid_tpu_torch.exact.lynch_ld import (
    DEFAULT_START,
    DEFAULT_STEP,
    estimate_profile_genotype_likelihoods_ld,
)
from sid_tpu_torch.exact.nmsimplex import MinimizeResult, minimize_nmsimplex2
from sid_tpu_torch.io import native
from sid_tpu_torch.native import bridge
from sid_tpu_torch.ops import likelihoods, lynch_objective
from sid_tpu_torch.ops.lgamma import lgamma_table
from sid_tpu_torch.ops.profiles import coverage_of, filter_min_coverage, nucleotide_distribution
from sid_tpu_torch.utils import profiling
from sid_tpu_torch.utils.errors import NotPortedError

# "auto" fits on the host up to this many unique profiles (sid_tpu's default)
EXACT_FIT_MAX_U = 500_000


def resolve_fit_backend(options: Options, u: int) -> str:
    """The fit backend of a run: "exact" or "device". Explicit choices are
    kept; "auto" is the device for a mesh or above EXACT_FIT_MAX_U unique
    profiles, the exact host fit otherwise."""
    if options.fit_backend != "auto":
        return options.fit_backend
    if options.mesh_devices is not None or u > EXACT_FIT_MAX_U:
        return "device"
    return "exact"


class DeviceObjective:
    """The compound objective (lynch.cpp:37-61) of fixed profiles on a torch
    device, as a function of theta = (pi, epsilon) for the host simplex.

    The rows are bound to the device once (``LynchWorkspace``: uploads, the
    row record, the grids). Outside the box [0,1]^2 it is DBL_MAX without a
    launch. Inside, one launch of B2 sums the terms of the rows the range
    screen clears and one fetch brings back the sum and the flagged count;
    when it flags rows, their terms come from the long-double objective over
    those rows; the total is clamped to +-DBL_MAX as sid_tpu clamps it.
    """

    def __init__(self, profiles: np.ndarray, mult: np.ndarray, nt: np.ndarray, device):
        self.profiles = np.ascontiguousarray(profiles, np.int32)
        self.mult = np.ascontiguousarray(mult, np.int64)
        self.nt = np.asarray(nt, np.float64)
        u = self.profiles.shape[0]
        max_cov = int(coverage_of(self.profiles).max()) if u else 0
        self.prof_dev = torch.from_numpy(self.profiles).to(device)
        self.mult_dev = torch.from_numpy(self.mult).to(device)
        self.tab = lgamma_table(max_cov, device)
        self.work = lynch_objective.LynchWorkspace(self.prof_dev, self.mult_dev, self.tab)
        self.flagged = 0  # most rows the screen flagged in one evaluation

    def __call__(self, theta) -> float:
        pi, eps = float(theta[0]), float(theta[1])
        if not (0.0 <= pi <= 1.0 and 0.0 <= eps <= 1.0):
            return likelihoods.DBL_MAX
        total, n_flagged = self.work.nll(likelihoods.lynch_scalars(pi, eps, self.nt))
        if n_flagged:
            rows = np.nonzero(self.work.flags.cpu().numpy())[0]
            self.flagged = max(self.flagged, rows.size)
            ld = bridge.NativeLynchLD(native.load(), self.profiles, self.mult, self.nt, rows)
            total = total - ld.objective((pi, eps))
        if total > likelihoods.DBL_MAX:
            total = likelihoods.DBL_MAX
        elif total < -likelihoods.DBL_MAX:
            total = -likelihoods.DBL_MAX
        return -total

    def marginals(self, eps: float) -> Tuple[np.ndarray, np.ndarray]:
        """(log L_hom, log L_het) f64 at epsilon (B4); the rows the screen
        flags get the log of their long-double marginals."""
        log_l_hom, log_l_het, flags = self.work.marginals_host(likelihoods.lynch_scalars(0.0, eps, self.nt))
        rows = np.nonzero(flags)[0]
        if rows.size:
            ld = bridge.NativeLynchLD(native.load(), self.profiles, self.mult, self.nt, rows)
            l_hom, l_het = ld.marginals(eps)
            with np.errstate(divide="ignore", invalid="ignore"):
                log_l_hom[rows] = np.log(l_hom).astype(np.float64)
                log_l_het[rows] = np.log(l_het).astype(np.float64)
        return log_l_hom, log_l_het


class LanesObjective:
    """``DeviceObjective`` for a cohort: the compound objective of each of
    S histograms (lanes) on a torch device, evaluated for any set of lanes,
    each at its own theta, in one call (``f_lanes`` of
    ``exact.nmsimplex.minimize_nmsimplex2_lanes``).

    The lanes' rows are bound to the device once (``LynchLanesWorkspace``).
    A lane's theta is its point (pi, epsilon), or (pi, ``eps``) when the
    lanes fit pi alone at a fixed error rate. A lane whose theta is outside
    the box [0,1]^2 gets DBL_MAX without a launch; one launch evaluates the
    others. Where the range screen flags rows of a lane, their terms come
    from the long-double objective over that lane's flagged rows; each
    lane's total is clamped to +-DBL_MAX. So each lane's value is bitwise
    ``DeviceObjective``'s for its histogram alone.
    """

    def __init__(self, histograms: Sequence[Tuple[np.ndarray, np.ndarray]], nts: np.ndarray, device,
                 eps: Optional[float] = None):
        self.profiles = np.ascontiguousarray(
            np.concatenate([np.asarray(p, np.int32).reshape(-1, 4) for p, _ in histograms]), np.int32)
        self.mult = np.ascontiguousarray(np.concatenate([np.asarray(m, np.int64) for _, m in histograms]),
                                         np.int64)
        self.offsets = np.concatenate([[0], np.cumsum([len(m) for _, m in histograms])]).astype(np.int64)
        self.nts = np.asarray(nts, np.float64).reshape(len(histograms), 4)
        self.eps = eps
        max_cov = int(coverage_of(self.profiles).max()) if self.profiles.shape[0] else 0
        self.tab = lgamma_table(max_cov, device)
        self.work = lynch_objective.LynchLanesWorkspace(
            torch.from_numpy(self.profiles).to(device), torch.from_numpy(self.mult).to(device),
            torch.from_numpy(self.offsets).to(device), self.tab,
        )
        self._scalars = np.zeros((len(histograms), 16), np.float64)
        self.rounds = 0  # objective launches (one a round with a lane in the box)
        self.evaluations = 0  # lane evaluations in the box

    def _rows(self, lane: int) -> slice:
        return slice(int(self.offsets[lane]), int(self.offsets[lane + 1]))

    def _ld(self, lane: int, rows: np.ndarray) -> bridge.NativeLynchLD:
        r = self._rows(lane)
        return bridge.NativeLynchLD(native.load(), self.profiles[r], self.mult[r], self.nts[lane], rows)

    def __call__(self, lanes: List[int], points: List[np.ndarray]) -> List[float]:
        thetas = [(float(x[0]), float(x[1]) if self.eps is None else self.eps) for x in points]
        values = [likelihoods.DBL_MAX] * len(lanes)
        inside = [k for k, (pi, eps) in enumerate(thetas) if 0.0 <= pi <= 1.0 and 0.0 <= eps <= 1.0]
        if not inside:
            return values
        for k in inside:
            pi, eps = thetas[k]
            self._scalars[lanes[k]] = likelihoods.lynch_scalars(pi, eps, self.nts[lanes[k]])
        out = self.work.nll_lanes(self._scalars, [lanes[k] for k in inside])
        self.rounds += 1
        self.evaluations += len(inside)
        for k, (total, n_flagged) in zip(inside, out.tolist()):
            if n_flagged:
                rows = np.nonzero(self.work.flags[self._rows(lanes[k])].cpu().numpy())[0]
                total = total - self._ld(lanes[k], rows).objective(thetas[k])
            if total > likelihoods.DBL_MAX:
                total = likelihoods.DBL_MAX
            elif total < -likelihoods.DBL_MAX:
                total = -likelihoods.DBL_MAX
            values[k] = -total
        return values

    def marginals(self, eps: Sequence[float]) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per lane (log L_hom, log L_het) f64 at that lane's epsilon, all
        lanes in one launch of the lanes' marginals; the rows the screen
        flags get the log of their long-double marginals."""
        scalars = np.stack([likelihoods.lynch_scalars(0.0, e, nt) for e, nt in zip(eps, self.nts)])
        log_l_hom, log_l_het, flags = self.work.marginals_lanes_host(scalars)
        out = []
        for lane, e in enumerate(eps):
            r = self._rows(lane)
            lhom, lhet = log_l_hom[r], log_l_het[r]
            rows = np.nonzero(flags[r])[0]
            if rows.size:
                l_hom, l_het = self._ld(lane, rows).marginals(float(e))
                with np.errstate(divide="ignore", invalid="ignore"):
                    lhom[rows] = np.log(l_hom).astype(np.float64)
                    lhet[rows] = np.log(l_het).astype(np.float64)
            out.append((lhom, lhet))
        return out


def fit_lynch(
    profiles: np.ndarray,
    mult: np.ndarray,
    nt: np.ndarray,
    device,
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[MinimizeResult, np.ndarray, np.ndarray]:
    """The device fit: nmsimplex2 from (1e-3, 1e-3), step 1e-4, over B2,
    then B4 at the fitted epsilon. Returns (result, log_l_hom, log_l_het)."""
    objective = DeviceObjective(profiles, mult, nt, device)
    res = minimize_nmsimplex2(objective, DEFAULT_START, DEFAULT_STEP, log=log)
    log_l_hom, log_l_het = objective.marginals(float(res.x[1]))
    return res, log_l_hom, log_l_het


def fit_on_filtered_profiles(
    profiles: np.ndarray,
    mult: np.ndarray,
    device,
    diag: Optional[Callable[[str], None]] = None,
) -> Tuple[float, float, np.ndarray, np.ndarray, np.ndarray]:
    """nt distribution + device fit on (already filtered) profiles; returns
    (pi, eps, log_l_hom, log_l_het, nt) and logs the minimizer's line."""
    nt = nucleotide_distribution(profiles, mult)
    with profiling.device_stage("fit_lynch", device):
        res, log_l_hom, log_l_het = fit_lynch(profiles, mult, nt, device, log=diag)
    return float(res.x[0]), float(res.x[1]), log_l_hom, log_l_het, nt


def fit_profiles(
    profiles: np.ndarray,
    mult: np.ndarray,
    options: Options,
    diag: Optional[Callable[[str], None]] = None,
) -> Tuple[float, float, np.ndarray, np.ndarray, np.ndarray]:
    """The fit on already-filtered profiles through the run's backend:
    (pi, eps, log_l_hom, log_l_het, nt). The exact fit's long-double
    likelihoods are returned as their f64 logs."""
    backend = resolve_fit_backend(options, profiles.shape[0])
    if backend == "exact":
        nt = nucleotide_distribution(profiles, mult)
        with profiling.maybe_stage("host:fit_lynch_ld"):
            pi, eps, l_hom, l_het = estimate_profile_genotype_likelihoods_ld(
                profiles, mult, nt, log=diag
            )
        with np.errstate(divide="ignore"):
            log_l_hom = np.log(l_hom).astype(np.float64)
            log_l_het = np.log(l_het).astype(np.float64)
        return pi, eps, log_l_hom, log_l_het, nt
    if options.mesh_devices is not None:
        raise NotPortedError("--devices")
    return fit_on_filtered_profiles(profiles, mult, options.device(), diag)


def estimate_prior_heterozygosity(
    profiles: np.ndarray,
    mult: np.ndarray,
    options: Options,
    diag: Optional[Callable[[str], None]] = None,
) -> float:
    """The -R prior (call.cpp:223-234): fit the cov>=4 profiles, return the
    heterozygosity."""
    fprof, fmult, _ = filter_min_coverage(profiles, mult, 4)
    pi, _, _, _, _ = fit_profiles(fprof, fmult, options, diag)
    return pi
