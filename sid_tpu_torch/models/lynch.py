"""The Lynch (2008) genome-wide model fit: (pi, epsilon) and the per-profile
marginal likelihoods at the fitted epsilon.

estimateProfileGenotypeLikelihoods (lynch.cpp:17-35) runs as one of two fits:

- the exact fit (``exact/lynch_ld.py``): the long-double objective on the
  host, the reference's arithmetic;
- the device fit (``fit_lynch``): nmsimplex2 over the compound objective
  on the options' device, then the marginals at the fitted epsilon
  (kernel B4). The profiles, their multiplicities and the lgamma table are
  uploaded once. On a card the whole loop runs there, one launch of the
  fit's kernel (``ops/lynch_objective.py`` ``LynchFitWorkspace``: its
  blocks run every evaluation, and the block that completes one takes the
  simplex's step); on the CPU, its plain version, the host loop over B2's.

The reference multiplies linear long doubles, so at deep coverage a row's
factors can leave the 80-bit range, where log space does not (fault C2,
ROADMAP.md): mc overflows to inf and the row's NaN term is skipped, or the
dominant term's powers underflow to 0. The kernels' range screen flags such
rows; the device fit adds their long-double objective terms and takes their
long-double marginals from libsidtpu, so both fits follow the reference.
A fit on the card hands such a fit to the host at the first evaluation
that flags rows: the host replays the card's history into its own loop
(``exact.nmsimplex.replay``, bitwise, nothing evaluated again), adds the
flagged rows' long-double terms to that evaluation, and goes on evaluating
B2 a point as the CPU and a mesh do.

``resolve_fit_backend`` picks between them: "auto" fits on the host up to
EXACT_FIT_MAX_U unique profiles, where it is cheap and byte-exact by
construction, and on the device above; with ``--devices`` it is always the
device fit, over the mesh (``parallel.fit.fit_lynch_global``).
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
from sid_tpu_torch.exact import nmsimplex
from sid_tpu_torch.exact.nmsimplex import MinimizeResult, minimize_nmsimplex2
from sid_tpu_torch.io import native
from sid_tpu_torch.native import bridge
from sid_tpu_torch.ops import likelihoods, lynch_objective
from sid_tpu_torch.ops.lgamma import lgamma_table
from sid_tpu_torch.ops.profiles import coverage_of, filter_min_coverage, nucleotide_distribution
from sid_tpu_torch.utils import profiling

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


def run_fit(fit: lynch_objective.LynchFitWorkspace, start, step, value):
    """Run ``fit``'s loop on the device: (its ``FitLanes``, each lane's
    result where its loop ended there, else None; and for the lanes it
    handed over, their loops replayed from their histories
    (``exact.nmsimplex.replay``) and sent the flagged evaluation's value
    ``value(lane, point, sum of the unflagged terms, flagged count)``: the
    loops still running and their pending points by lane, as
    ``exact.nmsimplex.finish_lanes`` takes them)."""
    out = fit.run()
    results: List[Optional[MinimizeResult]] = [
        out.result(k) if out.status[k] == lynch_objective.FIT_DONE else None for k in range(fit.lanes)]
    handed = [k for k, r in enumerate(results) if r is None]
    runs, pending = {}, {}
    for k, (points, values, flagged) in zip(handed, fit.history(handed)):
        steps, x = nmsimplex.replay(start, step, fit.tol, fit.max_iterations, values[:-1], points)
        try:
            pending[k] = steps.send(value(k, x, values[-1], flagged[-1]))
            runs[k] = steps
        except StopIteration as done:
            results[k] = done.value
    return out, results, runs, pending


class DeviceObjective:
    """The compound objective (lynch.cpp:37-61) of fixed profiles on a torch
    device, as a function of theta = (pi, epsilon) for the host simplex.

    The rows are bound to the device once (``LynchWorkspace``: uploads, the
    row record, the grids). Outside the box [0,1]^2 it is DBL_MAX without a
    launch. Inside, one launch of B2 sums the terms of the rows the range
    screen clears and one fetch brings back the sum and the flagged count;
    when it flags rows, their terms come from the long-double objective over
    those rows; the total is clamped to +-DBL_MAX as sid_tpu clamps it.
    Over a mesh the workspace is ``parallel.fit.ShardedLynchWorkspace``,
    given as ``work``: one launch of the sharded objective on each device
    that holds shards (one on one card), the fold in the fold device's
    last block, in place of B2's one launch, with the same values.
    """

    def __init__(self, profiles: np.ndarray, mult: np.ndarray, nt: np.ndarray, device=None, work=None):
        self.profiles = np.ascontiguousarray(profiles, np.int32)
        self.mult = np.ascontiguousarray(mult, np.int64)
        self.nt = np.asarray(nt, np.float64)
        if work is None:
            max_cov = int(coverage_of(self.profiles).max()) if self.profiles.shape[0] else 0
            work = lynch_objective.LynchWorkspace(
                torch.from_numpy(self.profiles).to(device), torch.from_numpy(self.mult).to(device),
                lgamma_table(max_cov, device))
        self.work = work  # nll, flags and marginals_host over these rows
        self.flagged = 0  # most rows the screen flagged in one evaluation
        self.fit: Optional[lynch_objective.FitLanes] = None  # the last loop on the device's

    def __call__(self, theta) -> float:
        pi, eps = float(theta[0]), float(theta[1])
        if not (0.0 <= pi <= 1.0 and 0.0 <= eps <= 1.0):
            return likelihoods.DBL_MAX
        total, n_flagged = self.work.nll(likelihoods.lynch_scalars(pi, eps, self.nt))
        return self.value(theta, total, n_flagged)

    def value(self, theta, total: float, n_flagged: float) -> float:
        """The objective at theta (in the box) from its evaluation's sum of
        the unflagged terms and flagged count, the flags in the workspace:
        the flagged rows' long-double terms added, the sum clamped and
        negated."""
        if n_flagged:
            rows = np.nonzero(self.work.flags.cpu().numpy())[0]
            self.flagged = max(self.flagged, rows.size)
            ld = bridge.NativeLynchLD(native.load(), self.profiles, self.mult, self.nt, rows)
            total = total - ld.objective((float(theta[0]), float(theta[1])))
        return -lynch_objective.clamp_total(total)

    def minimize(self, start, step) -> MinimizeResult:
        """nmsimplex2 over this objective from ``start`` with ``step``. Over
        one device's workspace the loop is ``LynchFitWorkspace``'s (one
        launch on a card; its plain version on the CPU); a fit it
        hands over goes on in the host's loop from the replayed history.
        Over a mesh, the host's loop."""
        if not isinstance(self.work, lynch_objective.LynchWorkspace):
            return minimize_nmsimplex2(self, start, step)
        fit = lynch_objective.LynchFitWorkspace(self.work, [list(start) + list(step) + [0.0]], self.nt[None])
        self.fit, results, runs, pending = run_fit(fit, start, step, lambda k, x, total, n: self.value(x, total, n))
        return nmsimplex.finish_lanes(lambda lanes, points: [self(x) for x in points], runs, pending, results)[0]

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
        self.fit: Optional[lynch_objective.FitLanes] = None  # the last loop on the device's

    def _rows(self, lane: int) -> slice:
        return slice(int(self.offsets[lane]), int(self.offsets[lane + 1]))

    def _ld(self, lane: int, rows: np.ndarray) -> bridge.NativeLynchLD:
        r = self._rows(lane)
        return bridge.NativeLynchLD(native.load(), self.profiles[r], self.mult[r], self.nts[lane], rows)

    def __call__(self, lanes: List[int], points: List[np.ndarray]) -> List[float]:
        return self.enqueue(lanes, points)()

    def _theta(self, x) -> Tuple[float, float]:
        return float(x[0]), float(x[1]) if self.eps is None else self.eps

    def enqueue(self, lanes: List[int], points: List[np.ndarray]):
        """One round of ``__call__`` in two halves: its launch enqueued, and
        a callable that waits for it and returns the lanes' values."""
        thetas = [self._theta(x) for x in points]
        values = [likelihoods.DBL_MAX] * len(lanes)
        inside = [k for k, (pi, eps) in enumerate(thetas) if 0.0 <= pi <= 1.0 and 0.0 <= eps <= 1.0]
        if not inside:
            return lambda: values
        for k in inside:
            pi, eps = thetas[k]
            self._scalars[lanes[k]] = likelihoods.lynch_scalars(pi, eps, self.nts[lanes[k]])
        running = [lanes[k] for k in inside]
        fetch = self.work.enqueue_nll_lanes(self._scalars, running)
        self.rounds += 1
        self.evaluations += len(inside)

        def finish() -> List[float]:
            for k, (total, n_flagged) in zip(inside, fetch().tolist()):
                values[k] = self.value(lanes[k], thetas[k], total, n_flagged)
            return values

        return finish

    def value(self, lane: int, theta, total: float, n_flagged: float) -> float:
        """Lane ``lane``'s objective at theta (in the box) from its
        evaluation's sum of the unflagged terms and flagged count, the
        lane's flags in the workspace: the flagged rows' long-double terms
        added, the sum clamped and negated."""
        if n_flagged:
            rows = np.nonzero(self.work.flags[self._rows(lane)].cpu().numpy())[0]
            total = total - self._ld(lane, rows).objective(theta)
        return -lynch_objective.clamp_total(total)

    def minimize(self, start, step) -> List[MinimizeResult]:
        """Every lane's nmsimplex2 fit from ``start`` with ``step`` (1-D
        fits of pi at ``eps`` when the objective holds one):
        ``LynchFitWorkspace``'s loop over the lanes (one launch on a
        card; its plain version on the CPU); the lanes it hands over go on
        in the host's lockstep over this objective from their replayed
        histories."""
        held = 0.0 if self.eps is None else self.eps
        fit = lynch_objective.LynchFitWorkspace(self.work, [list(start) + list(step) + [held]] * len(self.nts),
                                                self.nts)
        self.fit, results, runs, pending = run_fit(
            fit, start, step, lambda k, x, total, n: self.value(k, self._theta(x), total, n))
        return nmsimplex.finish_lanes(self, runs, pending, results)

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


class ShardedLanesObjective:
    """``LanesObjective`` over a mesh (``--devices`` in population mode,
    sid_tpu's sample-axis shard_map fits): the cohort's lanes cut into
    contiguous blocks of ceil(S / n), one a device of the mesh, each its own
    ``LanesObjective`` on its device (empty blocks bind nothing). A round
    enqueues every block's running lanes, then waits for each block in
    turn; a block whose lanes have all stopped launches nothing. Lanes are
    independent, so each lane's value is bitwise its value unsharded."""

    def __init__(self, histograms: Sequence[Tuple[np.ndarray, np.ndarray]], nts: np.ndarray, mesh,
                 eps: Optional[float] = None):
        from sid_tpu_torch.parallel.mesh import shard_bounds

        nts = np.asarray(nts, np.float64).reshape(len(histograms), 4)
        bounds = shard_bounds(len(histograms), len(mesh)).tolist()
        # (first lane, end lane, objective) of each block that holds lanes
        self.blocks = [(a, b, LanesObjective(histograms[a:b], nts[a:b], dev, eps))
                       for a, b, dev in zip(bounds[:-1], bounds[1:], mesh) if b > a]
        self.rounds = 0  # rounds in which some block launched

    @property
    def evaluations(self) -> int:
        return sum(obj.evaluations for _, _, obj in self.blocks)

    def __call__(self, lanes: List[int], points: List[np.ndarray]) -> List[float]:
        values: List[float] = [likelihoods.DBL_MAX] * len(lanes)
        pending = []
        launched = False
        for a, b, obj in self.blocks:
            ks = [k for k, lane in enumerate(lanes) if a <= lane < b]
            if ks:
                before = obj.rounds
                pending.append((ks, obj.enqueue([lanes[k] - a for k in ks], [points[k] for k in ks])))
                launched |= obj.rounds > before
        for ks, finish in pending:
            for k, v in zip(ks, finish()):
                values[k] = v
        self.rounds += launched
        return values

    def marginals(self, eps: Sequence[float]) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per lane (log L_hom, log L_het) at its epsilon: each block's
        lanes' marginals on its device, in lane order."""
        return [m for a, b, obj in self.blocks for m in obj.marginals(list(eps[a:b]))]


def fit_lynch(
    profiles: np.ndarray,
    mult: np.ndarray,
    nt: np.ndarray,
    device,
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[MinimizeResult, np.ndarray, np.ndarray]:
    """The device fit: nmsimplex2 from (1e-3, 1e-3), step 1e-4, over B2,
    then B4 at the fitted epsilon. Returns (result, log_l_hom, log_l_het)."""
    return fit_objective(DeviceObjective(profiles, mult, nt, device), log)


def fit_objective(objective: DeviceObjective, log: Optional[Callable[[str], None]] = None):
    """nmsimplex2 from (1e-3, 1e-3), step 1e-4, over ``objective``
    (``DeviceObjective.minimize``), then its marginals at the fitted
    epsilon: (result, log_l_hom, log_l_het)."""
    res = objective.minimize(DEFAULT_START, DEFAULT_STEP)
    nmsimplex.log_result(res, log)
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
    mesh = options.mesh()
    if mesh is not None:
        from sid_tpu_torch.parallel.fit import fit_lynch_global

        return fit_lynch_global(profiles, mult, mesh, diag)
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
