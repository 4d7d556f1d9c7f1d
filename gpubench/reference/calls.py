"""sid's calls worked out again in plain NumPy: dedup, the ``local``
classification, the Lynch fit, its marginals, the LRT and Benjamini-Hochberg.

The formulas are sid's (EvolBioInf/sid: call.cpp, lynch.hpp, lynch.cpp,
stats.cpp), taken in log space: sid multiplies linear long doubles, and a
likelihood below the smallest 80-bit subnormal is 0 there, so a log below
``LD_UNDERFLOW_LOG`` is taken as -inf. ``dtype`` is the precision of every
floating-point step (float64 as sid's doubles; float32 is the control).
Coverages beyond the long-double range (about 10^4 reads a site), where sid's
products overflow, are outside what this reference covers.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
from scipy.special import erfc, gammaln

from gpubench.reference.nmsimplex import minimize

LD_UNDERFLOW_LOG = -16445.0 * math.log(2.0)
PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


class Profiles(NamedTuple):
    """The unique (A, C, G, T) count rows in sid's order, their
    multiplicities, and each site's row."""

    rows: np.ndarray  # (U, 4) int64
    mult: np.ndarray  # (U,) int64
    inverse: np.ndarray  # (N,) int64
    first: np.ndarray  # (U,) each row's first site


def unique_profiles(counts: np.ndarray) -> Profiles:
    """sid's profile map (pileup.cpp:169-217): rows in lexicographic order."""
    c = np.asarray(counts, np.uint64)
    keys = (c[:, 0] << np.uint64(48)) | (c[:, 1] << np.uint64(32)) | (c[:, 2] << np.uint64(16)) | c[:, 3]
    uniq, first, inverse, mult = np.unique(keys, return_index=True, return_inverse=True, return_counts=True)
    rows = np.stack([(uniq >> np.uint64(s)) & np.uint64(0xFFFF) for s in (48, 32, 16, 0)], 1).astype(np.int64)
    return Profiles(rows, mult.astype(np.int64), inverse.reshape(-1).astype(np.int64), first.astype(np.int64))


def top_two(rows: np.ndarray):
    """(major, second): the two most-read bases; on a tie the higher base
    index wins (call.cpp:52-60 sorts {0,1,2,3} by count, stably)."""
    order = np.argsort(rows * 4 + np.arange(4), axis=1)
    return order[:, 3], order[:, 2]


@functools.lru_cache(maxsize=None)
def phred_terms(dtype=np.float64) -> np.ndarray:
    """(256, 4) log terms of a read by its decoded quality q, with error
    e = 10^(-q/10): [ln(1-e), ln(e), ln(1-2e/3), ln(2e/3)] (call.cpp:331-342),
    every step in ``dtype``."""
    q = np.arange(256, dtype=dtype)
    e = np.power(dtype(10), -q / dtype(10))
    with np.errstate(divide="ignore"):
        terms = np.stack([np.log(dtype(1) - e), np.log(e), np.log(dtype(1) - dtype(2) / dtype(3) * e),
                          np.log(dtype(2) / dtype(3) * e)], 1).astype(dtype)
    terms.flags.writeable = False  # one table for every caller
    return terms


def _xlogy(n, log_y):
    """n * log_y with sid's powl(y, 0) == 1."""
    return np.where(n == 0, 0, n * log_y)


def _log_multinomial(rows, dtype):
    cov = rows.sum(1)
    return (gammaln(cov + 1) - gammaln(rows + 1).sum(1)).astype(dtype)


def lrt_pvalue(log_l0, log_l1, dtype=np.float64):
    """likelihoodRatioTest (stats.cpp:29-37): chisq = -2 (ln l0 - ln max(l0, l1)),
    p = erfc(sqrt(chisq / 2)); l0 == 0 gives 0."""
    log_l0 = np.asarray(log_l0, dtype)
    log_l1 = np.asarray(log_l1, dtype)
    with np.errstate(invalid="ignore"):
        chisq = dtype(-2) * (log_l0 - np.maximum(log_l0, log_l1))
        p = erfc(np.sqrt(chisq * dtype(0.5))).astype(dtype)
    return np.where(log_l0 == -np.inf, dtype(0), p)


def benjamini_hochberg(p, dtype=np.float64):
    """adjustBenjaminiHochberg (stats.cpp:68-80): in descending order the
    running minimum of p m / (m - i), the first the raw p, capped at 1."""
    p = np.asarray(p, dtype)
    m = p.shape[0]
    if m == 0:
        return p
    order = np.argsort(-p, kind="stable")
    i = np.arange(m, dtype=dtype)
    scaled = p[order] * dtype(m) / (dtype(m) - i)
    scaled[0] = p[order][0]
    out = np.empty_like(p)
    out[order] = np.minimum.accumulate(scaled)
    return np.minimum(out, dtype(1))


class Classes(NamedTuple):
    """Per unique profile: the call and its two confidences."""

    is_het: np.ndarray
    major: np.ndarray
    second: np.ndarray
    hom_conf: np.ndarray
    het_conf: np.ndarray


def classify_local(rows, error_threshold=0.1, snp_prior=-1.0, alpha=0.05, dtype=np.float64) -> Classes:
    """callSiteMLError (call.cpp:213-289): plug-in error rates capped at -E,
    the fixed-allele likelihoods, two LRTs; het iff l2 > l1 and p2 < alpha."""
    rows = np.asarray(rows, np.int64)
    major, second = top_two(rows)
    idx = np.arange(rows.shape[0])
    cov = rows.sum(1)
    n1, n2 = rows[idx, major], rows[idx, second]
    covf, n1f, n2f = cov.astype(dtype), n1.astype(dtype), n2.astype(dtype)
    thr = dtype(error_threshold)
    with np.errstate(invalid="ignore", divide="ignore"):
        e1 = (covf - n1f) / covf
        e1 = np.where(e1 > thr, thr, e1)
        e2 = dtype(1.5) * (covf - n1f - n2f) / covf
        e2 = np.where(e2 > thr, thr, e2)
        mc = _log_multinomial(rows, dtype)
        l1 = mc + _xlogy(n1f, np.log1p(-e1)) + _xlogy(covf - n1f, np.log(e1 / dtype(3)))
        l2 = (mc + _xlogy(n1f + n2f, np.log((dtype(1) - dtype(2) / dtype(3) * e2) / dtype(2)))
              + _xlogy(covf - n1f - n2f, np.log(e2 / dtype(3))))
        if snp_prior > 0:
            l1 = l1 + np.log(dtype(1.0 - snp_prior))
            l2 = l2 + np.log(dtype(snp_prior))
    l1 = np.where(l1 < LD_UNDERFLOW_LOG, -np.inf, l1).astype(dtype)
    l2 = np.where(l2 < LD_UNDERFLOW_LOG, -np.inf, l2).astype(dtype)
    p1 = lrt_pvalue(l2, l1, dtype)
    p2 = lrt_pvalue(l1, l2, dtype)
    return Classes((l2 > l1) & (p2 < alpha), major, second, p1, p2)


def nucleotide_distribution(rows, mult):
    """Weighted base composition (pileup.cpp:198-217); 0.25 each when empty."""
    acc = (np.asarray(rows, np.uint64) * np.asarray(mult, np.uint64)[:, None]).sum(0, dtype=np.uint64)
    total = acc.sum(dtype=np.uint64)
    if total == 0:
        return np.full(4, 0.25)
    return acc.astype(np.float64) / np.float64(total)


def _logsumexp(terms, dtype):
    top = np.max(terms, axis=0)
    shift = np.where(np.isfinite(top), top, dtype(0))
    with np.errstate(divide="ignore"):
        return np.log(np.exp(terms - shift).sum(0)) + shift


class Lynch:
    """The Lynch model over fixed profiles (lynch.hpp:48-96, lynch.cpp:37-61)."""

    def __init__(self, rows, mult, dtype=np.float64):
        self.dtype = dtype
        self.rows = np.asarray(rows, np.int64)
        self.mult = np.asarray(mult, np.int64).astype(dtype)
        self.cov = self.rows.sum(1)
        self.mc = _log_multinomial(self.rows, dtype)
        self.nt = nucleotide_distribution(self.rows, mult).astype(dtype)
        self.evaluations = 0
        c = self.rows
        self.n_hom = [c[:, i] for i in range(4)]
        self.n_het = [c[:, i] + c[:, j] for i, j in PAIRS]

    def marginals(self, eps):
        """log L_hom = log mc + log sum_i nt_i (1-e)^n_i (e/3)^(cov-n_i) and
        log L_het = log mc + log sum_{i<j} nt_i nt_j ((1-2e/3)/2)^(n_i+n_j)
        (e/3)^(cov-n_i-n_j) - log(1 - sum nt_i^2)."""
        d, nt = self.dtype, self.nt
        e = d(eps)
        with np.errstate(divide="ignore", invalid="ignore"):
            log_match, log_err = np.log1p(-e), np.log(e / d(3))
            log_half = np.log((d(1) - d(2) / d(3) * e) / d(2))
            hom = np.stack([np.log(nt[i]) + _xlogy(n.astype(d), log_match) + _xlogy((self.cov - n).astype(d), log_err)
                            for i, n in enumerate(self.n_hom)])
            het = np.stack([np.log(nt[i] * nt[j]) + _xlogy(n.astype(d), log_half)
                            + _xlogy((self.cov - n).astype(d), log_err)
                            for (i, j), n in zip(PAIRS, self.n_het)])
            lhom = self.mc + _logsumexp(hom, d)
            lhet = self.mc + _logsumexp(het, d) - np.log1p(-(nt * nt).sum())
        return lhom.astype(d), lhet.astype(d)

    def objective(self, theta) -> float:
        """-sum mult log((1-pi) L_hom + pi L_het), rows with a zero mixture
        left out, clamped to +-DBL_MAX; DBL_MAX outside [0, 1]^2."""
        self.evaluations += 1
        pi, eps = float(theta[0]), float(theta[1])
        big = float(np.finfo(np.float64).max)
        if not (0.0 <= pi <= 1.0 and 0.0 <= eps <= 1.0):
            return big
        d = self.dtype
        lhom, lhet = self.marginals(eps)
        with np.errstate(divide="ignore", invalid="ignore"):
            mix = np.logaddexp(np.log1p(-d(pi)) + lhom, np.log(d(pi)) + lhet)
        terms = np.where(mix == -np.inf, d(0), mix * self.mult)
        return float(min(max(-float(terms.sum(dtype=d)), -big), big))


class Fit(NamedTuple):
    pi: float
    eps: float
    iterations: int
    converged: bool
    evaluations: int
    log_l_hom: np.ndarray
    log_l_het: np.ndarray


def fit_lynch(rows, mult, dtype=np.float64) -> Fit:
    """estimateProfileGenotypeLikelihoods (lynch.cpp:17-35): nmsimplex2 from
    (1e-3, 1e-3) with steps 1e-4, then the marginals at the fitted error."""
    model = Lynch(rows, mult, dtype)
    res = minimize(model.objective, (1e-3, 1e-3), (1e-4, 1e-4))
    pi, eps = float(res.x[0]), float(res.x[1])
    lhom, lhet = model.marginals(eps)
    return Fit(pi, eps, res.iterations, res.converged, model.evaluations, lhom, lhet)


def classify_likelihood_ratio(rows, mult, estimate_prior=True, alpha=0.05, dtype=np.float64):
    """callLikelihoodRatio (call.cpp:62-143) on the cov >= 4 profiles: the
    fit, with -R the prior on both marginals, both LRTs, BH over the
    profiles; het iff the adjusted p2 < alpha. Returns (Classes, Fit)."""
    fit = fit_lynch(rows, mult, dtype)
    lhom, lhet = fit.log_l_hom, fit.log_l_het
    if estimate_prior:
        with np.errstate(divide="ignore"):
            lhet = lhet + np.log(dtype(fit.pi))
            lhom = lhom + np.log(dtype(1.0 - fit.pi))
    lhom = np.where(lhom < LD_UNDERFLOW_LOG, -np.inf, lhom).astype(dtype)
    lhet = np.where(lhet < LD_UNDERFLOW_LOG, -np.inf, lhet).astype(dtype)
    adj1 = benjamini_hochberg(lrt_pvalue(lhet, lhom, dtype), dtype)
    adj2 = benjamini_hochberg(lrt_pvalue(lhom, lhet, dtype), dtype)
    major, second = top_two(rows)
    return Classes(adj2 < alpha, major, second, adj1, adj2), fit
