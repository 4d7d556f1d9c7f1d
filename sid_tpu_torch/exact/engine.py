"""Host-exact engine (``--engine exact``): local, bayes and likelihood_ratio
in long double, the reference's observable pipeline (call.cpp) as sid_tpu's
``exact/engine.py`` runs it. No device stage.

Each function takes a parsed PileupBatch and Options and returns a
CallResult; stderr diagnostics (call.cpp:72-80,155-163 and the minimizer's
convergence line) go through ``diag``. ``quality`` waits for its slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.exact import lynch_ld, stats_ld
from sid_tpu_torch.models import common
from sid_tpu_torch.models.local import classify_profiles_local_ld
from sid_tpu_torch.ops.profiles import (
    filter_min_coverage,
    nucleotide_distribution,
    unique_profiles,
)

LD = np.longdouble


def _fit(
    profiles: np.ndarray, mult: np.ndarray, diag: Optional[Callable[[str], None]]
) -> Tuple[float, float, np.ndarray, np.ndarray, np.ndarray]:
    """Lynch fit on cov>=4-filtered profiles: (pi, eps, L_hom, L_het, nt)."""
    nt = nucleotide_distribution(profiles, mult)
    pi, eps, l_hom, l_het = lynch_ld.estimate_profile_genotype_likelihoods_ld(
        profiles, mult, nt, log=diag
    )
    return pi, eps, l_hom, l_het, nt


def _estimate_prior(batch_counts: np.ndarray, diag) -> float:
    """The -R path (call.cpp:223-234): fit the cov>=4 profiles, the
    heterozygosity is the SNP prior."""
    profiles, mult, _ = unique_profiles(batch_counts)
    profiles, mult, _ = filter_min_coverage(profiles, mult, 4)
    pi, _, _, _, _ = _fit(profiles, mult, diag)
    return pi


def _fit_with_diagnostics(profiles, mult, diag):
    if diag:
        diag(f"# unique profiles: {profiles.shape[0]}")
    pi, eps, l_hom, l_het, _ = _fit(profiles, mult, diag)
    if diag:
        diag(f"# heterozygosity: {pi:.6e}")
        diag(f"# error: {eps:.6e}")
    return pi, eps, l_hom, l_het


def call_local_exact(batch, options: Options, diag=None) -> common.CallResult:
    """callSiteMLError (call.cpp:213-289) through the host long-double
    classifier; with -R the prior is fitted first, even on empty input."""
    profiles, _mult, inverse = unique_profiles(batch.counts)
    snp_prior = options.snp_prior
    if options.estimate_prior:
        snp_prior = _estimate_prior(batch.counts, diag)
    if profiles.shape[0] == 0:
        empty = np.zeros(0, np.int32)
        cls = (np.zeros(0, bool), empty, empty, np.zeros(0), np.zeros(0))
    else:
        cls = classify_profiles_local_ld(profiles, options, snp_prior)
    return common.gather_result(batch, "p_value", inverse, *cls)


def call_bayes_exact(batch, options: Options, diag=None) -> common.CallResult:
    """callBayes (call.cpp:145-211): posteriors in long double."""
    profiles, mult, inverse = unique_profiles(batch.counts)
    profiles, mult, keep = filter_min_coverage(profiles, mult, 4)
    pi, _eps, l_hom, l_het = _fit_with_diagnostics(profiles, mult, diag)
    with np.errstate(invalid="ignore", divide="ignore"):
        apost_hom = l_hom * LD(np.float64(1.0 - pi))
        apost_het = l_het * LD(pi)
        denom = apost_hom + apost_het
        prob_hom = (apost_hom / denom).astype(np.float64)
        prob_het = (apost_het / denom).astype(np.float64)
        is_het = prob_het > prob_hom
    major, second = common.major_allele_indices_np(profiles)
    return common.gather_result(
        batch, "probability", inverse, is_het, major, second, prob_hom, prob_het,
        keep_u=keep,
    )


def call_likelihood_ratio_exact(batch, options: Options, diag=None) -> common.CallResult:
    """callLikelihoodRatio (call.cpp:62-143): long-double LRT, then BH over
    the unique profiles."""
    profiles, mult, inverse = unique_profiles(batch.counts)
    profiles, mult, keep = filter_min_coverage(profiles, mult, 4)
    pi, _eps, l_hom, l_het = _fit_with_diagnostics(profiles, mult, diag)
    if options.estimate_prior:
        l_het = l_het * LD(pi)
        l_hom = l_hom * LD(np.float64(1.0 - pi))
    p1 = stats_ld.lrt_pvalue_ld(l_het, l_hom)  # confidence against het
    p2 = stats_ld.lrt_pvalue_ld(l_hom, l_het)
    adj_p1 = stats_ld.adjust_benjamini_hochberg_np(p1)
    adj_p2 = stats_ld.adjust_benjamini_hochberg_np(p2)
    is_het = adj_p2 < options.significance_level
    major, second = common.major_allele_indices_np(profiles)
    return common.gather_result(
        batch, "p_value", inverse, is_het, major, second, adj_p1, adj_p2,
        keep_u=keep,
    )
