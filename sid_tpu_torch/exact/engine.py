"""Host-exact engine (``--engine exact``): all four methods in long double,
the reference's observable pipeline (call.cpp) as sid_tpu's
``exact/engine.py`` runs it. No device stage.

Each function takes a parsed PileupBatch and Options and returns a
CallResult; stderr diagnostics (call.cpp:72-80,155-163 and the minimizer's
convergence line) go through ``diag``. ``quality`` needs the batch's
per-read arrays (a parse with both quality columns, not terms only).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
from scipy.special import gammaln

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


def call_quality_exact(batch, options: Options, diag=None) -> common.CallResult:
    """callQualityBasedSimple (call.cpp:291-372): per-read log terms of the
    min(bq, mq) error rate summed per site in long double, the allele-balance
    binomial, linear long-double likelihoods and the LD LRT; every site is
    emitted."""
    n_sites = batch.num_sites
    snp_prior = options.snp_prior
    if options.estimate_prior:
        snp_prior = _estimate_prior(batch.counts, diag)

    counts = batch.counts.astype(np.int64)
    major, second = common.major_allele_indices_np(counts)

    offsets = batch.read_offsets
    code = batch.read_code.astype(np.int64)
    bq = batch.read_bq.astype(np.float64)
    mq = batch.read_mq.astype(np.float64)

    # per-read error from the smaller Phred value (call.cpp:331)
    err = np.power(10.0, np.minimum(bq, mq) / -10.0)
    site_of_read = np.repeat(np.arange(n_sites), np.diff(offsets))
    is_major = code == major[site_of_read]
    is_top2 = is_major | (code == second[site_of_read])

    with np.errstate(divide="ignore"):
        hom_terms = np.where(is_major, np.log(1.0 - err), np.log(err))
        het_terms = np.where(is_top2, np.log(1.0 - 2.0 / 3.0 * err), np.log(2.0 / 3.0 * err))
    # sequential within-site accumulation in long double (reference loop order)
    log_hom = _segment_sum_ld(hom_terms, offsets)
    log_het = _segment_sum_ld(het_terms, offsets)

    # allele-balance binomial (call.cpp:344-349): n = n1 + n2, k = n2
    n = np.take_along_axis(counts, major[:, None].astype(np.int64), 1)[:, 0] + (
        np.take_along_axis(counts, second[:, None].astype(np.int64), 1)[:, 0]
    )
    k = np.take_along_axis(counts, second[:, None].astype(np.int64), 1)[:, 0]
    logbinom = gammaln(n + 1) - gammaln(n - k + 1) - gammaln(k + 1)
    log_het = log_het + (logbinom.astype(LD) - n.astype(LD) * np.log(LD(2)))

    # the reference's exp of a long double is the long-double overload
    pp1 = np.exp(log_hom)
    pp2 = np.exp(log_het)
    if snp_prior > 0:
        pp1 = pp1 * LD(np.float64(1.0 - snp_prior))
        pp2 = pp2 * LD(np.float64(snp_prior))

    p1 = stats_ld.lrt_pvalue_ld(pp2, pp1)
    p2 = stats_ld.lrt_pvalue_ld(pp1, pp2)
    is_het = p2 < options.significance_level
    return common.CallResult(
        chrom_id=batch.chrom_id,
        chrom_table=batch.chrom_table,
        pos=batch.pos,
        is_het=is_het,
        major=major,
        second=second,
        conf_hom=p1,
        conf_het=p2,
        conf_type="p_value",
    )


def _segment_sum_ld(terms: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Per-segment sums in long double over CSR offsets (np.add.reduceat,
    sid_tpu/exact/engine.py:238-247)."""
    terms_ld = terms.astype(LD)
    out = np.zeros(offsets.shape[0] - 1, LD)
    nonempty = np.diff(offsets) > 0
    if terms_ld.size:
        out[nonempty] = np.add.reduceat(terms_ld, offsets[:-1][nonempty])
    return out
