"""Method ``likelihood_ratio``: Lynch fit + LRT + Benjamini-Hochberg.

Reference: callLikelihoodRatio (call.cpp:62-143), the thesis-pipeline
configuration (`sid -R -m likelihood_ratio`). Coverage>=4 profiles; fit;
optional prior weighting (-R); two LRT p-values per profile through host
libm; BH correction across *unique profiles* (not sites); het iff adjusted
p2 < alpha; filtered sites omitted from output. With ``exact_pvalues=False``
(sid_tpu's fused on-device LRT) the clamp, the prior, both LRTs and both BH
corrections run on the device (``ops.stats.lrt_benjamini_hochberg``).
"""

from __future__ import annotations

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.models import common
from sid_tpu_torch.models.lynch import fit_profiles
from sid_tpu_torch.ops import stats
from sid_tpu_torch.ops.profiles import filter_min_coverage, unique_profiles
from sid_tpu_torch.utils import profiling


def classify_profiles_lr(profiles, mult, options: Options, diag=None):
    """Per-class LRT+BH classification on (filtered) profiles: the 5 host
    arrays (is_het, major, second, adj_p1, adj_p2)."""
    if diag:
        diag(f"# unique profiles: {profiles.shape[0]}")
    pi, eps, log_l_hom, log_l_het, _ = fit_profiles(profiles, mult, options, diag)
    if diag:
        diag(f"# heterozygosity: {pi:.6e}")
        diag(f"# error: {eps:.6e}")
    return lrt_classify(profiles, pi, log_l_hom, log_l_het, options)


def lrt_classify(profiles, pi: float, log_l_hom, log_l_het, options: Options):
    """The classification from a fit: (is_het, major, second, adj_p1,
    adj_p2) over the profiles; the LRT and BH on the host, or on the
    options' device with ``exact_pvalues=False``."""
    major, second = common.major_allele_indices_np(profiles)
    if not options.exact_pvalues:
        log_priors = stats.prior_logs(pi) if options.estimate_prior else None
        device = options.device()
        with profiling.device_stage("classify_lr", device):
            is_het, adj_p1, adj_p2 = stats.lrt_benjamini_hochberg(
                log_l_hom, log_l_het, log_priors, options.significance_level, device
            )
        return is_het, major, second, adj_p1, adj_p2
    with np.errstate(invalid="ignore"):
        lhom = common.clamp_ld_underflow_np(log_l_hom)
        lhet = common.clamp_ld_underflow_np(log_l_het)
        if options.estimate_prior:
            lhet = common.clamp_ld_underflow_np(lhet + np.log(np.float64(pi)))
            lhom = common.clamp_ld_underflow_np(lhom + np.log(np.float64(1.0 - pi)))
        p1 = stats.lrt_pvalue_from_logs_np(lhet, lhom)  # confidence against het
        p2 = stats.lrt_pvalue_from_logs_np(lhom, lhet)
        adj_p1 = stats.adjust_benjamini_hochberg_np(p1)
        adj_p2 = stats.adjust_benjamini_hochberg_np(p2)
        is_het = adj_p2 < options.significance_level
    return is_het, major, second, adj_p1, adj_p2


def call_likelihood_ratio(batch, options: Options, diag=None) -> common.CallResult:
    profiles, mult, inverse = unique_profiles(batch.counts)
    profiles, mult, keep = filter_min_coverage(profiles, mult, 4)
    cls = classify_profiles_lr(profiles, mult, options, diag)
    return common.gather_result(batch, "p_value", inverse, *cls, keep_u=keep)
