"""Method ``bayes``: posterior odds under the fitted Lynch model.

Reference: callBayes (call.cpp:145-211). Coverage>=4 profiles only; fit
(pi, epsilon); posterior P(hom) = L_hom(1-pi) / (L_hom(1-pi) + L_het pi);
label het iff P(het) > P(hom); conf_type "probability"; sites whose profile
was filtered out are omitted. The posteriors are f64 from log space, as
sid_tpu computes them (``sid_tpu/models/bayes.py``).
"""

from __future__ import annotations

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.models import common
from sid_tpu_torch.models.lynch import fit_profiles
from sid_tpu_torch.ops.profiles import filter_min_coverage, unique_profiles


def classify_profiles_bayes(profiles, mult, options: Options, diag=None):
    """Per-class posterior classification on (filtered) profiles: the 5
    host arrays (is_het, major, second, prob_hom, prob_het)."""
    if diag:
        diag(f"# unique profiles: {profiles.shape[0]}")
    pi, eps, log_l_hom, log_l_het, _ = fit_profiles(profiles, mult, options, diag)
    if diag:
        diag(f"# heterozygosity: {pi:.6e}")
        diag(f"# error: {eps:.6e}")
    return posteriors(profiles, pi, log_l_hom, log_l_het)


def posteriors(profiles, pi: float, log_l_hom, log_l_het):
    """The classification from a fit: (is_het, major, second, prob_hom,
    prob_het) over the profiles."""
    # likelihoods (and prior-weighted products) below the 80-bit subnormal
    # line are exactly 0 in the reference: -inf here; 0/0 stays NaN
    log_l_hom = common.clamp_ld_underflow_np(log_l_hom)
    log_l_het = common.clamp_ld_underflow_np(log_l_het)
    log_apost_hom = log_l_hom + np.log(np.float64(1.0 - pi))
    log_apost_het = log_l_het + np.log(np.float64(pi)) if pi > 0 else np.full_like(log_l_hom, -np.inf)
    log_apost_hom = common.clamp_ld_underflow_np(log_apost_hom)
    log_apost_het = common.clamp_ld_underflow_np(log_apost_het)
    with np.errstate(invalid="ignore", over="ignore"):
        # normalize by the larger to avoid overflow
        m = np.maximum(log_apost_hom, log_apost_het)
        wh = np.exp(log_apost_hom - m)
        wt = np.exp(log_apost_het - m)
        denom = wh + wt
        prob_hom = wh / denom
        prob_het = wt / denom
        is_het = prob_het > prob_hom
    major, second = common.major_allele_indices_np(profiles)
    return is_het, major, second, prob_hom, prob_het


def call_bayes(batch, options: Options, diag=None) -> common.CallResult:
    profiles, mult, inverse = unique_profiles(batch.counts)
    profiles, mult, keep = filter_min_coverage(profiles, mult, 4)
    cls = classify_profiles_bayes(profiles, mult, options, diag)
    return common.gather_result(batch, "probability", inverse, *cls, keep_u=keep)
