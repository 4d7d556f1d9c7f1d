"""Method ``local`` (the default): per-site maximum-likelihood error rates.

Reference: callSiteMLError (call.cpp:213-289). Per unique profile, plug-in
error rates — hom: (cov - n_major)/cov, het: 1.5*(cov - n1 - n2)/cov, both
capped at the -E threshold — feed the fixed-allele likelihoods; LRT
p-values (no multiple-testing correction); het iff l2 > l1 and p2 < alpha.
No coverage filter: every input site is emitted.

With -R the SNP prior is the heterozygosity of the Lynch fit on the
cov>=4 profiles (``models.lynch.estimate_prior_heterozygosity``,
call.cpp:223-234), fitted before the classification.

Placement: the device takes the counts and returns, per profile, the top-2
alleles, (l1, l2) and the range screen's flag (``ops.local_classify``: the
CUDA kernel on a CUDA device, the torch f64 twin on the CPU), and the host
adds the prior and runs the LRT through glibc libm; with ``--devices`` each
device of the mesh classifies one contiguous block of the profiles. With
``exact_pvalues=False`` (sid_tpu's fused on-device LRT, ``classify_local``)
the device also adds the prior and runs both LRTs and is_het (B5, the same
source's second kernel), and returns (p1, p2) and the byte instead.
``classify_profiles_local_ld`` is the same classification in long double
on the host (libsidtpu), an independent path with no device stage, against
which the device path is held.

The reference multiplies linear long doubles, mc * (1-e)^n0 * (e/3)^m *
prior, so at deep coverage a factor can overflow or underflow the long
double range: 9000 reads of each of two alleles give mc = inf and a NaN
call. Log space never leaves its range, so those profiles would differ.
``long_double_range_rows`` bounds every factor from the coverage alone (the
kernel flags the same rows); the profiles it cannot clear are classified by
the long-double classifier instead, so both placements give the
reference's bytes.
"""

from __future__ import annotations

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.io import native
from sid_tpu_torch.models import common
from sid_tpu_torch.models.lynch import estimate_prior_heterozygosity
from sid_tpu_torch.native import bridge
from sid_tpu_torch.ops import local_classify, stats
from sid_tpu_torch.ops.profiles import unique_profiles
from sid_tpu_torch.utils import profiling


def long_double_range_rows(cov: np.ndarray, error_threshold: float, snp_prior: float) -> np.ndarray:
    """Profiles whose long-double likelihoods may leave the normal range.

    For a profile of coverage c the multinomial coefficient is at most 4^c,
    and each likelihood's two powers together are at least exp(-c K): K is
    ln 4 for uncapped error rates (max of H(p) + p ln 3, and of ln 2 + H(q))
    and -ln of the smallest base a capped rate gives. The prior adds its own
    log. Rows where these bounds stay inside the normal range evaluate
    every factor and partial product there, so log space gives the same
    answer; the others are returned True. A negative -E (negative bases) or
    a prior of 1 or more flags every row (``common.long_double_screen``).
    The local classify kernel computes the same flag per row.
    """
    every, k, prior = common.long_double_screen(error_threshold, snp_prior)
    if every:
        return np.ones(cov.shape[0], bool)
    c = np.asarray(cov, np.float64)
    return (c * common.LN4 > common.LD_LOG_MAX) | (c * k + prior > -common.LD_LOG_MIN)


def classify_profiles_local(profiles: np.ndarray, options: Options, snp_prior: float, mesh=None):
    """Per-class local classification on the options' device, or over the
    run's mesh (``--devices``) or ``mesh`` (a list of devices) one
    contiguous block of rows a device; returns the 5 host arrays (is_het,
    major, second, p1, p2) over U. The alleles and the range screen's rows
    come from the classify kernel's byte; (l1, l2) too, and the host adds
    the prior and runs the LRT through glibc libm, or, with
    ``exact_pvalues=False``, B5 returns (p1, p2) and is_het from the device.
    The screen's rows are classified in long double either way, with a mesh
    too (sid_tpu's mesh classify has no screen: fault C1, ROADMAP.md)."""
    mesh = options.mesh() if mesh is None else mesh
    device = options.device() if mesh is None else mesh[0]
    thr, alpha = options.site_error_threshold, options.significance_level

    def classify(alpha=None):
        if mesh is None:
            return local_classify.classify_profiles(profiles, thr, snp_prior, device, alpha)
        return local_classify.classify_profiles_sharded(profiles, thr, snp_prior, mesh, alpha)

    if options.exact_pvalues:
        with profiling.device_stage("local_log_likelihoods", device):
            l1, l2, packed = classify()
        if snp_prior > 0:
            # glibc log, matching the oracle's prior arithmetic
            l1 = l1 + np.log(np.float64(1.0 - snp_prior))
            l2 = l2 + np.log(np.float64(snp_prior))
        p1 = stats.lrt_pvalue_from_logs_np(l2, l1)
        p2 = stats.lrt_pvalue_from_logs_np(l1, l2)
        with np.errstate(invalid="ignore"):
            is_het = (l2 > l1) & (p2 < alpha)
    else:
        with profiling.device_stage("classify_local", device):
            p1, p2, packed = classify(alpha)
        is_het = local_classify.het_flags(packed)
    major, second, ld_rows = local_classify.unpack(packed)
    rows = np.flatnonzero(ld_rows)
    if rows.size:
        is_het[rows], p1[rows], p2[rows] = _classify_ld(
            profiles[rows], major[rows], second[rows], options, snp_prior
        )
    return is_het, major, second, p1, p2


def classify_profiles_local_ld(profiles: np.ndarray, options: Options, snp_prior: float):
    """The same classification in host long double (libsidtpu's
    sidtpu_local_classify_ld, call.cpp:238-273); no device stage."""
    major, second = common.major_allele_indices_np(profiles)
    is_het, p1, p2 = _classify_ld(profiles, major, second, options, snp_prior)
    return is_het, major, second, p1, p2


def _classify_ld(profiles, major, second, options: Options, snp_prior: float):
    """(is_het, p1, p2) in host long double for given alleles."""
    with profiling.maybe_stage("host:local_classify_ld"):
        return bridge.local_classify_ld(
            native.load(), profiles, major, second,
            options.site_error_threshold, snp_prior, options.significance_level,
        )


def _call(batch, options: Options, classify, diag) -> common.CallResult:
    profiles, mult, inverse = unique_profiles(batch.counts)
    if profiles.shape[0] == 0:
        empty = np.zeros(0, np.int32)
        cls = (np.zeros(0, bool), empty, empty, np.zeros(0), np.zeros(0))
    else:
        snp_prior = options.snp_prior
        if options.estimate_prior:
            snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)
        cls = classify(profiles, options, snp_prior)
    return common.gather_result(batch, "p_value", inverse, *cls)


def call_local(batch, options: Options, diag=None) -> common.CallResult:
    """End-to-end ``local`` call on a parsed batch (device path); ``diag``
    gets -R's fit diagnostics."""
    return _call(batch, options, classify_profiles_local, diag)


def call_local_ld(batch, options: Options, diag=None) -> common.CallResult:
    """End-to-end ``local`` call through the host long-double classifier."""
    return _call(batch, options, classify_profiles_local_ld, diag)
