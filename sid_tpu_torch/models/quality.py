"""Method ``quality``: per-read Phred-quality genotype likelihoods.

Reference: callQualityBasedSimple (call.cpp:291-372), the only per-site (not
per-profile) method. Per read j: error = 10^(-min(bq_j, mq_j)/10); log P(hom)
accumulates ln(1-e)/ln(e) by major-allele match, log P(het) ln(1-2e/3) /
ln(2e/3) by top-2 match, plus an allele-balance log-binomial; LRT p-values;
het iff p2 < alpha. Every input site is emitted in order.

The per-read stage is a 256-entry table lookup and a sequential per-site
sum: the native parser does it inline (``io.pileup``'s ``q_*`` fields),
``accumulate_read_terms`` is the same sums in numpy for batches from the
Python parser.

Placement: the het side of the finalization (the binomial from the counts,
the clamp and the prior) runs on the device (``ops.quality_finalize``: the
CUDA kernel on a CUDA device, the torch f64 version on the CPU); the host
clamps the hom side, adds its prior and runs both LRTs through glibc libm
(libsidtpu's ``sidtpu_lrt_pvalues``). ``call_quality_host`` is the
independent host path the device path is held against: libsidtpu's fused
``sidtpu_quality_finalize``, bitwise the same composition. With
``exact_pvalues=False`` (sid_tpu's fused on-device LRT, ``finalize_quality``)
the device runs the whole finalize (``quality_finalize.finalize_lrt``: the
same kernel source's full form, with both LRTs through the device erfc).
"""

from __future__ import annotations

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.io import native
from sid_tpu_torch.models import common
from sid_tpu_torch.models.lynch import estimate_prior_heterozygosity
from sid_tpu_torch.native import bridge
from sid_tpu_torch.native.bridge import quality_term_tables
from sid_tpu_torch.ops import quality_finalize, stats
from sid_tpu_torch.ops.lgamma import lgamma_int_table, table_size
from sid_tpu_torch.ops.profiles import coverage_of, unique_profiles
from sid_tpu_torch.utils import profiling

__all__ = [
    "quality_term_tables", "accumulate_read_terms", "finalize_quality_np",
    "finalize_logs", "finalize_quality_native", "call_quality", "call_quality_host",
]


def accumulate_read_terms(batch, major: np.ndarray, second: np.ndarray):
    """Host per-read stage: (log_hom, log_het) sums per site, f64, for a
    batch that carries reads (sid_tpu/models/quality.py:54-86): table terms
    masked by major / top-2 membership, reduced per site with
    np.add.reduceat."""
    n = batch.num_sites
    offsets = batch.read_offsets
    lens = np.diff(offsets)
    site_of_read = np.repeat(np.arange(n, dtype=np.int64), lens)
    minq = np.minimum(batch.read_bq, batch.read_mq).astype(np.int64)
    code = batch.read_code.astype(np.int64)

    rows = quality_term_tables()[minq]  # (R, 4)
    is_major = code == major[site_of_read]
    is_top2 = is_major | (code == second[site_of_read])
    hom_terms = np.where(is_major, rows[:, 0], rows[:, 1])
    het_terms = np.where(is_top2, rows[:, 2], rows[:, 3])

    log_hom = np.zeros(n, np.float64)
    log_het = np.zeros(n, np.float64)
    nonempty = lens > 0
    if hom_terms.size:
        starts = offsets[:-1][nonempty]
        log_hom[nonempty] = np.add.reduceat(hom_terms, starts)
        log_het[nonempty] = np.add.reduceat(het_terms, starts)
    return log_hom, log_het


def finalize_quality_np(counts, major, second, log_hom, log_het, snp_prior: float, lgamma_tab):
    """Host finalization in numpy (sid_tpu/models/quality.py:169-199),
    operation for operation the kernel: (lpp1, lpp2)."""
    counts = counts.astype(np.int64)
    idx = np.arange(counts.shape[0])
    n = counts[idx, major] + counts[idx, second]
    k = counts[idx, second]
    log_c = lgamma_tab[n + 1] - lgamma_tab[n - k + 1] - lgamma_tab[k + 1]
    log_het = log_het + log_c - n.astype(np.float64) * np.log(2.0)

    log_pp1 = common.clamp_ld_underflow_np(log_hom)
    log_pp2 = common.clamp_ld_underflow_np(log_het)
    if snp_prior > 0:
        log_pp1 = log_pp1 + np.log(np.float64(1.0 - snp_prior))
        log_pp2 = log_pp2 + np.log(np.float64(snp_prior))
    return log_pp1, log_pp2


def finalize_logs(counts, major, second, log_hom, log_het, snp_prior: float, device):
    """(lpp1, lpp2): the het side on ``device`` (``ops.quality_finalize``),
    the hom side's clamp and prior on the host."""
    with profiling.device_stage("finalize_quality_het", device):
        lpp2 = quality_finalize.finalize_het(counts, major, second, log_het, snp_prior, device)
    lpp1 = common.clamp_ld_underflow_np(log_hom)
    if snp_prior > 0:
        lpp1 = lpp1 + np.log(np.float64(1.0 - snp_prior))
    return lpp1, lpp2


def finalize_quality_native(counts, major, second, log_hom, log_het, snp_prior: float, alpha: float):
    """(is_het, p1, p2) through libsidtpu's fused host finalize, the table
    sized as sid_tpu sizes it (twice the largest coverage)."""
    max_cov = int(coverage_of(counts).max()) if len(counts) else 0
    tab = lgamma_int_table(table_size(2 * max_cov))
    with profiling.maybe_stage("host:quality_finalize"):
        return bridge.quality_finalize(
            native.load(), counts, major, second, log_hom, log_het, snp_prior, alpha, tab,
            common.LONG_DOUBLE_UNDERFLOW_LOG,
        )


def _terms(batch, options: Options, diag):
    """(snp_prior, major, second, log_hom, log_het) of a batch: the prior
    (fitted under -R), and the parser's inline terms or their numpy sums."""
    snp_prior = options.snp_prior
    if options.estimate_prior:
        profiles, mult, _ = unique_profiles(batch.counts)
        snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)
    if batch.q_log_hom is not None:
        return snp_prior, batch.q_major, batch.q_second, batch.q_log_hom, batch.q_log_het
    major, second = common.major_allele_indices_np(batch.counts.astype(np.int64))
    log_hom, log_het = accumulate_read_terms(batch, major, second)
    return snp_prior, major, second, log_hom, log_het


def _result(batch, major, second, is_het, p1, p2) -> common.CallResult:
    return common.CallResult(
        chrom_id=batch.chrom_id,
        chrom_table=batch.chrom_table,
        pos=batch.pos,
        is_het=is_het,
        major=np.asarray(major, np.int32),
        second=np.asarray(second, np.int32),
        conf_hom=p1,
        conf_het=p2,
        conf_type="p_value",
    )


def call_quality(batch, options: Options, diag=None) -> common.CallResult:
    """End-to-end ``quality`` call on a parsed batch (device path); ``diag``
    gets -R's fit diagnostics."""
    snp_prior, major, second, log_hom, log_het = _terms(batch, options, diag)
    if not options.exact_pvalues:
        device = options.device()
        with profiling.device_stage("finalize_quality", device):
            is_het, p1, p2 = quality_finalize.finalize_lrt(
                batch.counts, major, second, log_hom, log_het, snp_prior,
                options.significance_level, device,
            )
        return _result(batch, major, second, is_het, p1, p2)
    lpp1, lpp2 = finalize_logs(
        batch.counts, major, second, log_hom, log_het, snp_prior, options.device()
    )
    p1 = stats.lrt_pvalue_from_logs_np(lpp2, lpp1)
    p2 = stats.lrt_pvalue_from_logs_np(lpp1, lpp2)
    with np.errstate(invalid="ignore"):
        is_het = p2 < options.significance_level
    return _result(batch, major, second, is_het, p1, p2)


def call_quality_host(batch, options: Options, diag=None) -> common.CallResult:
    """End-to-end ``quality`` call through libsidtpu's fused host finalize;
    no device stage."""
    snp_prior, major, second, log_hom, log_het = _terms(batch, options, diag)
    is_het, p1, p2 = finalize_quality_native(
        batch.counts, major, second, log_hom, log_het, snp_prior, options.significance_level
    )
    return _result(batch, major, second, is_het, p1, p2)
