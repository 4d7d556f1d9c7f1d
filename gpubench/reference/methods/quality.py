"""``-m quality`` (callQualityBasedSimple, call.cpp:291-372): every site
called from its own reads' qualities and emitted in order. The reads'
sums against the site's top-2 bases come from the parse
(``pileup.Reads``); here the allele balance, the prior and both LRTs."""

import numpy as np
from scipy.special import gammaln

from gpubench.reference import calls
from gpubench.reference.check import Expected

# parse both quality columns for this method (``pileup.parse(..., reads=dtype)``)
READS = True


def expected(options: dict, chrom_id, chrom_table, pos, counts, dtype=np.float64, reads=None) -> Expected:
    if options.get("estimate_prior", False):
        raise NotImplementedError("no reference for -m quality with -R")
    counts = np.asarray(counts, np.int64)
    major, second = calls.top_two(counts)
    idx = np.arange(counts.shape[0])
    n, k = counts[idx, major] + counts[idx, second], counts[idx, second]
    # the allele balance ln C(n, k) - n ln 2 on the het side (call.cpp:344-349)
    log_c = (gammaln(n + 1) - gammaln(n - k + 1) - gammaln(k + 1)).astype(dtype)
    lpp1 = np.asarray(reads.log_hom, dtype)
    lpp2 = (np.asarray(reads.log_het, dtype) + log_c) - n.astype(dtype) * np.log(dtype(2))
    lpp1 = np.where(lpp1 < calls.LD_UNDERFLOW_LOG, -np.inf, lpp1).astype(dtype)
    lpp2 = np.where(lpp2 < calls.LD_UNDERFLOW_LOG, -np.inf, lpp2).astype(dtype)
    snp_prior = options.get("snp_prior", -1.0)
    if snp_prior > 0:
        lpp1 = lpp1 + np.log(dtype(1.0 - snp_prior))
        lpp2 = lpp2 + np.log(dtype(snp_prior))
    p1 = calls.lrt_pvalue(lpp2, lpp1, dtype)
    p2 = calls.lrt_pvalue(lpp1, lpp2, dtype)
    with np.errstate(invalid="ignore"):
        is_het = p2 < options.get("significance_level", 0.05)
    sites = np.arange(counts.shape[0])
    return Expected(chrom_table, chrom_id, pos, sites, sites, calls.Classes(is_het, major, second, p1, p2),
                    "p_value", None)
