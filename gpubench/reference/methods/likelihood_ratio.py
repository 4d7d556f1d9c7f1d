"""``-m likelihood_ratio``: the Lynch fit over the coverage >= 4 profiles,
with ``-R`` its prior, two LRTs and Benjamini-Hochberg; sites of lower
coverage are left out of the CSV."""

import numpy as np

from gpubench.reference import calls
from gpubench.reference.check import Expected


def expected(options: dict, chrom_id, chrom_table, pos, counts, dtype=np.float64) -> Expected:
    prof = calls.unique_profiles(counts)
    keep = prof.rows.sum(1) >= 4
    classes, fit = calls.classify_likelihood_ratio(
        prof.rows[keep], prof.mult[keep], options.get("estimate_prior", False),
        options.get("significance_level", 0.05), dtype)
    site_keep = keep[prof.inverse]
    cls = (np.cumsum(keep) - 1)[prof.inverse[site_keep]]
    first = (np.cumsum(site_keep) - 1)[prof.first[keep]]
    return Expected(chrom_table, chrom_id[site_keep], pos[site_keep], cls, first, classes, "p_value", fit)
