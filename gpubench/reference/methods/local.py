"""sid's default method, ``-m local``: every site classified from its own
counts (call.cpp:238-273)."""

import numpy as np

from gpubench.reference import calls
from gpubench.reference.check import Expected


def expected(options: dict, chrom_id, chrom_table, pos, counts, dtype=np.float64) -> Expected:
    if options.get("estimate_prior", False):
        raise NotImplementedError("no reference for -m local with -R")
    prof = calls.unique_profiles(counts)
    classes = calls.classify_local(prof.rows, options.get("site_error_threshold", 0.1),
                                   options.get("snp_prior", -1.0), options.get("significance_level", 0.05), dtype)
    return Expected(chrom_table, chrom_id, pos, prof.inverse, prof.first, classes, "p_value", None)
