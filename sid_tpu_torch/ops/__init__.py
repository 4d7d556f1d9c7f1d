"""Ops: the lgamma table, the fixed-allele likelihoods in torch f64, the
host libm LRT, profile compaction, and the kernels' wrappers: the slim
local classify, the Lynch objective and marginals (one fit, or a cohort's
lanes), the quality finalize."""
