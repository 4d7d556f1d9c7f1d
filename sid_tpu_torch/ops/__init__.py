"""Ops: the lgamma table, the fixed-allele likelihoods in torch f64, the
host libm LRT, profile compaction, and the slim local classify kernel."""
