"""Calling methods: ``local`` (per-site ML error, the default), ``bayes`` and
``likelihood_ratio`` over the Lynch fit, and ``quality`` (per-read Phred
likelihoods); ``population`` calls a cohort of samples with all four."""
