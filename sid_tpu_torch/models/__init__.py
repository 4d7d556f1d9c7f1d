"""Calling methods. ``local`` (per-site ML error, the default) is ported;
``bayes``, ``likelihood_ratio`` and ``quality`` follow with the Lynch fit and
the quality slice."""
