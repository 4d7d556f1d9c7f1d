"""Milliseconds a request of the fitted chunk pipeline's stage
``fit+classify``: the Lynch fit over the request's coverage >= 4 profiles
(on the card under ``--fit device``), its marginals, and the LRT and
Benjamini-Hochberg over every profile, once between the two passes."""

STAGE = "fit+classify"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / run.requests
