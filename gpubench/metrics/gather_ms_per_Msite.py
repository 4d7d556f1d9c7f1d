"""Milliseconds of the stage ``call:gather_result`` (each call's classes
joined back onto its sites) a million input sites."""

STAGE = "call:gather_result"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
