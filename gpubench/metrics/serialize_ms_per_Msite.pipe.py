"""Milliseconds of the chunk pipeline's stage ``pipeline:serialize`` (its main
thread) a million input sites."""

STAGE = "pipeline:serialize"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
