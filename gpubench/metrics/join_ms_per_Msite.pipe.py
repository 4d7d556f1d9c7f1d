"""Milliseconds of the stage ``join`` (the chunk pipeline's parts joined
into one output, and freed, after its pass) a million input sites."""

STAGE = "join"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
