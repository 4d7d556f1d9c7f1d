"""Milliseconds of the stage ``join`` (after the chunk pipeline's pass,
the request's one output, written in place, handed back) a million input
sites."""

STAGE = "join"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
