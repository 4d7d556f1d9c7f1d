"""Milliseconds of the stage ``call:unique_profiles`` (the dedup of each
call's sites into unique profiles) a million input sites."""

STAGE = "call:unique_profiles"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
