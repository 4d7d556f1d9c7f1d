"""Milliseconds of the chunk pipeline's stage ``worker:parse`` (its worker
thread's parse of each chunk, beside the main thread's work) a million
input sites."""

STAGE = "worker:parse"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
