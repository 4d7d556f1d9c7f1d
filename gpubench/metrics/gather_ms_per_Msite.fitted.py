"""Milliseconds of the fitted chunk pipeline's stage ``pipeline:gather``
(its main thread: each held chunk's profiles mapped onto the fitted table
and the classes gathered onto its sites) a million input sites."""

STAGE = "pipeline:gather"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
