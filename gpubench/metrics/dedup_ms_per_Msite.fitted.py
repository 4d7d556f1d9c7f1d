"""Milliseconds of the fitted chunk pipeline's stage ``pipeline:dedup``
(its main thread: each chunk's dedup into unique profiles and their merge
into the request's table) a million input sites."""

STAGE = "pipeline:dedup"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
