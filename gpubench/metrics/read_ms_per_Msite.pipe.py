"""Milliseconds of the chunk pipeline's stage ``pipeline:read`` (its main
thread taking the next chunk from the file: the open and map, the newline
search and a view of the mapping, no copy) a million input sites."""

STAGE = "pipeline:read"


def read(run):
    if not run.has_stage(STAGE):
        return None
    return run.stage_seconds(STAGE) * 1e3 / (run.requests * run.sites_per_request / 1e6)
