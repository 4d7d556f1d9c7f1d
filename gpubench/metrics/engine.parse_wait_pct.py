"""The share of the chunk pipeline's pass (stage ``pipeline``) in which its
main thread waited for the worker's parse (stage ``pipeline:parse_wait``):
the parse the overlap failed to hide."""


def read(run):
    total = run.stage_seconds("pipeline")
    if not total:
        return None
    return 100.0 * run.stage_seconds("pipeline:parse_wait") / total
