"""The share of the requests' wall in which the fitted chunk pipeline's
main thread was in none of its leaf stages: 100 (sum of request walls -
sum of ``pipeline:read``, ``pipeline:parse_wait``, ``pipeline:dedup``,
``fit+classify``, ``pipeline:gather``, ``pipeline:serialize`` and
``join``) / sum of request walls. Read where the program records
``pipeline:dedup``."""

LEAVES = ("pipeline:read", "pipeline:parse_wait", "pipeline:dedup", "fit+classify", "pipeline:gather",
          "pipeline:serialize", "join")


def read(run):
    wall = sum(run.request_walls)
    if not run.has_stage("pipeline:dedup") or not wall:
        return None
    return 100.0 * (wall - sum(run.stage_seconds(name) for name in LEAVES)) / wall
