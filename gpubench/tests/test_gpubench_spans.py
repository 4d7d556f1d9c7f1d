"""The readers of the port's pipeline spans (``gpubench/metrics``) on a
made-up run: nothing without their stage, exact values for given stages
and walls, and ``engine.unspanned_pct`` falling as leaves are added."""

import pytest

from gpubench import harness

PER_MSITE = {
    "read_ms_per_Msite.pipe": "pipeline:read",
    "parse_ms_per_Msite.pipe": "worker:parse",
    "dedup_ms_per_Msite": "call:unique_profiles",
    "gather_ms_per_Msite": "call:gather_result",
    "join_ms_per_Msite.pipe": "join",
}
LEAVES = [("pipeline:read", 0.4), ("pipeline:parse_wait", 0.1), ("pipeline:call", 1.2),
          ("pipeline:serialize", 1.6), ("join", 0.5)]


def _run(stages, walls=(2.0, 2.0)):
    """Two requests of 2M sites each."""
    return harness.Run({"total": 1.0}, list(walls), sum(walls), 2_000_000, stages=list(stages))


@pytest.mark.parametrize("name", sorted(PER_MSITE))
def test_per_msite_reader(name):
    read = harness.reader(name)
    assert read(_run([("pipeline", 3.0), ("pipeline:call", 1.0)])) is None
    stage = PER_MSITE[name]
    # 0.25 + 0.15 s over two requests of 2M sites: 100 ms a Msite
    assert read(_run([(stage, 0.25), ("pipeline", 3.0), (stage, 0.15)])) == pytest.approx(100.0)


def test_unspanned_pct_reads_nothing_without_the_read_stage():
    read = harness.reader("engine.unspanned_pct")
    assert read(_run([("pipeline", 3.5), ("pipeline:parse_wait", 0.1), ("pipeline:call", 1.2),
                      ("pipeline:serialize", 1.6)])) is None


def test_unspanned_pct_is_exact_and_falls_as_leaves_are_added():
    read = harness.reader("engine.unspanned_pct")
    # 4 s of request walls; the leaves sum to 3.8 s: 5 %
    assert read(_run(LEAVES + [("pipeline", 3.3), ("worker:parse", 2.0), ("call:gather_result", 0.3)])) == (
        pytest.approx(5.0))
    values = [read(_run(LEAVES[:k])) for k in range(1, len(LEAVES) + 1)]
    assert values == sorted(values, reverse=True) and len(set(values)) == len(values)
    assert values[0] == pytest.approx(90.0)
