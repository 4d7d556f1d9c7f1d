"""BENCHMARK.json keeps to the benchmark's format: its keys, names, units
and lengths, and every name it gives has its file."""

import json
import os
import re

from gpubench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_format():
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 << 10
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert all(_line(word) for word in spec["command"]) and len(spec["command"]) <= 32
    for group, keys in KEYS.items():
        names = [entry["name"] for entry in spec[group]]
        assert len(names) == len(set(names))
        for entry in spec[group]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"]) and set(m["workloads"]) <= cells
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    for c in spec["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("gpubench/")
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert set(c["reduced"]) <= set(json.load(f)["reduced"])
    for w in spec["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])
