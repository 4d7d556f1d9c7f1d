"""The harness finds a cell's configuration, traffic, metrics, roofline
models and the reference of its method by name, so a later change adds a
cell by adding files and entries."""

import json
import os
import shutil
import sys
import types

from gpubench import harness, rooflines
from gpubench.reference import check

ROOT = harness.ROOT


def _copy_tree(tmp_path):
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    return str(tmp_path)


def test_every_named_file_exists():
    spec = harness.load_spec()
    for cell in spec["workloads"]:
        found = harness.find_cell(spec, cell["name"])
        assert found["config"]["options"] is not None and found["traffic"]["sites"] > 0
        for trace in (False, True):
            for metric in harness.cell_metrics(spec, cell["name"], trace):
                assert callable(harness.reader(metric["name"]))


def test_a_new_cell_is_added_by_files_and_entries(tmp_path, monkeypatch):
    root = _copy_tree(tmp_path)
    bench = os.path.join(root, "gpubench")
    with open(os.path.join(bench, "configs", "fake-config.json"), "w") as f:
        json.dump({"source": "a test", "options": {"method": "local"}, "limits": {"rows_bad": 0}}, f)
    with open(os.path.join(bench, "traffic", "fake_traffic.json"), "w") as f:
        json.dump({"sites": 10, "body_sites": 10, "distinct_bodies": 1}, f)
    with open(os.path.join(bench, "metrics", "fake.requests_pct.py"), "w") as f:
        f.write("def read(run):\n    return 100.0 * run.requests / 4\n")
    with open(os.path.join(bench, "rooflines", "fake_kernel.py"), "w") as f:
        f.write("KERNEL = 'fake_kernel'\nWRAPS = 'gpubench_fake_port:kernel'\n\n"
                "def record(rows):\n    return rows\n\n"
                "def work(records):\n    return 8 * sum(records), 2 * sum(records)\n")
    with open(os.path.join(bench, "metrics", "fake_kernel_roofline.py"), "w") as f:
        f.write(f"from gpubench import rooflines\n\nROOT = {root!r}\n\n"
                "def read(run):\n    return rooflines.read(run, 'fake_kernel', ROOT)\n")
    with open(os.path.join(bench, "reference", "methods", "fake_method.py"), "w") as f:
        f.write("def expected(options, chrom_id, chrom_table, pos, counts, dtype=None):\n"
                "    return ('fake', options['method'], len(pos))\n")
    spec = harness.load_spec(root)
    spec["configs"].append({"name": "fake-config", "source": "a test", "file": "gpubench/configs/fake-config.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "fake.cell", "config": "fake-config", "traffic": "fake_traffic",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "fake.requests_pct", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "engine", "moves": "sites_per_s",
                              "workloads": ["fake.cell"]})

    cell = harness.find_cell(spec, "fake.cell", root)
    assert cell["config"]["options"] == {"method": "local"} and cell["traffic"]["sites"] == 10
    names = [m["name"] for m in harness.cell_metrics(spec, "fake.cell", True)]
    assert names == ["fake.requests_pct"]
    assert [m["name"] for m in harness.cell_metrics(spec, "fake.cell", False)] == ["sites_per_s", "setup_s"]
    run = harness.Run({"total": 1.0}, [0.5, 0.5], 1.0, 10)
    assert harness.reader("fake.requests_pct", root)(run) == 50.0
    # the fake roofline model's function is wrapped, its calls recorded, and its metric read
    port = types.ModuleType("gpubench_fake_port")
    port.kernel = lambda rows: rows + 1
    monkeypatch.setitem(sys.modules, "gpubench_fake_port", port)
    with harness.recording(run, root):
        assert port.kernel(3) == 4 and port.kernel(5) == 6
    assert port.kernel(7) == 8 and run.calls["fake_kernel"] == [3, 5]
    run.device = {"kernels": {"fake_kernel": [2, 1e-9]}}
    assert harness.reader("fake_kernel_roofline", root)(run) == rooflines.share(64, 16, 1e-9)
    # and a new method's reference is found by its name
    assert check.expected({"method": "fake_method"}, [0], [b"c"], [1, 2], None, root=root) == ("fake", "fake_method", 2)
    # the cells already there report what they did
    assert "fake.requests_pct" not in [m["name"] for m in harness.cell_metrics(spec, "local.chrom17M", True)]
