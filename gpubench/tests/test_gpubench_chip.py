"""Each cell once on the card, short: correct, with its metrics. Needs a
CUDA card; skips without one."""

import json
import os
import subprocess
import sys

import pytest

from gpubench import harness


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in harness.load_spec()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", workload, "--seed", "7",
                          "--seconds", "3", "--trace", str(trace)], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=360, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    wanted = {m["name"] for m in harness.cell_metrics(harness.load_spec(), workload, bool(trace))}
    assert set(result["metrics"]) == wanted
