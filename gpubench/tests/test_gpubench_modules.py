"""What a run may load: no JAX and nothing of the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""

import os
import shutil
import subprocess
import sys

import pytest

from gpubench import harness

ROOT = harness.ROOT


@pytest.mark.parametrize("names, found", [
    (["sid_tpu_torch", "sid_tpu_torch.engine", "numpy.linalg", "torch"], []),
    (["sid_tpu", "sid_tpu_torch"], ["sid_tpu"]),
    (["sid_tpu.models.local"], ["sid_tpu"]),
    (["jax._src.api", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jax_utils", "sid_tpu_tools", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def _python(code, cwd=ROOT):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_the_run_loads_no_jax():
    code = ("import sys; from gpubench import harness, trace, control; "
            "from gpubench.reference import check, pileup; from sid_tpu_torch import engine; "
            "from sid_tpu_torch.models import likelihood_ratio, local; "
            "print(harness.forbidden_modules(sys.modules))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; from gpubench.reference import calls, check, nmsimplex, pileup; "
            "from gpubench.traffic import generate; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('sid_tpu_torch', 'sid_tpu', 'torch')))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    args = ["-m", "gpubench.run", "--workload", "local.chrom17M", "--seed", "1", "--seconds", "1"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, *args], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
