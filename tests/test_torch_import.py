"""sid_tpu_torch never imports JAX or the sid_tpu package.

Importing any sid_tpu module imports jax, turns on x64 and makes an XLA cache
directory; the port must stand on torch, numpy and scipy alone.
"""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sid_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import sid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sid_tpu_torch.__path__, "sid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "sid_tpu" or m.startswith("sid_tpu."))
print(len(names), bad)
"""


def _sources():
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for name in files:
            yield os.path.join(root, name)


def test_import_loads_no_jax_and_no_sid_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 20  # every module of the slice was imported
    assert bad == "[]", bad


def test_sources_name_no_jax_and_no_sid_tpu_import():
    pattern = re.compile(
        r"^\s*(import\s+jax|from\s+jax|import\s+sid_tpu(?!_torch)\b|from\s+sid_tpu(?!_torch)\b)",
        re.M,
    )
    offenders = []
    for path in _sources():
        with open(path, encoding="utf-8", errors="replace") as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
