"""The port builds its libraries from its own sources.

``sid_tpu_torch/native/build.py`` compiles libsidtpu.so from the port's copy
of sid_tpu's host C++ (``csrc/host``) and each kernel library from
``csrc``; nothing it builds from lies outside ``sid_tpu_torch/``. The copies
must stay byte-equal to ``sid_tpu/native/``'s, line for line, so any drift
between the two packages' host code shows here. The one edit: the fourth
line of parser.cpp, a comment, names the reference parser without the
location of the machine it was read on.
"""

import os

import pytest

pytest.importorskip("torch")

from sid_tpu_torch.native import build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sid_tpu_torch")
# file -> the comment lines (0-based) the copy words differently
EDITED_COMMENTS = {"parser.cpp": {3}}


def _inside_port(path):
    return os.path.commonpath([os.path.realpath(path), os.path.realpath(PKG)]) == os.path.realpath(PKG)


def test_host_library_builds_from_the_port_alone():
    assert build.HOST_SRC in build.HOST_DEPS
    sources = [a for a in build._host_cmd("OUT") if a.endswith((".cpp", ".cc", ".c"))]
    assert sources == [build.HOST_SRC]
    for path in build.HOST_DEPS:
        assert os.path.isfile(path), path
        assert _inside_port(path), path


@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_kernel_library_builds_from_the_port_alone(name):
    deps = build.kernel_deps(name)
    assert deps[0].endswith(f"{name}.cu")
    for path in deps:
        assert os.path.isfile(path), path
        assert _inside_port(path), path


@pytest.mark.parametrize("name", ["parser.cpp", "fmt_g_pow10.h"])
def test_host_sources_are_byte_equal_to_sid_tpu(name):
    with open(os.path.join(REPO, "sid_tpu", "native", name), "rb") as f:
        want = f.read().splitlines(keepends=True)
    with open(os.path.join(PKG, "csrc", "host", name), "rb") as f:
        got = f.read().splitlines(keepends=True)
    assert len(got) == len(want), f"csrc/host/{name} and sid_tpu/native/{name} differ in length"
    differ = {i for i, (a, b) in enumerate(zip(got, want)) if a != b}
    assert differ <= EDITED_COMMENTS.get(name, set()), (
        f"csrc/host/{name} differs from sid_tpu/native/{name} at lines {sorted(i + 1 for i in differ)}"
    )
    assert all(got[i].startswith(b"//") and want[i].startswith(b"//") for i in differ)


@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_kernel_deps_name_every_header_the_source_includes(name):
    """A header left out of KERNELS would not rebuild its library when it
    changes: every quoted include, followed through the headers, is a dep."""
    import re

    deps = {os.path.basename(p) for p in build.kernel_deps(name)}
    todo, seen = [f"{name}.cu"], set()
    while todo:
        src = todo.pop()
        if src in seen:
            continue
        seen.add(src)
        with open(os.path.join(build.CSRC, src)) as f:
            todo += re.findall(r'^#include "([^"]+)"', f.read(), re.M)
    assert seen == deps, (sorted(seen), sorted(deps))
