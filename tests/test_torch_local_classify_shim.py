"""The CUDA kernel's per-profile arithmetic, compiled for the host, vs torch.

``sid_tpu_torch/csrc/local_classify.cuh`` holds the expressions the card
runs; ``local_classify_host.cpp`` loops them over arrays. Built here with
g++ (contraction off, like nvcc --fmad=false) and held against the plain
torch f64 version with the parity tolerance of the kernel: identical
non-finite positions, finite values within 1e-12 relative. Only the log
implementations differ (glibc here, libdevice on the card).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu_torch.models.common import (  # noqa: E402
    LONG_DOUBLE_UNDERFLOW_LOG,
    major_allele_indices_np,
)
from sid_tpu_torch.ops import local_classify  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from test_torch_local_classify import (  # noqa: E402
    THRESHOLDS,
    adversarial_profiles,
    assert_agree,
    bulk_profiles,
)

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sid_tpu_torch", "csrc"
)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = str(tmp_path_factory.mktemp("shim") / "liblocal_classify_host.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, os.path.join(CSRC, "local_classify_host.cpp")],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p = ctypes.c_void_p
    lib.sid_local_classify_host.restype = None
    lib.sid_local_classify_host.argtypes = [
        p, p, p, ctypes.c_double, p, ctypes.c_int, p, p, ctypes.c_int64,
    ]
    lib.sid_long_double_underflow_log.restype = ctypes.c_double
    lib.sid_long_double_underflow_log.argtypes = []
    return lib


def run_shim(lib, prof, major, second, thr, tab):
    u = prof.shape[0]
    l1 = np.empty(u, np.float64)
    l2 = np.empty(u, np.float64)
    lib.sid_local_classify_host(
        prof.ctypes.data, major.ctypes.data, second.ctypes.data, thr,
        tab.ctypes.data, tab.shape[0], l1.ctypes.data, l2.ctypes.data, u,
    )
    return l1, l2


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("make", [adversarial_profiles, bulk_profiles])
def test_shim_matches_plain(shim, make, thr):
    prof = np.ascontiguousarray(make(), np.int32)
    major, second = major_allele_indices_np(prof)
    tab_t = lgamma_table(int(prof.sum(-1).max()), "cpu")
    got = run_shim(shim, prof, major, second, thr, tab_t.numpy())
    want = local_classify.local_log_likelihoods_ref(
        torch.from_numpy(prof), torch.from_numpy(major), torch.from_numpy(second),
        thr, tab_t,
    )
    for a, b in zip(got, want):
        assert_agree(a, b.numpy(), 1e-12)


def test_shim_underflow_line_is_the_packages(shim):
    assert shim.sid_long_double_underflow_log() == LONG_DOUBLE_UNDERFLOW_LOG


def test_shim_table_overrun_gives_nan(shim):
    # a coverage past the table reads no memory outside it
    prof = np.array([[5, 0, 0, 0]], np.int32)
    idx = np.zeros(1, np.int32)
    tab = np.zeros(4, np.float64)
    l1, l2 = run_shim(shim, prof, idx, idx, 0.1, tab)
    assert np.isnan(l1[0]) and np.isnan(l2[0])
