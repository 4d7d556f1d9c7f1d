"""The Lynch kernels' arithmetic and reduction, compiled for the host, vs torch.

``sid_tpu_torch/csrc/lynch.cuh`` holds the per-profile expressions, the
long-double range screen and the fixed-order reduction that the card runs;
``lynch_host.cpp`` loops them over arrays and runs the objective's chunks in
the order a grid of a given size would. Built here with g++ (contraction off,
like nvcc --fmad=false) and held against the plain torch f64 versions:
identical non-finite positions and flags, finite values within 1e-12
relative (only the exp/log implementations differ: glibc here, torch's on
the CPU), and a sum that does not change with the number of blocks.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu_torch.ops import likelihoods as lk  # noqa: E402
from sid_tpu_torch.ops import lynch_objective  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from sid_tpu_torch.ops.profiles import nucleotide_distribution  # noqa: E402
from test_torch_local_classify import assert_agree  # noqa: E402
from test_torch_lynch import THETAS, lynch_profiles  # noqa: E402

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sid_tpu_torch", "csrc"
)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = str(tmp_path_factory.mktemp("shim") / "liblynch_host.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, os.path.join(CSRC, "lynch_host.cpp")],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sid_lynch_chunk_rows_host.restype = ctypes.c_int
    lib.sid_lynch_chunk_rows_host.argtypes = []
    lib.sid_lynch_rows_host.restype = None
    lib.sid_lynch_rows_host.argtypes = [p, p, p, ctypes.c_int, i64, p, p, p, p, p]
    lib.sid_lynch_nll_host.restype = None
    lib.sid_lynch_nll_host.argtypes = [p, p, p, p, ctypes.c_int, i64, ctypes.c_int, p, p]
    return lib


@pytest.fixture(scope="module")
def data():
    prof, mult = lynch_profiles()
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    return prof, mult, tab, nucleotide_distribution(prof, mult)


def run_rows(lib, prof, s, tab):
    u = prof.shape[0]
    outs = [np.empty(u) for _ in range(3)] + [np.empty(u, np.uint8) for _ in range(2)]
    tab = tab.numpy()
    lib.sid_lynch_rows_host(
        prof.ctypes.data, s.ctypes.data, tab.ctypes.data, tab.shape[0], u,
        *[o.ctypes.data for o in outs],
    )
    return outs


def run_nll(lib, prof, mult, s, tab, grid):
    u = prof.shape[0]
    flags = np.empty(u, np.uint8)
    out = np.empty(2)
    tab = tab.numpy()
    lib.sid_lynch_nll_host(
        prof.ctypes.data, mult.ctypes.data, s.ctypes.data, tab.ctypes.data,
        tab.shape[0], u, grid, flags.ctypes.data, out.ctypes.data,
    )
    return out, flags


def test_chunk_is_the_packages(shim):
    assert shim.sid_lynch_chunk_rows_host() == lk.CHUNK_ROWS


@pytest.mark.parametrize("theta", [t for t in THETAS if 0 <= t[0] <= 1 and 0 <= t[1] <= 1])
def test_rows_match_plain(shim, data, theta):
    prof, _, tab, nt = data
    s = lk.lynch_scalars(theta[0], theta[1], nt)
    got = run_rows(shim, prof, s, tab)
    want = lk.lynch_rows(torch.from_numpy(prof), s, tab)
    for a, b in zip(got[:3], want[:3]):
        assert_agree(a, b.numpy(), 1e-12)
    assert np.array_equal(got[3], want.flag_marginals.numpy())
    assert np.array_equal(got[4], want.flag_mixture.numpy())


@pytest.mark.parametrize("theta", [(1e-3, 1e-3), (0.05, 0.01), (0.5, 0.999)])
def test_objective_reduction_matches_plain(shim, data, theta):
    prof, mult, tab, nt = data
    s = lk.lynch_scalars(theta[0], theta[1], nt)
    got, flags = run_nll(shim, prof, mult, s, tab, grid=3)
    want, want_flags = lynch_objective.lynch_compound_nll_ref(
        torch.from_numpy(prof), torch.from_numpy(mult), s, tab
    )
    assert np.array_equal(flags, want_flags.numpy())
    assert got[1] == float(want[1]) == float(flags.sum()) >= 4  # the deep rows
    assert abs(got[0] - float(want[0])) <= 1e-12 * abs(float(want[0]))


@pytest.mark.parametrize("u", [1, 1024, 5000, 70_000])
def test_sum_does_not_change_with_the_number_of_blocks(shim, u):
    rng = np.random.default_rng(u)
    prof = rng.multinomial(30, [0.94, 0.03, 0.02, 0.01], u).astype(np.int32)
    mult = rng.integers(1, 1000, u).astype(np.int64)
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    s = lk.lynch_scalars(0.01, 0.01, nucleotide_distribution(prof, mult))
    results = [run_nll(shim, prof, mult, s, tab, grid)[0] for grid in (1, 2, 7, 64, 1000)]
    assert all(np.array_equal(r, results[0]) for r in results)
