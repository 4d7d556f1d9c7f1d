"""The device LRT's and BH's arithmetic, compiled for the host.

``sid_tpu_torch/csrc/lrt.cuh`` and ``lrt_bh.cuh`` hold the expressions the
card runs; ``lrt_bh_host.cpp`` loops them over arrays. Built here with g++
(contraction off, like nvcc --fmad=false), where erfc is glibc's:

- ``sid::lrt_pvalue`` is bitwise libsidtpu's ``sidtpu_lrt_pvalues`` (the
  host path), NaN bits included;
- the LRT kernel's row (clamp, -R prior, both p-values) is bitwise the host
  path's composition (numpy clamp and prior, ``sidtpu_lrt_pvalues``);
- the BH scan walked as the kernels split it (tiles of threads x items
  positions: one tile, three tiles, many tiles) is bitwise the host BH.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu_torch.models import common  # noqa: E402
from sid_tpu_torch.models.common import LONG_DOUBLE_UNDERFLOW_LOG  # noqa: E402
from sid_tpu_torch.ops import stats  # noqa: E402
from test_torch_lrt import bits, log_pairs, marginals  # noqa: E402

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sid_tpu_torch", "csrc"
)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = str(tmp_path_factory.mktemp("shim") / "liblrt_bh_host.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, os.path.join(CSRC, "lrt_bh_host.cpp")],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sid_lrt_pvalue_host.restype = None
    lib.sid_lrt_pvalue_host.argtypes = [p, p, i64, p]
    lib.sid_lrt_pvalues_host.restype = None
    lib.sid_lrt_pvalues_host.argtypes = [p, p, i64, p, i32, p, p]
    lib.sid_bh_adjust_host.restype = None
    lib.sid_bh_adjust_host.argtypes = [p, p, i64, i32, i32, ctypes.c_double, p, p]
    return lib


def _ptr(a):
    return a.ctypes.data


def test_lrt_pvalue_is_bitwise_sidtpu_lrt_pvalues(shim):
    l0, l1 = log_pairs(n=20000, seed=2)
    out = np.empty_like(l0)
    shim.sid_lrt_pvalue_host(_ptr(l0), _ptr(l1), l0.size, _ptr(out))
    want = stats.lrt_pvalue_from_logs_np(l0, l1)
    assert np.array_equal(bits(out), bits(want))
    assert np.signbit(out[60]) and np.isnan(out[60])  # the negative NaN kept


@pytest.mark.parametrize("pi", [None, 0.02, 0.0])
def test_lrt_row_is_bitwise_the_host_path(shim, pi):
    lhom, lhet = marginals(n=5000, seed=3)
    lhom[200], lhet[201] = -np.float64(np.nan), np.nan
    log_priors = None if pi is None else stats.prior_logs(pi)
    lp = log_priors or (0.0, 0.0)
    params = np.array([LONG_DOUBLE_UNDERFLOW_LOG, lp[0], lp[1]])
    p1, p2 = np.empty_like(lhom), np.empty_like(lhom)
    shim.sid_lrt_pvalues_host(_ptr(lhom), _ptr(lhet), lhom.size, _ptr(params), int(log_priors is not None),
                              _ptr(p1), _ptr(p2))
    # models/likelihood_ratio.py's host path, operation for operation
    with np.errstate(divide="ignore", invalid="ignore"):
        hom = common.clamp_ld_underflow_np(lhom)
        het = common.clamp_ld_underflow_np(lhet)
        if pi is not None:
            het = common.clamp_ld_underflow_np(het + np.log(np.float64(pi)))
            hom = common.clamp_ld_underflow_np(hom + np.log(np.float64(1.0 - pi)))
    assert np.array_equal(bits(p1), bits(stats.lrt_pvalue_from_logs_np(het, hom)))
    assert np.array_equal(bits(p2), bits(stats.lrt_pvalue_from_logs_np(hom, het)))
    only = np.empty_like(lhom)
    shim.sid_lrt_pvalues_host(_ptr(lhom), _ptr(lhet), lhom.size, _ptr(params), int(log_priors is not None),
                              _ptr(only), None)
    assert np.array_equal(bits(only), bits(p1))


def bh_input(m, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, m)
    p[rng.integers(0, m, max(1, m // 5))] = 0.5
    p[rng.integers(0, m, max(1, m // 40))] = 0.0
    p[rng.integers(0, m, max(1, m // 40))] = 1.0
    p[rng.integers(0, m, max(1, m // 100))] = np.nan
    return p


@pytest.mark.parametrize("threads, items", [(256, 8), (64, 5), (4, 3), (1, 1), (7, 64)])
@pytest.mark.parametrize("m", [1, 2, 1000, 4093])
def test_bh_walk_over_split_grids_is_the_host_bh(shim, m, threads, items):
    """One tile (m <= threads x items), three tiles and many: the same
    bits, and is_het = adjusted < alpha."""
    p = bh_input(m, seed=m)
    order = np.ascontiguousarray(np.argsort(-p, kind="stable"))
    out = np.empty(m)
    het = np.empty(m, np.uint8)
    shim.sid_bh_adjust_host(_ptr(p), _ptr(order), m, threads, items, 0.05, _ptr(out), _ptr(het))
    want = stats.adjust_benjamini_hochberg_np(p)
    assert np.array_equal(bits(out), bits(want))
    with np.errstate(invalid="ignore"):
        assert np.array_equal(het.astype(bool), want < 0.05)
    assert np.array_equal(stats.bh_order(torch.from_numpy(p)).numpy(), order)


def test_bh_walk_splits_as_described(shim):
    """The split of the largest case: 4093 positions in tiles of 4 x 3
    give 342 tiles, of 256 x 8 two, of 7 x 64 ten; the kernels' launches
    follow the tiles (one pass for one tile, three otherwise)."""
    tiles = {(t, i): -(-4093 // (t * i)) for t, i in ((4, 3), (256, 8), (7, 64))}
    assert tiles == {(4, 3): 342, (256, 8): 2, (7, 64): 10}
    assert stats.bh_launches(2048) == 1 and stats.bh_launches(2049) == 3 and stats.bh_launches(0) == 0


def test_bh_threads_are_the_kernels():
    import re

    with open(os.path.join(CSRC, "lrt_bh.cu")) as f:
        assert re.search(r"constexpr int kThreads = (\d+);", f.read()).group(1) == str(stats.BH_THREADS)
