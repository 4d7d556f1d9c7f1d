"""The CUDA kernel's per-profile arithmetic, compiled for the host, vs torch.

``sid_tpu_torch/csrc/local_classify.cuh`` holds the expressions the card
runs; ``local_classify_host.cpp`` loops them over arrays, and its
``sid_local_classify_rows_host`` is the kernel's row loop (counts as four
uint16 in, top-2, range flag, byte out, the table's head read from a copy as
the kernel reads it from shared memory). Built here with g++ (contraction
off, like nvcc --fmad=false) and held against the plain torch f64 version:
the byte bitwise; l1 and l2 with the parity tolerance of the kernel
(identical non-finite positions, finite values within 1e-12 relative), since
only the log implementations differ (glibc here, libdevice on the card),
and bitwise against the same expressions reading the table from global
memory alone.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu_torch.models import common  # noqa: E402
from sid_tpu_torch.models.common import (  # noqa: E402
    LONG_DOUBLE_UNDERFLOW_LOG,
    major_allele_indices_np,
)
from sid_tpu_torch.models import local  # noqa: E402
from sid_tpu_torch.ops import local_classify, stats  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from test_torch_local_classify import (  # noqa: E402
    SCREEN_PRIORS,
    SCREEN_THRESHOLDS,
    THRESHOLDS,
    adversarial_profiles,
    assert_agree,
    bulk_profiles,
    deep_screen_profiles,
    tie_profiles,
)
from test_torch_lrt import assert_pvalues_close  # noqa: E402

# the plain version's logs are torch's and the shim's glibc's (1e-12 on l1,
# l2, measured below 2.4e-13), and erfc's slope turns a log's last bits into
# up to ~1e-11 of a small p-value: the B5 p-values of the two are held to
# the likelihoods' tolerance, not the erfc's
RTOL_LIKELIHOOD = 1e-10

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sid_tpu_torch", "csrc"
)
# csrc/local_classify.cu kTabHead: table entries the kernel stages in shared memory
TAB_HEAD = 1024


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
    lib.sid_local_classify_rows_host.restype = None
    lib.sid_local_classify_rows_host.argtypes = [
        p, ctypes.c_int64, p, ctypes.c_int, p, ctypes.c_int, p, ctypes.c_int, p,
    ]
    lib.sid_local_classify_lrt_rows_host.restype = None
    lib.sid_local_classify_lrt_rows_host.argtypes = [
        p, ctypes.c_int64, p, ctypes.c_int, p, ctypes.c_int, p, ctypes.c_int, p, ctypes.c_int, p,
    ]
    lib.sid_lrt_pair_one_erfc_host.restype = None
    lib.sid_lrt_pair_one_erfc_host.argtypes = [p, p, ctypes.c_int64, p, p]
    lib.sid_lrt_pvalue_pairs_host.restype = None
    lib.sid_lrt_pvalue_pairs_host.argtypes = [p, p, ctypes.c_int64, p]
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


def run_rows(lib, counts, thr, prior, tab, head_len=TAB_HEAD):
    """The kernel's row loop on the host: (l1, l2, packed). The head is the
    table's first head_len entries and a NaN after them, so a read past the
    head shows."""
    counts = np.ascontiguousarray(counts, np.uint16)
    u = counts.shape[0]
    head_len = min(head_len, tab.shape[0])
    head = np.append(tab[:head_len], np.nan)
    every, k, pr = common.long_double_screen(thr, prior)
    params = np.array([thr, common.LN4, k, pr, common.LD_LOG_MAX, -common.LD_LOG_MIN], np.float64)
    out = np.empty(17 * u, np.uint8)
    lib.sid_local_classify_rows_host(
        counts.ctypes.data, u, params.ctypes.data, int(every), tab.ctypes.data,
        tab.shape[0], head.ctypes.data, head_len, out.ctypes.data,
    )
    return out[: 8 * u].view(np.float64), out[8 * u : 16 * u].view(np.float64), out[16 * u :]


def run_lrt_rows(lib, counts, thr, prior, alpha, tab, head_len=TAB_HEAD):
    """B5's row loop on the host (local_classify_lrt_kernel): (p1, p2, packed)."""
    counts = np.ascontiguousarray(counts, np.uint16)
    u = counts.shape[0]
    head_len = min(head_len, tab.shape[0])
    head = np.append(tab[:head_len], np.nan)
    every, k, pr = common.long_double_screen(thr, prior)
    params = np.array([thr, common.LN4, k, pr, common.LD_LOG_MAX, -common.LD_LOG_MIN], np.float64)
    lp_hom, lp_het, alpha, use_prior = local_classify.lrt_constants(prior, alpha)
    lrt = np.array([lp_hom, lp_het, alpha], np.float64)
    out = np.empty(17 * u, np.uint8)
    lib.sid_local_classify_lrt_rows_host(
        counts.ctypes.data, u, params.ctypes.data, int(every), lrt.ctypes.data, int(use_prior),
        tab.ctypes.data, tab.shape[0], head.ctypes.data, head_len, out.ctypes.data,
    )
    return out[: 8 * u].view(np.float64), out[8 * u : 16 * u].view(np.float64), out[16 * u :]


def plain(counts, thr, prior, tab_t):
    got = local_classify.local_classify_ref(
        torch.from_numpy(np.ascontiguousarray(counts, np.uint16)), thr, prior, tab_t
    )
    return tuple(t.numpy() for t in got)


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


def test_tab_head_is_the_kernels():
    with open(os.path.join(CSRC, "local_classify.cu")) as f:
        assert re.search(r"constexpr int kTabHead = (\d+);", f.read()).group(1) == str(TAB_HEAD)


def test_shim_underflow_line_is_the_packages(shim):
    assert shim.sid_long_double_underflow_log() == LONG_DOUBLE_UNDERFLOW_LOG


def test_shim_table_overrun_gives_nan(shim):
    # a coverage past the table reads no memory outside it
    prof = np.array([[5, 0, 0, 0]], np.int32)
    idx = np.zeros(1, np.int32)
    tab = np.zeros(4, np.float64)
    l1, l2 = run_shim(shim, prof, idx, idx, 0.1, tab)
    assert np.isnan(l1[0]) and np.isnan(l2[0])


@pytest.mark.parametrize("head_len", [0, 7, TAB_HEAD])
@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("make", [adversarial_profiles, bulk_profiles, tie_profiles])
def test_shim_rows_match_plain(shim, make, thr, head_len):
    counts = make()
    tab_t = lgamma_table(int(counts.astype(np.int64).sum(-1).max()), "cpu")
    tab = tab_t.numpy()
    l1, l2, packed = run_rows(shim, counts, thr, 1e-3, tab, head_len)
    p1, p2, p_packed = plain(counts, thr, 1e-3, tab_t)
    assert np.array_equal(packed, p_packed)
    assert_agree(l1, p1, 1e-12)
    assert_agree(l2, p2, 1e-12)
    # the staged head changes no bit: the same expressions on the global table
    prof = counts.astype(np.int32)
    major, second = major_allele_indices_np(prof)
    g1, g2 = run_shim(shim, prof, major, second, thr, tab)
    assert np.array_equal(l1.view(np.uint64), g1.view(np.uint64))
    assert np.array_equal(l2.view(np.uint64), g2.view(np.uint64))


def test_shim_rows_read_both_sides_of_the_cut(shim):
    # table indices just below, at and above the head's end, in one row and
    # across rows: every index below the cut from the head, every other from
    # the table, and the same bits as reading the table alone
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 700, (4000, 4)).astype(np.uint16)
    counts[:200, 0] = rng.integers(TAB_HEAD - 3, TAB_HEAD + 3, 200)
    cov = counts.astype(np.int64).sum(-1)
    assert (cov + 1 < TAB_HEAD).any() and (cov + 1 >= TAB_HEAD).any()
    assert np.isin(counts[:, 0].astype(np.int64) + 1, [TAB_HEAD - 1, TAB_HEAD]).any()
    tab = lgamma_table(int(cov.max()), "cpu").numpy()
    staged = run_rows(shim, counts, 0.1, 1e-3, tab)
    flat = run_rows(shim, counts, 0.1, 1e-3, tab, head_len=0)
    for a, b in zip(staged, flat):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert np.isfinite(staged[0]).all() and np.isfinite(staged[1]).all()


@pytest.mark.parametrize("prior", SCREEN_PRIORS)
@pytest.mark.parametrize("thr", SCREEN_THRESHOLDS)
def test_shim_rows_flags_match_long_double_range_rows(shim, thr, prior):
    counts = deep_screen_profiles()
    tab = lgamma_table(int(counts.astype(np.int64).sum(-1).max()), "cpu").numpy()
    packed = run_rows(shim, counts, thr, prior, tab)[2]
    major, second, flags = local_classify.unpack(packed)
    want = local.long_double_range_rows(counts.astype(np.int64).sum(-1), thr, prior)
    assert np.array_equal(flags, want)
    want_major, want_second = major_allele_indices_np(counts.astype(np.int32))
    assert np.array_equal(major, want_major) and np.array_equal(second, want_second)


LRT_PRIORS = [-1.0, 0.0, 1e-3, 0.999]


@pytest.mark.parametrize("prior", LRT_PRIORS)
@pytest.mark.parametrize("thr", [0.1, 1.0])
@pytest.mark.parametrize("make", [adversarial_profiles, bulk_profiles, tie_profiles])
def test_lrt_rows_are_bitwise_b1_rows_and_the_host_lrt(shim, make, thr, prior):
    """B5's row is B1's row then the host path's tail: its byte's bits 0-4
    are B1's; with glibc's log and erfc both ways, p1 and p2 are bitwise the
    host libm LRT over B1's (l1, l2) plus the glibc prior, and is_het
    (bit 5) is l2 > l1 and p2 < alpha."""
    counts = np.ascontiguousarray(make(), np.uint16)
    tab = lgamma_table(int(counts.astype(np.int64).sum(-1).max()), "cpu").numpy()
    l1, l2, b1 = run_rows(shim, counts, thr, prior, tab)
    p1, p2, b5 = run_lrt_rows(shim, counts, thr, prior, 0.05, tab)
    assert np.array_equal(b5 & 31, b1)
    if prior > 0:
        l1 = l1 + np.log(np.float64(1.0 - prior))
        l2 = l2 + np.log(np.float64(prior))
    want1 = stats.lrt_pvalue_from_logs_np(l2, l1)
    want2 = stats.lrt_pvalue_from_logs_np(l1, l2)
    assert np.array_equal(p1.view(np.uint64), want1.view(np.uint64))
    assert np.array_equal(p2.view(np.uint64), want2.view(np.uint64))
    with np.errstate(invalid="ignore"):
        assert np.array_equal(local_classify.het_flags(b5), (l2 > l1) & (want2 < 0.05))
    # and the plain version's: the same bytes, p-values by the device-LRT tolerance
    q1, q2, qb = local_classify.local_classify_lrt_ref(
        torch.from_numpy(counts), thr, prior, 0.05, torch.from_numpy(tab))
    assert np.array_equal(qb.numpy() & 31, b1)
    assert_pvalues_close(q1.numpy(), p1, RTOL_LIKELIHOOD)
    assert_pvalues_close(q2.numpy(), p2, RTOL_LIKELIHOOD)


def test_lrt_rows_table_overrun_gives_nan_pvalues(shim):
    counts = np.array([[5, 3, 0, 0], [1000, 7, 0, 0]], np.uint16)
    tab = lgamma_table(8, "cpu").numpy()[:10]
    p1, p2, _ = run_lrt_rows(shim, counts, 0.1, -1.0, 0.05, tab)
    assert np.isfinite(p1[0]) and np.isnan(p1[1]) and np.isnan(p2[1])


# every pair of these logs, both ways: zeros of both signs, +-1, the
# f64 exp's underflow, a tiny positive and a huge negative, +-inf and NaN of
# both signs
PAIR_LOGS = np.array([0.0, -0.0, 1.0, -1.0, -745.0, 1e-300, -1e300, np.inf, -np.inf, np.nan, -np.nan])


@pytest.mark.parametrize("prior", [None, 1e-3, 0.999])
def test_one_erfc_tail_is_bitwise_the_two_lrt_pvalues(shim, prior):
    """B5's tail with one erfc (lrt_pair_arg, lrt_pair_from) is bitwise
    (lrt_pvalue(l2, l1), lrt_pvalue(l1, l2)) under glibc, NaN bits
    included: both logs +inf (d NaN) gives NaN on both sides, -inf gives 0."""
    lib = shim
    l1, l2 = (np.ascontiguousarray(a.ravel()) for a in np.meshgrid(PAIR_LOGS, PAIR_LOGS))
    l1 = np.concatenate([l1, np.random.default_rng(5).normal(-50, 30, 2000)])
    l2 = np.concatenate([l2, np.random.default_rng(6).normal(-50, 30, 2000)])
    if prior is not None:
        with np.errstate(invalid="ignore"):
            l1 = np.where(np.isnan(l1), l1, l1 + np.log(np.float64(1.0 - prior)))
            l2 = np.where(np.isnan(l2), l2, l2 + np.log(np.float64(prior)))
    n = l1.size
    p1, p2, w1, w2 = (np.empty(n) for _ in range(4))
    lib.sid_lrt_pair_one_erfc_host(l1.ctypes.data, l2.ctypes.data, n, p1.ctypes.data, p2.ctypes.data)
    lib.sid_lrt_pvalue_pairs_host(l2.ctypes.data, l1.ctypes.data, n, w1.ctypes.data)
    lib.sid_lrt_pvalue_pairs_host(l1.ctypes.data, l2.ctypes.data, n, w2.ctypes.data)
    assert np.array_equal(p1.view(np.uint64), w1.view(np.uint64))
    assert np.array_equal(p2.view(np.uint64), w2.view(np.uint64))
    both_inf = (l1 == np.inf) & (l2 == np.inf)
    assert both_inf.any() and np.isnan(p1[both_inf]).all() and np.isnan(p2[both_inf]).all()
    assert (p2[l1 == -np.inf] == 0).all() and (p1[l2 == -np.inf] == 0).all()
