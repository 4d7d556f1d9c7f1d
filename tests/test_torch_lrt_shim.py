"""The device LRT's and BH's arithmetic, compiled for the host.

``sid_tpu_torch/csrc/lrt.cuh`` and ``lrt_bh.cuh`` hold the expressions the
card runs; ``lrt_bh_host.cpp`` loops them over arrays. Built here with g++
(contraction off, like nvcc --fmad=false), where erfc is glibc's:

- ``sid::lrt_pvalue`` is bitwise libsidtpu's ``sidtpu_lrt_pvalues`` (the
  host path), NaN bits included;
- the LRT kernel's row (clamp, -R prior, both p-values) is bitwise the host
  path's composition (numpy clamp and prior, ``sidtpu_lrt_pvalues``), in
  its two-erfc form and as the kernel walks it: one erfc a row, a
  grid-stride loop over a few threads, every row written once, on every pair of edge values (NaN of both signs, +-inf,
  +-0, equal logs, the 80-bit underflow line and its neighbours) with and
  without the prior and one-sided, at n = 0 to 3 and beyond;
- BH walked as the kernels split it (``csrc/bh_sort.cuh``): the radix
  order's histogram, plan and digit passes over tiles, warps and lanes is
  exactly numpy's stable argsort of -p and ``bh_order``, skipping the
  digits that are the same in every key; the chained scan over tiles with
  its look-back, and the one-block path for one and two arrays, are
  bitwise the host BH.
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
    lib.sid_lrt_pvalues_walk_host.restype = None
    lib.sid_lrt_pvalues_walk_host.argtypes = [p, p, i64, p, i32, p, p, i64, p]
    lib.sid_bh_radix_keys_host.restype = None
    lib.sid_bh_radix_keys_host.argtypes = [p, i64, p]
    lib.sid_bh_p_of_key_host.restype = None
    lib.sid_bh_p_of_key_host.argtypes = [p, i64, p, p]
    lib.sid_bh_radix_order_host.restype = i32
    lib.sid_bh_radix_order_host.argtypes = [p, i64, i32, i32, i32, p]
    lib.sid_bh_scan_host.restype = None
    lib.sid_bh_scan_host.argtypes = [p, p, i64, i32, i32, i32, ctypes.c_double, p, p]
    lib.sid_bh_small_host.restype = i32
    lib.sid_bh_small_host.argtypes = [i32, p, i64, ctypes.c_double, p, p]
    lib.sid_bh_layout_bytes_host.restype = i64
    lib.sid_bh_layout_bytes_host.argtypes = [i64, i32]
    lib.sid_bh_constants_host.restype = None
    lib.sid_bh_constants_host.argtypes = [p]
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


def edge_values(pi=0.02):
    """Edge values of a log likelihood: NaN of both signs, +-inf, -0 and
    +0, a plain value, the 80-bit underflow line and its neighbours, and
    the values that the prior's logs at ``pi`` move onto the line."""
    line = LONG_DOUBLE_UNDERFLOW_LOG
    lp_hom, lp_het = stats.prior_logs(pi)
    return [np.nan, -np.float64(np.nan), np.inf, -np.inf, -0.0, 0.0, -7.25, line, np.nextafter(line, -np.inf),
            np.nextafter(line, np.inf), line - lp_hom, line - lp_het, np.nextafter(line - lp_het, -np.inf)]


def edge_logs(n_bulk=1000, seed=5):
    """(log_l_hom, log_l_het): every pair of edge values (equal logs among
    them), then a bulk of marginals; an odd count."""
    vals = edge_values()
    pairs = np.array([(a, b) for a in vals for b in vals], np.float64)
    hom, het = marginals(n=n_bulk, seed=seed)
    return np.concatenate([pairs[:, 0], hom]), np.concatenate([pairs[:, 1], het])


def some_rows(arrays, n):
    """n rows of each array, spread over it ("edges": all of them)."""
    if n == "edges":
        return arrays
    at = (np.arange(n) * 37) % arrays[0].shape[0]
    return tuple(np.ascontiguousarray(a[at]) for a in arrays)


def lrt_walk(shim, lhom, lhet, log_priors, threads, one_sided=False):
    """lrt_pvalues_kernel's walk on the host: (p1, p2 or None, visits)."""
    n = lhom.shape[0]
    lp = log_priors or (0.0, 0.0)
    params = np.array([LONG_DOUBLE_UNDERFLOW_LOG, lp[0], lp[1]])
    p1, p2 = np.full(n, 7.0), None if one_sided else np.full(n, 7.0)
    visits = np.zeros(n, np.uint8)
    shim.sid_lrt_pvalues_walk_host(_ptr(lhom), _ptr(lhet), n, _ptr(params), int(log_priors is not None), _ptr(p1),
                                   None if one_sided else _ptr(p2), threads, _ptr(visits))
    return p1, p2, visits


# threads of the host replays of the row kernels' grid-stride walks
WALKS = [1, 2, 3, 5, 64]


@pytest.mark.parametrize("pi", [None, 0.02])
@pytest.mark.parametrize("threads", WALKS)
@pytest.mark.parametrize("n", [0, 1, 2, 3, "edges"])
def test_lrt_walk_is_bitwise_the_two_erfc_form_and_the_host_path(shim, n, threads, pi):
    """The kernel's walk (one erfc a row, erfc(0.0) once a thread, a
    grid-stride loop) writes every row once, bitwise the two-erfc form and the host
    path's composition (numpy clamp and prior, sidtpu_lrt_pvalues), on every
    pair of edge values; the one-sided call gives the same p1."""
    lhom, lhet = some_rows(edge_logs(), n)
    log_priors = None if pi is None else stats.prior_logs(pi)
    p1, p2, visits = lrt_walk(shim, lhom, lhet, log_priors, threads)
    assert np.all(visits == 1)
    lp = log_priors or (0.0, 0.0)
    params = np.array([LONG_DOUBLE_UNDERFLOW_LOG, lp[0], lp[1]])
    t1, t2 = np.empty_like(lhom), np.empty_like(lhom)
    shim.sid_lrt_pvalues_host(_ptr(lhom), _ptr(lhet), lhom.size, _ptr(params), int(log_priors is not None),
                              _ptr(t1), _ptr(t2))
    assert np.array_equal(bits(p1), bits(t1)) and np.array_equal(bits(p2), bits(t2))
    with np.errstate(divide="ignore", invalid="ignore"):
        hom = common.clamp_ld_underflow_np(lhom)
        het = common.clamp_ld_underflow_np(lhet)
        if pi is not None:
            het = common.clamp_ld_underflow_np(het + np.log(np.float64(pi)))
            hom = common.clamp_ld_underflow_np(hom + np.log(np.float64(1.0 - pi)))
    assert np.array_equal(bits(p1), bits(stats.lrt_pvalue_from_logs_np(het, hom)))
    assert np.array_equal(bits(p2), bits(stats.lrt_pvalue_from_logs_np(hom, het)))
    only, _, visits = lrt_walk(shim, lhom, lhet, log_priors, threads, one_sided=True)
    assert np.array_equal(bits(only), bits(p1)) and np.all(visits == 1)


def test_edge_logs_cover_the_edges():
    """The edge set reaches every arm of the row: NaN of both signs out,
    p = 0 (a -inf H0), p = 1 (equal logs), p-values past erfc's underflow,
    rows the clamp and the prior send to -inf, and an odd count."""
    lhom, lhet = edge_logs()
    with np.errstate(divide="ignore", invalid="ignore"):
        p2 = stats.lrt_pvalue_from_logs_np(common.clamp_ld_underflow_np(lhom), common.clamp_ld_underflow_np(lhet))
    assert lhom.shape[0] % 2 == 1
    assert np.isnan(p2).sum() > 0 and np.signbit(p2[np.isnan(p2)]).any() and (~np.signbit(p2[np.isnan(p2)])).any()
    assert (p2 == 0).sum() > 0 and (p2 == 1).sum() > 0 and ((p2 > 0) & (p2 < 1)).sum() > 100
    assert (lhom == LONG_DOUBLE_UNDERFLOW_LOG).any() and (lhom == -0.0).any()


def bh_input(m, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, m)
    p[rng.integers(0, m, max(1, m // 5))] = 0.5
    p[rng.integers(0, m, max(1, m // 40))] = 0.0
    p[rng.integers(0, m, max(1, m // 40))] = 1.0
    p[rng.integers(0, m, max(1, m // 100))] = np.nan
    return p


def edge_input(m, seed):
    """bh_input with every edge of the key planted: -0, NaN of both signs,
    +-inf, negatives, subnormals and values above 1."""
    p = bh_input(m, seed)
    rng = np.random.default_rng(seed + 1)
    for v, every in ((-0.0, 30), (-np.nan, 90), (np.inf, 150), (-np.inf, 150), (-0.25, 70),
                     (-1e-300, 200), (5e-324, 200), (1.5, 60), (1e300, 300)):
        p[rng.integers(0, m, max(1, m // every))] = v
    return p


INPUTS = {"ties": bh_input, "edges": edge_input}
# the sort's tile (kSortTile)
TILE = 4096
ORDER_SIZES = [0, 1, TILE - 1, TILE, TILE + 1, 4093, 2**20]


def radix_order(shim, p, bits, threads=256, items=16):
    m = p.shape[0]
    order = np.empty(m, np.uint32)
    passes = shim.sid_bh_radix_order_host(_ptr(p), m, bits, threads, items, _ptr(order))
    return order.astype(np.int64), passes


@pytest.mark.parametrize("kind", list(INPUTS))
@pytest.mark.parametrize("bits", [8, 11])
@pytest.mark.parametrize("m", ORDER_SIZES)
def test_radix_order_is_the_stable_argsort(shim, m, bits, kind):
    """The kernels' order (histogram, plan, digit passes over tiles of
    256 x 16 pairs) is numpy's stable argsort of -p and bh_order's, +-0,
    NaN of both signs, +-inf and negatives included."""
    p = INPUTS[kind](m, seed=m + bits) if m else np.zeros(0)
    order, passes = radix_order(shim, p, bits)
    assert np.array_equal(order, np.argsort(-p, kind="stable"))
    if m:
        assert np.array_equal(stats.bh_order(torch.from_numpy(p)).numpy(), order)
    assert passes <= -(-64 // bits)


@pytest.mark.parametrize("threads, items", [(32, 1), (64, 3), (96, 2)])
@pytest.mark.parametrize("m", [33, 1000, 4093])
def test_radix_order_over_small_tiles_is_the_stable_argsort(shim, m, threads, items):
    """Many tiles, each with a look-back over the ones before it."""
    p = edge_input(m, seed=7 * m)
    for bits in (8, 11):
        assert np.array_equal(radix_order(shim, p, bits, threads, items)[0], np.argsort(-p, kind="stable"))


def test_radix_keys_order_as_the_key(shim):
    """The twiddled key's unsigned order is bh_order's key's float order:
    -inf < negatives < +0 < positives < +inf < NaN, zeros of both signs one
    key and every NaN one key, above every other."""
    p = edge_input(5000, seed=11)
    keys = np.empty(p.shape[0], np.uint64)
    shim.sid_bh_radix_keys_host(_ptr(p), p.shape[0], _ptr(keys))
    with np.errstate(invalid="ignore"):
        key = np.where(np.isnan(p), np.float64(np.nan), np.float64(0.0) - p)
    assert np.array_equal(np.argsort(keys, kind="stable"), np.argsort(key, kind="stable"))
    assert len(set(keys[np.isnan(p)].tolist())) == 1 and len(set(keys[p == 0].tolist())) == 1
    assert np.all(keys[np.isnan(p)] > keys[~np.isnan(p)].max())


@pytest.mark.parametrize("m", [1, 5000])
def test_scan_reads_p_from_the_sorted_key(shim, m):
    """bh_scan_kernel takes p back from the sorted key (bh_p_of_key), bitwise,
    and gathers p itself only for the keys of zeros and NaN, whose sign and
    payload the key dropped."""
    p = edge_input(m, seed=13)
    keys = np.empty(m, np.uint64)
    shim.sid_bh_radix_keys_host(_ptr(p), m, _ptr(keys))
    got = np.full(m, 7.0)
    ok = np.empty(m, np.uint8)
    shim.sid_bh_p_of_key_host(_ptr(keys), m, _ptr(got), _ptr(ok))
    gather = (p == 0) | np.isnan(p)
    assert np.array_equal(ok.astype(bool), ~gather)
    assert np.array_equal(bits(got[~gather]), bits(p[~gather]))


@pytest.mark.parametrize("case, passes8, passes11", [
    ("one value", 0, 0), ("zeros of both signs", 0, 0), ("nan of both signs", 0, 0),
    ("two values", 1, 1), ("low bits", 1, 1), ("both signs", 8, 6),
])
def test_radix_order_skips_the_digits_every_key_shares(shim, case, passes8, passes11):
    """A digit that is the same in every key gets no scatter pass; the
    order is still the stable argsort (the identity where none is left)."""
    m = 10000
    rng = np.random.default_rng(3)
    p = {
        "one value": np.full(m, 0.25),
        "zeros of both signs": np.where(rng.random(m) < 0.5, 0.0, -0.0),
        "nan of both signs": np.where(rng.random(m) < 0.5, np.nan, -np.nan),
        "two values": np.where(rng.random(m) < 0.5, 0.25, 0.5),  # exponents differ: the top digit only
        "low bits": (np.full(m, 0.25).view(np.uint64) + rng.integers(0, 200, m).astype(np.uint64)).view(np.float64),
        "both signs": np.where(rng.random(m) < 0.5, 0.25, -0.25),  # a negative key's bits flip
    }[case]
    for bits, want in ((8, passes8), (11, passes11)):
        order, passes = radix_order(shim, p, bits)
        assert passes == want
        assert np.array_equal(order, np.argsort(-p, kind="stable"))


SCAN_SPLITS = [(256, 16, 0), (256, 4, 0), (32, 1, 3), (64, 3, 1)]


@pytest.mark.parametrize("threads, items, lag", SCAN_SPLITS)
@pytest.mark.parametrize("m", [1, 2, 1000, 4093, TILE + 1])
def test_chained_scan_walk_is_the_host_bh(shim, m, threads, items, lag):
    """bh_scan_kernel's tiles in order, each thread's blocked positions, the
    block's shuffle scan and the look-back (through `lag` tiles that show
    only their aggregates): bitwise adjust_benjamini_hochberg_np, is_het =
    adjusted < alpha; NaN of both signs, +-0 and +-inf included."""
    p = edge_input(m, seed=m + threads)
    order = np.ascontiguousarray(np.argsort(-p, kind="stable"))
    out = np.empty(m)
    het = np.empty(m, np.uint8)
    shim.sid_bh_scan_host(_ptr(p), _ptr(order), m, threads, items, lag, 0.05, _ptr(out), _ptr(het))
    want = stats.adjust_benjamini_hochberg_np(p)
    assert np.array_equal(bits(out), bits(want))
    with np.errstate(invalid="ignore"):
        assert np.array_equal(het.astype(bool), want < 0.05)


@pytest.mark.parametrize("arrays", [1, 2])
@pytest.mark.parametrize("m", [1, 2, 1000, 4093, 8192])
def test_one_block_path_is_the_host_bh(shim, m, arrays):
    """bh_small_kernel's block for each of one or two arrays: the key, the
    8-bit radix passes in shared memory, the block scan: bitwise
    adjust_benjamini_hochberg_np; is_het on the second array only."""
    ps = [edge_input(m, seed=m + a) for a in range(arrays)]
    outs = [np.empty(m) for _ in range(arrays)]
    hets = [np.full(m, 7, np.uint8) for _ in range(arrays)]
    ptrs = (ctypes.c_void_p * 2)(*[_ptr(x) for x in ps] + [None] * (2 - arrays))
    optrs = (ctypes.c_void_p * 2)(*[_ptr(x) for x in outs] + [None] * (2 - arrays))
    hptrs = (ctypes.c_void_p * 2)(None, _ptr(hets[1]) if arrays == 2 else None)
    assert shim.sid_bh_small_host(arrays, ptrs, m, 0.05, optrs, hptrs) >= 0
    for a in range(arrays):
        want = stats.adjust_benjamini_hochberg_np(ps[a])
        assert np.array_equal(bits(outs[a]), bits(want))
    with np.errstate(invalid="ignore"):
        if arrays == 2:
            assert np.array_equal(hets[1].astype(bool), want < 0.05)
    assert np.all(hets[0] == 7)


def test_one_block_path_refuses_more_than_it_holds(shim):
    p = np.zeros(stats.BH_SMALL_MAX + 1)
    out = np.empty_like(p)
    ptrs = (ctypes.c_void_p * 2)(_ptr(p), None)
    optrs = (ctypes.c_void_p * 2)(_ptr(out), None)
    assert shim.sid_bh_small_host(1, ptrs, p.shape[0], 0.05, optrs, (ctypes.c_void_p * 2)(None, None)) == -1


def test_bh_constants_are_the_kernels(shim):
    """The wrapper's tile sizes, limits and digit width are the header's."""
    got = np.empty(5, np.int64)
    shim.sid_bh_constants_host(_ptr(got))
    assert got.tolist() == [stats.BH_SORT_TILE, stats.BH_SCAN_THREADS * stats.BH_ITEMS,
                            stats.BH_SMALL_MAX, 8, stats.BH_BITS]
    assert TILE == stats.BH_SORT_TILE


@pytest.mark.parametrize("m", [8193, 2**20, 2**31 - 1])
def test_bh_scratch_holds_the_pairs_and_the_look_back(shim, m):
    """The scratch covers both 12-byte pair buffers and the look-back words
    of every tile and bin."""
    n = shim.sid_bh_layout_bytes_host(m, 1)
    tiles = -(-m // stats.BH_SORT_TILE)
    assert n >= 24 * m + 8 * tiles * (1 << stats.BH_BITS)
    assert n % 16 == 0


@pytest.mark.parametrize("m", [1, 8193, 2**20, 2**31 - 1])
def test_bh_scratch_of_a_given_order_is_the_scan_state(shim, m):
    """A scan over a given order takes the scan's tile counter and its
    look-back (a flag and two f64 a tile), none of the sort's buffers."""
    n = shim.sid_bh_layout_bytes_host(m, 0)
    tiles = -(-m // (stats.BH_SCAN_THREADS * stats.BH_ITEMS))
    assert 4 + 20 * tiles <= n <= 64 + 20 * tiles
    assert n % 16 == 0


def test_bh_launches_follow_the_paths():
    assert stats.bh_launches(0) == 0
    assert stats.bh_launches(1) == stats.bh_launches(stats.BH_SMALL_MAX) == 1
    assert stats.bh_launches(stats.BH_SMALL_MAX + 1) == 3 + 64 // stats.BH_BITS == 3 + 8
    assert stats.bh_launches(10**6, ordered=True) == 2
