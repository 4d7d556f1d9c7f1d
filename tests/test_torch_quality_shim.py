"""The quality finalize kernel's per-site arithmetic, compiled for the host,
vs the plain torch version.

``sid_tpu_torch/csrc/quality_finalize.cuh`` holds the expressions the card
runs; ``quality_finalize_host.cpp`` loops them over arrays as the kernel's
grid-stride loop does (counts as two 32-bit words, the allele byte, the het
sum in; lpp2 out; sites whose n + 1 lies past the table counted). Built here
with g++ (contraction off, like nvcc --fmad=false) and held bitwise against
``ops.quality_finalize.quality_finalize_ref`` (and so against
``finalize_quality_np`` and libsidtpu's host pass, test_torch_quality.py):
every operation is an IEEE f64 add, subtract, multiply or compare, so no
tolerance. The full form (both LRT p-values and is_het) is held against
libsidtpu's fused ``sidtpu_quality_finalize`` with glibc's erfc: in its
two-erfc form, and as ``quality_finalize_lrt_kernel`` walks it (one erfc a
site, a grid-stride loop over a few threads, every site written once) on
every pair of edge values of the per-read sums, at n = 0 to 3 and beyond.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu_torch.models import quality  # noqa: E402
from sid_tpu_torch.ops import quality_finalize as qf  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from test_torch_lrt_shim import WALKS, edge_values, some_rows  # noqa: E402
from test_torch_quality import PRIORS, bits, finalize_cases  # noqa: E402

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sid_tpu_torch", "csrc"
)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = str(tmp_path_factory.mktemp("shim") / "libquality_finalize_host.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, os.path.join(CSRC, "quality_finalize_host.cpp")],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p = ctypes.c_void_p
    lib.sid_quality_finalize_rows_host.restype = ctypes.c_uint32
    lib.sid_quality_finalize_rows_host.argtypes = [
        p, p, p, ctypes.c_int64, p, ctypes.c_int, p, ctypes.c_int, p,
    ]
    lib.sid_quality_finalize_lrt_rows_host.restype = ctypes.c_uint32
    lib.sid_quality_finalize_lrt_rows_host.argtypes = [
        p, p, p, p, ctypes.c_int64, p, ctypes.c_int, p, p, ctypes.c_int, p, p, p,
    ]
    lib.sid_quality_finalize_lrt_walk_host.restype = ctypes.c_uint32
    lib.sid_quality_finalize_lrt_walk_host.argtypes = [
        p, p, p, p, ctypes.c_int64, p, ctypes.c_int, p, p, ctypes.c_int, p, p, p, ctypes.c_int64, p,
    ]
    return lib


def run_lrt_rows(lib, counts, alleles, log_hom, log_het, prior, alpha, tab):
    """The full form's site loop on the host: (p1, p2, is_het, misses)."""
    counts = np.ascontiguousarray(counts, np.uint16)
    n = counts.shape[0]
    ln2, underflow, log_prior = qf.host_constants(prior)
    params = np.array([ln2, underflow, 0.0 if log_prior is None else log_prior], np.float64)
    lrt = np.array([qf.log_prior_hom(prior), alpha], np.float64)
    p1, p2, het = np.empty(n), np.empty(n), np.empty(n, np.uint8)
    misses = lib.sid_quality_finalize_lrt_rows_host(
        counts.ctypes.data, alleles.ctypes.data, np.ascontiguousarray(log_het).ctypes.data,
        np.ascontiguousarray(log_hom).ctypes.data, n, params.ctypes.data, int(log_prior is not None),
        lrt.ctypes.data, tab.ctypes.data, tab.shape[0], p1.ctypes.data, p2.ctypes.data, het.ctypes.data,
    )
    return p1, p2, het.astype(bool), misses


def run_rows(lib, counts, alleles, log_het, prior, tab):
    """The kernel's row loop on the host: (lpp2, sites past the table)."""
    counts = np.ascontiguousarray(counts, np.uint16)
    n = counts.shape[0]
    ln2, underflow, log_prior = qf.host_constants(prior)
    params = np.array([ln2, underflow, 0.0 if log_prior is None else log_prior], np.float64)
    out = np.empty(n, np.float64)
    misses = lib.sid_quality_finalize_rows_host(
        counts.ctypes.data, alleles.ctypes.data, np.ascontiguousarray(log_het).ctypes.data, n,
        params.ctypes.data, int(log_prior is not None), tab.ctypes.data, tab.shape[0], out.ctypes.data,
    )
    return out, misses


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shim_rows_bitwise_plain(shim, seed, prior):
    counts, major, second, _, log_het = finalize_cases(seed=seed)
    alleles = qf.pack_alleles(major, second)
    tab_t = lgamma_table(2 * int(counts.astype(np.int64).sum(-1).max()), "cpu")
    got, misses = run_rows(shim, counts, alleles, log_het, prior, tab_t.numpy())
    want = qf.quality_finalize_ref(
        torch.from_numpy(counts), torch.from_numpy(alleles), torch.from_numpy(log_het), tab_t, prior
    ).numpy()
    assert misses == 0
    assert np.array_equal(bits(got), bits(want))
    assert np.isneginf(got).sum() > 0 and np.isnan(got).sum() > 0 and np.isfinite(got).sum() > 0


def test_shim_unmasked_allele_bits_are_ignored(shim):
    # bits 4-7 of the byte carry nothing: the row reads major & 3, second & 3
    counts, major, second, _, log_het = finalize_cases(n=500, seed=5)
    alleles = qf.pack_alleles(major, second)
    tab = lgamma_table(2 * int(counts.astype(np.int64).sum(-1).max()), "cpu").numpy()
    clean = run_rows(shim, counts, alleles, log_het, 1e-3, tab)[0]
    noisy = run_rows(shim, counts, alleles | np.uint8(0xF0), log_het, 1e-3, tab)[0]
    assert np.array_equal(bits(clean), bits(noisy))


def test_shim_table_overrun_counts_the_sites(shim):
    counts = np.array([[5, 3, 0, 0], [0, 0, 0, 0], [1000, 0, 0, 7], [2, 2, 2, 2]], np.uint16)
    alleles = qf.pack_alleles(np.array([0, 3, 0, 3]), np.array([1, 2, 3, 2]))
    tab = lgamma_table(8, "cpu").numpy()[:10]  # reaches index 9: n + 1 <= 9 is covered
    got, misses = run_rows(shim, counts, alleles, np.zeros(4), -1.0, tab)
    assert misses == 1  # the 1007x site only
    assert np.isnan(got[2]) and np.isfinite(got[[0, 1, 3]]).all()
    with pytest.raises(ValueError, match="does not reach"):
        qf.quality_finalize(torch.from_numpy(counts), torch.from_numpy(alleles),
                            torch.zeros(4, dtype=torch.float64), torch.from_numpy(tab))


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("seed", [0, 1])
def test_shim_full_rows_bitwise_the_host_pass(shim, seed, prior):
    """The full form (B6's het side, the hom clamp and prior, both LRTs,
    is_het) with glibc's erfc is bitwise libsidtpu's fused
    sidtpu_quality_finalize: p1, p2 and the calls."""
    counts, major, second, log_hom, log_het = finalize_cases(seed=seed)
    alleles = qf.pack_alleles(major, second)
    tab = lgamma_table(2 * int(counts.astype(np.int64).sum(-1).max()), "cpu").numpy()
    p1, p2, het, misses = run_lrt_rows(shim, counts, alleles, log_hom, log_het, prior, 0.05, tab)
    h_het, h1, h2 = quality.finalize_quality_native(counts, major, second, log_hom, log_het, prior, 0.05)
    assert misses == 0
    assert np.array_equal(bits(p1), bits(h1)) and np.array_equal(bits(p2), bits(h2))
    assert np.array_equal(het, h_het)
    assert np.isnan(p2).sum() > 0 and (p2 == 0).sum() > 0 and ((p2 > 0) & (p2 < 1)).sum() > 100


def edge_sites(n=1001, seed=7):
    """finalize_cases with every pair of edge values planted as (log_hom,
    log_het) at the first sites; an odd count."""
    counts, major, second, log_hom, log_het = finalize_cases(n=n, seed=seed)
    vals = edge_values()
    pairs = np.array([(a, b) for a in vals for b in vals], np.float64)
    log_hom[: pairs.shape[0]], log_het[: pairs.shape[0]] = pairs[:, 0], pairs[:, 1]
    return counts, major, second, log_hom, log_het


def run_lrt_walk(lib, counts, alleles, log_hom, log_het, prior, alpha, tab, threads):
    """quality_finalize_lrt_kernel's walk on the host: (p1, p2, is_het,
    misses, visits)."""
    counts = np.ascontiguousarray(counts, np.uint16)
    n = counts.shape[0]
    ln2, underflow, log_prior = qf.host_constants(prior)
    params = np.array([ln2, underflow, 0.0 if log_prior is None else log_prior], np.float64)
    lrt = np.array([qf.log_prior_hom(prior), alpha], np.float64)
    p1, p2, het, visits = np.full(n, 7.0), np.full(n, 7.0), np.full(n, 7, np.uint8), np.zeros(n, np.uint8)
    misses = lib.sid_quality_finalize_lrt_walk_host(
        counts.ctypes.data, alleles.ctypes.data, np.ascontiguousarray(log_het).ctypes.data,
        np.ascontiguousarray(log_hom).ctypes.data, n, params.ctypes.data, int(log_prior is not None),
        lrt.ctypes.data, tab.ctypes.data, tab.shape[0], p1.ctypes.data, p2.ctypes.data, het.ctypes.data,
        threads, visits.ctypes.data,
    )
    return p1, p2, het, misses, visits


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("threads", WALKS)
@pytest.mark.parametrize("n", [0, 1, 2, 3, "edges"])
def test_full_walk_is_bitwise_the_two_erfc_form_and_the_host_pass(shim, n, threads, prior):
    """The kernel's walk (one erfc a site, erfc(0.0) once a thread, a
    grid-stride loop) writes every site once, bitwise the two-erfc form and
    libsidtpu's sidtpu_quality_finalize: p1, p2, is_het and the misses."""
    counts, major, second, log_hom, log_het = some_rows(edge_sites(), n)
    alleles = qf.pack_alleles(major, second)
    tab = lgamma_table(2 * 4 * 65535, "cpu").numpy()
    p1, p2, het, misses, visits = run_lrt_walk(shim, counts, alleles, log_hom, log_het, prior, 0.05, tab, threads)
    assert np.all(visits == 1) and misses == 0
    t1, t2, t_het, t_misses = run_lrt_rows(shim, counts, alleles, log_hom, log_het, prior, 0.05, tab)
    assert np.array_equal(bits(p1), bits(t1)) and np.array_equal(bits(p2), bits(t2))
    assert np.array_equal(het.astype(bool), t_het) and t_misses == 0
    h_het, h1, h2 = quality.finalize_quality_native(counts, major, second, log_hom, log_het, prior, 0.05)
    assert np.array_equal(bits(p1), bits(h1)) and np.array_equal(bits(p2), bits(h2))
    assert np.array_equal(het.astype(bool), h_het)


@pytest.mark.parametrize("threads", WALKS)
def test_full_walk_counts_the_misses_as_the_two_erfc_form(shim, threads):
    """With a table that the deep sites read past, the walk's miss count
    and its NaN sites are the two-erfc form's."""
    counts, major, second, log_hom, log_het = edge_sites()
    alleles = qf.pack_alleles(major, second)
    tab = lgamma_table(2 * 4 * 65535, "cpu").numpy()[:1000]
    p1, p2, het, misses, visits = run_lrt_walk(shim, counts, alleles, log_hom, log_het, 1e-3, 0.05, tab, threads)
    t1, t2, t_het, t_misses = run_lrt_rows(shim, counts, alleles, log_hom, log_het, 1e-3, 0.05, tab)
    assert misses == t_misses > 0 and np.all(visits == 1)
    assert np.array_equal(bits(p1), bits(t1)) and np.array_equal(bits(p2), bits(t2))
    assert np.array_equal(het.astype(bool), t_het)
