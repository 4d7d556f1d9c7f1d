"""The port's device-LRT statistics vs sid_tpu's, on the CPU.

``sid_tpu_torch.ops.stats``'s tensor functions are the fused on-device
LRT's (``exact_pvalues=False``): on the CPU they run their plain torch
versions, which the CUDA kernels of ``csrc/lrt_bh.cu`` are held to on the
card. Here they are held against

- sid_tpu's XLA ``lrt_pvalue_from_logs`` and the host libm path
  (``lrt_pvalue_from_logs_np``, libsidtpu's ``sidtpu_lrt_pvalues``): the
  same arithmetic through other erfc implementations, so p-values agree to
  1e-13 relative where both are at least DBL_MIN and fall below DBL_MIN
  together (XLA:CPU flushes erfc's subnormal results to 0), NaN where the
  host has NaN, with its bits;
- the host Benjamini-Hochberg ``adjust_benjamini_hochberg_np`` and sid_tpu's
  XLA ``adjust_benjamini_hochberg``: bitwise (a sort, exact scalings and a
  running min), with ties, zeros, ones and NaN, for m in 0, 1, 2, 1000;
- sid_tpu's device LRT of ``models/likelihood_ratio.py`` (the clamp, the
  -R prior, both LRTs, both BH corrections) on the same marginals;
- the reference's dead-code API of sid_tpu's ``ops/stats.py`` on the
  vectors of tests/test_stats.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sid_tpu.models import common as ref_common  # noqa: E402
from sid_tpu.ops import stats as ref_stats  # noqa: E402
from sid_tpu.ops.lgamma import lgamma_int_table  # noqa: E402
from sid_tpu_torch.models.common import LONG_DOUBLE_UNDERFLOW_LOG  # noqa: E402
from sid_tpu_torch.ops import stats  # noqa: E402

DBL_MIN = np.finfo(np.float64).tiny
# p-values through different erfc implementations (glibc, XLA:CPU, torch,
# CUDA): measured within 6e-14 relative of each other where >= DBL_MIN
RTOL = 1e-13


def bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


def assert_pvalues_close(got, want, rtol=RTOL):
    """The device-LRT tolerance: NaN at the same positions; below DBL_MIN
    together; elsewhere |got - want| <= rtol * want. Returns the largest
    relative error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), "NaN positions differ"
    g, w = got[~nan], want[~nan]
    low = w < DBL_MIN
    assert np.array_equal(g < DBL_MIN, low), (
        f"below DBL_MIN apart at {np.flatnonzero((g < DBL_MIN) != low)[:5]}")
    rel = np.abs(g[~low] - w[~low]) / w[~low]
    worst = int(np.argmax(rel)) if rel.size else 0
    assert (rel <= rtol).all(), (rel[worst], g[~low][worst], w[~low][worst])
    return float(rel.max()) if rel.size else 0.0


def assert_het_close(got, want, p2, alpha, rtol=RTOL):
    """is_het equal except where p2 lies within rtol * alpha of alpha."""
    differ = np.asarray(got, bool) != np.asarray(want, bool)
    assert (np.abs(np.asarray(p2)[differ] - alpha) <= rtol * alpha).all(), np.flatnonzero(differ)[:5]


def assert_csv_close(got: bytes, want: bytes, alpha=0.05):
    """Two CSVs of p-values held by the device-LRT tolerance as printed:
    the same sites and confidence type; each p-value equal, or one unit of
    %g's sixth digit apart (where a 1e-13 difference straddles a rounding
    point); the call apart only where het_conf prints as alpha. Prints the
    lines that differ in bytes; returns their count."""
    gl, wl = got.split(b"\n"), want.split(b"\n")
    assert len(gl) == len(wl)
    differ = [k for k, (a, b) in enumerate(zip(gl, wl)) if a != b]
    print(f"{len(differ)} of {len(gl) - 2} CSV lines differ in bytes"
          + (f"; first: line {differ[0]}: {gl[differ[0]]!r} vs {wl[differ[0]]!r}" if differ else ""))
    for k in differ:
        a, b = gl[k].split(b","), wl[k].split(b",")
        assert a[:2] == b[:2] and a[6:] == b[6:], (a, b)
        for x, y in zip(a[4:6], b[4:6]):
            fx, fy = float(x), float(y)
            assert (math.isnan(fx) and math.isnan(fy)) or abs(fx - fy) <= 1e-5 * max(abs(fx), abs(fy)), (a, b)
        if a[2:4] != b[2:4]:
            assert abs(float(b[5]) - alpha) <= 1e-5 * alpha, (a, b)
    return len(differ)


def log_pairs(n=4000, seed=0):
    """(log_l0, log_l1) over the LRT's range: the bulk, p-values down to
    the subnormal line and past it, ties, -inf, NaN and +inf edges."""
    rng = np.random.default_rng(seed)
    l0 = rng.normal(-80, 60, n)
    l1 = l0 + np.concatenate([rng.normal(0, 8, n // 2), rng.uniform(0, 760, n - n // 2)])
    l1[:40] = l0[:40]  # d == 0: p == 1
    edges = [(-np.inf, -1.0), (-np.inf, -np.inf), (-1.0, -np.inf), (np.nan, -1.0), (-1.0, np.nan),
             (np.nan, np.nan), (-np.inf, np.nan), (np.inf, np.inf), (-5.0, np.inf), (0.0, 0.0),
             (-700.0, 0.0), (-745.5, 0.0), (-708.0, 0.0)]
    for k, (a, b) in enumerate(edges):
        l0[40 + k], l1[40 + k] = a, b
    l0[60], l1[60] = -np.float64(np.nan), -1.0  # a negative NaN, as x86's 0 * inf gives
    return l0, l1


def test_lrt_plain_matches_host_libm_and_xla():
    l0, l1 = log_pairs()
    got = stats.lrt_pvalues(torch.from_numpy(l0), torch.from_numpy(l1)).numpy()
    host = ref_stats.lrt_pvalue_from_logs_np(l0, l1)
    xla = np.asarray(ref_stats.lrt_pvalue_from_logs(jnp.asarray(l0), jnp.asarray(l1)))
    assert assert_pvalues_close(got, host) < RTOL
    assert assert_pvalues_close(got, xla) < RTOL
    assert np.array_equal(bits(got)[np.isnan(host)], bits(host)[np.isnan(host)])  # the NaN's sign too
    assert (host < DBL_MIN).sum() > 100 and (host == 1.0).sum() >= 40


@pytest.mark.parametrize("m", [0, 1, 2, 1000])
def test_bh_plain_bitwise_host(m):
    rng = np.random.default_rng(m)
    p = rng.uniform(0, 1, m)
    if m >= 2:
        p[rng.integers(0, m, max(1, m // 8))] = 0.5  # ties
        p[rng.integers(0, m, max(1, m // 50))] = 0.0
        p[rng.integers(0, m, max(1, m // 50))] = 1.0
        p[rng.integers(0, m, max(1, m // 50))] = 1e-300
    if m >= 1000:
        p[rng.integers(0, m, 7)] = np.nan
    got = stats.adjust_benjamini_hochberg(torch.from_numpy(p)).numpy()
    want = ref_stats.adjust_benjamini_hochberg_np(p)
    assert np.array_equal(bits(got), bits(want))
    xla = np.asarray(ref_stats.adjust_benjamini_hochberg(jnp.asarray(p)))
    assert np.array_equal(bits(got), bits(xla))


@pytest.mark.parametrize("case", ["nan", "all-nan", "ones", "zeros", "one-nan-first"])
def test_bh_plain_bitwise_host_edges(case):
    p = {
        "nan": np.array([0.3, np.nan, 0.01, np.nan, 0.7, 0.01]),
        "all-nan": np.full(5, np.nan),
        "ones": np.ones(9),
        "zeros": np.zeros(9),
        "one-nan-first": np.array([np.nan, 0.2, 0.2, 0.9]),
    }[case]
    got = stats.adjust_benjamini_hochberg(torch.from_numpy(p)).numpy()
    assert np.array_equal(bits(got), bits(ref_stats.adjust_benjamini_hochberg_np(p)))


def test_bh_order_is_numpys():
    rng = np.random.default_rng(3)
    p = rng.choice([0.0, 0.25, 0.5, 1.0, np.nan, 1e-300, 0.125], 3000)
    want = np.argsort(-p, kind="stable")
    assert np.array_equal(stats.bh_order(torch.from_numpy(p)).numpy(), want)


def test_sqrt_rn_is_correctly_rounded():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(0, 1000, 50000), np.exp(rng.uniform(-700, 700, 20000))])
    assert np.array_equal(bits(stats.sqrt_rn(torch.from_numpy(x)).numpy()), bits(np.sqrt(x)))


def marginals(n=3000, seed=1):
    """Post-fit (log L_hom, log L_het) over the range the clamp and the
    prior see: the bulk, both sides of the 80-bit underflow line, -inf."""
    rng = np.random.default_rng(seed)
    lhom = -rng.exponential(40.0, n)
    lhet = lhom + rng.normal(0, 20, n)
    lhom[:50] = LONG_DOUBLE_UNDERFLOW_LOG + rng.normal(0, 5, 50)
    lhet[50:100] = LONG_DOUBLE_UNDERFLOW_LOG + rng.normal(0, 5, 50)
    lhom[100], lhet[101] = -np.inf, -np.inf
    return lhom, lhet


def _ref_device_lr(lhom, lhet, pi, prior, alpha):
    """sid_tpu/models/likelihood_ratio.py:49-66, the device branch."""
    lhom = ref_common.clamp_ld_underflow(jnp.asarray(lhom))
    lhet = ref_common.clamp_ld_underflow(jnp.asarray(lhet))
    if prior:
        lhet = ref_common.clamp_ld_underflow(lhet + jnp.log(jnp.float64(pi)))
        lhom = ref_common.clamp_ld_underflow(lhom + jnp.log(jnp.float64(1.0 - pi)))
    p1 = ref_stats.lrt_pvalue_from_logs(lhet, lhom)
    p2 = ref_stats.lrt_pvalue_from_logs(lhom, lhet)
    adj1 = np.asarray(ref_stats.adjust_benjamini_hochberg(p1))
    adj2 = np.asarray(ref_stats.adjust_benjamini_hochberg(p2))
    return adj2 < alpha, adj1, adj2, np.asarray(p1), np.asarray(p2)


def _host_lr(lhom, lhet, pi, prior, alpha):
    """The port's host path (models/likelihood_ratio.py, exact_pvalues)."""
    lhom = ref_common.clamp_ld_underflow_np(lhom)
    lhet = ref_common.clamp_ld_underflow_np(lhet)
    if prior:
        lhet = ref_common.clamp_ld_underflow_np(lhet + np.log(np.float64(pi)))
        lhom = ref_common.clamp_ld_underflow_np(lhom + np.log(np.float64(1.0 - pi)))
    p1 = ref_stats.lrt_pvalue_from_logs_np(lhet, lhom)
    p2 = ref_stats.lrt_pvalue_from_logs_np(lhom, lhet)
    return p1, p2


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("pi", [0.02, 1e-4])
def test_lrt_benjamini_hochberg_matches_sid_tpu_device_lr(pi, prior):
    lhom, lhet = marginals()
    alpha = 0.05
    log_priors = stats.prior_logs(pi) if prior else None
    het, adj1, adj2 = stats.lrt_benjamini_hochberg(lhom, lhet, log_priors, alpha, "cpu")
    r_het, r_adj1, r_adj2, r_p1, r_p2 = _ref_device_lr(lhom, lhet, pi, prior, alpha)
    assert_pvalues_close(adj1, r_adj1)
    assert_pvalues_close(adj2, r_adj2)
    assert_het_close(het, r_het, r_adj2, alpha)
    # the p-values before BH against the host path, and BH bitwise the host BH of the plain p
    h1, h2 = _host_lr(lhom, lhet, pi, prior, alpha)
    p1, p2 = stats.lrt_pair(torch.from_numpy(lhom), torch.from_numpy(lhet), log_priors)
    assert_pvalues_close(p1.numpy(), h1)
    assert_pvalues_close(p2.numpy(), h2)
    assert np.array_equal(bits(adj1), bits(ref_stats.adjust_benjamini_hochberg_np(p1.numpy())))
    assert np.array_equal(bits(adj2), bits(ref_stats.adjust_benjamini_hochberg_np(p2.numpy())))
    assert np.array_equal(het, adj2 < alpha)
    assert (np.asarray(r_p2) < DBL_MIN).sum() > 10


def test_lrt_benjamini_hochberg_of_no_profiles():
    het, adj1, adj2 = stats.lrt_benjamini_hochberg(np.zeros(0), np.zeros(0), None, 0.05, "cpu")
    assert het.shape == adj1.shape == adj2.shape == (0,)


def test_tensor_entry_points_check_their_inputs():
    x = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        stats.lrt_pvalues(x, x.float())
    with pytest.raises(ValueError, match=r"\(4,\)"):
        stats.lrt_pair(x, torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        stats.adjust_benjamini_hochberg(torch.zeros(8, dtype=torch.float64)[::2])


@pytest.mark.parametrize("kw, match", [
    ({"p": torch.zeros(1, dtype=torch.float64).expand(2**31)}, "at most"),
    ({"order": torch.zeros(4, dtype=torch.int32)}, "order"), ({"order": torch.zeros(3, dtype=torch.int64)}, "order"),
])
def test_bh_launch_checks_its_arguments_before_any_launch(kw, match):
    """launch_bh raises on more p-values than a 32-bit position holds (a
    stride-0 view, no memory) or an order the kernels do not take, before it
    loads the kernel library."""
    p = kw.get("p", torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match=match):
        stats.launch_bh(p, kw.get("order"), p)


# ---- the dead-code API, on tests/test_stats.py's vectors ----

def test_bonferroni_is_sid_tpus():
    p = np.array([0.01, 0.02])
    for n in (0, 10):
        got = stats.adjust_bonferroni(torch.from_numpy(p), n=n).numpy()
        assert np.array_equal(got, np.asarray(ref_stats.adjust_bonferroni(jnp.asarray(p), n=n)))


def test_aic_and_relative_likelihoods_are_sid_tpus():
    pairs = np.array([[0.9, 0.1], [0.1, 0.9], [0.5, 0.5], [1e-300, 0.3]])
    got = stats.relative_likelihoods(torch.from_numpy(pairs)).numpy()
    want = np.asarray(ref_stats.relative_likelihoods(jnp.asarray(pairs)))
    np.testing.assert_allclose(got, want, rtol=1e-15)
    assert got[0, 0] == 1.0 and got[1, 1] == 1.0
    assert float(stats.aic(0.9, 2)) == pytest.approx(float(ref_stats.aic(0.9, 2)), rel=1e-15)
    assert float(stats.relative_likelihoods(torch.tensor([[0.9, 0.1]], dtype=torch.float64))[0, 1]) == \
        pytest.approx(math.exp((float(ref_stats.aic(0.9, 2)) - float(ref_stats.aic(0.1, 2))) / 2.0), rel=1e-12)


def test_binomial_is_sid_tpus():
    tab = lgamma_int_table(200)
    rng = np.random.default_rng(9)
    n = rng.integers(0, 150, 300)
    k = (n * rng.uniform(size=300)).astype(np.int64)
    p = rng.uniform(0.001, 0.999, 300)
    t = torch.from_numpy(tab)
    got_c = stats.log_binomial_coefficient(torch.from_numpy(n), torch.from_numpy(k), t).numpy()
    want_c = np.asarray(ref_stats.log_binomial_coefficient(jnp.asarray(n), jnp.asarray(k), jnp.asarray(tab)))
    assert np.array_equal(bits(got_c), bits(want_c))
    got = stats.binomial_pmf(torch.from_numpy(n), torch.from_numpy(k), torch.from_numpy(p), t).numpy()
    # the same formula in glibc libm: exp of a sum of logs, where the terms'
    # last-ulp differences become relative errors of the pmf
    libm = np.array([math.exp(c + kk * math.log(pp) + (nn - kk) * math.log1p(-pp))
                     for c, nn, kk, pp in zip(want_c.tolist(), n.tolist(), k.tolist(), p.tolist())])
    terms = np.abs(want_c) + np.abs(k * np.log(p)) + np.abs((n - k) * np.log1p(-p))
    assert (np.abs(got - libm) / libm <= 8 * np.finfo(np.float64).eps * np.maximum(1.0, terms)).all()
    # sid_tpu's XLA:CPU log1p is up to 120 ulps from glibc's here
    want = np.asarray(ref_stats.binomial_pmf(n, k, p, jnp.asarray(tab)))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert float(stats.binomial_pmf(10, 5, 0.5, t)) == pytest.approx(252 / 1024, rel=1e-14)
