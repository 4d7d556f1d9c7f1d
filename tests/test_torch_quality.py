"""The port's ``-m quality`` slice vs sid_tpu's, on the CPU.

The Phred term table and the per-read sums (the parser's inline terms and
``accumulate_read_terms``) bitwise sid_tpu's; the finalize's plain torch
version bitwise ``sid_tpu.models.quality.finalize_quality_np`` and
libsidtpu's fused host pass, and within 2 ulps of the largest operand of
sid_tpu's XLA program ``finalize_quality_het_nk`` (XLA contracts n * ln2 into
an FMA, so it rounds once where the others round twice); ``engine.run -m
quality`` byte-equal to ``sid_tpu.engine.run`` under both engines, -R, -r,
-p and ``--io python``, on the golden fixture, simulated Phred-varied
pileups, grammar-rich input and sites up to 65535 deep.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.io.pileup import parse_pileup as ref_parse  # noqa: E402
from sid_tpu.models import quality as ref_quality  # noqa: E402
from sid_tpu.ops import stats as ref_stats  # noqa: E402
from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io import native  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import common, quality  # noqa: E402
from sid_tpu_torch.native import bridge  # noqa: E402
from sid_tpu_torch.ops import quality_finalize as qf  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_int_table, lgamma_table, table_size  # noqa: E402
from synth import make_bwa_like_pileup, simulate_diploid_counts  # noqa: E402
from test_torch_lrt import assert_csv_close  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PRIORS = (-1.0, 1e-3, 0.999)


def _read(*parts):
    with open(os.path.join(FIXTURES, *parts), "rb") as f:
        return f.read()


def phred_pileup(counts, seed=0, chrom="chr1") -> bytes:
    """Pileup of plain base letters whose per-read base and mapping
    qualities are drawn from a seed (Phred 2..41 and 1..60)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    lines = []
    for s, c in enumerate(np.asarray(counts, np.int64)):
        cov = int(c.sum())
        bases = np.repeat(letters, c)
        rng.shuffle(bases)
        q = max(cov, 1)
        bq = (33 + rng.integers(2, 42, q)).astype(np.uint8).tobytes()
        mq = (33 + rng.integers(1, 61, q)).astype(np.uint8).tobytes()
        lines.append(b"\t".join([chrom.encode(), str(s + 1).encode(), b"N", str(cov).encode(),
                                 bases.tobytes() or b"*", bq, mq]))
    return b"\n".join(lines) + b"\n"


def deep_counts():
    """Simulated ~20x sites and deep ones: one allele at 65535, two at
    65535 each, a mixed 30000x site and zero coverage."""
    bulk = simulate_diploid_counts(150, coverage=20, pi=0.05, eps=0.01, seed=31)
    deep = np.array([[65535, 0, 0, 0], [0, 65535, 65535, 0], [20000, 9000, 1000, 0],
                     [0, 0, 0, 0], [3, 3, 3, 3]])
    return np.vstack([bulk, deep])


def finalize_cases(n=6000, seed=0):
    """(counts uint16, major, second, log_hom, log_het) with zero-coverage
    rows, ties, deep rows up to 65535 and log sums on both sides of the
    80-bit underflow line."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(25, (n, 4)) * (rng.uniform(size=(n, 4)) < [0.95, 0.3, 0.1, 0.05])
    counts[: n // 20] = 0
    tie = rng.integers(1, 300, n // 20)
    counts[n // 20 : n // 10] = np.stack([tie, tie, tie * 0, tie], 1)
    deep = slice(n // 10, n // 10 + n // 50)
    counts[deep] = rng.integers(0, 65536, (n // 50, 4))
    counts[n // 10] = [65535, 65535, 65535, 65535]
    counts = counts.astype(np.uint16)
    major, second = common.major_allele_indices_np(counts)
    log_hom = -rng.exponential(60.0, n)
    log_het = -rng.exponential(60.0, n)
    line = common.LONG_DOUBLE_UNDERFLOW_LOG
    near = rng.integers(0, n, n // 10)
    log_het[near] = line + rng.normal(0, 40.0, near.size)
    log_hom[near[::2]] = line + rng.normal(0, 40.0, near[::2].size)
    log_het[deep] = -rng.uniform(0, 3e5, n // 50)
    log_het[: n // 40] = np.where(np.arange(n // 40) % 2, -np.inf, np.nan)
    return counts, major, second, log_hom, log_het


def plain_lpp2(counts, major, second, log_het, prior):
    tab = lgamma_table(2 * int(counts.astype(np.int64).sum(-1).max()), "cpu")
    return qf.quality_finalize(
        torch.from_numpy(counts), torch.from_numpy(qf.pack_alleles(major, second)),
        torch.from_numpy(log_het), tab, prior,
    ).numpy()


def bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


def test_term_table_is_sid_tpus():
    assert np.array_equal(bits(quality.quality_term_tables()), bits(ref_quality.quality_term_tables()))


@pytest.fixture(scope="module")
def grammar_rich():
    return make_bwa_like_pileup(1500, seed=77)


def test_inline_terms_match_sid_tpu(grammar_rich):
    got = parse_pileup(grammar_rich, True, True)
    want = ref_parse(grammar_rich, True, True)
    assert got.q_log_hom is not None
    for name in ("q_log_hom", "q_log_het"):
        assert np.array_equal(bits(getattr(got, name)), bits(getattr(want, name))), name
    for name in ("q_major", "q_second", "read_offsets", "read_code", "read_bq", "read_mq"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    only = parse_pileup(grammar_rich, True, True, quality_terms_only=True)
    assert only.read_offsets is None
    assert np.array_equal(bits(only.q_log_het), bits(got.q_log_het))


@pytest.mark.parametrize("backend", ["native", "python"])
def test_accumulate_read_terms_matches_sid_tpu(grammar_rich, backend):
    batch = parse_pileup(grammar_rich, True, True, backend=backend)
    ref_batch = ref_parse(grammar_rich, True, True, backend=backend)
    major, second = common.major_allele_indices_np(batch.counts.astype(np.int64))
    got = quality.accumulate_read_terms(batch, major, second)
    want = ref_quality.accumulate_read_terms(ref_batch, major, second)
    for a, b in zip(got, want):
        assert np.array_equal(bits(a), bits(b))
    if backend == "python":
        assert batch.q_log_hom is None


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_finalize_bitwise_finalize_quality_np(seed, prior):
    counts, major, second, log_hom, log_het = finalize_cases(seed=seed)
    tab = lgamma_int_table(table_size(2 * int(counts.astype(np.int64).sum(-1).max())))
    want1, want2 = ref_quality.finalize_quality_np(counts, major, second, log_hom, log_het, prior, tab)
    got2 = plain_lpp2(counts, major, second, log_het, prior)
    assert np.array_equal(bits(got2), bits(want2))
    got1, got2b = quality.finalize_quality_np(counts, major, second, log_hom, log_het, prior, tab)
    assert np.array_equal(bits(got1), bits(want1)) and np.array_equal(bits(got2b), bits(want2))
    # the device stage's host half (hom clamp and prior) on the CPU
    lpp1, lpp2 = quality.finalize_logs(counts, major, second, log_hom, log_het, prior, torch.device("cpu"))
    assert np.array_equal(bits(lpp1), bits(want1)) and np.array_equal(bits(lpp2), bits(want2))


@pytest.mark.parametrize("prior", PRIORS)
def test_native_finalize_bitwise_the_composition(prior):
    counts, major, second, log_hom, log_het = finalize_cases(seed=2)
    lpp1, lpp2 = quality.finalize_logs(counts, major, second, log_hom, log_het, prior, torch.device("cpu"))
    p1 = ref_stats.lrt_pvalue_from_logs_np(lpp2, lpp1)
    p2 = ref_stats.lrt_pvalue_from_logs_np(lpp1, lpp2)
    het, q1, q2 = quality.finalize_quality_native(counts, major, second, log_hom, log_het, prior, 0.05)
    assert np.array_equal(bits(q1), bits(p1)) and np.array_equal(bits(q2), bits(p2))
    with np.errstate(invalid="ignore"):
        assert np.array_equal(het, p2 < 0.05)


def test_plain_within_two_ulps_of_xla():
    counts, major, second, _, log_het = finalize_cases(seed=3)
    c64 = counts.astype(np.int64)
    idx = np.arange(c64.shape[0])
    n = c64[idx, major] + c64[idx, second]
    k = c64[idx, second]
    tab = lgamma_int_table(table_size(2 * int(c64.sum(-1).max())))
    xla = np.asarray(ref_quality.finalize_quality_het_nk(
        jnp.asarray(n.astype(np.int32)), jnp.asarray(k.astype(np.int32)), jnp.asarray(log_het),
        jnp.asarray(tab),
    ))
    got = plain_lpp2(counts, major, second, log_het, -1.0)
    for pred in (np.isnan, np.isneginf, np.isposinf):
        assert np.array_equal(pred(got), pred(xla))
    fin = np.isfinite(got)
    log_c = tab[n + 1] - tab[n - k + 1] - tab[k + 1]
    scale = np.maximum.reduce([np.abs(got), np.abs(log_het + log_c), n * np.log(2.0)])[fin]
    diff = np.abs(got[fin] - xla[fin])
    assert (diff <= 2 * np.spacing(scale)).all()
    assert (diff > 0).any()  # the FMA does move bits: the bound is not vacuous


def test_wrapper_raises_on_short_table_and_foreign_devices():
    counts, major, second, _, log_het = finalize_cases(n=400, seed=4)
    args = (torch.from_numpy(counts), torch.from_numpy(qf.pack_alleles(major, second)),
            torch.from_numpy(log_het))
    need = int((counts.astype(np.int64)[np.arange(400), major] + counts[np.arange(400), second]).max()) + 1
    short = torch.from_numpy(lgamma_int_table(need - 1))  # entries 0..need-1: index need is past it
    with pytest.raises(ValueError, match="does not reach"):
        qf.quality_finalize(*args, short)
    exact = torch.from_numpy(lgamma_int_table(need))
    assert qf.quality_finalize(*args, exact).shape == (400,)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no quality finalize kernel for device meta"):
        qf.quality_finalize(*meta, exact.to("meta"))
    with pytest.raises(TypeError):
        qf.quality_finalize(args[0].to(torch.int32), *args[1:], exact)
    with pytest.raises(ValueError):
        qf.quality_finalize(args[0][:, :3].contiguous(), *args[1:], exact)
    with pytest.raises(ValueError, match="must be contiguous"):
        qf.quality_finalize(args[0], args[1], torch.from_numpy(np.repeat(log_het, 2))[::2], exact)


def test_pack_alleles_masks_like_the_host_pass():
    major = np.array([0, 3, 7, -1], np.int32)
    second = np.array([1, 2, 5, -2], np.int32)
    assert qf.pack_alleles(major, second).tolist() == [0 | 1 << 2, 3 | 2 << 2, 3 | 1 << 2, 3 | 2 << 2]


@pytest.fixture(scope="module")
def inputs(grammar_rich):
    return {
        "golden": _read("golden.pileup"),
        "phred": phred_pileup(simulate_diploid_counts(2000, coverage=25, pi=0.02, eps=0.01, seed=11), seed=12),
        "grammar": grammar_rich,
        "deep": phred_pileup(deep_counts(), seed=13),
    }


VARIANTS = {
    "device": {},
    "exact": {"engine": "exact"},
    "R": {"estimate_prior": True},
    "r0.01": {"snp_prior": 0.01},
    "p0.01": {"significance_level": 0.01},
    "io-python": {"io_backend": "python"},
}


def _cases():
    for name in ("golden", "phred", "grammar", "deep"):
        for variant in VARIANTS:
            if name == "deep" and variant in ("io-python", "R"):
                # megabytes of bases through the Python grammar spec; a fit
                # whose deep rows go through long-double power tables
                continue
            yield name, variant


@pytest.mark.parametrize("name,variant", list(_cases()))
def test_csv_byte_equal_to_sid_tpu(inputs, name, variant):
    kw = dict(method="quality", **VARIANTS[variant])
    got_diag, want_diag = [], []
    want = ref_engine.run(inputs[name], RefOptions(**kw), want_diag.append, binary=True)
    got = engine.run(inputs[name], Options(platform="cpu", **kw), got_diag.append, binary=True)
    assert got_diag == want_diag
    assert got.count(b"\n") == want.count(b"\n") > 1
    if got != want:
        g, w = got.split(b"\n"), want.split(b"\n")
        k = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        pytest.fail(f"first differing line {k}: port {g[k]!r} vs sid_tpu {w[k]!r}")


@pytest.mark.parametrize("golden,kw", [("golden_quality.csv", {}),
                                       ("golden_quality_R.csv", {"estimate_prior": True})])
def test_golden_fixtures(golden, kw):
    got = engine.run(_read("golden.pileup"), Options(platform="cpu", method="quality", **kw), binary=True)
    assert got == _read(golden)


@pytest.mark.parametrize("name,kw", [("phred", {}), ("phred", {"snp_prior": 1e-3}),
                                     ("phred", {"estimate_prior": True}), ("deep", {}),
                                     ("deep", {"snp_prior": 1e-3}), ("deep", {"snp_prior": 0.999})])
def test_device_path_equals_native_host_path(inputs, name, kw):
    opts = Options(platform="cpu", method="quality", **kw)
    batch = parse_pileup(inputs[name], True, True, quality_terms_only=True)
    dev = quality.call_quality(batch, opts).to_csv_bytes()
    host = quality.call_quality_host(batch, opts).to_csv_bytes()
    assert dev == host


@pytest.mark.parametrize("prior", PRIORS)
@pytest.mark.parametrize("name", ["phred", "grammar", "deep"])
def test_device_path_equals_exact_engine(inputs, name, prior):
    """The f64 log-space path with its 80-bit clamp gives the bytes of the
    host long-double engine (linear likelihoods, per-read long-double sums),
    deep sites included."""
    kw = dict(method="quality", snp_prior=prior, platform="cpu")
    dev = engine.run(inputs[name], Options(**kw), binary=True)
    assert dev == engine.run(inputs[name], Options(engine="exact", **kw), binary=True)


def test_deep_input_reaches_the_table_edge_and_the_clamp(inputs):
    batch = parse_pileup(inputs["deep"], True, True, quality_terms_only=True)
    n = (batch.counts.astype(np.int64)[np.arange(batch.num_sites), batch.q_major]
         + batch.counts[np.arange(batch.num_sites), batch.q_second])
    assert n.max() == 2 * 65535
    lpp1, lpp2 = quality.finalize_logs(batch.counts, batch.q_major, batch.q_second, batch.q_log_hom,
                                       batch.q_log_het, -1.0, torch.device("cpu"))
    assert np.isneginf(lpp1).any() and np.isneginf(lpp2).any()
    assert np.isfinite(lpp2).sum() > 100


def test_fused_device_lrt_is_not_ported():
    """(Named when the fused on-device LRT raised NotPortedError.) -m
    quality with exact_pvalues=False: sid_tpu's CSV by the device-LRT
    tolerance."""
    _device_lrt_matches_sid_tpu({})


@pytest.mark.parametrize("kw", [{"estimate_prior": True}, {"snp_prior": 1e-3}, {"snp_prior": 0.999}])
def test_fused_device_lrt_with_priors(kw):
    _device_lrt_matches_sid_tpu(kw)


def _device_lrt_matches_sid_tpu(kw):
    """engine.run -m quality, exact_pvalues=False: sid_tpu's CSV by the
    device-LRT tolerance, the same diagnostics."""
    src = _read("golden.pileup")
    want_diag, got_diag = [], []
    want = ref_engine.run(src, RefOptions(method="quality", exact_pvalues=False, **kw), want_diag.append,
                          binary=True)
    got = engine.run(src, Options(platform="cpu", method="quality", exact_pvalues=False, **kw),
                     got_diag.append, binary=True)
    assert got_diag == want_diag and got.count(b"\n") > 300
    assert_csv_close(got, want)


def test_bridge_declares_the_quality_hooks():
    lib = native.load()
    for name in ("sidtpu_set_quality_table", "sidtpu_num_terms", "sidtpu_term_hom", "sidtpu_term_het",
                 "sidtpu_term_major", "sidtpu_term_second", "sidtpu_quality_finalize"):
        assert getattr(lib, name).argtypes is not None, name
    assert bridge.PARSE_TERMS == 1 and bridge.PARSE_TERMS_ONLY == 2
