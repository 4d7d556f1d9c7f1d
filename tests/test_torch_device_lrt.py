"""The port's fused on-device LRT (``exact_pvalues=False``) vs sid_tpu's, on
the CPU.

On the CPU the port runs its plain torch versions of the kernels (B5
``local_classify_lrt_ref``, B6's full form ``quality_finalize_lrt_ref``, the
LRT and BH of ``ops.stats``); sid_tpu runs its XLA programs
(``classify_local``, ``finalize_quality``, the device branch of
``classify_profiles_lr``). The tolerance (``test_torch_lrt``): p-values
1e-13 relative where both are at least DBL_MIN, below DBL_MIN together,
is_het apart only within 1e-13 of alpha; alleles equal.

The two packages' log likelihoods come from different log implementations
(torch's and XLA's, held to 1e-12 by test_torch_local_classify.py), and
erfc's slope turns a last-bit difference of the log into up to ~1e-11 of a
small p-value. So against sid_tpu each step is held on the same inputs:
the post-prior logs to 1e-12 (or 2 ulps for the quality finalize), the
p-values over sid_tpu's own logs to 1e-13. End to end the p-values are held
to 1e-13 against the port's host-libm path, whose logs are the same bits.

Rows the long-double range screen flags go to the host long-double
classifier in the port (fault C1's fix) but not in sid_tpu's
``classify_local`` (fault C6, ROADMAP.md): they are compared with the host
path, and a test asserts that sid_tpu differs there.

``engine.run`` on golden.pileup is held to ``sid_tpu.engine.run`` with the
same options by parsing both CSVs (the lines that differ in bytes are
printed); ``engine.run_streaming`` is byte-equal to ``engine.run``.
"""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.models import local as ref_local  # noqa: E402
from sid_tpu.models import quality as ref_quality  # noqa: E402
from sid_tpu.ops import lgamma as ref_lgamma  # noqa: E402
from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import local, quality  # noqa: E402
from sid_tpu_torch.ops import local_classify, stats  # noqa: E402
from sid_tpu_torch.ops import quality_finalize as qf  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402
from test_torch_local_classify import (  # noqa: E402
    adversarial_profiles,
    assert_agree,
    bulk_profiles,
    tie_profiles,
)
from test_torch_lrt import assert_csv_close, assert_het_close, assert_pvalues_close  # noqa: E402
from test_torch_quality import finalize_cases, phred_pileup  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ALPHA = 0.05
LRT_PRIORS = [-1.0, 0.0, 1e-3, 0.999]


def _read(*parts):
    with open(os.path.join(FIXTURES, *parts), "rb") as f:
        return f.read()


def capped_deep_profiles(seed=21):
    """Rows whose plug-in error rates hit the -E cap, and deep rows up to
    ~3000x (below the range screen's line at -E 0.1)."""
    rng = np.random.default_rng(seed)
    capped = rng.integers(0, 40, (1500, 4))
    cov = rng.integers(500, 3000, 500)
    deep = np.stack([rng.multinomial(c, [0.6, 0.3, 0.07, 0.03]) for c in cov])
    return np.vstack([capped, deep, np.zeros((3, 4), np.int64)]).astype(np.uint16)


MAKERS = {"adversarial": adversarial_profiles, "bulk": bulk_profiles, "ties": tie_profiles,
          "capped-deep": capped_deep_profiles}


def _b5_plain(profiles, thr, prior):
    """The port's B5 plain version and its post-prior logs."""
    counts = torch.from_numpy(np.ascontiguousarray(profiles, np.uint16))
    tab = lgamma_table(int(profiles.astype(np.int64).sum(-1).max()), "cpu")
    p1, p2, packed = (t.numpy() for t in local_classify.local_classify_lrt_ref(counts, thr, prior, ALPHA, tab))
    l1, l2, b1 = (t.numpy() for t in local_classify.local_classify_ref(counts, thr, prior, tab))
    if prior > 0:
        l1 = l1 + np.log(np.float64(1.0 - prior))
        l2 = l2 + np.log(np.float64(prior))
    assert np.array_equal(packed & 31, b1)
    return p1, p2, packed, l1, l2


@pytest.mark.parametrize("prior", LRT_PRIORS)
@pytest.mark.parametrize("thr", [0.1, 1.0])
@pytest.mark.parametrize("make", list(MAKERS))
def test_b5_plain_matches_sid_tpu_classify_local(make, thr, prior):
    profiles = MAKERS[make]()
    p1, p2, packed, l1, l2 = _b5_plain(profiles, thr, prior)
    prof = profiles.astype(np.int32)
    tab = ref_lgamma.lgamma_int_table(ref_lgamma.table_size(int(prof.sum(-1).max())))
    out = ref_local.classify_local(jnp.asarray(prof), jnp.float64(thr), jnp.float64(ALPHA),
                                   jnp.float64(prior), jnp.asarray(tab))
    r_het, r_major, r_second, r_p1, r_p2, r_l1, r_l2 = (np.array(o) for o in out)
    major, second, flagged = local_classify.unpack(packed)
    assert np.array_equal(major, r_major) and np.array_equal(second, r_second)
    keep = ~flagged  # C6: sid_tpu has no range screen here
    assert_agree(l1[keep], r_l1[keep], 1e-12)
    assert_agree(l2[keep], r_l2[keep], 1e-12)
    # the p-values over sid_tpu's own logs: the erfc alone
    q1 = stats.lrt_pvalues_ref(torch.from_numpy(r_l2), torch.from_numpy(r_l1)).numpy()
    q2 = stats.lrt_pvalues_ref(torch.from_numpy(r_l1), torch.from_numpy(r_l2)).numpy()
    assert_pvalues_close(q1, r_p1)
    assert_pvalues_close(q2, r_p2)
    assert_het_close(local_classify.het_flags(packed)[keep], r_het[keep], r_p2[keep], ALPHA)


@pytest.mark.parametrize("prior", LRT_PRIORS)
@pytest.mark.parametrize("thr", [0.1, 1.0])
@pytest.mark.parametrize("make", list(MAKERS))
def test_b5_path_matches_the_host_libm_path(make, thr, prior):
    """classify_profiles_local with exact_pvalues=False (B5) against the
    same call with the default host-libm LRT: the same logs, so p-values
    to 1e-13; the screen's rows bitwise (host long double both ways)."""
    profiles = MAKERS[make]().astype(np.int32)
    host = local.classify_profiles_local(
        profiles, Options(platform="cpu", site_error_threshold=thr), prior)
    dev = local.classify_profiles_local(
        profiles, Options(platform="cpu", site_error_threshold=thr, exact_pvalues=False), prior)
    assert np.array_equal(dev[1], host[1]) and np.array_equal(dev[2], host[2])
    assert_pvalues_close(dev[3], host[3])
    assert_pvalues_close(dev[4], host[4])
    assert_het_close(dev[0], host[0], host[4], ALPHA)
    rows = np.flatnonzero(local.long_double_range_rows(profiles.sum(-1), thr, prior))
    for a, b in ((dev[3], host[3]), (dev[4], host[4])):
        assert np.array_equal(a[rows].view(np.uint64), b[rows].view(np.uint64))


def _quality_plain(counts, major, second, log_hom, log_het, prior):
    tab = lgamma_table(qf.MAX_TOP2, "cpu")
    p1, p2, het = qf.quality_finalize_lrt(
        torch.from_numpy(counts), torch.from_numpy(qf.pack_alleles(major, second)),
        torch.from_numpy(log_het), torch.from_numpy(log_hom), tab, prior, ALPHA)
    return het.numpy().astype(bool), p1.numpy(), p2.numpy()


@pytest.mark.parametrize("prior", LRT_PRIORS)
@pytest.mark.parametrize("seed", [0, 1])
def test_b6_full_plain_matches_sid_tpu_and_the_host_pass(seed, prior):
    counts, major, second, log_hom, log_het = finalize_cases(n=3000, seed=seed)
    het, p1, p2 = _quality_plain(counts, major, second, log_hom, log_het, prior)
    # against libsidtpu's fused host pass: the same logs, p-values to 1e-13
    h_het, h1, h2 = quality.finalize_quality_native(counts, major, second, log_hom, log_het, prior, ALPHA)
    assert_pvalues_close(p1, h1)
    assert_pvalues_close(p2, h2)
    assert_het_close(het, h_het, h2, ALPHA)
    # the logs bitwise the host pass's composition (finalize_quality_np)
    tab = lgamma_table(qf.MAX_TOP2, "cpu").numpy()
    lpp1, lpp2 = quality.finalize_quality_np(counts, major, second, log_hom, log_het, prior, tab)
    q1 = stats.lrt_pvalues(torch.from_numpy(lpp2), torch.from_numpy(lpp1)).numpy()
    assert np.array_equal(q1.view(np.uint64), p1.view(np.uint64))
    # against sid_tpu's XLA finalize_quality: its logs within 2 ulps of the
    # largest operand (its FMA), its p-values over its own logs to 1e-13
    r_tab = ref_lgamma.lgamma_int_table(ref_lgamma.table_size(2 * int(counts.astype(np.int64).sum(-1).max())))
    out = ref_quality.finalize_quality(
        jnp.asarray(counts.astype(np.int32)), jnp.asarray(major), jnp.asarray(second), jnp.asarray(log_hom),
        jnp.asarray(log_het), jnp.float64(prior), jnp.float64(ALPHA), jnp.asarray(r_tab))
    r_het, r_p1, r_p2, r_l1, r_l2 = (np.array(o) for o in out)
    for pred in (np.isnan, np.isneginf, np.isposinf):
        assert np.array_equal(pred(r_l2), pred(lpp2)) and np.array_equal(pred(r_l1), pred(lpp1))
    c64 = counts.astype(np.int64)
    idx = np.arange(c64.shape[0])
    n, k = c64[idx, major] + c64[idx, second], c64[idx, second]
    log_c = tab[n + 1] - tab[n - k + 1] - tab[k + 1]
    prior_log = abs(np.log(prior)) if prior > 0 else 0.0
    scale = np.maximum.reduce([np.abs(lpp2), np.abs(log_het + log_c), n * np.log(2.0), np.full(n.shape, prior_log)])
    for a, b, sc in ((r_l2, lpp2, scale), (r_l1, lpp1, np.maximum(np.abs(lpp1), prior_log))):
        fin = np.isfinite(b)
        assert (np.abs(a[fin] - b[fin]) <= 2 * np.spacing(sc[fin])).all()
    assert_pvalues_close(stats.lrt_pvalues_ref(torch.from_numpy(r_l2), torch.from_numpy(r_l1)).numpy(), r_p1)
    assert_pvalues_close(stats.lrt_pvalues_ref(torch.from_numpy(r_l1), torch.from_numpy(r_l2)).numpy(), r_p2)


def test_b6_full_stage_is_its_plain_version():
    counts, major, second, log_hom, log_het = finalize_cases(n=2000, seed=4)
    got = qf.finalize_lrt(counts, major, second, log_hom, log_het, 1e-3, ALPHA, "cpu")
    want = _quality_plain(counts, major, second, log_hom, log_het, 1e-3)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


# ---- engine.run and run_streaming ----

VARIANTS = {
    "local": {},
    "local-R": {"estimate_prior": True},
    "quality": {"method": "quality"},
    "quality-R": {"method": "quality", "estimate_prior": True},
    "LR": {"method": "likelihood_ratio"},
    "LR-R": {"method": "likelihood_ratio", "estimate_prior": True},
}


@pytest.fixture(scope="module")
def golden():
    return _read("golden.pileup")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_run_matches_sid_tpu(golden, variant):
    kw = VARIANTS[variant]
    want_diag, got_diag = [], []
    want = ref_engine.run(golden, RefOptions(exact_pvalues=False, **kw), want_diag.append, binary=True)
    got = engine.run(golden, Options(platform="cpu", exact_pvalues=False, **kw), got_diag.append, binary=True)
    assert got_diag == want_diag
    assert got.count(b"\n") > 300
    assert_csv_close(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_call_batch_matches_the_host_libm_path(golden, variant):
    """The same call with the host-libm LRT: the same logs, so every
    p-value to 1e-13, alleles equal, calls apart only at alpha."""
    kw = VARIANTS[variant]
    reads = kw.get("method") == "quality"
    batch = parse_pileup(golden, reads, reads, quality_terms_only=reads)
    dev = engine.call_batch(batch, Options(platform="cpu", exact_pvalues=False, **kw))
    host = engine.call_batch(batch, Options(platform="cpu", **kw))
    assert np.array_equal(dev.major, host.major) and np.array_equal(dev.second, host.second)
    assert_pvalues_close(dev.conf_hom, host.conf_hom)
    assert_pvalues_close(dev.conf_het, host.conf_het)
    assert_het_close(dev.is_het, host.is_het, host.conf_het, ALPHA)


@pytest.fixture(scope="module")
def synth_text():
    counts = simulate_diploid_counts(2500, coverage=25, pi=0.02, eps=0.01, seed=41)
    return phred_pileup(counts, seed=42)


@pytest.mark.parametrize("variant", ["local", "LR-R", "quality", "local-R"])
def test_streaming_is_byte_equal_to_in_memory(tmp_path, synth_text, variant):
    src = tmp_path / "in.pileup"
    src.write_bytes(synth_text)
    opts = Options(platform="cpu", exact_pvalues=False, **VARIANTS[variant])
    out = io.BytesIO()
    engine.run_streaming(str(src), opts, out=out, chunk_bytes=20_000)
    assert out.getvalue() == engine.run(str(src), opts, binary=True)
    assert out.getvalue().count(b"\n") > 2000


def test_c6_deep_profile_follows_long_double():
    """Fault C6: sid_tpu's classify_local has no long-double range screen,
    so a (9000, 9000, 0, 0) profile gets its log-space call there; the port
    screens it and classifies it in host long double, the reference's -nan
    row."""
    counts = np.vstack([simulate_diploid_counts(300, coverage=25, pi=0.02, eps=0.01, seed=5),
                        [[9000, 9000, 0, 0]]])
    src = make_pileup_text(counts, with_qualities=True)
    got = engine.run(src, Options(platform="cpu", exact_pvalues=False), binary=True)
    ld = local.call_local_ld(parse_pileup(src), Options()).to_csv_bytes()
    want = ref_engine.run(src, RefOptions(exact_pvalues=False), binary=True)
    assert got.split(b"\n")[301] == ld.split(b"\n")[301] == b"chr1,301,hom,CC,-nan,-nan,p_value"
    assert want.split(b"\n")[301] == b"chr1,301,het,CA,1,0,p_value"
    assert_csv_close(got, ld)
    differ = [k for k, (a, b) in enumerate(zip(got.split(b"\n"), want.split(b"\n"))) if a != b]
    assert differ == [301]
