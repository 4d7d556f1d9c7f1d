"""The port's ``-m local`` path end to end vs sid_tpu's, byte for byte.

``sid_tpu_torch.engine.run`` on the CPU (the torch f64 twin of the kernel)
must write the same CSV bytes as ``sid_tpu.engine.run`` (its host
long-double classifier at these sizes) on the golden fixture, the
real-data-shaped fixture, simulated diploid data and a pileup of
adversarial profiles, at the option variants below. The port's own two
placements — device path (l1, l2) + host LRT, and the host long-double
classifier — must agree byte for byte as well.
"""

import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import local  # noqa: E402
from sid_tpu_torch.utils.format import fmt_g  # noqa: E402
from synth import (  # noqa: E402
    make_pileup_text,
    make_pileup_text_fast,
    simulate_diploid_counts,
)
from test_torch_local_classify import adversarial_profiles  # noqa: E402
from test_torch_lrt import assert_csv_close  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

VARIANTS = {
    "default": {},
    "r1e-3": {"snp_prior": 1e-3},
    "r0.5": {"snp_prior": 0.5},
    "E0": {"site_error_threshold": 0.0},
    "E1": {"site_error_threshold": 1.0},
    "p0.01": {"significance_level": 0.01},
    "io-python": {"io_backend": "python"},
}


def _read(*parts):
    with open(os.path.join(FIXTURES, *parts), "rb") as f:
        return f.read()


def deep_profiles(n=400, seed=13):
    """Deep coverage, where the reference's linear long doubles overflow or
    underflow (mc = inf at ~18000x of two alleles) and log space does not."""
    rng = np.random.default_rng(seed)
    cov = np.exp(rng.uniform(np.log(1000), np.log(40000), n)).astype(np.int64)
    p = rng.dirichlet([4, 2, 0.3, 0.1], n)
    prof = np.stack([rng.multinomial(c, q) for c, q in zip(cov, p)])
    prof[:5] = [
        [9000, 9000, 0, 0], [12000, 6000, 10, 0], [8000, 8000, 0, 0],
        [20000, 100, 0, 0], [65535, 65535, 65535, 65535],
    ]
    return np.minimum(prof, 65535)


@pytest.fixture(scope="module")
def inputs():
    real_gz = _read("realdata", "bwa_like_100k.pileup.gz")
    real_raw = gzip.decompress(real_gz)
    return {
        "golden": _read("golden.pileup"),
        "realdata": real_gz,
        # the Python grammar spec is slow: its variant runs on a 20k-site cut
        "realdata20k": b"\n".join(real_raw.split(b"\n")[:20000]) + b"\n",
        "synth": make_pileup_text(
            simulate_diploid_counts(3000, coverage=20, pi=0.05, eps=0.01, seed=5),
            with_qualities=True,
        ),
        "adversarial": make_pileup_text_fast(adversarial_profiles()),
        "deep": make_pileup_text_fast(deep_profiles()),
    }


def _cases():
    for name in ("golden", "realdata", "synth", "adversarial", "deep"):
        for variant in VARIANTS:
            if name == "realdata" and variant == "io-python":
                name = "realdata20k"
            if name == "deep" and variant == "io-python":
                continue  # megabytes of bases through the Python grammar spec
            yield name, variant


@pytest.mark.parametrize("name,variant", list(_cases()))
def test_csv_byte_equal_to_sid_tpu(inputs, name, variant):
    kw = VARIANTS[variant]
    src = inputs[name]
    want = ref_engine.run(src, RefOptions(**kw), binary=True)
    got = engine.run(src, Options(platform="cpu", **kw), binary=True)
    assert got.count(b"\n") == want.count(b"\n")
    if got != want:
        g, w = got.split(b"\n"), want.split(b"\n")
        k = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        pytest.fail(f"first differing line {k}: port {g[k]!r} vs sid_tpu {w[k]!r}")


def test_golden_fixture():
    got = engine.run(_read("golden.pileup"), Options(platform="cpu"), binary=True)
    assert got == _read("golden_local.csv")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", ["realdata", "synth", "adversarial"])
def test_device_path_equals_host_long_double(inputs, name, variant):
    opts = Options(platform="cpu", **VARIANTS[variant])
    src = inputs["realdata20k" if variant == "io-python" and name == "realdata" else name]
    batch = parse_pileup(src, backend=opts.io_backend)
    dev = local.call_local(batch, opts).to_csv_bytes()
    ld = local.call_local_ld(batch, opts).to_csv_bytes()
    assert dev == ld


@pytest.mark.parametrize("thr", [0.0, 1e-300, 1e-3, 0.1, 0.5, 1.0, 1.2, 2.0, -0.1, float("nan")])
@pytest.mark.parametrize("prior", [-1.0, 1e-300, 1e-3, 0.999])
def test_long_double_range_screen_is_conservative(thr, prior):
    """Every profile the screen clears gives the long-double classifier's
    p-values (as %g) and calls through the device path."""
    rng = np.random.default_rng(17)
    cov = np.exp(rng.uniform(0, np.log(262140), 1500)).astype(np.int64)
    p = rng.dirichlet([3, 2, 0.5, 0.2], cov.size)
    prof = np.stack([rng.multinomial(c // 4 * 4, q) for c, q in zip(cov, p)])
    prof = np.unique(np.minimum(prof, 65535).astype(np.int32), axis=0)
    opts = Options(platform="cpu", site_error_threshold=thr)
    dev = local.classify_profiles_local(prof, opts, prior)
    ld = local.classify_profiles_local_ld(prof, opts, prior)
    assert np.array_equal(dev[0], ld[0])
    for a, b in ((dev[3], ld[3]), (dev[4], ld[4])):
        assert [fmt_g(x) for x in a] == [fmt_g(x) for x in b]


def test_screen_clears_realistic_coverage(inputs):
    batch = parse_pileup(inputs["realdata"])
    cov = batch.counts.sum(-1, dtype=np.int64)
    assert not local.long_double_range_rows(cov, 0.1, -1.0).any()
    assert not local.long_double_range_rows(cov, 0.1, 1e-3).any()


def test_unknown_method_is_header_only():
    out = engine.run(_read("golden.pileup"), Options(method="bogus", platform="cpu"))
    assert out == ref_engine.run(_read("golden.pileup"), RefOptions(method="bogus"))
    assert out == "chrom,pos,label,gt,hom_conf,het_conf,conf_type\n"


def test_empty_input():
    want = ref_engine.run(b"", RefOptions(), binary=True)
    assert engine.run(b"", Options(platform="cpu"), binary=True) == want


# options that raised NotPortedError before the Lynch-fit slice and the
# quality and streaming slice ported them (``stream`` is a CLI mode: through
# engine.run it calls the input in memory, as sid_tpu's does)
PORTED_SINCE = ({"method": "bayes"}, {"method": "likelihood_ratio"},
                {"estimate_prior": True}, {"engine": "exact"}, {"method": "quality"},
                {"stream": True})
# the fused on-device LRT, ported since: its p-values come from another erfc,
# so its CSV is held to sid_tpu's by the device-LRT tolerance, not bytes
DEVICE_LRT = {"exact_pvalues": False}


@pytest.mark.parametrize("kw", [
    {"method": "bayes"}, {"method": "likelihood_ratio"}, {"method": "quality"},
    {"estimate_prior": True}, {"engine": "exact"}, {"stream": True},
    {"per_shard_fit": True}, {"mesh_devices": 2}, {"exact_pvalues": False},
])
def test_unported_options_raise(kw):
    """Unported options raise; the ported ones give sid_tpu's bytes (the
    device LRT: sid_tpu's CSV by its tolerance) and diagnostic lines."""
    from sid_tpu_torch.utils.errors import NotPortedError

    src = _read("golden.pileup")
    if kw in PORTED_SINCE or kw == DEVICE_LRT:
        want_diag, got_diag = [], []
        want = ref_engine.run(src, RefOptions(**kw), want_diag.append, binary=True)
        got = engine.run(src, Options(platform="cpu", **kw), got_diag.append, binary=True)
        assert got_diag == want_diag
        if kw == DEVICE_LRT:
            assert_csv_close(got, want)
        else:
            assert got == want
        assert got.count(b"\n") > 1
        return
    with pytest.raises(NotPortedError, match="not yet ported in sid_tpu_torch"):
        engine.run(src, Options(platform="cpu", **kw))


def test_cuda_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.run(_read("golden.pileup"), Options())
