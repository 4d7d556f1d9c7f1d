"""The port's local classify vs sid_tpu's, on the CPU.

``sid_tpu_torch.ops.local_classify.local_classify_ref`` (plain torch f64,
the CPU path and the CUDA kernel's oracle on the card) is held against

- sid_tpu's XLA f64 twin ``models.local.local_log_likelihoods``: the same
  math through other log implementations and another summation order, so
  non-finite positions must be identical and finite values agree to
  1e-12 relative (measured differences are below 1e-13);
- sid_tpu's Pallas kernel ``ops.pallas_classify.local_log_likelihoods_pallas``
  in interpret mode: double-single arithmetic good to about 2^-48, so
  1e-10 relative;
- for its byte: sid_tpu's top-2 programs ``models.common.major_allele_indices``
  (XLA on the CPU) and ``major_allele_indices_np``, and the port's host
  range screen ``models.local.long_double_range_rows``, bitwise.

Inputs are made with numpy from a seed and handed to both packages. The
CUDA kernel itself runs only on the card (chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sid_tpu.models import common as ref_common  # noqa: E402
from sid_tpu.models import local as ref_local  # noqa: E402
from sid_tpu.ops import lgamma as ref_lgamma  # noqa: E402
from sid_tpu_torch.models import local  # noqa: E402
from sid_tpu_torch.models.common import major_allele_indices_np  # noqa: E402
from sid_tpu_torch.ops import lgamma, local_classify  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402

THRESHOLDS = [0.0, 0.1, 1.0]
# the -E x prior grid of test_torch_slice.py's range-screen test
SCREEN_THRESHOLDS = [0.0, 1e-300, 1e-3, 0.1, 0.5, 1.0, 1.2, 2.0, -0.1, float("nan")]
SCREEN_PRIORS = [-1.0, 1e-300, 1e-3, 0.999]


def adversarial_profiles():
    """The edge cases of tests/test_native_local_ld.py over a random bulk."""
    rng = np.random.default_rng(11)
    prof = rng.integers(0, 60, (8192, 4)).astype(np.uint16)
    prof[0] = 0  # zero coverage: 0/0 error -> NaN -> xlogy(0, .) == 0
    prof[1] = [1, 0, 0, 0]
    prof[2] = [0, 0, 0, 1]
    prof[3] = [3000, 2, 1, 0]  # deep coverage: underflow clamp -> p = 0
    prof[4] = [800, 800, 0, 0]  # balanced het, large n
    prof[5] = [10, 10, 10, 10]  # 4-way tie
    prof[6] = [2, 2, 0, 0]
    prof[7] = [65535, 0, 0, 0]  # uint16 extreme
    return prof


def bulk_profiles(n=20000, seed=7):
    rng = np.random.default_rng(seed)
    prof = rng.integers(0, 200, (n, 4)).astype(np.uint16)
    prof[rng.integers(0, n, 50)] = 0
    prof[rng.integers(0, n, 50), rng.integers(0, 4, 50)] = 5000
    return prof


def tie_profiles(seed=3):
    """Every pattern of ties: rows drawn from few values, so most rows tie
    two, three or four counts, at small and uint16-extreme values."""
    rng = np.random.default_rng(seed)
    vals = np.array([0, 1, 2, 7, 30, 65534, 65535])
    return vals[rng.integers(0, vals.size, (6000, 4))].astype(np.uint16)


def deep_screen_profiles(seed=17):
    """Coverage from 1 to 262140 on a log scale (test_torch_slice.py's
    range-screen input), so every threshold of the screen is crossed."""
    rng = np.random.default_rng(seed)
    cov = np.exp(rng.uniform(0, np.log(262140), 1500)).astype(np.int64)
    p = rng.dirichlet([3, 2, 0.5, 0.2], cov.size)
    prof = np.stack([rng.multinomial(c // 4 * 4, q) for c, q in zip(cov, p)])
    return np.minimum(prof, 65535).astype(np.uint16)


def classify_ref(profiles, thr, prior=-1.0):
    """local_classify_ref on numpy counts: (l1, l2, packed) as numpy."""
    counts = torch.from_numpy(np.ascontiguousarray(profiles, np.uint16))
    tab = lgamma_table(int(profiles.astype(np.int64).sum(-1).max()), "cpu")
    return tuple(t.numpy() for t in local_classify.local_classify_ref(counts, thr, prior, tab))


def assert_agree(a, b, rtol):
    for pred in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(pred(a), pred(b)), pred.__name__
    fin = np.isfinite(a)
    err = np.abs(a[fin] - b[fin])
    bound = rtol * np.maximum(1.0, np.abs(a[fin]))
    worst = int(np.argmax(err / bound)) if err.size else 0
    assert (err <= bound).all(), (err[worst], a[fin][worst], b[fin][worst])


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("make", [adversarial_profiles, bulk_profiles])
def test_plain_matches_jax_f64(make, thr):
    profiles = make()
    prof = profiles.astype(np.int32)
    major, second = major_allele_indices_np(prof)
    tab = ref_lgamma.lgamma_int_table(ref_lgamma.table_size(int(prof.sum(-1).max())))
    want = ref_local.local_log_likelihoods(
        jnp.asarray(prof), jnp.asarray(major), jnp.asarray(second),
        jnp.float64(thr), jnp.asarray(tab),
    )
    got = classify_ref(profiles, thr)
    for a, b in zip(got[:2], want):
        assert_agree(a, np.asarray(b), 1e-12)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_plain_matches_pallas_interpret(thr):
    from sid_tpu.ops.likelihoods_ds import lgamma_table_ds
    from sid_tpu.ops.pallas_classify import local_log_likelihoods_pallas

    prof = adversarial_profiles()[:1024].astype(np.int32)
    major, second = major_allele_indices_np(prof)
    tsize = ref_lgamma.table_size(int(prof.sum(-1).max()))
    want = local_log_likelihoods_pallas(
        jnp.asarray(prof), jnp.asarray(major), jnp.asarray(second),
        jnp.float64(thr), lgamma_table_ds(tsize), interpret=True,
    )
    got = classify_ref(prof, thr)
    for a, b in zip(got[:2], want):
        assert_agree(a, np.asarray(b), 1e-10)


@pytest.mark.parametrize("make", [adversarial_profiles, bulk_profiles, tie_profiles])
def test_alleles_match_sid_tpu_bitwise(make):
    profiles = make()
    _, _, packed = classify_ref(profiles, 0.1)
    major, second, _ = local_classify.unpack(packed)
    want_np = major_allele_indices_np(profiles.astype(np.int32))
    want_jax = ref_common.major_allele_indices(jnp.asarray(profiles.astype(np.int32)))
    for want in (want_np, want_jax):
        assert np.array_equal(major, np.asarray(want[0]))
        assert np.array_equal(second, np.asarray(want[1]))
        assert major.dtype == second.dtype == np.int32


@pytest.mark.parametrize("prior", SCREEN_PRIORS)
@pytest.mark.parametrize("thr", SCREEN_THRESHOLDS)
def test_flags_match_long_double_range_rows(thr, prior):
    profiles = deep_screen_profiles()
    _, _, packed = classify_ref(profiles, thr, prior)
    want = local.long_double_range_rows(profiles.astype(np.int64).sum(-1), thr, prior)
    assert np.array_equal(local_classify.unpack(packed)[2], want)


def test_screen_input_crosses_the_screen():
    # the flag test above sees both answers at the default -E
    cov = deep_screen_profiles().astype(np.int64).sum(-1)
    flags = local.long_double_range_rows(cov, 0.1, 1e-3)
    assert flags.any() and not flags.all()


def test_pack_unpack_round_trip():
    major = np.tile(np.repeat(np.arange(4), 4), 2)
    second = np.tile(np.arange(4), 8)
    flag = np.repeat([False, True], 16)
    packed = torch.from_numpy((major | second << 2 | flag * local_classify.FLAG_BIT).astype(np.uint8))
    got = local_classify.unpack(packed.numpy())
    assert [g.tolist() for g in got] == [major.tolist(), second.tolist(), flag.tolist()]
    assert got[0].dtype == got[1].dtype == np.int32 and got[2].dtype == bool


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint16])
def test_narrow_counts_keeps_every_value(dtype):
    prof = tie_profiles()[:500].astype(dtype)
    got, hi = local_classify.narrow_counts(prof)
    assert got.dtype == np.uint16 and hi == 65535
    assert np.array_equal(got.astype(np.int64), prof.astype(np.int64))
    out = np.empty(prof.shape, np.uint16)
    assert local_classify.narrow_counts(prof, out)[0] is out
    assert np.array_equal(out, got)


@pytest.mark.parametrize("bad", [65536, -1, 2**31 - 1, -(2**31)])
def test_stage_raises_on_counts_out_of_range(bad):
    prof = np.ones((16, 4), np.int64)
    prof[5, 2] = bad
    with pytest.raises(ValueError, match="0..65535"):
        local_classify.narrow_counts(prof)
    with pytest.raises(ValueError, match="0..65535"):
        local_classify.classify_profiles(prof, 0.1, 1e-3, "cpu")


def test_stage_on_cpu_is_the_plain_version():
    prof = adversarial_profiles().astype(np.int32)
    before = local_classify.LAUNCHES
    got = local_classify.classify_profiles(prof, 0.1, 1e-3, "cpu")
    assert local_classify.LAUNCHES == before
    want = classify_ref(prof, 0.1, 1e-3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_wrapper_on_cpu_takes_plain_path():
    prof = adversarial_profiles()
    args = (torch.from_numpy(prof), 0.1, 1e-3, lgamma_table(int(prof.astype(np.int64).sum(-1).max()), "cpu"))
    before = local_classify.LAUNCHES
    got = local_classify.local_classify(*args)
    assert local_classify.LAUNCHES == before
    want = local_classify.local_classify_ref(*args)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert torch.equal(got[2], want[2])
    # int16 holding the uint16 bits is the same input
    bits = local_classify.local_classify(args[0].view(torch.int16), *args[1:])
    assert torch.equal(bits[2], got[2])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    counts = torch.zeros((8, 4), dtype=torch.int16)
    tab = lgamma_table(0, "cpu")
    f = local_classify.local_classify
    with pytest.raises(TypeError):
        f(counts.to(torch.int32), 0.1, 1e-3, tab)  # narrow first
    with pytest.raises(TypeError):
        f(counts, 0.1, 1e-3, tab.to(torch.float32))
    with pytest.raises(ValueError):
        f(counts[:, :3], 0.1, 1e-3, tab)
    with pytest.raises(ValueError):
        f(counts.t().contiguous().t(), 0.1, 1e-3, tab)  # non-contiguous
    with pytest.raises(ValueError):
        f(counts, 0.1, 1e-3, tab[None])
    # a device with no kernel and no plain path: raise, never fall back
    with pytest.raises(ValueError, match="no local classify kernel"):
        f(counts.to("meta"), 0.1, 1e-3, tab.to("meta"))


def test_empty_input():
    counts = torch.zeros((0, 4), dtype=torch.int16)
    l1, l2, packed = local_classify.local_classify(counts, 0.1, 1e-3, lgamma_table(0, "cpu"))
    assert l1.shape == l2.shape == packed.shape == (0,)
    assert l1.dtype == torch.float64 and packed.dtype == torch.uint8
    got = local_classify.classify_profiles(np.zeros((0, 4), np.int32), 0.1, 1e-3, "cpu")
    assert [a.shape for a in got] == [(0,), (0,), (0,)]


def test_lgamma_table_is_kept_per_size_and_device():
    a = lgamma.lgamma_table(30, "cpu")
    assert lgamma.lgamma_table(1000, "cpu") is a  # the same 1024-entry table
    assert lgamma.lgamma_table(5000, "cpu") is not a
    assert lgamma.lgamma_table(5000, "cpu").shape[0] == lgamma.table_size(5000) + 1
