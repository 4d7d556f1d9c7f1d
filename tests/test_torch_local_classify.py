"""The port's slim local classify vs sid_tpu's, on the CPU.

``sid_tpu_torch.ops.local_classify.local_log_likelihoods_ref`` (plain torch
f64, the CPU path and the CUDA kernel's oracle on the card) is held against

- sid_tpu's XLA f64 twin ``models.local.local_log_likelihoods``: the same
  math through other log implementations and another summation order, so
  non-finite positions must be identical and finite values agree to
  1e-12 relative (measured differences are below 1e-13);
- sid_tpu's Pallas kernel ``ops.pallas_classify.local_log_likelihoods_pallas``
  in interpret mode: double-single arithmetic good to about 2^-48, so
  1e-10 relative.

Inputs are made with numpy from a seed and handed to both packages. The
CUDA kernel itself runs only on the card (chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sid_tpu.models import local as ref_local  # noqa: E402
from sid_tpu.ops import lgamma as ref_lgamma  # noqa: E402
from sid_tpu_torch.models.common import major_allele_indices_np  # noqa: E402
from sid_tpu_torch.ops import local_classify  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402

THRESHOLDS = [0.0, 0.1, 1.0]


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


def port_ref(profiles, thr):
    prof = profiles.astype(np.int32)
    major, second = major_allele_indices_np(prof)
    l1, l2 = local_classify.local_log_likelihoods_ref(
        torch.from_numpy(prof), torch.from_numpy(major), torch.from_numpy(second),
        thr, lgamma_table(int(prof.sum(-1).max()), "cpu"),
    )
    return l1.numpy(), l2.numpy()


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
    got = port_ref(profiles, thr)
    for a, b in zip(got, want):
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
    got = port_ref(prof, thr)
    for a, b in zip(got, want):
        assert_agree(a, np.asarray(b), 1e-10)


def test_wrapper_on_cpu_takes_plain_path():
    prof = adversarial_profiles().astype(np.int32)
    major, second = major_allele_indices_np(prof)
    args = (
        torch.from_numpy(prof), torch.from_numpy(major), torch.from_numpy(second),
        0.1, lgamma_table(int(prof.sum(-1).max()), "cpu"),
    )
    before = local_classify.LAUNCHES
    got = local_classify.local_log_likelihoods(*args)
    assert local_classify.LAUNCHES == before
    want = local_classify.local_log_likelihoods_ref(*args)
    for a, b in zip(got, want):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    prof = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros(8, dtype=torch.int32)
    tab = lgamma_table(0, "cpu")
    f = local_classify.local_log_likelihoods
    with pytest.raises(TypeError):
        f(prof.to(torch.int64), idx, idx, 0.1, tab)
    with pytest.raises(TypeError):
        f(prof, idx, idx, 0.1, tab.to(torch.float32))
    with pytest.raises(ValueError):
        f(prof[:, :3], idx, idx, 0.1, tab)
    with pytest.raises(ValueError):
        f(prof, idx[:4], idx, 0.1, tab)
    with pytest.raises(ValueError):
        f(prof.t().contiguous().t(), idx, idx, 0.1, tab)  # non-contiguous
    # a device with no kernel and no plain path: raise, never fall back
    meta = [t.to("meta") for t in (prof, idx, idx)]
    with pytest.raises(ValueError, match="no local classify kernel"):
        f(meta[0], meta[1], meta[2], 0.1, tab.to("meta"))


def test_empty_input():
    prof = torch.zeros((0, 4), dtype=torch.int32)
    idx = torch.zeros(0, dtype=torch.int32)
    l1, l2 = local_classify.local_log_likelihoods(prof, idx, idx, 0.1, lgamma_table(0, "cpu"))
    assert l1.shape == (0,) and l2.shape == (0,) and l1.dtype == torch.float64
