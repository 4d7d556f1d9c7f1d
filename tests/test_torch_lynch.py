"""The port's Lynch marginals and objective vs sid_tpu's, on the CPU.

``sid_tpu_torch.ops.likelihoods`` (plain torch f64: the CPU path, and the
oracle of the CUDA kernels B2 and B4 on the card) is held against sid_tpu's
XLA f64 ``ops.likelihoods`` over a grid of (pi, epsilon), including the box
edges, a theta outside the box and a base composition with a zero base.
Both compute the same log-space math through other log/exp implementations
and other summation orders, so non-finite positions must be identical and
finite values agree to 1e-12 relative; DBL_MAX outside the box is exact.
Inputs are made with numpy from a seed and handed to both packages.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sid_tpu.ops import lgamma as ref_lgamma  # noqa: E402
from sid_tpu.ops import likelihoods as ref_lk  # noqa: E402
from sid_tpu_torch.ops import likelihoods as lk  # noqa: E402
from sid_tpu_torch.ops import lynch_objective  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from sid_tpu_torch.ops.profiles import nucleotide_distribution  # noqa: E402
from test_torch_local_classify import assert_agree  # noqa: E402

THETAS = [
    (1e-3, 1e-3), (0.05, 0.01), (0.0, 1e-3), (1e-3, 0.0), (1.0, 1.0),
    (0.5, 0.999), (-0.1, 0.5), (0.02, 3.85e-11), (0.3, 1.5),
]
EPSILONS = [1e-3, 0.01, 3.85e-11, 0.0, 0.5, 0.999, 1.0]
DBL_MAX = float(np.finfo(np.float64).max)


def lynch_profiles(n=4000, seed=21):
    """~25x diploid-like rows, the reference's edge cases and deep rows."""
    rng = np.random.default_rng(seed)
    prof = rng.multinomial(25, [0.9, 0.05, 0.03, 0.02], n)
    prof = rng.permuted(prof, axis=1)
    prof[:12] = [
        [0, 0, 0, 0], [1, 0, 0, 0], [4, 0, 0, 0], [2, 2, 0, 0], [10, 10, 10, 10],
        [3000, 2800, 0, 0], [9000, 9000, 0, 0], [15000, 0, 5000, 0],
        [12000, 6000, 10, 0], [65535, 0, 0, 0], [65535, 65535, 65535, 65535],
        [1, 2, 3000, 2900],
    ]
    mult = rng.integers(1, 300, n).astype(np.int64)
    return prof.astype(np.int32), mult


def _nt(kind, prof, mult):
    if kind == "data":
        return nucleotide_distribution(prof, mult)
    return np.array([0.5, 0.3, 0.0, 0.2])  # a base that never occurs


@pytest.fixture(scope="module")
def data():
    prof, mult = lynch_profiles()
    max_cov = int(prof.sum(-1).max())
    return {
        "prof": prof,
        "mult": mult,
        "tab_j": jnp.asarray(ref_lgamma.lgamma_int_table(ref_lgamma.table_size(max_cov))),
        "tab_t": lgamma_table(max_cov, "cpu"),
    }


@pytest.mark.parametrize("nt_kind", ["data", "zero-base"])
@pytest.mark.parametrize("eps", EPSILONS)
def test_marginals_match_sid_tpu(data, eps, nt_kind):
    prof = data["prof"]
    nt = _nt(nt_kind, prof, data["mult"])
    for ref_fn, fn in (
        (ref_lk.log_hom_marginal, lk.log_hom_marginal),
        (ref_lk.log_het_marginal, lk.log_het_marginal),
    ):
        want = np.asarray(ref_fn(jnp.asarray(prof), eps, jnp.asarray(nt), data["tab_j"]))
        got = fn(torch.from_numpy(prof), eps, nt, data["tab_t"]).numpy()
        assert_agree(got, want, 1e-12)


@pytest.mark.parametrize("nt_kind", ["data", "zero-base"])
@pytest.mark.parametrize("theta", THETAS)
def test_objective_matches_sid_tpu(data, theta, nt_kind):
    prof, mult = data["prof"], data["mult"]
    nt = _nt(nt_kind, prof, mult)
    want = float(ref_lk.compound_neg_log_likelihood(
        jnp.asarray(theta), jnp.asarray(prof), jnp.asarray(mult), jnp.asarray(nt), data["tab_j"]
    ))
    got = float(lk.compound_neg_log_likelihood(
        theta, torch.from_numpy(prof), torch.from_numpy(mult), nt, data["tab_t"]
    ))
    in_box = 0 <= theta[0] <= 1 and 0 <= theta[1] <= 1
    if not in_box:
        assert got == want == DBL_MAX
    else:
        assert math.isfinite(got) and abs(got - want) <= 1e-12 * max(1.0, abs(want))


def test_one_base_input_is_nan_as_in_sid_tpu(data):
    # sum nt^2 == 1: every log(nt_i nt_j) is -inf and log1p(-1) = -inf, so
    # L_het is -inf - (-inf) = NaN in sid_tpu; the port mirrors it
    prof = np.array([[5, 0, 0, 0], [7, 0, 0, 0]], np.int32)
    mult = np.array([3, 1], np.int64)
    nt = np.array([1.0, 0.0, 0.0, 0.0])
    want = float(ref_lk.compound_neg_log_likelihood(
        jnp.asarray([0.01, 0.01]), jnp.asarray(prof), jnp.asarray(mult), jnp.asarray(nt),
        data["tab_j"],
    ))
    got = float(lk.compound_neg_log_likelihood(
        (0.01, 0.01), torch.from_numpy(prof), torch.from_numpy(mult), nt, data["tab_t"]
    ))
    assert math.isnan(want) and math.isnan(got)


@pytest.mark.parametrize("u", [0, 1, 1023, 1024, 1025, 300_000])
def test_fixed_order_sum_is_the_kernels_order(u):
    rng = np.random.default_rng(u)
    x = rng.standard_normal(u) * 10.0 ** rng.integers(-3, 4, u)
    got = float(lk.fixed_order_sum(torch.from_numpy(x)))
    # the spec, written as loops: per chunk, thread sums in k order, a tree
    c, t, k = lk.CHUNK_ROWS, lk.REDUCE_THREADS, lk.ROWS_PER_THREAD

    def tree(v):
        v = list(v)
        s = len(v) // 2
        while s:
            v = [v[i] + v[i + s] for i in range(s)]
            s //= 2
        return v[0]

    pad = np.zeros(-(-u // c) * c)
    pad[:u] = x
    parts = []
    for chunk in pad.reshape(-1, k, t):
        acc = np.zeros(t)
        for row in chunk:
            acc = acc + row
        parts.append(tree(acc))
    rounds = np.zeros(-(-len(parts) // t) * t)
    rounds[: len(parts)] = parts
    acc = np.zeros(t)
    for row in rounds.reshape(-1, t):
        acc = acc + row
    assert got == tree(acc)
    assert abs(got - math.fsum(x)) <= 1e-12 * max(1.0, float(np.abs(x).sum()))


def test_screen_flags_deep_rows_only(data):
    prof, mult = data["prof"], data["mult"]
    nt = nucleotide_distribution(prof, mult)
    rows = lk.lynch_rows(torch.from_numpy(prof), lk.lynch_scalars(0.01, 0.01, nt), data["tab_t"])
    mix = np.nonzero(rows.flag_mixture.numpy())[0]
    marg = np.nonzero(rows.flag_marginals.numpy())[0]
    # mc overflows: (9000, 9000, 0, 0), (12000, 6000, 10, 0), (65535 x 4);
    # both components underflow without it: (15000, 0, 5000, 0)
    assert set(mix) == {6, 7, 8, 10}
    # one marginal underflows where the mixture ignores it: the het of
    # (65535, 0, 0, 0), the hom of (3000, 2800, 0, 0) and (1, 2, 3000, 2900)
    assert set(marg) == {5, 6, 7, 8, 9, 10, 11}
    assert not rows.flag_mixture[12:].any() and not rows.flag_marginals[12:].any()


def test_wrappers_on_cpu_take_plain_path(data):
    prof = torch.from_numpy(data["prof"])
    mult = torch.from_numpy(data["mult"])
    s = lk.lynch_scalars(0.05, 0.01, nucleotide_distribution(data["prof"], data["mult"]))
    before = (lynch_objective.NLL_LAUNCHES, lynch_objective.MARGINALS_LAUNCHES)
    out, flags = lynch_objective.lynch_compound_nll(prof, mult, s, data["tab_t"])
    marg = lynch_objective.lynch_marginals(prof, s, data["tab_t"])
    assert (lynch_objective.NLL_LAUNCHES, lynch_objective.MARGINALS_LAUNCHES) == before
    want_out, want_flags = lynch_objective.lynch_compound_nll_ref(prof, mult, s, data["tab_t"])
    assert torch.equal(out, want_out) and torch.equal(flags, want_flags)
    assert int(out[1]) == int(flags.sum()) == 4
    for a, b in zip(marg, lynch_objective.lynch_marginals_ref(prof, s, data["tab_t"])):
        assert torch.equal(torch.nan_to_num(a.double()), torch.nan_to_num(b.double()))


def test_wrappers_reject_what_the_kernels_do_not_take(data):
    prof = torch.zeros((8, 4), dtype=torch.int32)
    mult = torch.ones(8, dtype=torch.int64)
    tab = lgamma_table(0, "cpu")
    s = lk.lynch_scalars(0.01, 0.01, [0.25] * 4)
    f = lynch_objective.lynch_compound_nll
    with pytest.raises(TypeError):
        f(prof.to(torch.int64), mult, s, tab)
    with pytest.raises(TypeError):
        f(prof, mult.to(torch.int32), s, tab)
    with pytest.raises(ValueError):
        f(prof[:, :3], mult, s, tab)
    with pytest.raises(ValueError):
        f(prof, mult[:4], s, tab)
    with pytest.raises(ValueError):
        f(prof, mult, s[:15], tab)
    with pytest.raises(ValueError):
        f(prof.t().contiguous().t(), mult, s, tab)
    # a device with no kernel and no plain path: raise, never fall back
    with pytest.raises(ValueError, match="no Lynch objective kernel"):
        f(prof.to("meta"), mult.to("meta"), s, tab.to("meta"))
    with pytest.raises(ValueError, match="no Lynch marginals kernel"):
        lynch_objective.lynch_marginals(prof.to("meta"), s, tab.to("meta"))


def test_records_ref_is_the_packed_record(data):
    """The plain version of the set-up kernel: m of sid_tpu (to 1e-12) and
    of log_multinomial (bitwise), the multiplicity with the theta-free
    screen in its sign bit, the counts as four uint16, c0 lowest."""
    prof, mult = data["prof"], data["mult"]
    rec = lynch_objective.lynch_records_ref(torch.from_numpy(prof), torch.from_numpy(mult), data["tab_t"])
    assert rec.shape == (lynch_objective.RECORD_PLANES, prof.shape[0]) and rec.dtype == torch.float64
    m = lk.log_multinomial(torch.from_numpy(prof), data["tab_t"]).numpy()
    assert np.array_equal(rec[0].numpy().view(np.int64), m.view(np.int64))
    assert_agree(m, np.asarray(ref_lk.log_multinomial(jnp.asarray(prof), data["tab_j"])), 1e-12)
    over = m > lk.SAFE_MAX
    assert over.sum() == 3  # (9000, 9000, 0, 0), (12000, 6000, 10, 0), (65535 x 4)
    w = rec[1].numpy()
    assert np.array_equal(np.signbit(w), over) and np.array_equal(np.abs(w), mult.astype(np.float64))
    c = prof.astype(np.uint64)
    packed = c[:, 0] | (c[:, 1] << np.uint64(16)) | (c[:, 2] << np.uint64(32)) | (c[:, 3] << np.uint64(48))
    assert np.array_equal(rec[2].numpy().view(np.uint64), packed)


def test_workspace_on_cpu_is_the_plain_version(data):
    prof = torch.from_numpy(data["prof"])
    mult = torch.from_numpy(data["mult"])
    tab = data["tab_t"]
    nt = nucleotide_distribution(data["prof"], data["mult"])
    counts = (lynch_objective.RECORD_LAUNCHES, lynch_objective.NLL_LAUNCHES,
              lynch_objective.MARGINALS_LAUNCHES)
    work = lynch_objective.LynchWorkspace(prof, mult, tab)
    for theta in [(1e-3, 1e-3), (0.05, 0.01), (0.5, 0.999)]:
        s = lk.lynch_scalars(theta[0], theta[1], nt)
        total, n_flagged = work.nll(s)
        want, want_flags = lynch_objective.lynch_compound_nll_ref(prof, mult, s, tab)
        assert [total, n_flagged] == want.tolist()
        assert torch.equal(work.flags, want_flags)
        out, flags = lynch_objective.lynch_compound_nll(prof, mult, s, tab, work=work)
        assert torch.equal(out, want) and torch.equal(flags, want_flags)
    s = lk.lynch_scalars(0.0, 0.01, nt)
    got = work.marginals_host(s)
    for a, b in zip(got, lynch_objective.lynch_marginals_ref(prof, s, tab)):
        assert isinstance(a, np.ndarray)
        assert np.array_equal(a, b.numpy(), equal_nan=a.dtype.kind == "f")
    assert counts == (lynch_objective.RECORD_LAUNCHES, lynch_objective.NLL_LAUNCHES,
                      lynch_objective.MARGINALS_LAUNCHES)


def test_workspace_rejects_counts_it_cannot_pack_and_other_rows():
    prof = torch.zeros((8, 4), dtype=torch.int32)
    mult = torch.ones(8, dtype=torch.int64)
    tab = lgamma_table(4 * 65536, "cpu")
    s = lk.lynch_scalars(0.01, 0.01, [0.25] * 4)
    f = lynch_objective.lynch_compound_nll
    Workspace = lynch_objective.LynchWorkspace
    for value in (65536, -1):
        bad = prof.clone()
        bad[3, 2] = value
        with pytest.raises(ValueError, match="counts must be in 0..65535"):
            Workspace(bad, mult, tab)
        with pytest.raises(ValueError, match="counts must be in 0..65535"):
            f(bad, mult, s, tab)
        with pytest.raises(ValueError, match="counts must be in 0..65535"):
            lynch_objective.lynch_marginals(bad, s, tab)
    with pytest.raises(ValueError, match="multiplicities must be >= 0"):
        Workspace(prof, -mult, tab)
    Workspace(torch.full((8, 4), 65535, dtype=torch.int32), mult, tab)  # the largest count
    work = Workspace(prof, mult, tab)
    f(prof, mult, s, tab, work=work)
    for args in ((prof.clone(), mult, s, tab), (prof, mult.clone(), s, tab), (prof, mult, s, tab.clone()),
                 (prof[:4], mult[:4], s, tab)):
        with pytest.raises(ValueError, match="made for other rows"):
            f(*args, work=work)
    with pytest.raises(ValueError, match="mult must be"):
        Workspace(prof, mult[:4], tab)
    with pytest.raises(ValueError, match="16 values"):
        work.nll(s[:15])
    # a device with no kernel and no plain path, or tensors on two devices
    with pytest.raises(ValueError, match="no Lynch kernel for device meta"):
        Workspace(prof.to("meta"), mult.to("meta"), tab.to("meta"))
    with pytest.raises(ValueError, match="mult is on meta"):
        Workspace(prof, mult.to("meta"), tab)
