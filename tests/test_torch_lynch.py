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
    prof_t = torch.from_numpy(prof)
    rows = lk.lynch_rows(prof_t, lk.row_scalars(lk.lynch_scalars(0.01, 0.01, nt), prof_t), data["tab_t"])
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


def lane_cohort(seed=4):
    """Eight lanes of lynch_profiles-like rows: an empty lane, a 1-row lane,
    lanes around the chunk size, one of 12 chunks (whose chunk sums fold in
    an order that matters) and one with the deep rows."""
    rng = np.random.default_rng(seed)
    prof, mult = lynch_profiles(n=20000, seed=seed)
    sizes = [0, 1, 1023, 1024, 1025, 12, 12000, 2915]  # the last holds rows 5..11, the deep ones
    parts = []
    start = 12
    for n in sizes[:-1]:
        parts.append((prof[start:start + n], mult[start:start + n]))
        start += n
    tail = np.concatenate([prof[:12], prof[start:start + sizes[-1] - 12]])
    parts.append((tail, np.concatenate([mult[:12], mult[start:start + sizes[-1] - 12]])))
    # the 12-chunk lane's multiplicities span nine orders of magnitude, so
    # its chunk sums differ in size and their fold order shows in the bits
    big = sizes.index(12000)
    parts[big] = (parts[big][0], 10 ** rng.integers(0, 10, 12000))
    rng.shuffle(parts)
    return parts


def _stack(parts):
    prof = np.concatenate([p for p, _ in parts]).astype(np.int32)
    mult = np.concatenate([m for _, m in parts]).astype(np.int64)
    off = np.concatenate([[0], np.cumsum([len(m) for _, m in parts])]).astype(np.int64)
    return torch.from_numpy(prof), torch.from_numpy(mult), torch.from_numpy(off)


LANE_THETAS = [(1e-3, 1e-3), (0.05, 0.01), (0.0, 1e-3), (1e-3, 0.0), (1.0, 1.0), (0.5, 0.999), (0.02, 3.85e-11)]


@pytest.mark.parametrize("subset", ["all", "every-other", "one", "last-two"])
def test_lanes_plain_version_is_each_lane_alone(subset):
    parts = lane_cohort()
    prof, mult, off = _stack(parts)
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    n = len(parts)
    scalars = np.stack([
        lk.lynch_scalars(*LANE_THETAS[k % len(LANE_THETAS)], nucleotide_distribution(*parts[k])) for k in range(n)
    ])
    lanes = {"all": list(range(n)), "every-other": list(range(0, n, 2)), "one": [3], "last-two": [n - 2, n - 1]}[subset]
    out, flags = lynch_objective.lynch_compound_nll_lanes_ref(prof, mult, off.numpy(), scalars, tab, lanes)
    assert out.shape == (len(lanes), 2)
    for row, k in zip(out, lanes):
        a, b = int(off[k]), int(off[k + 1])
        want, want_flags = lynch_objective.lynch_compound_nll_ref(prof[a:b], mult[a:b], scalars[k], tab)
        assert torch.equal(row.view(torch.int64), want.view(torch.int64))
        assert torch.equal(flags[a:b], want_flags)
    outside = torch.ones(prof.shape[0], dtype=torch.bool)
    for k in lanes:
        outside[int(off[k]):int(off[k + 1])] = False
    assert not flags[outside].any()
    # the empty lane's value is a fit of no rows: +0.0 and no flagged row
    empty = [k for k, (p, _) in enumerate(parts) if p.shape[0] == 0][0]
    got, _ = lynch_objective.lynch_compound_nll_lanes_ref(prof, mult, off.numpy(), scalars, tab, [empty])
    assert got[0].tolist() == [0.0, 0.0] and not torch.signbit(got[0, 0])
    hom, het, mflags = lynch_objective.lynch_marginals_lanes_ref(prof, off.numpy(), scalars, tab)
    for k in range(n):
        a, b = int(off[k]), int(off[k + 1])
        for x, y in zip((hom[a:b], het[a:b], mflags[a:b]),
                        lynch_objective.lynch_marginals_ref(prof[a:b], scalars[k], tab)):
            assert torch.equal(torch.nan_to_num(x.double()).view(torch.int64),
                               torch.nan_to_num(y.double()).view(torch.int64))


def test_lanes_workspace_on_cpu_is_the_plain_version():
    parts = lane_cohort(seed=8)
    prof, mult, off = _stack(parts)
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    n = len(parts)
    counts = (lynch_objective.RECORD_LAUNCHES, lynch_objective.NLL_LANES_LAUNCHES,
              lynch_objective.MARGINALS_LANES_LAUNCHES)
    work = lynch_objective.LynchLanesWorkspace(prof, mult, off, tab)
    scalars = np.stack([lk.lynch_scalars(0.05, 0.01, nucleotide_distribution(*parts[k])) for k in range(n)])
    got = work.nll_lanes(scalars, [1, 4, 5])
    want, want_flags = lynch_objective.lynch_compound_nll_lanes_ref(prof, mult, off.numpy(), scalars, tab, [1, 4, 5])
    assert isinstance(got, np.ndarray) and np.array_equal(got, want.numpy())
    assert torch.equal(work.flags, want_flags)
    for a, b in zip(work.marginals_lanes_host(scalars),
                    lynch_objective.lynch_marginals_lanes_ref(prof, off.numpy(), scalars, tab)):
        assert isinstance(a, np.ndarray) and np.array_equal(a, b.numpy(), equal_nan=a.dtype.kind == "f")
    assert counts == (lynch_objective.RECORD_LAUNCHES, lynch_objective.NLL_LANES_LAUNCHES,
                      lynch_objective.MARGINALS_LANES_LAUNCHES)


def test_lanes_workspace_rejects_what_the_kernels_do_not_take():
    prof = torch.zeros((8, 4), dtype=torch.int32)
    mult = torch.ones(8, dtype=torch.int64)
    tab = lgamma_table(0, "cpu")
    W = lynch_objective.LynchLanesWorkspace
    off = torch.tensor([0, 3, 3, 8])
    for bad, err in (
        (torch.tensor([0, 3, 8], dtype=torch.int32), TypeError),  # dtype
        (torch.tensor([1, 3, 8]), ValueError),  # not from 0
        (torch.tensor([0, 3, 7]), ValueError),  # not to the row count
        (torch.tensor([0, 5, 3, 8]), ValueError),  # falling
        (torch.tensor([0]), ValueError),  # no lane
        (torch.tensor([[0, 8]]), ValueError),  # not 1-D
        (torch.tensor([0, 9, 3, 8])[::2], ValueError),  # not contiguous
        (np.array([0, 8]), ValueError),  # not a tensor
    ):
        with pytest.raises(err):
            W(prof, mult, bad, tab)
    with pytest.raises(ValueError, match="offsets is on meta"):
        W(prof, mult, off.to("meta"), tab)
    with pytest.raises(TypeError):
        W(prof.to(torch.int64), mult, off, tab)
    with pytest.raises(ValueError, match="mult must be"):
        W(prof, mult[:4], off, tab)
    with pytest.raises(ValueError, match="no Lynch lanes kernel for device meta"):
        W(prof.to("meta"), mult.to("meta"), off.to("meta"), tab.to("meta"))
    work = W(prof, mult, off, tab)
    s = np.tile(lk.lynch_scalars(0.01, 0.01, [0.25] * 4), (3, 1))
    with pytest.raises(ValueError, match=r"scalars must be \(3, 16\)"):
        work.nll_lanes(s[:2], [0])
    with pytest.raises(ValueError, match=r"scalars must be \(3, 16\)"):
        work.marginals_lanes(s[:, :15])
    for lanes in ([], [3], [-1], [1, 0], [1, 1]):
        with pytest.raises(ValueError, match="lanes must be"):
            work.nll_lanes(s, lanes)
    assert work.nll_lanes(s, [0, 1, 2]).shape == (3, 2)
    # the kernel-only relaunches have no kernel to launch on the CPU
    with pytest.raises(RuntimeError):
        work.launch_nll_lanes()
    with pytest.raises(RuntimeError):
        work.launch_marginals_lanes()


@pytest.mark.parametrize("sizes", [[0], [5, 0, 1], [1024, 1025, 0, 1023, 1], [300_000, 7, 0, 2048]])
def test_fixed_order_sums_is_each_run_alone(sizes):
    rng = np.random.default_rng(sum(sizes))
    n = sum(sizes)
    x = torch.from_numpy(rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))
    got = lk.fixed_order_sums(x, sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for k, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
        want = lk.fixed_order_sum(x[a:b])
        assert got[k].view(torch.int64) == want.view(torch.int64)
