"""``--devices`` in sid_tpu_torch against sid_tpu's mesh, on the CPU.

The port's counterparts of ``tests/test_parallel.py`` and of
``test_population.py::test_sharded_fits_identical``. sid_tpu runs as its own
tests run it, on the conftest's 8 virtual CPU devices. The port's CPU
platform has one device; a shard count k above it is a mesh of ``[cpu] * k``
(a list of devices to ``fit_lynch_global`` and ``_fit_population``, or
``platform_devices`` patched to 8 CPU devices for the engine's
``mesh_devices``), the partitions a mesh of ``[cuda:0] * k`` makes
on one card. Inputs are made from a seed with numpy.

- the fold: ``fold_chunk_sums_ref(chunk_sums_ref(t))`` is ``fixed_order_sum(t)``
  bitwise; the sharded objective's wrapper (``LynchShardGroup``) runs its
  plain version on the CPU, bitwise ``fold_chunk_sums_ref``;
- the mesh, its row splitter and the shards' grouping by device (the fold's
  device last);
- shard counts: ``fit_lynch_global`` over ``[cpu] * k``, k = 1..8, is bitwise
  ``fit_on_filtered_profiles`` (shards left empty above the chunk count;
  with a C2 deep row in the last shard), and within sid_tpu's rel 1e-6 of
  its ``fit_lynch_global(make_site_mesh(k))``;
- method CSVs and diagnostics byte-equal to sid_tpu's with ``mesh_devices``
  1, 2 and 8 for every method, on the goldens and a synth input, in memory,
  streamed and per shard;
- population mode: the fits over a mesh bitwise the unsharded port's, the
  cohort CSVs byte-equal to sid_tpu's ``mesh_devices=8``;
- the differences (ROADMAP.md C12, C13): sid_tpu's mesh classify and mesh
  fit have no long-double range screen, so a deep row changes its bytes; the
  port's bytes are its exact engine's.
"""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.models import population as ref_pop  # noqa: E402
from sid_tpu.parallel.fit import fit_lynch_global as ref_fit_lynch_global  # noqa: E402
from sid_tpu.parallel.mesh import make_site_mesh as ref_make_site_mesh  # noqa: E402
from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import population as pop  # noqa: E402
from sid_tpu_torch.models.lynch import DeviceObjective, fit_on_filtered_profiles  # noqa: E402
from sid_tpu_torch.ops import likelihoods as lk  # noqa: E402
from sid_tpu_torch.ops import lynch_objective  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from sid_tpu_torch.ops.profiles import filter_min_coverage, nucleotide_distribution, unique_profiles  # noqa: E402
from sid_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from sid_tpu_torch.parallel.fit import ShardedLynchWorkspace, fit_lynch_global  # noqa: E402
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402

CPU = torch.device("cpu")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
DEEP = [9000, 9000, 0, 0]
METHODS = {
    "local": {},
    "bayes": {"method": "bayes"},
    "lr": {"method": "likelihood_ratio"},
    "lr-R": {"method": "likelihood_ratio", "estimate_prior": True},
    "quality": {"method": "quality"},
    "quality-R": {"method": "quality", "estimate_prior": True},
}
THETAS = ((1e-3, 1e-3), (0.05, 0.01), (0.0, 0.2), (1.0, 1.0), (0.5, 0.999), (-0.1, 0.5))


def bits(a):
    return np.asarray(a, np.float64).view(np.int64)


def same_fit(a, b) -> bool:
    """Two (pi, eps, log_l_hom, log_l_het, nt) fits bitwise equal."""
    return (bits(a[0]) == bits(b[0]) and bits(a[1]) == bits(b[1])
            and all(np.array_equal(bits(x), bits(y)) for x, y in zip(a[2:], b[2:])))


def histogram(n_sites=40_000, seed=3, deep=False):
    """The cov >= 4 histogram of simulated sites, shallow rows first and
    the deep row (fault C2) last, so it lies in the last shard."""
    counts = simulate_diploid_counts(n_sites, coverage=25, pi=0.02, eps=0.01, seed=seed)
    if deep:
        counts = np.vstack([counts, [DEEP]])
    p, m, _ = unique_profiles(counts)
    p, m, _ = filter_min_coverage(p, m, 4)
    order = np.argsort(p.sum(1), kind="stable")
    return np.ascontiguousarray(p[order]), np.ascontiguousarray(m[order])


@pytest.fixture(scope="module")
def hist():
    return histogram()


@pytest.fixture(scope="module")
def deep_hist():
    return histogram(deep=True)


@pytest.fixture
def eight_cpus(monkeypatch):
    """The port's CPU platform as 8 devices, as the conftest gives sid_tpu 8
    virtual CPU devices: ``mesh_devices=k`` then shards k ways."""
    monkeypatch.setattr(mesh_mod, "platform_devices", lambda device: [CPU] * 8)


# ---- the fold ----

@pytest.mark.parametrize("u", [0, 1, 1023, 1024, 1025, 8 * 1024 + 1])
def test_fold_of_chunk_sums_is_fixed_order_sum(u):
    terms = torch.from_numpy(np.random.default_rng(u).standard_normal(u) * 1e3)
    sums = lk.chunk_sums_ref(terms)
    assert sums.shape == (-(-u // lk.CHUNK_ROWS),)
    got = lk.fold_chunk_sums_ref(sums)
    assert bits(got.item()) == bits(lk.fixed_order_sum(terms).item())
    # the lanes' reduction is an independent implementation of the same order
    assert bits(got.item()) == bits(lk.fixed_order_sums(terms, [u])[0].item())


@pytest.mark.parametrize("n_chunks", [1, 2, 255, 256, 257, 973])
def test_shards_wrapper_on_the_cpu_is_its_plain_version(n_chunks):
    """The sharded objective's wrapper over three shards of a histogram of
    ``n_chunks`` chunks (the last one short; deep rows the range screen
    flags planted) runs the plain version on the CPU and launches nothing:
    [sum, count] bitwise ``lynch_nll_shards_ref`` and
    ``fold_chunk_sums_ref`` of its chunk sums, the chunk sums and flags its
    own."""
    rng = np.random.default_rng(n_chunks)
    u = n_chunks * lk.CHUNK_ROWS - 7
    prof = rng.multinomial(30, [0.94, 0.03, 0.02, 0.01], u).astype(np.int32)
    prof[rng.choice(u, min(u, 3), replace=False)] = DEEP
    mult = rng.integers(1, 1000, u).astype(np.int64)
    tab = lgamma_table(int(prof.sum(-1).max()), CPU)
    s = lk.lynch_scalars(0.05, 0.01, nucleotide_distribution(prof, mult))
    b = mesh_mod.chunk_bounds(u, 3)
    parts = [(torch.from_numpy(prof[x:y]), torch.from_numpy(mult[x:y]), tab) for x, y in zip(b[:-1], b[1:]) if y > x]
    works = [(lynch_objective.LynchWorkspace(*p), x // lk.CHUNK_ROWS) for p, x in zip(parts, b)]
    group = lynch_objective.LynchShardGroup(CPU, works, n_chunks, fold=True)
    before = lynch_objective.NLL_SHARDS_LAUNCHES
    got = group.nll(s)
    assert lynch_objective.NLL_SHARDS_LAUNCHES == before  # the plain version is no launch
    want, part_sum, part_cnt, flags = lynch_objective.lynch_nll_shards_ref(parts, s)
    assert bits(np.array(got)).tolist() == bits(want.numpy()).tolist()
    assert bits(got[0]) == bits(lk.fold_chunk_sums_ref(group.part_sum).item())
    assert np.array_equal(bits(group.part_sum.numpy()), bits(part_sum.numpy()))
    assert torch.equal(group.part_cnt, part_cnt) and got[1] == float(part_cnt.sum()) >= 1
    assert all(torch.equal(w.flags, f) for (w, _), f in zip(works, flags))


# ---- the mesh ----

def test_make_site_mesh_cuts_as_sid_tpu():
    assert mesh_mod.make_site_mesh(devices=["cpu"]) == [CPU]
    assert mesh_mod.make_site_mesh(4, [CPU]) == [CPU]  # --devices 4 on one device
    assert mesh_mod.make_site_mesh(3, [CPU] * 8) == [CPU] * 3
    assert mesh_mod.make_site_mesh(-1, [CPU] * 8) == [CPU] * 7  # devices[:n] as sid_tpu slices
    assert mesh_mod.platform_devices(CPU) == [CPU]
    for n in (0, -1):
        with pytest.raises(ValueError, match="selects no device"):
            mesh_mod.make_site_mesh(n, [CPU])
    assert Options(platform="cpu").mesh() is None
    assert Options(platform="cpu", mesh_devices=2).mesh() == [CPU]


@pytest.mark.parametrize("n_rows,k", [(0, 3), (1, 1), (1023, 2), (2049, 2), (5000, 3), (5000, 8), (10_000, 4)])
def test_chunk_bounds_cut_at_chunks(n_rows, k):
    b = mesh_mod.chunk_bounds(n_rows, k)
    assert b.shape == (k + 1,) and b[0] == 0 and b[-1] == n_rows
    assert (np.diff(b) >= 0).all()
    assert all(x % lk.CHUNK_ROWS == 0 for x in b[:-1] if x < n_rows)
    chunks = -(-n_rows // lk.CHUNK_ROWS)
    assert int((np.diff(b) > 0).sum()) == min(k, chunks) or chunks < k


C0, C1, C2 = (torch.device("cuda", i) for i in range(3))


@pytest.mark.parametrize("devices, fold, want", [
    ([C0], C0, [(C0, [0])]),
    ([C0] * 4, C0, [(C0, [0, 1, 2, 3])]),
    ([C0, C1, C0], C0, [(C1, [1]), (C0, [0, 2])]),
    ([C0, C1, C2, C1], C0, [(C1, [1, 3]), (C2, [2]), (C0, [0])]),
    ([C1, C2], C0, [(C1, [0]), (C2, [1]), (C0, [])]),
    ([], CPU, [(CPU, [])]),
    ([CPU] * 3, CPU, [(CPU, [0, 1, 2])]),
    ([C0] * 40, C0, [(C0, list(range(32))), (C0, list(range(32, 40)))]),
    ([C0, C1] * 33, C0, [(C1, list(range(1, 64, 2))), (C1, [65]), (C0, list(range(0, 64, 2))), (C0, [64])]),
], ids=["one", "one-card-x4", "repeated", "three-cards", "fold-without-shards", "no-rows", "cpu-x3",
        "one-card-x40", "two-cards-x33"])
def test_device_groups_put_the_fold_device_last(devices, fold, want):
    """The shards' launch groups from torch.device objects alone (no card):
    one group a device, in the order the devices first appear in the mesh,
    each group's shards in row order, the fold device's group last; a
    device with more than 32 shards (the table one launch takes) one group
    for each 32 of them."""
    from sid_tpu_torch.parallel.fit import device_groups

    assert device_groups(devices, fold) == want


def test_run_sharded_enqueues_every_shard_before_waiting():
    events = []

    def enqueue(a, b, dev):
        events.append(("enqueue", a, b))

        def wait():
            events.append(("wait", a, b))
            return (np.arange(a, b),)
        return wait

    (rows,) = mesh_mod.run_sharded(10, [CPU] * 4, enqueue)
    assert np.array_equal(rows, np.arange(10))
    assert [e[0] for e in events] == ["enqueue"] * 4 + ["wait"] * 4
    (rows,) = mesh_mod.run_sharded(0, [CPU] * 4, enqueue)  # no rows: one empty shard
    assert rows.shape == (0,)


# ---- shard counts ----

@pytest.mark.parametrize("k", range(1, 9))
def test_partials_and_fold_plain_are_b2_plain(hist, k):
    prof, mult = hist
    nt = nucleotide_distribution(prof, mult)
    tab = lgamma_table(int(prof.sum(-1).max()), CPU)
    s = lk.lynch_scalars(0.05, 0.01, nt)
    want, want_flags = lynch_objective.lynch_compound_nll_ref(torch.from_numpy(prof), torch.from_numpy(mult), s, tab)
    b = mesh_mod.chunk_bounds(prof.shape[0], k)
    parts = [lynch_objective.lynch_nll_partials_ref(torch.from_numpy(prof[x:y]), torch.from_numpy(mult[x:y]), s, tab)
             for x, y in zip(b[:-1], b[1:])]
    got = lynch_objective.lynch_fold_ref(torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    assert np.array_equal(bits(got.numpy()), bits(want.numpy()))
    assert np.array_equal(torch.cat([p[2] for p in parts]).numpy(), want_flags.numpy())
    # the sharded objective's plain version is these two, composed
    shards = [(torch.from_numpy(prof[x:y]), torch.from_numpy(mult[x:y]), tab) for x, y in zip(b[:-1], b[1:]) if y > x]
    out, _, _, flags = lynch_objective.lynch_nll_shards_ref(shards, s)
    assert np.array_equal(bits(out.numpy()), bits(want.numpy()))
    assert np.array_equal(torch.cat(flags).numpy(), want_flags.numpy())


@pytest.mark.parametrize("k", range(1, 9))
def test_fit_lynch_global_is_the_one_device_fit(hist, k):
    prof, mult = hist
    one, lines = [], []
    want = fit_on_filtered_profiles(prof, mult, CPU, one.append)
    got = fit_lynch_global(prof, mult, [CPU] * k, lines.append)
    assert same_fit(got, want)
    assert lines == one
    # sid_tpu's own bound across mesh sizes (tests/test_parallel.py)
    ref = ref_fit_lynch_global(prof, mult, ref_make_site_mesh(k))
    assert got[0] == pytest.approx(ref[0], rel=1e-6, abs=1e-9)
    assert got[1] == pytest.approx(ref[1], rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("k", range(1, 9))
def test_sharded_objective_keeps_the_range_screen(deep_hist, k):
    """A deep row (fault C2) in the last shard: the objective is bitwise the
    one-device objective at every theta (the flagged row's long-double term
    included, by its row in the whole histogram), so are the marginals."""
    prof, mult = deep_hist
    nt = nucleotide_distribution(prof, mult)
    one = DeviceObjective(prof, mult, nt, CPU)
    sharded = DeviceObjective(prof, mult, nt, work=ShardedLynchWorkspace(prof, mult, [CPU] * k))
    for theta in THETAS:
        assert bits(sharded(theta)) == bits(one(theta)), theta
    assert sharded.flagged == one.flagged == 1
    assert np.nonzero(sharded.work.flags.numpy())[0].tolist() == [prof.shape[0] - 1]
    for x, y in zip(sharded.marginals(0.01), one.marginals(0.01)):
        assert np.array_equal(bits(x), bits(y))


@pytest.mark.parametrize("k", [2, 3, 8])
def test_sharded_workspace_copies_own_buffers_into_the_fold(hist, k):
    """A group of shards on another device than the fold's writes its chunk
    sums into buffers of its own, copied into the fold's each evaluation.
    On the CPU every shard shares the fold's device (one group), so the
    last shard is given a group of its own; the fold's place for its chunk
    sums is poisoned first, and the objective is still bitwise one-device
    B2's."""
    prof, mult = hist
    nt = nucleotide_distribution(prof, mult)
    work = ShardedLynchWorkspace(prof, mult, [CPU] * k)
    assert len(work.groups) == 1 and work.groups[0].fold and not work.groups[0].peers
    last = work.shards[-1]
    peer = work.group(CPU, [len(work.shards) - 1])
    work.groups = [peer, work.group(CPU, range(len(work.shards) - 1), [peer])]
    assert peer.runs == [last.chunks] and peer.part_sum.data_ptr() != work.groups[-1].part_sum.data_ptr()
    one = lynch_objective.LynchWorkspace(torch.from_numpy(prof), torch.from_numpy(mult),
                                         lgamma_table(int(prof.sum(-1).max()), CPU))
    for theta in THETAS[:-1]:  # inside the box
        work.groups[-1].part_sum[last.chunks] = float("nan")
        work.groups[-1].part_cnt[last.chunks] = -1
        s = lk.lynch_scalars(*theta, nt)
        assert bits(np.array(work.nll(s))).tolist() == bits(np.array(one.nll(s))).tolist(), theta


def test_more_shards_than_a_launch_takes_are_bitwise_one_device():
    """A mesh that lists one device 40 times (more shards than the 32 of a
    launch's table) splits them into two launch groups, the fold's last;
    the objective and flags are one-device B2's bit for bit. A group of 33
    shards is refused on every device."""
    rng = np.random.default_rng(40)
    u = 40 * lk.CHUNK_ROWS - 300
    prof = rng.multinomial(30, [0.94, 0.03, 0.02, 0.01], u).astype(np.int32)
    prof[[7, u - 1]] = DEEP
    mult = rng.integers(1, 1000, u).astype(np.int64)
    nt = nucleotide_distribution(prof, mult)
    work = ShardedLynchWorkspace(prof, mult, [CPU] * 40)
    assert len(work.shards) == 40 and [len(g.works) for g in work.groups] == [32, 8]
    assert work.groups[-1].peers == work.groups[:1] and work.groups[0].runs == [slice(0, 32)]
    one = lynch_objective.LynchWorkspace(torch.from_numpy(prof), torch.from_numpy(mult),
                                         lgamma_table(int(prof.sum(-1).max()), CPU))
    for theta in THETAS[:-1]:
        s = lk.lynch_scalars(*theta, nt)
        assert bits(np.array(work.nll(s))).tolist() == bits(np.array(one.nll(s))).tolist(), theta
        assert torch.equal(work.flags, one.flags.cpu())
    with pytest.raises(ValueError, match="at most 32 shards"):
        work.group(CPU, range(33))


def test_sharded_workspace_indexes_its_mesh():
    """The mesh is normalised once (``make_site_mesh``): the fold's device
    and every shard's are the list's devices, indexed."""
    prof = np.zeros((3 * lk.CHUNK_ROWS, 4), np.int32)
    prof[:, 0] = 5
    work = ShardedLynchWorkspace(prof, np.ones(prof.shape[0], np.int64), ["cpu", CPU, torch.device("cpu")])
    assert work.device == CPU and [s.work.device for s in work.shards] == [CPU] * 3


def test_fit_lynch_global_with_a_deep_row(deep_hist):
    prof, mult = deep_hist
    assert prof.shape[0] > lk.CHUNK_ROWS  # two chunks: the deep row in the second shard
    want = fit_on_filtered_profiles(prof, mult, CPU)
    assert same_fit(fit_lynch_global(prof, mult, [CPU] * 3), want)


def test_mesh_fit_forces_the_device_backend(hist, eight_cpus):
    """--devices fits on the device under --fit auto (a mesh fit), and the
    exact fit is kept when asked for, as sid_tpu does."""
    from sid_tpu_torch.models import lynch

    prof, mult = hist
    assert lynch.resolve_fit_backend(Options(platform="cpu", mesh_devices=2), 10) == "device"
    assert lynch.resolve_fit_backend(Options(platform="cpu", mesh_devices=2, fit_backend="exact"), 10) == "exact"
    before = lynch_objective.NLL_SHARDS_LAUNCHES, lynch_objective.NLL_LAUNCHES
    got = lynch.fit_profiles(prof, mult, Options(platform="cpu", mesh_devices=4))
    assert same_fit(got, fit_on_filtered_profiles(prof, mult, CPU))
    # the CPU runs the plain versions: no kernel launch is counted
    assert (lynch_objective.NLL_SHARDS_LAUNCHES, lynch_objective.NLL_LAUNCHES) == before


# ---- method CSVs against sid_tpu's mesh ----

def synth_text():
    counts = simulate_diploid_counts(2000, coverage=25, pi=0.02, eps=0.01, seed=5)
    two = simulate_diploid_counts(800, coverage=20, pi=0.06, eps=0.02, seed=6)
    return (make_pileup_text(counts, with_qualities=True)
            + make_pileup_text(two, chrom="chr2", with_qualities=True, seed=7))


@pytest.fixture(scope="module")
def inputs():
    with open(os.path.join(FIXTURES, "golden.pileup"), "rb") as f:
        return {"golden": f.read(), "synth": synth_text()}


def _run_both(src, kw, mode, k):
    """(sid_tpu's CSV and diagnostics, the port's) for one case."""
    out = []
    for run, opts in ((ref_engine, RefOptions), (engine, Options)):
        extra = {} if run is ref_engine else {"platform": "cpu"}
        o = opts(mesh_devices=k, per_shard_fit=mode == "per-shard", **kw, **extra)
        lines = []
        if mode == "stream":
            buf = io.BytesIO()
            run.run_streaming(src, o, buf, lines.append, chunk_bytes=16 << 10)
            out.append((buf.getvalue(), lines))
        else:
            out.append((run.run(src, o, lines.append, binary=True), lines))
    return out


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("mode", ["memory", "stream", "per-shard"])
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("name", ["golden", "synth"])
def test_csv_equals_sid_tpu_mesh(inputs, eight_cpus, name, method, mode, k):
    if mode == "per-shard" and method.startswith("quality"):
        # sid_tpu's --per-shard-fit -m quality raises (ROADMAP.md C10), with
        # a mesh too: the port's mesh run writes its run without a mesh
        with pytest.raises(ValueError, match="at least one dimensional"):
            _run_both(inputs[name], METHODS[method], mode, k)
        kw = dict(METHODS[method], platform="cpu", per_shard_fit=True)
        lines, want_lines = [], []
        got = engine.run(inputs[name], Options(mesh_devices=k, **kw), lines.append, binary=True)
        assert got == engine.run(inputs[name], Options(**kw), want_lines.append, binary=True)
        assert lines == want_lines
        return
    want, got = _run_both(inputs[name], METHODS[method], mode, k)
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert got[0].count(b"\n") > 1


# the parity inputs of tests/test_methods_parity.py (as test_torch_fit_slice.py
# makes them) and the real-data-shaped fixture
PARITY = {
    "edge": [[0, 0, 0, 0], [1, 0, 0, 0], [5, 5, 0, 0], [3, 3, 3, 3], [200, 3, 0, 1],
             [15, 14, 1, 0], [0, 0, 0, 9], [2, 2, 2, 0], [30, 0, 0, 0], [0, 0, 0, 0]],
    "extreme": [[20, 1, 0, 0], [10, 10, 0, 0], [3000, 2800, 0, 0], [6000, 0, 0, 0],
                [2500, 2500, 100, 0], [25, 0, 1, 0], [1, 2, 3000, 2900]] * 4,
    "degenerate": [[5, 0, 0, 0], [5, 0, 0, 0], [4, 0, 0, 0], [2, 2, 0, 0], [6, 0, 0, 0]],
    "near-flat": [[4, 0, 0, 0], [2, 2, 0, 0], [5, 0, 0, 0], [3, 3, 0, 0], [0, 4, 0, 0],
                  [0, 2, 2, 0], [6, 1, 0, 0], [3, 2, 1, 0]],
}


def parity_text(name):
    if name == "realdata":
        with open(os.path.join(FIXTURES, "realdata", "bwa_like_100k.pileup.gz"), "rb") as f:
            return f.read()
    return make_pileup_text(np.array(PARITY[name]), with_qualities=name != "extreme")


@pytest.mark.parametrize("name, method", [
    (name, method) for name in ("edge", "extreme", "degenerate", "near-flat", "realdata") for method in METHODS
    if not (name == "extreme" and method.startswith("quality"))  # no quality columns
])
def test_parity_inputs_equal_sid_tpu_mesh(eight_cpus, name, method):
    """The parity inputs over 8 shards. On ``degenerate`` the fit methods
    meet ROADMAP.md C3 (sid_tpu's device fit at the box boundary), where
    the port writes its one-device --fit device bytes (= its exact fit's)
    and sid_tpu's mesh run differs."""
    src, kw = parity_text(name), METHODS[method]
    (want, want_lines), (got, lines) = _run_both(src, kw, "memory", 8)
    if name == "degenerate" and method in ("bayes", "lr", "lr-R"):
        one_lines = []
        one = engine.run(src, Options(platform="cpu", fit_backend="device", **kw), one_lines.append, binary=True)
        assert (got, lines) == (one, one_lines)
        assert got != want
        return
    assert (got, lines) == (want, want_lines)


@pytest.mark.parametrize("method", ["local", "bayes", "lr-R"])
def test_deep_row_follows_long_double_where_sid_tpu_mesh_does_not(eight_cpus, method):
    """ROADMAP.md C12 (``-m local``: sid_tpu's mesh classify has no range
    screen, C1 on a mesh) and C13 (bayes, LR: its mesh fit has none, C2 on
    a mesh): 300 simulated sites and one (9000, 9000, 0, 0) site. The port
    over 2 shards writes its exact engine's bytes and lines; sid_tpu's mesh
    run differs."""
    counts = np.vstack([simulate_diploid_counts(300, coverage=25, pi=0.02, eps=0.01, seed=5), [DEEP]])
    src = make_pileup_text(counts, with_qualities=True)
    kw = METHODS[method]
    exact_lines, lines, ref_lines = [], [], []
    exact = engine.run(src, Options(platform="cpu", fit_backend="exact", **kw), exact_lines.append, binary=True)
    got = engine.run(src, Options(platform="cpu", mesh_devices=2, **kw), lines.append, binary=True)
    ref = ref_engine.run(src, RefOptions(mesh_devices=2, **kw), ref_lines.append, binary=True)
    assert (got, lines) == (exact, exact_lines)
    assert ref != got
    if method == "local":
        assert got.split(b"\n")[301] == b"chr1,301,hom,CC,-nan,-nan,p_value"
        assert ref.split(b"\n")[301] == b"chr1,301,het,CA,1,0,p_value"
    else:
        assert ref_lines != lines


# ---- population mode ----

def cohort(n=5):
    return [simulate_diploid_counts(700, coverage=25, pi=(0.002, 0.02, 0.06, 0.01, 0.03)[k % 5], eps=0.01,
                                    seed=400 + k) for k in range(n)]


@pytest.fixture(scope="module")
def cohort_hists():
    hists = []
    for c in cohort():
        p, m, _ = unique_profiles(c)
        hists.append(filter_min_coverage(p, m, 4)[:2])
    return hists


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("mode", ["pooled", "independent"])
def test_population_fits_over_a_mesh_are_bitwise(cohort_hists, mode, k):
    """Every sample's fit over ``[cpu] * k`` (blocks of ceil(S / k)
    samples; some blocks empty at k = 8) is bitwise its unsharded fit."""
    want_lines, lines = [], []
    want, want_pooled = pop.fit_population(cohort_hists, mode, want_lines.append, device="cpu")
    got, pooled, _ = pop._fit_population(cohort_hists, mode, lines.append, [CPU] * k, CPU)
    assert got == want and pooled == want_pooled and lines == want_lines
    for f, w in zip(got, want):
        assert bits(f.pi) == bits(w.pi) and bits(f.eps) == bits(w.eps)


def test_sharded_lanes_objective_rounds(cohort_hists):
    """One round over 3 blocks is one round; each lane's value is bitwise
    the unsharded objective's, blocks whose lanes have stopped launch
    nothing."""
    from sid_tpu_torch.models.lynch import LanesObjective, ShardedLanesObjective

    nts = np.stack([nucleotide_distribution(p, m) for p, m in cohort_hists])
    one = LanesObjective(cohort_hists, nts, CPU)
    sharded = ShardedLanesObjective(cohort_hists, nts, [CPU] * 3)
    assert [(a, b) for a, b, _ in sharded.blocks] == [(0, 2), (2, 4), (4, 5)]
    points = [np.array([0.01 * (i + 1), 0.01]) for i in range(5)]
    for lanes in ([0, 1, 2, 3, 4], [1, 4], [0]):
        pts = [points[i] for i in lanes]
        assert [bits(v) for v in sharded(lanes, pts)] == [bits(v) for v in one(lanes, pts)]
    assert sharded.rounds == 3 and sharded.evaluations == one.evaluations == 8
    assert sharded([2], [np.array([2.0, 0.1])]) == [lk.DBL_MAX]  # out of the box: no launch
    assert sharded.rounds == 3


POP_METHODS = {
    "bayes": {"method": "bayes"},
    "lr-R": {"method": "likelihood_ratio", "estimate_prior": True},
    "local": {"method": "local"},
    "quality": {"method": "quality"},
}


@pytest.mark.parametrize("method", list(POP_METHODS))
@pytest.mark.parametrize("mode", ["pooled", "independent"])
def test_population_csv_equals_sid_tpu_mesh(eight_cpus, mode, method):
    texts = [make_pileup_text(c, with_qualities=True) for c in cohort()]
    kw = POP_METHODS[method]
    reads = method == "quality"
    ref_batches = [ref_engine.parse_pileup(t, reads, reads) for t in texts]
    batches = [parse_pileup(t, reads, reads, quality_terms_only=reads) for t in texts]
    ref_lines, lines = [], []
    want = ref_pop.call_population(ref_batches, RefOptions(mesh_devices=8, **kw), mode=mode, diag=ref_lines.append)
    got = pop.call_population(batches, Options(platform="cpu", mesh_devices=8, **kw), mode=mode,
                              diag=lines.append)
    assert lines == ref_lines
    for g, w in zip(got, want):
        assert g.to_csv_bytes() == w.to_csv_bytes()


@pytest.mark.parametrize("method", ["local", "lr-R", "quality"])
def test_multihost_process_meshes_over_its_devices(tmp_path, eight_cpus, method):
    """One ``--multihost`` process with ``--devices 4`` meshes over its own
    devices: byte-equal to sid_tpu's run_multihost with the same mesh, and
    to the port's run without one."""
    from sid_tpu.parallel import distributed as ref_distributed
    from sid_tpu_torch.parallel import distributed

    text = make_pileup_text(simulate_diploid_counts(1500, coverage=18, pi=0.03, eps=0.01), with_qualities=True)
    src = tmp_path / "in.pileup"
    src.write_bytes(text)
    kw = METHODS[method]
    outs, diags = [], []
    for run, opts in ((distributed.run_multihost, Options(platform="cpu", mesh_devices=4, **kw)),
                      (distributed.run_multihost, Options(platform="cpu", **kw)),
                      (ref_distributed.run_multihost, RefOptions(mesh_devices=4, **kw))):
        out = str(tmp_path / f"out{len(outs)}.csv")
        lines = []
        run(str(src), opts, out, lines.append, ranges_per_process=3)
        outs.append(open(out, "rb").read())
        diags.append(lines)
    assert outs[0] == outs[1] == outs[2] and diags[0] == diags[1] == diags[2]
