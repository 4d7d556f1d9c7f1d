"""The Lynch kernels' arithmetic, row record and reduction, compiled for the
host, vs torch.

``sid_tpu_torch/csrc/lynch.cuh`` holds the per-profile expressions, the
per-fit row record, the long-double range screen and the fixed-order
reduction that the card runs; ``lynch_host.cpp`` loops them over arrays and
runs the objective's chunks in the order a grid of a given size would, then
folds the chunk sums. Built here with g++
(contraction off, like nvcc --fmad=false) and held:

- against itself: the record path (the set-up kernel's record, then the
  objective's and the marginals' row functions) gives the bits of
  ``lynch_row`` from the counts and the table;
- against the plain torch f64 versions: the record bitwise, m and the flags
  bitwise, the values within 1e-12 relative (only the exp/log
  implementations differ: glibc here, torch's on the CPU), and a sum that
  does not change with the number of blocks;
- the cohort's lanes: ``slot_of`` (a walk chunk's lane by binary search
  over a launch's lane slots) against numpy, and the lanes' objective and
  marginals as their kernels walk a cohort's record through the tables
  that ``fill_lane_slots`` writes: each lane bitwise the single-lane
  objective and marginals over its own rows, for every set of running
  lanes and grid, cohorts with runs of empty and 1-row lanes, and lanes
  split into launches of a few;
- a sharded fit's objective on one device: the walk of the device's shard
  table (``ShardSlot``), fold on and off, over 1, 2, 3 and 8 shards and
  over two groups whose first's chunk sums are copied into the fold's
  buffers, bitwise the one-launch objective and its flags; the plain
  version ``lynch_nll_shards_ref`` the same counts and flags, the chunk
  sums to 1e-12.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu_torch.ops import likelihoods as lk  # noqa: E402
from sid_tpu_torch.ops import lynch_objective  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from sid_tpu_torch.ops.profiles import nucleotide_distribution  # noqa: E402
from test_torch_local_classify import assert_agree  # noqa: E402
from test_torch_lynch import LANE_THETAS, THETAS, lane_cohort, lynch_profiles  # noqa: E402

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sid_tpu_torch", "csrc"
)
IN_BOX = [t for t in THETAS if 0 <= t[0] <= 1 and 0 <= t[1] <= 1]
# the resident grids of an H100 (132 SMs) at 3 and 4 blocks an SM
RESIDENT_GRIDS = (396, 528)
# the lanes one launch of a lane kernel takes (csrc/lynch.cu kLanesPerLaunch)
PER_LAUNCH = 384


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = str(tmp_path_factory.mktemp("shim") / "liblynch_host.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, os.path.join(CSRC, "lynch_host.cpp")],
        check=True,
    )
    lib = ctypes.CDLL(out)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sid_lynch_chunk_rows_host.restype = i32
    lib.sid_lynch_chunk_rows_host.argtypes = []
    lib.sid_lynch_lane_chunks_host.restype = i64
    lib.sid_lynch_lane_chunks_host.argtypes = [i64, i64]
    lib.sid_lynch_lane_slot_bytes_host.restype = i32
    lib.sid_lynch_lane_slot_bytes_host.argtypes = []
    lib.sid_lynch_shard_slot_bytes_host.restype = i32
    lib.sid_lynch_shard_slot_bytes_host.argtypes = []
    for name, args in (
        ("sid_lynch_rows_host", [p, p, p, i32, i64] + [p] * 6),
        ("sid_lynch_records_host", [p, p, p, i32, i64, p]),
        ("sid_lynch_read_records_host", [p, i64, p, p, p, p]),
        ("sid_lynch_record_rows_host", [p, i64, p] + [p] * 5),
        ("sid_lynch_nll_host", [p, i64, p, i32, p, p]),
        ("sid_lynch_slot_of_host", [p, i32, p, i64, p]),
        ("sid_lynch_nll_lanes_host", [p, i64, p, i32, i32, i32, p, p]),
        ("sid_lynch_marginals_lanes_host", [p, i64, p, i32, i32, i32, i32, p, p, p]),
        ("sid_lynch_nll_shards_host", [p, i32, p, p, p, i64, i32, i32, p]),
    ):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args
    return lib


@pytest.fixture(scope="module")
def data():
    prof, mult = lynch_profiles()
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    return prof, mult, tab, nucleotide_distribution(prof, mult)


def run_rows(lib, prof, s, tab):
    """lynch_row from the counts and the table: lhom, lhet, log_mix,
    flag_marginals, flag_mixture, m."""
    u = prof.shape[0]
    outs = [np.empty(u) for _ in range(3)] + [np.empty(u, np.uint8) for _ in range(2)] + [np.empty(u)]
    tab = tab.numpy()
    lib.sid_lynch_rows_host(
        prof.ctypes.data, s.ctypes.data, tab.ctypes.data, tab.shape[0], u,
        *[o.ctypes.data for o in outs],
    )
    return outs


def run_records(lib, prof, mult, tab):
    u = prof.shape[0]
    rec = np.empty((lynch_objective.RECORD_PLANES, u))
    tab = tab.numpy()
    lib.sid_lynch_records_host(prof.ctypes.data, mult.ctypes.data, tab.ctypes.data, tab.shape[0], u,
                               rec.ctypes.data)
    return rec


def run_record_rows(lib, rec, s):
    """The record path: log_mix, flag_mixture, lhom, lhet, flag_marginals."""
    u = rec.shape[1]
    outs = [np.empty(u), np.empty(u, np.uint8), np.empty(u), np.empty(u), np.empty(u, np.uint8)]
    lib.sid_lynch_record_rows_host(rec.ctypes.data, u, s.ctypes.data, *[o.ctypes.data for o in outs])
    return outs


def run_nll(lib, rec, s, grid):
    """The objective over the records with `grid` blocks: (out (2,), flags)."""
    u = rec.shape[1]
    flags = np.empty(u, np.uint8)
    out = np.empty(2)
    lib.sid_lynch_nll_host(rec.ctypes.data, u, s.ctypes.data, grid, flags.ctypes.data, out.ctypes.data)
    return out, flags


def bits(a):
    return np.asarray(a, np.float64).view(np.int64)


def test_chunk_is_the_packages(shim):
    assert shim.sid_lynch_chunk_rows_host() == lk.CHUNK_ROWS


@pytest.mark.parametrize("theta", IN_BOX)
def test_rows_match_plain(shim, data, theta):
    prof, _, tab, nt = data
    s = lk.lynch_scalars(theta[0], theta[1], nt)
    got = run_rows(shim, prof, s, tab)
    prof_t = torch.from_numpy(prof)
    want = lk.lynch_rows(prof_t, lk.row_scalars(s, prof_t), tab)
    for a, b in zip(got[:3], want[:3]):
        assert_agree(a, b.numpy(), 1e-12)
    assert np.array_equal(got[3], want.flag_marginals.numpy())
    assert np.array_equal(got[4], want.flag_mixture.numpy())
    assert np.array_equal(bits(got[5]), bits(lk.log_multinomial(torch.from_numpy(prof), tab)))


def test_record_is_the_plain_record(shim, data):
    """The set-up kernel's record, bitwise: m as lynch_row computes it, the
    counts packed as uint16, the multiplicity with the theta-free screen in
    its sign bit."""
    prof, mult, tab, _ = data
    rec = run_records(shim, prof, mult, tab)
    want = lynch_objective.lynch_records_ref(torch.from_numpy(prof), torch.from_numpy(mult), tab)
    assert np.array_equal(bits(rec), want.view(torch.int64).numpy())
    u = prof.shape[0]
    counts, m, w, mc_over = np.empty((u, 4), np.int32), np.empty(u), np.empty(u), np.empty(u, np.uint8)
    shim.sid_lynch_read_records_host(
        rec.ctypes.data, u, counts.ctypes.data, m.ctypes.data, w.ctypes.data, mc_over.ctypes.data
    )
    assert np.array_equal(counts, prof)
    lynch_m = run_rows(shim, prof, lk.lynch_scalars(0.01, 0.01, data[3]), tab)[5]
    assert np.array_equal(bits(m), bits(lynch_m))
    assert np.array_equal(w, mult.astype(np.float64))
    assert np.array_equal(mc_over, (lynch_m > lk.SAFE_MAX).astype(np.uint8))
    assert mc_over.sum() == 3  # (9000, 9000, 0, 0), (12000, 6000, 10, 0), (65535 x 4)


@pytest.mark.parametrize("theta", IN_BOX)
def test_record_rows_are_lynch_row(shim, data, theta):
    """The objective's and the marginals' row functions read the record and
    give lynch_row's bits; against the plain version, the flags bitwise and
    the values to 1e-12."""
    prof, mult, tab, nt = data
    s = lk.lynch_scalars(theta[0], theta[1], nt)
    log_mix, flag_mixture, lhom, lhet, flag_marginals = run_record_rows(
        shim, run_records(shim, prof, mult, tab), s
    )
    r_lhom, r_lhet, r_log_mix, r_fmarg, r_fmix, _ = run_rows(shim, prof, s, tab)
    for a, b in ((log_mix, r_log_mix), (lhom, r_lhom), (lhet, r_lhet)):
        assert np.array_equal(bits(a), bits(b))
    assert np.array_equal(flag_mixture, r_fmix) and np.array_equal(flag_marginals, r_fmarg)
    prof_t = torch.from_numpy(prof)
    want = lk.lynch_rows(prof_t, lk.row_scalars(s, prof_t), tab)
    for a, b in ((lhom, want.lhom), (lhet, want.lhet), (log_mix, want.log_mix)):
        assert_agree(a, b.numpy(), 1e-12)
    assert np.array_equal(flag_marginals, want.flag_marginals.numpy())
    assert np.array_equal(flag_mixture, want.flag_mixture.numpy())


@pytest.mark.parametrize("theta", [(1e-3, 1e-3), (0.05, 0.01), (0.5, 0.999)])
def test_objective_reduction_matches_plain(shim, data, theta):
    prof, mult, tab, nt = data
    s = lk.lynch_scalars(theta[0], theta[1], nt)
    got, flags = run_nll(shim, run_records(shim, prof, mult, tab), s, grid=3)
    want, want_flags = lynch_objective.lynch_compound_nll_ref(
        torch.from_numpy(prof), torch.from_numpy(mult), s, tab
    )
    assert np.array_equal(flags, want_flags.numpy())
    assert got[1] == float(want[1]) == float(flags.sum()) >= 4  # the deep rows
    assert abs(got[0] - float(want[0])) <= 1e-12 * abs(float(want[0]))


@pytest.mark.parametrize("u", [1, 1024, 5000, 20_000, 70_000])
def test_sum_does_not_change_with_the_number_of_blocks(shim, u):
    rng = np.random.default_rng(u)
    prof = rng.multinomial(30, [0.94, 0.03, 0.02, 0.01], u).astype(np.int32)
    mult = rng.integers(1, 1000, u).astype(np.int64)
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    s = lk.lynch_scalars(0.01, 0.01, nucleotide_distribution(prof, mult))
    rec = run_records(shim, prof, mult, tab)
    results = [run_nll(shim, rec, s, grid)[0] for grid in (1, 2, 7, 64, 1000) + RESIDENT_GRIDS]
    assert all(np.array_equal(r, results[0]) for r in results)
    want, _ = lynch_objective.lynch_compound_nll_ref(torch.from_numpy(prof), torch.from_numpy(mult), s, tab)
    assert results[0][1] == float(want[1])
    assert abs(results[0][0] - float(want[0])) <= 1e-12 * abs(float(want[0]))


def run_shards(lib, table, s, n_chunks, fold, grid, part_sum, part_cnt):
    """One device's walk of its shard table (with fold: then the fit's
    fold): out (2,), NaN where the launch writes none."""
    out = np.full(2, np.nan)
    lib.sid_lynch_nll_shards_host(table.ctypes.data, table.shape[0], s.ctypes.data, part_sum.ctypes.data,
                                  part_cnt.ctypes.data, n_chunks, int(fold), grid, out.ctypes.data)
    return out


@pytest.mark.parametrize("shards", [1, 2, 3, 8, "two-groups"])
def test_shard_walk_is_the_objective(shim, shards):
    """A sharded fit's card arithmetic (csrc/lynch.cu lynch_nll_shards_kernel:
    one launch a device walks its shards' chunks through their table,
    cut at multiples of the chunk, each chunk sum at its global index; the
    fold's device folds them all) gives the one-launch objective's bits and
    flags for every grid. With two groups the first walks the middle shard
    with the fold off into buffers of its own (and writes no result), whose
    chunks are copied into the fold's buffers before the fold's walk of the
    other shards. The plain version (lynch_nll_shards_ref) gives the same
    counts and flags, the chunk sums within 1e-12."""
    from sid_tpu_torch.parallel.mesh import chunk_bounds

    assert shim.sid_lynch_shard_slot_bytes_host() == lynch_objective.SHARD_SLOT.itemsize
    prof, mult = lynch_profiles(n=8 * lk.CHUNK_ROWS - 100, seed=23)
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    s = lk.lynch_scalars(0.05, 0.01, nucleotide_distribution(prof, mult))
    want, want_flags = run_nll(shim, run_records(shim, prof, mult, tab), s, grid=5)
    assert want[1] >= 4  # the deep rows
    u = prof.shape[0]
    n_chunks = -(-u // lk.CHUNK_ROWS)
    bounds = chunk_bounds(u, 3 if shards == "two-groups" else shards)
    cut = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    assert len(cut) == (3 if shards == "two-groups" else shards)
    recs = [run_records(shim, np.ascontiguousarray(prof[a:b]), np.ascontiguousarray(mult[a:b]), tab) for a, b in cut]
    groups = [[1], [0, 2]] if shards == "two-groups" else [list(range(len(cut)))]
    for grid in (1, 3, 64, RESIDENT_GRIDS[0]):
        flags = [np.full(b - a, 7, np.uint8) for a, b in cut]
        sums = []
        for g in groups:
            table = np.zeros(len(g), lynch_objective.SHARD_SLOT)
            for i, k in enumerate(g):
                a, b = cut[k]
                table[i] = (recs[k].ctypes.data, b - a, flags[k].ctypes.data, a // lk.CHUNK_ROWS,
                            -(-(b - a) // lk.CHUNK_ROWS))
            table["walk_end"] = np.cumsum(table["walk_end"])
            part_sum, part_cnt = np.full(n_chunks, np.nan), np.full(n_chunks, -1, np.int32)
            fold = g is groups[-1]
            for peer, (p_sum, p_cnt) in zip(groups, sums):  # the peers' chunks copied in before the fold
                for k in peer:
                    c = slice(cut[k][0] // lk.CHUNK_ROWS, -(-cut[k][1] // lk.CHUNK_ROWS))
                    part_sum[c], part_cnt[c] = p_sum[c], p_cnt[c]
            out = run_shards(shim, table, s, n_chunks, fold, grid, part_sum, part_cnt)
            sums.append((part_sum, part_cnt))
            assert np.isnan(out).all() != fold
        assert np.array_equal(bits(out), bits(want)), grid
        assert np.array_equal(np.concatenate(flags), want_flags)
    plain, p_sum, p_cnt, p_flags = lynch_objective.lynch_nll_shards_ref(
        [(torch.from_numpy(prof[a:b]), torch.from_numpy(mult[a:b]), tab) for a, b in cut], s)
    assert np.array_equal(p_cnt.numpy(), part_cnt) and plain[1].item() == want[1]
    assert np.array_equal(torch.cat(p_flags).numpy(), want_flags)
    assert (np.abs(p_sum.numpy() - part_sum) <= 1e-12 * np.maximum(1.0, np.abs(part_sum))).all()


def lane_table(off, scalars, lanes, per_launch=PER_LAUNCH, chunk_rows=lk.CHUNK_ROWS):
    """The lane kernels' slot table of ``lanes`` (fill_lane_slots) for a
    walk of chunks of ``chunk_rows``."""
    slots = np.zeros(len(lanes), lynch_objective.LANE_SLOT)
    chunks = lk.lane_chunks(np.diff(off), chunk_rows)
    lynch_objective.fill_lane_slots(slots, off, chunks, scalars, lanes, per_launch)
    return slots


@pytest.mark.parametrize("sizes", [[5], [0, 1, 0, 0, 7, 1, 0], [1] * 9, [0, 3000, 1, 1024, 1025, 0], [0, 0, 4],
                                   [0, 2000, 1] * 128])
def test_lane_of_is_searchsorted(shim, sizes):
    """A walk chunk's lane (slot_of over a launch's slots) is numpy's
    searchsorted over the walk's chunk offsets: every lane, an empty one
    too, owns lane_chunks of the walk, in order, whatever launch the table
    is cut into."""
    assert shim.sid_lynch_lane_slot_bytes_host() == lynch_objective.LANE_SLOT.itemsize
    chunks = np.array([shim.sid_lynch_lane_chunks_host(int(n), lk.CHUNK_ROWS) for n in sizes])
    assert list(chunks) == list(lk.lane_chunks(sizes))
    assert list(chunks) == [max(1, -(-n // lk.CHUNK_ROWS)) for n in sizes]
    # the marginals' walk takes chunks of another size the same way
    assert [shim.sid_lynch_lane_chunks_host(int(n), 256) for n in sizes] == list(lk.lane_chunks(sizes, 256))
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    scalars = np.zeros((len(sizes), 16))
    for per_launch in (PER_LAUNCH, 2):
        slots = lane_table(off, scalars, range(len(sizes)), per_launch)
        for first in range(0, len(sizes), per_launch):
            group = np.ascontiguousarray(slots[first:first + per_launch])
            coff = np.concatenate([[0], np.cumsum(chunks[first:first + per_launch])]).astype(np.int64)
            assert np.array_equal(group["walk_end"], coff[1:])
            assert np.array_equal(group["first_row"], off[first:first + len(group)])
            assert np.array_equal(group["end_row"], off[first + 1:first + len(group) + 1])
            js = np.arange(coff[-1], dtype=np.int64)
            got = np.empty(js.size, np.int32)
            shim.sid_lynch_slot_of_host(group.ctypes.data, len(group), js.ctypes.data, js.size, got.ctypes.data)
            assert np.array_equal(got, np.searchsorted(coff[1:], js, side="right"))
            assert np.array_equal(got, np.repeat(np.arange(len(group)), chunks[first:first + per_launch]))


def run_nll_lanes(lib, rec, off, scalars, lanes, grid, per_launch=PER_LAUNCH):
    """The lanes' objective of ``lanes`` through their slot table: out
    (S, 2) by lane (NaN for the others) and the flags."""
    n = rec.shape[1]
    flags = np.zeros(n, np.uint8)
    got = np.full((len(lanes), 2), np.nan)
    slots = lane_table(off, scalars, lanes, per_launch)
    lib.sid_lynch_nll_lanes_host(rec.ctypes.data, n, slots.ctypes.data, len(lanes), per_launch, grid,
                                 flags.ctypes.data, got.ctypes.data)
    out = np.full((len(off) - 1, 2), np.nan)
    out[list(lanes)] = got
    return out, flags


def _cohort(shim, parts):
    prof = np.ascontiguousarray(np.concatenate([p for p, _ in parts]), np.int32)
    mult = np.concatenate([m for _, m in parts]).astype(np.int64)
    off = np.concatenate([[0], np.cumsum([len(m) for _, m in parts])]).astype(np.int64)
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    scalars = np.ascontiguousarray(np.stack([
        lk.lynch_scalars(*LANE_THETAS[k % len(LANE_THETAS)], nucleotide_distribution(*parts[k]))
        if len(parts[k][1]) else lk.lynch_scalars(*LANE_THETAS[k % len(LANE_THETAS)], [0.25] * 4)
        for k in range(len(parts))
    ]))
    return parts, prof, mult, off, tab, scalars, run_records(shim, prof, mult, tab)


@pytest.fixture(scope="module")
def cohorts(shim):
    """lane_cohort's eight lanes ("mixed": an empty and a 1-row lane, lanes
    around the chunk size, a 12-chunk lane whose fold order shows in the
    bits, the deep rows), and "sparse": runs of empty and 1-row lanes
    between lanes that end mid-chunk."""
    parts = lane_cohort(seed=11)
    prof, mult = lynch_profiles(n=6000, seed=13)
    sizes = [0, 0, 1, 1, 0, 700, 1, 0, 0, 1500, 1, 1, 2047, 0, 1, 1737]
    start = np.concatenate([[0], np.cumsum(sizes)])
    sparse = [(prof[a:b], mult[a:b]) for a, b in zip(start[:-1], start[1:])]
    return {"mixed": _cohort(shim, parts), "sparse": _cohort(shim, sparse)}


def _walks(ids):
    return [pytest.param(*case, id=i) for i, case in ids.items()]


@pytest.mark.parametrize("which, grid, per_launch", _walks({
    "1": ("mixed", 1, PER_LAUNCH), "3": ("mixed", 3, PER_LAUNCH), "64": ("mixed", 64, PER_LAUNCH),
    "396": ("mixed", 396, PER_LAUNCH), "528": ("mixed", 528, PER_LAUNCH),
    "3-launches-of-3": ("mixed", 3, 3), "64-launches-of-1": ("mixed", 64, 1),
    "sparse-1": ("sparse", 1, PER_LAUNCH), "sparse-7-launches-of-4": ("sparse", 7, 4),
    "sparse-528-launches-of-5": ("sparse", 528, 5),
}))
def test_lanes_objective_is_each_lane_alone(shim, cohorts, which, grid, per_launch):
    """Each running lane's [sum, flagged count] is bitwise the single-lane
    objective over its own rows (its own record), and its flags the
    same, for every set of running lanes, grid and launch size."""
    parts, prof, mult, off, tab, scalars, rec = cohorts[which]
    n = len(parts)
    alone = []
    for k, (p, m) in enumerate(parts):
        alone.append(run_nll(shim, run_records(shim, np.ascontiguousarray(p, np.int32), m, tab), scalars[k], 5))
    for lanes in (list(range(n)), list(range(0, n, 2)), [n - 1], [1, 2]):
        out, flags = run_nll_lanes(shim, rec, off, scalars, lanes, grid, per_launch)
        for k in range(n):
            if k in lanes:
                assert np.array_equal(bits(out[k]), bits(alone[k][0]))
                assert np.array_equal(flags[off[k]:off[k + 1]], alone[k][1])
            else:
                assert np.isnan(out[k]).all() and not flags[off[k]:off[k + 1]].any()
    # every empty lane's sum is +0.0 with no flagged row
    empty = [k for k, (p, _) in enumerate(parts) if p.shape[0] == 0]
    assert empty and all(bits(alone[k][0])[0] == 0 and alone[k][0][1] == 0 for k in empty)
    if which == "mixed":  # the deep lane's flagged rows are counted
        assert sum(a[0][1] for a in alone) >= 4


@pytest.mark.parametrize("which, grid, per_launch, rows_per_thread", _walks({
    "mixed": ("mixed", 396, PER_LAUNCH, 4), "mixed-1": ("mixed", 1, PER_LAUNCH, 4),
    "mixed-5-launches-of-3": ("mixed", 5, 3, 4), "sparse": ("sparse", 528, PER_LAUNCH, 4),
    "sparse-7-launches-of-2": ("sparse", 7, 2, 4), "mixed-1-row-a-thread": ("mixed", 396, PER_LAUNCH, 1),
    "sparse-1-row-a-thread-launches-of-3": ("sparse", 64, 3, 1),
}))
def test_lanes_marginals_are_each_lane_alone(shim, cohorts, which, grid, per_launch, rows_per_thread):
    """Every row's marginals and flag bitwise the single-lane marginals of
    its lane, whatever the grid, the launch size and the rows a thread
    takes of a chunk; within 1e-12 of the plain version."""
    parts, prof, mult, off, tab, scalars, rec = cohorts[which]
    n = rec.shape[1]
    lhom, lhet, flags = np.full(n, np.nan), np.full(n, np.nan), np.full(n, 7, np.uint8)
    slots = lane_table(off, scalars, range(len(parts)), per_launch, rows_per_thread * lk.REDUCE_THREADS)
    shim.sid_lynch_marginals_lanes_host(rec.ctypes.data, n, slots.ctypes.data, len(parts), per_launch, grid,
                                        rows_per_thread, lhom.ctypes.data, lhet.ctypes.data, flags.ctypes.data)
    for k, (p, m) in enumerate(parts):
        r = slice(off[k], off[k + 1])
        _, _, w_hom, w_het, w_flags = run_record_rows(
            shim, run_records(shim, np.ascontiguousarray(p, np.int32), m, tab), scalars[k])
        assert np.array_equal(bits(lhom[r]), bits(w_hom)) and np.array_equal(bits(lhet[r]), bits(w_het))
        assert np.array_equal(flags[r], w_flags)
    want = lynch_objective.lynch_marginals_lanes_ref(torch.from_numpy(prof), off, scalars, tab)
    assert np.array_equal(flags, want[2].numpy())
    assert_agree(lhom, want[0].numpy(), 1e-12)
    assert_agree(lhet, want[1].numpy(), 1e-12)
