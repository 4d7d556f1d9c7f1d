"""The fit's loop on the card, held on the CPU.

``sid_tpu_torch/csrc/nmsimplex.cuh`` is the nmsimplex2 step machine that the
fit's kernel (csrc/lynch.cu ``lynch_fit_lanes_kernel``) runs, one evaluation
a launch; ``nmsimplex_host.cpp`` builds it with g++ (contraction off, like
nvcc --fmad=false) and these tests drive it point by point:

- against the port's host loop (``exact/nmsimplex.py _minimize``): every
  point, x, fval, iterations and converged bitwise, on the objectives of
  tests/test_nmsimplex.py (smooth, a box-penalty plateau, NaN and inf
  regions, unbounded to max_iterations), 1-D objectives at several
  max_iterations, points out of the box;
- against sid_tpu's ``minimize_nmsimplex2_jax`` on the CPU, in a subprocess
  with XLA's contraction off (``torch_nm_jax_runs.py``): x, fval,
  iterations and converged bitwise with the host loop and the step machine
  on the same jitted objectives;
- its dot products against numpy's (``dot_mode``), its five theta scalars
  against ``likelihoods.theta_scalars``;
- ``lynch_host.cpp``'s copy of the whole loop on the card (rounds of the
  fit's kernel, each lane's step in the block that folds it, handovers)
  against the plain version ``lynch_fit_lanes_ref``: results, histories,
  rounds and flags bitwise, for cohorts with empty, 1-row and deep lanes,
  in 1-D and 2-D, over several grids;
- ``replay`` cut at every evaluation of a Lynch fit (a C2 input included)
  against the uninterrupted host loop, and the device fit and the cohort's
  fits through ``LynchFitWorkspace`` (its plain version here) against the
  host loop over ``DeviceObjective`` and ``LanesObjective``, handovers
  included.
"""

import ctypes
import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_nm_jax_runs  # noqa: E402
from sid_tpu_torch.exact import nmsimplex  # noqa: E402
from sid_tpu_torch.models import lynch  # noqa: E402
from sid_tpu_torch.ops import likelihoods as lk  # noqa: E402
from sid_tpu_torch.ops import lynch_objective as lo  # noqa: E402
from sid_tpu_torch.ops.lgamma import lgamma_table  # noqa: E402
from sid_tpu_torch.ops.profiles import filter_min_coverage, nucleotide_distribution, unique_profiles  # noqa: E402
from synth import simulate_diploid_counts  # noqa: E402
from test_torch_lynch import lynch_profiles  # noqa: E402
from test_torch_nmsimplex import DBL_MAX, OBJECTIVES  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "sid_tpu_torch", "csrc")
JAX_CASES = [c[0] for c in torch_nm_jax_runs.cases(np)]
# the 1-D objectives of tests/test_torch_nmsimplex.py's lanes
ONE_D = [
    lambda x: float((x[0] - 0.3) ** 2),
    lambda x: float("nan") if x[0] > 0.0015 else float(x[0] ** 2),
    lambda x: DBL_MAX if x[0] < 0 else float(abs(x[0] - 0.02)),
    lambda x: float(-x[0]),
    lambda x: float("-inf") if x[0] > 0.01 else float(x[0]),
]


def _g_plus_plus(tmp_path_factory, src, name):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = str(tmp_path_factory.mktemp("shim") / name)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o", out,
                    os.path.join(CSRC, src)], check=True)
    return out


@pytest.fixture(scope="module")
def nm_path(tmp_path_factory):
    return _g_plus_plus(tmp_path_factory, "nmsimplex_host.cpp", "libnmsimplex_host.so")


@pytest.fixture(scope="module")
def nm(nm_path):
    lib = torch_nm_jax_runs.load_shim(nm_path)
    p, d, i = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    lib.sid_nm_dot.argtypes, lib.sid_nm_dot.restype = [i, p, p, i], d
    lib.sid_theta_scalars_many.argtypes, lib.sid_theta_scalars_many.restype = [p, p, ctypes.c_longlong, p], None
    return lib


@pytest.fixture(scope="module")
def fit_shim(tmp_path_factory):
    lib = ctypes.CDLL(_g_plus_plus(tmp_path_factory, "lynch_host.cpp", "liblynch_host.so"))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sid_lynch_fit_lane_bytes_host.argtypes, lib.sid_lynch_fit_lane_bytes_host.restype = [], i32
    lib.sid_lynch_fit_lanes_host.restype = ctypes.c_longlong
    lib.sid_lynch_fit_lanes_host.argtypes = [i32, p, i64, p, i32, p, p, ctypes.c_double, i32, i32, p, i64, p, p,
                                             i32]
    lib.sid_lynch_records_host.argtypes = [p, p, p, i32, i64, p]
    lib.sid_lynch_records_host.restype = None
    return lib


@pytest.fixture(scope="module")
def jax_runs(nm_path):
    """sid_tpu's loop, the host loop and the step machine on the same
    jitted objectives, in one subprocess with XLA's contraction off."""
    env = dict(os.environ, XLA_FLAGS="--xla_backend_optimization_level=0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([ROOT, HERE]))
    proc = subprocess.run([sys.executable, os.path.join(HERE, "torch_nm_jax_runs.py"), nm_path], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {row["name"]: row for row in map(json.loads, proc.stdout.splitlines())}


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


def _same_value(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


def _host(f, x0, step, max_iterations=1000):
    calls = []
    res = nmsimplex.minimize_nmsimplex2(lambda x: calls.append(np.array(x)) or f(x), x0, step,
                                        max_iterations=max_iterations)
    return calls, res


def _assert_same_run(shim_run, calls, res):
    points, x, fval, conv, it = shim_run
    assert len(points) == len(calls)
    assert all(_bits_equal(p, q) for p, q in zip(points, calls))
    assert _bits_equal(x, res.x) and _same_value(fval, res.fval)
    assert (conv, it) == (res.converged, res.iterations)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_step_machine_is_the_host_loop(nm, name):
    f, x0, step = OBJECTIVES[name]
    calls, res = _host(f, x0, step)
    _assert_same_run(torch_nm_jax_runs.shim_minimize(nm, f, x0, step, 1000, nmsimplex.dot_mode()), calls, res)


@pytest.mark.parametrize("max_iterations", [0, 1, 7, 1000])
@pytest.mark.parametrize("k", range(len(ONE_D)))
def test_step_machine_1d(nm, k, max_iterations):
    calls, res = _host(ONE_D[k], [1e-3], [1e-4], max_iterations)
    run = torch_nm_jax_runs.shim_minimize(nm, ONE_D[k], [1e-3], [1e-4], max_iterations, nmsimplex.dot_mode())
    _assert_same_run(run, calls, res)
    assert res.iterations <= max_iterations


def test_step_machine_points_out_of_the_box(nm):
    """The box penalty from a start whose first reflections leave the box:
    the points outside are asked for and take DBL_MAX like any value."""
    f, x0, step = OBJECTIVES["box_penalty"]
    calls, res = _host(f, [0.99, 0.99], [0.2, 0.2])
    assert any(max(abs(p)) > 1 for p in calls)
    _assert_same_run(torch_nm_jax_runs.shim_minimize(nm, f, [0.99, 0.99], [0.2, 0.2], 1000, nmsimplex.dot_mode()),
                     calls, res)


@pytest.mark.parametrize("name", JAX_CASES)
def test_step_machine_is_sid_tpus_device_loop(jax_runs, name):
    """x, fval, iterations and converged bitwise sid_tpu's
    minimize_nmsimplex2_jax (XLA's contraction off), the host loop's and
    the step machine's, whose visited points are the host loop's."""
    row = jax_runs[name]
    assert row["points_equal"] and row["points"] > 0
    assert row["shim"] == row["host"]
    if name.endswith("_0_iterations"):
        # sid_tpu's lean loop checks iterations < max_iterations before its
        # first trip, so at 0 it never evaluates the start simplex: x0 with
        # fval 0.0; the spec (and the card's loop) evaluates it first
        assert row["jax"]["iterations"] == row["host"]["iterations"] == 0
        assert row["jax"]["fval"] == (0.0).hex() and row["jax"]["x"] == [(1e-3).hex()]
    else:
        assert row["jax"] == row["host"]


def test_dot_mode_is_numpys(nm):
    rng = np.random.default_rng(3)
    mode = nmsimplex.dot_mode()
    a = rng.standard_normal((20000, 2)) * rng.uniform(0, 1e-2, (20000, 1))
    b = rng.standard_normal((20000, 2))
    for dims in (1, 2):
        for x, y in zip(a, b):
            x, y = np.ascontiguousarray(x[:dims]), np.ascontiguousarray(y[:dims])
            assert _bits_equal(nm.sid_nm_dot(dims, x.ctypes.data, y.ctypes.data, mode), np.dot(x, y))
    # mode 0 rounds each product and sum
    x, y = np.array([1.0, 1.0 + 2.0**-30]), np.array([-1.0, 1.0 + 2.0**-30])
    assert nm.sid_nm_dot(2, x.ctypes.data, y.ctypes.data, 0) == 2.0**-29
    assert nm.sid_nm_dot(2, x.ctypes.data, y.ctypes.data, 1) == 2.0**-29 + 2.0**-60


def test_theta_scalars_are_the_hosts(nm):
    """The five scalars the card computes for a point, from the host build:
    bitwise likelihoods.theta_scalars over the fit's range and its edges."""
    rng = np.random.default_rng(11)
    pis = np.concatenate([10 ** rng.uniform(-12, 0, 60000), [0.0, -0.0, 1.0, 5e-324, 1e-300, 0.5]])
    eps = np.concatenate([10 ** rng.uniform(-12, 0, 60000), [1.0, 0.0, -0.0, 5e-324, 0.999, 0.5]])
    out = np.zeros((pis.shape[0], 5))
    nm.sid_theta_scalars_many(pis.ctypes.data, eps.ctypes.data, pis.shape[0], out.ctypes.data)
    want = np.array([lk.theta_scalars(p, e) for p, e in zip(pis, eps)])
    assert np.array_equal(out.view(np.int64), want.view(np.int64))


def small_cohort(deep: bool = True):
    """Six lanes of lynch_profiles-like rows: an empty lane, a 1-row lane,
    one short lane, lanes of 2 and 3 chunks whose multiplicities span
    orders of magnitude (their chunk sums fold in an order that shows in
    the bits) and, with ``deep``, a lane holding the two C2 rows, which the
    range screen flags (C4)."""
    rng = np.random.default_rng(8)
    prof, mult = lynch_profiles(n=4000, seed=8)
    parts, start = [], 12
    for n in (0, 1, 300, 1025, 2100):
        parts.append((prof[start:start + n], mult[start:start + n]))
        start += n
    parts[4] = (parts[4][0], 10 ** rng.integers(0, 8, 2100))
    tail = slice(6, 8 if deep else 6)  # rows 6 and 7: the C2 repros (9000, 9000, 0, 0), (15000, 0, 5000, 0)
    parts.append((np.concatenate([prof[tail], prof[start:start + 40]]),
                  np.concatenate([mult[tail], mult[start:start + 40]])))
    return parts


def _stack(parts):
    prof = np.concatenate([p for p, _ in parts]).astype(np.int32)
    mult = np.concatenate([m for _, m in parts]).astype(np.int64)
    off = np.concatenate([[0], np.cumsum([len(m) for _, m in parts])]).astype(np.int64)
    nts = np.stack([nucleotide_distribution(p, m) if len(m) else np.full(4, 0.25) for p, m in parts])
    return prof, mult, off, nts


def _starts(dims, s):
    if dims == 2:
        return np.array([[1e-3, 1e-3, 1e-4, 1e-4, 0.0]] * s)
    return np.array([[1e-3, 1e-4, e] for e in np.linspace(0.005, 0.05, s)])


@functools.lru_cache(maxsize=None)
def _plain_fit(deep, dims):
    prof, mult, off, nts = _stack(small_cohort(deep))
    tab = lgamma_table(int(prof.sum(-1).max()), "cpu")
    scal = np.stack([lk.lynch_scalars(0.0, 0.0, nt) for nt in nts])
    out = lo.lynch_fit_lanes_ref(torch.from_numpy(prof), torch.from_numpy(mult), off, scal, tab,
                                 _starts(dims, len(nts)))
    return (prof, mult, off, scal, tab.numpy()), out


@pytest.mark.parametrize("grid", [1, 396])
@pytest.mark.parametrize("dims", [1, 2])
@pytest.mark.parametrize("deep", [False, True])
def test_kernel_loop_is_the_plain_version(fit_shim, deep, dims, grid):
    """lynch_host.cpp's copy of the fit's graph (the start, then rounds of
    lynch_fit_lanes_kernel, each lane stepped by the block that folds it)
    against lynch_fit_lanes_ref: results, statuses, histories, rounds and
    flags bitwise; the deep lane hands over at its first evaluation."""
    (prof, mult, off, scal, tabn), (want, hist, flags) = _plain_fit(deep, dims)
    s = off.shape[0] - 1
    starts = _starts(dims, s)
    table = np.zeros(s, lo.FIT_LANE)
    table["first_row"], table["end_row"] = off[:-1], off[1:]
    table["walk_end"] = np.cumsum(lk.lane_chunks(np.diff(off)))
    assert fit_shim.sid_lynch_fit_lane_bytes_host() == lo.FIT_LANE.itemsize
    rec = np.zeros((3, prof.shape[0]))
    fit_shim.sid_lynch_records_host(prof.ctypes.data, mult.ctypes.data, tabn.ctypes.data, tabn.shape[0],
                                    prof.shape[0], rec.ctypes.data)
    entries = lo.history_entries(dims, 1000)
    got_hist = np.zeros((s, entries, dims + 2))
    got_rows = np.zeros((s, dims + 5))
    got_flags = np.zeros(prof.shape[0], np.uint8)
    scal_io = scal.copy()
    rounds = fit_shim.sid_lynch_fit_lanes_host(
        dims, rec.ctypes.data, prof.shape[0], table.ctypes.data, s, np.ascontiguousarray(starts).ctypes.data,
        scal_io.ctypes.data, 1e-5, 1000, nmsimplex.dot_mode(), got_hist.ctypes.data, entries,
        got_flags.ctypes.data, got_rows.ctypes.data, grid)
    got = lo.FitLanes.from_rows(got_rows, dims, rounds)
    assert got.rounds == want.rounds == int(want.evaluations.max())
    assert np.array_equal(got.status, want.status) and np.array_equal(got.evaluations, want.evaluations)
    done = want.status == lo.FIT_DONE
    for a, b in ((got.x[done], want.x[done]), (got.fval[done], want.fval[done]),
                 (got.iterations[done], want.iterations[done]), (got.converged[done], want.converged[done])):
        assert _bits_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
    assert np.array_equal(got_hist.view(np.int64), hist.view(np.int64))
    assert np.array_equal(got_flags, flags.numpy())
    handed = np.nonzero(want.status == lo.FIT_HANDOVER)[0]
    assert (len(handed) > 0) == deep
    assert all(want.evaluations[k] == 1 for k in handed)


def _fit_input(deep_row=None, n=300, seed=9):
    counts = simulate_diploid_counts(n, coverage=25, pi=0.02, eps=0.01, seed=seed)
    if deep_row is not None:
        counts = np.vstack([counts, [deep_row]])
    prof, mult, _ = unique_profiles(counts)
    prof, mult, _ = filter_min_coverage(prof, mult, 4)
    return prof, mult, nucleotide_distribution(prof, mult)


FIT_INPUTS = {"simulated": None, "C2 (9000, 9000, 0, 0)": [9000, 9000, 0, 0]}


@functools.lru_cache(maxsize=None)
def _host_fit(name):
    """The host loop over DeviceObjective on FIT_INPUTS[name]: its points,
    their values, its result, the rows it flagged at most."""
    prof, mult, nt = _fit_input(FIT_INPUTS[name])
    obj = lynch.DeviceObjective(prof, mult, nt, torch.device("cpu"))
    values = []
    calls, want = _host(lambda x: values.append(obj(x)) or values[-1], (1e-3, 1e-3), (1e-4, 1e-4))
    return calls, values, want, obj.flagged


@pytest.mark.parametrize("name", list(FIT_INPUTS))
def test_replay_cut_at_every_evaluation(name):
    """The host loop over DeviceObjective, recorded; ``replay`` of its first
    k values then the host loop to the end, for every k: the rest of the
    points and the result bitwise the uninterrupted loop's."""
    calls, values, want, _ = _host_fit(name)
    for k in range(len(calls)):
        steps, x = nmsimplex.replay((1e-3, 1e-3), (1e-4, 1e-4), 1e-5, 1000, values[:k], calls)
        seen = [k]

        def recorded(point):
            i = seen[0]
            assert _bits_equal(point, calls[i])
            seen[0] += 1
            return values[i]

        (got,) = nmsimplex.finish_lanes(lambda lanes, points: [recorded(p) for p in points], {0: steps}, {0: x},
                                        [None])
        assert seen[0] == len(calls)
        assert _bits_equal(got.x, want.x) and got.fval == want.fval
        assert (got.iterations, got.converged) == (want.iterations, want.converged)
    # the whole history: the loop ends on it
    assert nmsimplex.replay((1e-3, 1e-3), (1e-4, 1e-4), 1e-5, 1000, values, calls)[0] is None


def test_replay_refuses_another_history():
    f, x0, step = OBJECTIVES["quadratic"]
    calls, _ = _host(f, x0, step)
    values = [f(x) for x in calls]
    bad = [c.copy() for c in calls]
    bad[5][0] = np.nextafter(bad[5][0], 1.0)
    with pytest.raises(RuntimeError, match="point 5"):
        nmsimplex.replay(x0, step, 1e-5, 1000, values[:8], bad)
    with pytest.raises(RuntimeError, match="ended at value"):
        nmsimplex.replay(x0, step, 1e-5, 1000, values + [0.0], None)


@pytest.mark.parametrize("name", list(FIT_INPUTS))
def test_device_fit_is_the_host_loop(name):
    """DeviceObjective.minimize (LynchFitWorkspace's plain version here)
    bitwise the host loop over DeviceObjective; the C2 inputs hand over at
    evaluation 0 and go on in the host's loop."""
    _, _, want, flagged = _host_fit(name)
    prof, mult, nt = _fit_input(FIT_INPUTS[name])
    obj = lynch.DeviceObjective(prof, mult, nt, torch.device("cpu"))
    before = lo.FIT_HANDOVERS
    got = obj.minimize((1e-3, 1e-3), (1e-4, 1e-4))
    assert _bits_equal(got.x, want.x) and got.fval == want.fval
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    handed = FIT_INPUTS[name] is not None
    assert lo.FIT_HANDOVERS - before == int(handed)
    assert obj.fit.status[0] == (lo.FIT_HANDOVER if handed else lo.FIT_DONE)
    assert obj.fit.evaluations[0] == (1 if handed else obj.fit.rounds)
    assert obj.flagged == flagged == int(handed)


@pytest.mark.parametrize("held_eps", [None, 0.0123])
def test_cohort_fits_are_the_host_lockstep(held_eps):
    """LanesObjective.minimize (the plain version here) bitwise the host's
    lockstep over LanesObjective, 2-D and 1-D at a held epsilon: the deep
    lane handed over and finished on the host, the empty and 1-row lanes
    on their own."""
    parts = small_cohort()
    nts = _stack(parts)[3]
    start, step = ((1e-3, 1e-3), (1e-4, 1e-4)) if held_eps is None else ((1e-3,), (1e-4,))
    host = lynch.LanesObjective(parts, nts, "cpu", held_eps)
    want = nmsimplex.minimize_nmsimplex2_lanes(host, [start] * len(parts), [step] * len(parts))
    obj = lynch.LanesObjective(parts, nts, "cpu", held_eps)
    got = obj.minimize(start, step)
    for g, w in zip(got, want):
        assert _bits_equal(g.x, w.x) and _same_value(g.fval, w.fval)
        assert (g.iterations, g.converged) == (w.iterations, w.converged)
    assert (obj.fit.status == lo.FIT_HANDOVER).sum() == 1


def test_fit_workspace_rejects_bad_starts():
    prof, mult, nt = _fit_input()
    work = lynch.DeviceObjective(prof, mult, nt, torch.device("cpu")).work
    with pytest.raises(ValueError, match="2 N \\+ 1"):
        lo.LynchFitWorkspace(work, [[1e-3, 1e-3, 1e-4, 1e-4]], nt[None])
    with pytest.raises(ValueError, match="2 starts for 1 lanes"):
        lo.LynchFitWorkspace(work, [[1e-3, 1e-4, 0.0]] * 2, np.stack([nt, nt]))
    with pytest.raises(ValueError, match="handed over"):
        out = lo.FitLanes.from_rows(np.array([[0.1, 0.2, 1.0, 0.0, 3.0, 4.0, lo.FIT_HANDOVER]]), 2, 4)
        out.result(0)
