"""The Lynch fit's device kernels: the per-fit row record, the compound
objective (B2) and the marginals at the fitted error rate (B4).

A ``LynchWorkspace`` binds one fit's rows to their device and checks them
once. On a CUDA device its set-up kernel writes the row record
(``csrc/lynch.cuh``: m, the packed counts, the multiplicity and the
theta-free part of the range screen), and B2 and B4 (``csrc/lynch.cu``, the
counterparts of sid_tpu's XLA programs
``ops/likelihoods.py::compound_neg_log_likelihood`` and
``log_{hom,het}_marginal``) read it; the kernels are built with nvcc at
first use. One evaluation of the objective is one ctypes call: the launch,
an async copy of the (2,) result into pinned host memory and one stream
sync. On the CPU the workspace runs the plain torch f64 versions ``*_ref``.
Any other device, dtype, shape, layout or value range raises; so does a
failed build or launch.

``lynch_compound_nll`` and ``lynch_marginals`` are the one-call forms the
tests hold against the plain versions.

Both kernels apply the long-double range screen: the objective leaves the
rows it flags out of its sum and counts them, the marginals flag theirs;
the caller evaluates the flagged rows in host long double
(``models/lynch.py``). The theta-dependent scalars come from
``ops.likelihoods.lynch_scalars``.

A ``LynchLanesWorkspace`` does the same for a cohort (population mode): the
lanes' rows one after another with lane row offsets, one row record over all
of them, and two more kernels, the counterparts of sid_tpu's vmapped
population programs (``models/population.py``: the fits' objective and
``_marginals_batched``): ``nll_lanes`` evaluates the objective of any set
of lanes, each at its own theta, in one launch (each lane bitwise B2 over
its rows alone), and ``marginals_lanes`` is B4 over every lane's rows at
its lane's epsilon in one launch; each launch takes a table of its lanes
(``fill_lane_slots``: scalars, rows, chunks) into the kernel library's
constant bank, and a cohort of more lanes than one launch takes
(``per_launch``) runs in several. Their plain versions
(``lynch_compound_nll_lanes_ref``, ``lynch_marginals_lanes_ref``) take
every lane's rows at once, each at its lane's scalars, and give each lane
the bits of the single-lane plain versions.

A sharded fit (``parallel/fit.py``, sid_tpu's ``fit_lynch_global``) binds
each shard's rows in a ``LynchWorkspace`` and groups the shards by device
(``LynchShardGroup``): one launch of the sharded objective a device and
evaluation walks every chunk of the device's shards through a table of
them built once (a kernel parameter), each chunk sum at its global index, and on the fold's
device (the mesh's first) the last block folds all the fit's chunk sums in
B2's order, after the other devices' chunk sums were copied in by the same
call. Its plain version, ``lynch_nll_shards_ref``, is
``lynch_nll_partials_ref`` per shard and ``lynch_fold_ref`` over them all.

A ``LynchFitWorkspace`` runs whole fits on the card (B3, sid_tpu's
``ops/nmsimplex.py:287`` while-loop around B2): S >= 1 nmsimplex2
minimizations (lanes) over the row record of a ``LynchWorkspace`` (one
lane) or a ``LynchLanesWorkspace``, the whole loop one cooperative launch
of the fit's kernel on a persistent grid (``run``: one launch, one copy of
the lanes' results, one sync): its blocks run each lane's rounds, each an
evaluation of the lane's objective whose last block takes the lane's
simplex step (``csrc/nmsimplex.cuh``, bitwise ``exact/nmsimplex.py``) and
publishes its next point. A lane stops at its
end or at its first evaluation that flags rows for the long-double
replay (a handover: ``history`` gives its points and values for
``exact.nmsimplex.replay``, and the host's loop goes on). Its plain
version, ``lynch_fit_lanes_ref``, is the host loop over
``lynch_compound_nll_lanes_ref`` with the same handovers and histories.

``RECORD_LAUNCHES``, ``NLL_LAUNCHES``, ``MARGINALS_LAUNCHES``,
``NLL_LANES_LAUNCHES``, ``MARGINALS_LANES_LAUNCHES``,
``NLL_SHARDS_LAUNCHES`` and ``FIT_LANES_LAUNCHES`` count kernel launches
(not plain-version calls; the fit's kernel once a fit), ``FIT_LAUNCHES``
the fits launched and run to their results, ``FIT_ROUNDS`` their rounds
(each lane's most evaluations) and ``FIT_HANDOVERS`` the lanes handed to
the host's loop, so a run can show that it went through the kernels; the
kernel library keeps its own count (``kernel_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sid_tpu_torch.exact import nmsimplex
from sid_tpu_torch.native import build
from sid_tpu_torch.ops import likelihoods

RECORD_LAUNCHES = 0
NLL_LAUNCHES = 0
MARGINALS_LAUNCHES = 0
NLL_LANES_LAUNCHES = 0
MARGINALS_LANES_LAUNCHES = 0
NLL_SHARDS_LAUNCHES = 0
FIT_LANES_LAUNCHES = 0
FIT_LAUNCHES = 0
FIT_ROUNDS = 0
FIT_HANDOVERS = 0

# counts arrive as uint16; the record packs them so
MAX_COUNT = 65535
# the record: m, the signed multiplicity, the packed counts (csrc/lynch.cuh)
RECORD_PLANES = 3
# the kernel library's launch counters (csrc/lynch.cu)
KERNELS = ("records", "nll", "marginals", "nll_lanes", "marginals_lanes", "nll_shards", "fit_lanes")
# one running lane of a launch of a lane kernel (csrc/lynch.cuh LaneSlot):
# its scalars, its rows, the end of its chunks in the launch's walk
LANE_SLOT = np.dtype([("s", "<f8", (16,)), ("first_row", "<i8"), ("end_row", "<i8"), ("walk_end", "<i8")])
# one shard of a sharded fit's launch on its device (csrc/lynch.cuh
# ShardSlot): its record and flags (device addresses), its rows, its first
# global chunk, the end of its chunks in the launch's walk
SHARD_SLOT = np.dtype([("rec", "<u8"), ("rows", "<i8"), ("flags", "<u8"), ("first_chunk", "<i8"), ("walk_end", "<i8")])
# the shards one launch of the sharded objective takes (csrc/lynch.cu
# kShardsPerLaunch: its table is a kernel parameter)
SHARDS_PER_LAUNCH = 32
# one copy the fold device's call makes before its launch (csrc/lynch.cu
# PeerPull): after the event, bytes from src on src_device into dst
PEER_PULL = np.dtype([("event", "<u8"), ("dst", "<u8"), ("src", "<u8"), ("bytes", "<i8"), ("src_device", "<i8")])
# one lane of a fit on the card (csrc/lynch.cuh FitLane): its rows, the
# end of its chunks in the walk over every lane's chunks and of its units
# in the walk over every lane's units
FIT_LANE = np.dtype([("first_row", "<i8"), ("end_row", "<i8"), ("walk_end", "<i8"), ("unit_end", "<i8")])
# a fit lane's status (csrc/lynch.cuh FitStatus)
FIT_DONE, FIT_HANDOVER = 1, 2
# the longest a block of the fit's kernel waits for a lane's next point
# before the launch ends with an error (ns): far above any round
FIT_WAIT_NS = 10_000_000_000

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# what each kernel library's constant bank holds on each device: the
# (workspace, "nll" or "marginals") whose slot table was copied there last
_bank = {}
_workspace_keys = itertools.count()


def lynch_records_ref(profiles: torch.Tensor, mult: torch.Tensor, lgamma_tab: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the set-up kernel: the (3, U) f64 row record
    of csrc/lynch.cuh. Plane 0 is m (``likelihoods.log_multinomial``),
    plane 1 the multiplicity as f64 with its sign bit set where m >
    SAFE_MAX, plane 2 the counts as four uint16, c0 lowest."""
    prof = profiles.to(torch.int64)
    m = likelihoods.log_multinomial(prof, lgamma_tab)
    w = mult.to(torch.float64)
    w = torch.where(m > likelihoods.SAFE_MAX, -w, w)
    # uint16 bit patterns as int16, then the four of a row as one 8-byte word
    as_i16 = torch.where(prof > 32767, prof - 65536, prof).to(torch.int16).contiguous()
    packed = as_i16.view(torch.float64).reshape(-1)
    return torch.stack([m, w, packed])


def lynch_compound_nll_ref(
    profiles: torch.Tensor, mult: torch.Tensor, scalars: np.ndarray, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch f64 version of B2: ([sum of the unflagged terms, flagged
    count] as a (2,) f64 tensor, (U,) uint8 flags)."""
    rows = likelihoods.lynch_rows(profiles, likelihoods.row_scalars(scalars, profiles), lgamma_tab)
    flags = rows.flag_mixture
    terms = torch.where(flags, 0.0, likelihoods.lynch_terms(rows.log_mix, mult))
    total = likelihoods.fixed_order_sum(terms)
    out = torch.stack([total, flags.sum().to(torch.float64)])
    return out, flags.to(torch.uint8)


def lynch_nll_partials_ref(
    profiles: torch.Tensor, mult: torch.Tensor, scalars: np.ndarray, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch f64 version of one shard's part of the sharded
    objective: the (ceil(U / CHUNK_ROWS),) chunk sums of the unflagged
    terms (f64) and flagged counts (int32), and the (U,) uint8 flags."""
    rows = likelihoods.lynch_rows(profiles, likelihoods.row_scalars(scalars, profiles), lgamma_tab)
    flags = rows.flag_mixture
    terms = torch.where(flags, 0.0, likelihoods.lynch_terms(rows.log_mix, mult))
    n_chunks = -(-profiles.shape[0] // likelihoods.CHUNK_ROWS)
    cnt = torch.zeros(n_chunks * likelihoods.CHUNK_ROWS, dtype=torch.int32, device=profiles.device)
    cnt[: profiles.shape[0]] = flags.to(torch.int32)
    counts = cnt.view(n_chunks, likelihoods.CHUNK_ROWS).sum(1, dtype=torch.int32)
    return likelihoods.chunk_sums_ref(terms), counts, flags.to(torch.uint8)


def lynch_fold_ref(part_sum: torch.Tensor, part_cnt: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the fold in the sharded objective's last
    block: [the chunk sums folded in B2's order, the flagged counts summed]
    as a (2,) f64 tensor."""
    return torch.stack([likelihoods.fold_chunk_sums_ref(part_sum), part_cnt.sum().to(torch.float64)])


def lynch_nll_shards_ref(
    shards, scalars: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, list]:
    """Plain version of one launch of the sharded objective that holds a
    whole fit (every shard on one device, the fold on): ``shards`` is the
    (profiles, mult, lgamma_tab) of each shard in row order, each but the
    last a multiple of CHUNK_ROWS rows. ``lynch_nll_partials_ref`` per
    shard, ``lynch_fold_ref`` over their concatenation. Returns ((2,) f64
    [sum of the unflagged terms, flagged count], the (C,) f64 chunk sums,
    the (C,) int32 flagged counts, each shard's (rows,) uint8 flags)."""
    parts = [lynch_nll_partials_ref(p, m, scalars, tab) for p, m, tab in shards]
    part_sum = torch.cat([q[0] for q in parts])
    part_cnt = torch.cat([q[1] for q in parts])
    return lynch_fold_ref(part_sum, part_cnt), part_sum, part_cnt, [q[2] for q in parts]


def lynch_marginals_ref(
    profiles: torch.Tensor, scalars: np.ndarray, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch f64 version of B4: (log L_hom, log L_het, uint8 flags)."""
    rows = likelihoods.lynch_rows(profiles, likelihoods.row_scalars(scalars, profiles), lgamma_tab)
    return rows.lhom, rows.lhet, rows.flag_marginals.to(torch.uint8)


def _lane_rows(offsets: np.ndarray, lanes, device):
    """The rows of ``lanes`` in order, and each one's place among them."""
    sizes = np.array([offsets[k + 1] - offsets[k] for k in lanes], np.int64)
    rows = np.concatenate([np.arange(offsets[k], offsets[k + 1]) for k in lanes]) if len(lanes) else []
    which = np.repeat(np.arange(len(lanes)), sizes)
    return (torch.as_tensor(np.asarray(rows, np.int64), device=device),
            torch.from_numpy(which).to(device), sizes)


def lynch_compound_nll_lanes_ref(
    profiles: torch.Tensor, mult: torch.Tensor, offsets: np.ndarray, scalars: np.ndarray,
    lgamma_tab: torch.Tensor, lanes,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the lanes' objective: for each of ``lanes``, B2's
    plain version over its rows at its own row of ``scalars`` (S, 16),
    bitwise ``lynch_compound_nll_ref`` of that lane alone. All the lanes'
    rows go through ``likelihoods.lynch_rows`` at once with per-row
    scalars, and ``likelihoods.fixed_order_sums`` sums each lane in the
    kernel's order. Returns ((len(lanes), 2) f64 [sum of the unflagged
    terms, flagged count] in the order of ``lanes``, (N,) uint8 flags, 0
    outside them)."""
    dev = profiles.device
    rows, which, sizes = _lane_rows(offsets, list(lanes), dev)
    per_row = torch.from_numpy(np.ascontiguousarray(scalars, np.float64)[list(lanes)]).to(dev)[which]
    r = likelihoods.lynch_rows(profiles[rows], per_row, lgamma_tab)
    terms = torch.where(r.flag_mixture, 0.0, likelihoods.lynch_terms(r.log_mix, mult[rows]))
    counts = torch.zeros(len(sizes), dtype=torch.int64, device=dev).index_add_(
        0, which, r.flag_mixture.to(torch.int64))
    flags = torch.zeros(profiles.shape[0], dtype=torch.uint8, device=dev)
    flags[rows] = r.flag_mixture.to(torch.uint8)
    out = torch.stack([likelihoods.fixed_order_sums(terms, sizes), counts.to(torch.float64)], 1)
    return out, flags


def lynch_marginals_lanes_ref(
    profiles: torch.Tensor, offsets: np.ndarray, scalars: np.ndarray, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the lanes' marginals: every row at its lane's row
    of ``scalars`` (S, 16), bitwise ``lynch_marginals_ref`` of each lane
    alone: (log L_hom, log L_het, uint8 flags), each (N,)."""
    dev = profiles.device
    lanes = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    per_row = torch.from_numpy(np.ascontiguousarray(scalars, np.float64)).to(dev)[torch.from_numpy(lanes).to(dev)]
    r = likelihoods.lynch_rows(profiles, per_row, lgamma_tab)
    return r.lhom, r.lhet, r.flag_marginals.to(torch.uint8)


def _check(profiles, lgamma_tab, mult) -> None:
    if profiles.dim() != 2 or profiles.shape[1] != 4:
        raise ValueError(f"profiles must be (U, 4), got {tuple(profiles.shape)}")
    if lgamma_tab.dim() != 1:
        raise ValueError("lgamma_tab must be 1-D")
    if mult.shape != (profiles.shape[0],):
        raise ValueError(f"mult must be ({profiles.shape[0]},), got {tuple(mult.shape)}")
    checks = [("profiles", profiles, torch.int32), ("lgamma_tab", lgamma_tab, torch.float64),
              ("mult", mult, torch.int64)]
    for name, t, dtype in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != profiles.device:
            raise ValueError(f"{name} is on {t.device}, profiles on {profiles.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_scalars(scalars) -> None:
    if np.shape(scalars) != (16,):
        raise ValueError("scalars must be the 16 values of lynch_scalars")


def _check_values(profiles, mult) -> None:
    """Counts in 0..MAX_COUNT (the record packs them as uint16) and
    multiplicities >= 0 (the record keeps the screen in their sign bit):
    raises, never clips. One reduction each, and a wait for it."""
    if profiles.numel():
        lo, hi = (int(v) for v in torch.aminmax(profiles))
        if lo < 0 or hi > MAX_COUNT:
            raise ValueError(f"counts must be in 0..{MAX_COUNT}, got {lo}..{hi}")
    if mult.numel() and int(mult.min()) < 0:
        raise ValueError("multiplicities must be >= 0")


def _cuda_checks(profiles, lgamma_tab, what: str) -> None:
    if profiles.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {profiles.device}")
    if profiles.data_ptr() % 16:
        raise ValueError("profiles must be 16-byte aligned (one int4 load per row)")
    if lgamma_tab.shape[0] >= 2**31:
        raise ValueError("lgamma_tab is too long for an int index")


def load_kernel_library(path: str) -> ctypes.CDLL:
    """A build of csrc/lynch.cu at ``path`` with its functions' types set,
    checked against this module's chunk, record and slot layouts."""
    lib = ctypes.CDLL(path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, args in (
        ("sid_lynch_chunk_rows", []),
        ("sid_lynch_record_planes", []),
        ("sid_lynch_lanes_per_launch", []),
        ("sid_lynch_lane_slot_bytes", []),
        ("sid_lynch_marginals_chunk_rows", []),
        ("sid_lynch_grids", [i64, p]),
        ("sid_lynch_blocks_per_sm", [i32, p]),
        ("sid_lynch_records_launch", [p, p, p, i32, i64, p, i32, p]),
        ("sid_lynch_nll_launch", [p, p, i64, p, p, p, p, p, i32, p, p]),
        ("sid_lynch_marginals_launch", [p, p, i64, p, p, p, i32, p]),
        ("sid_lynch_lanes_grids", [i64, i64, p]),
        ("sid_lynch_nll_lanes_launch", [p, i64, p, i32, i32, p, p, p, p, p, i32, p, p]),
        ("sid_lynch_marginals_lanes_launch", [p, i64, p, i32, i32, p, p, p, i32, p]),
        ("sid_lynch_shards_per_launch", []),
        ("sid_lynch_shard_slot_bytes", []),
        ("sid_lynch_peer_pull_bytes", []),
        ("sid_lynch_shards_grid", [i64, p]),
        ("sid_lynch_nll_shards_launch", [p, i32, p, p, p, i64, p, p, i32, p, i32, p, i32, p, p]),
        ("sid_lynch_fit_lane_bytes", []),
        ("sid_lynch_fit_state_bytes", [i32]),
        ("sid_lynch_fit_unit_rows", []),
        ("sid_lynch_fit_timed_out", []),
        ("sid_lynch_fit_create", [i32, p, i64, p, i32, p, p, p, p, i64, p, p, p, p, p, p, p, p, p, i64, i64,
                                  ctypes.c_double, i32, i32, i64, p]),
        ("sid_lynch_fit_grid", [p]),
        ("sid_lynch_fit_run", [p, p, p, p]),
        ("sid_lynch_fit_enqueue", [p, p]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    lib.sid_lynch_launches.restype = ctypes.c_longlong
    lib.sid_lynch_launches.argtypes = [i32]
    lib.sid_lynch_fits.restype = ctypes.c_longlong
    lib.sid_lynch_fits.argtypes = []
    lib.sid_lynch_fit_destroy.restype = None
    lib.sid_lynch_fit_destroy.argtypes = [p]
    lib.sid_lynch_error_string.restype = ctypes.c_char_p
    lib.sid_lynch_error_string.argtypes = [i32]
    if lib.sid_lynch_chunk_rows() != likelihoods.CHUNK_ROWS:
        raise RuntimeError("csrc/lynch.cuh and ops/likelihoods.py disagree on the chunk size")
    if lib.sid_lynch_record_planes() != RECORD_PLANES:
        raise RuntimeError("csrc/lynch.cuh and ops/lynch_objective.py disagree on the record")
    if lib.sid_lynch_lane_slot_bytes() != LANE_SLOT.itemsize:
        raise RuntimeError("csrc/lynch.cuh and ops/lynch_objective.py disagree on the lane slot")
    if (lib.sid_lynch_shard_slot_bytes() != SHARD_SLOT.itemsize or lib.sid_lynch_peer_pull_bytes() != PEER_PULL.itemsize
            or lib.sid_lynch_shards_per_launch() != SHARDS_PER_LAUNCH):
        raise RuntimeError("csrc/lynch.cu and ops/lynch_objective.py disagree on the shard table")
    if lib.sid_lynch_fit_lane_bytes() != FIT_LANE.itemsize:
        raise RuntimeError("csrc/lynch.cuh and ops/lynch_objective.py disagree on the fit lane")
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_kernel_library(build.kernel_library("lynch"))
        return _lib


def blocks_per_sm(device) -> dict:
    """The blocks of each kernel resident on one SM of ``device`` (the
    occupancy API), by the names of ``KERNELS``."""
    lib = _kernel_lib()
    per_sm = ctypes.c_int(0)
    out = {}
    with torch.cuda.device(device):
        for k, name in enumerate(KERNELS):
            _raise_on(lib, lib.sid_lynch_blocks_per_sm(k, ctypes.byref(per_sm)), "Lynch occupancy")
            out[name] = per_sm.value
    return out


def kernel_launches() -> dict:
    """The kernel library's own launch counts since it was loaded, by
    kernel: {"records": n, "nll": n, "marginals": n, "nll_lanes": n,
    "marginals_lanes": n, "nll_shards": n, "fit_lanes": n}, and the fits
    run to their results as "fits"."""
    lib = _kernel_lib()
    out = {name: lib.sid_lynch_launches(k) for k, name in enumerate(KERNELS)}
    out["fits"] = lib.sid_lynch_fits()
    return out


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sid_lynch_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


class LynchWorkspace:
    """One fit's rows bound to their device, checked once.

    profiles (U, 4) int32 counts in 0..65535, mult (U,) int64 >= 0,
    lgamma_tab (T,) f64 (T > max coverage + 1), contiguous on one device.
    On a CUDA device the set-up kernel writes the row record once, the
    grids come from the occupancy API once, and the kernels launch on the
    stream that was current when the workspace was made. On the CPU each
    method runs the plain version.
    """

    def __init__(self, profiles: torch.Tensor, mult: torch.Tensor, lgamma_tab: torch.Tensor):
        _check(profiles, lgamma_tab, mult)
        device = profiles.device
        if device.type != "cpu":
            _cuda_checks(profiles, lgamma_tab, "Lynch")
        _check_values(profiles, mult)
        self.profiles, self.mult, self.lgamma_tab = profiles, mult, lgamma_tab
        self.u = u = profiles.shape[0]
        self.device = device
        # the last objective's [sum of the unflagged terms, flagged count] and flags
        self.out: Optional[torch.Tensor] = None
        self.flags: Optional[torch.Tensor] = None
        if device.type == "cpu":
            return
        lib = self._lib = _kernel_lib()
        n_chunks = -(-u // likelihoods.CHUNK_ROWS)
        with torch.cuda.device(device):
            self.stream = torch.cuda.current_stream(device)
            grids = (ctypes.c_int * 3)()
            _raise_on(lib, lib.sid_lynch_grids(u, grids), "Lynch grid")
            self.grids = tuple(grids)  # records, objective, marginals
            self.records = torch.empty((RECORD_PLANES, u), dtype=torch.float64, device=device)
            self.flags = torch.empty(u, dtype=torch.uint8, device=device)
            self.part_sum = torch.empty(max(n_chunks, 1), dtype=torch.float64, device=device)
            self.part_cnt = torch.empty(max(n_chunks, 1), dtype=torch.int32, device=device)
            self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
            self.out = torch.empty(2, dtype=torch.float64, device=device)
            self.host_out = torch.empty(2, dtype=torch.float64, pin_memory=True)
            self._host_view = self.host_out.numpy()
            self._scalars = np.zeros(16, np.float64)  # passed to the kernels by address
            self._nll_args = (
                self.records.data_ptr(), self._scalars.ctypes.data, u, self.flags.data_ptr(),
                self.part_sum.data_ptr(), self.part_cnt.data_ptr(), self.ticket.data_ptr(),
                self.out.data_ptr(),
            )
        self.write_records()

    def write_records(self) -> None:
        """Enqueue the set-up kernel that writes the row record (done once
        when the workspace is made)."""
        global RECORD_LAUNCHES
        with torch.cuda.device(self.device):
            err = self._lib.sid_lynch_records_launch(
                self.profiles.data_ptr(), self.mult.data_ptr(), self.lgamma_tab.data_ptr(),
                self.lgamma_tab.shape[0], self.u, self.records.data_ptr(), self.grids[0],
                self.stream.cuda_stream,
            )
        _raise_on(self._lib, err, "Lynch record")
        if self.u:
            RECORD_LAUNCHES += 1

    def bound_to(self, profiles, mult, lgamma_tab) -> bool:
        """Whether the workspace was made for these tensors."""
        return (
            profiles.device == self.device
            and profiles.shape == self.profiles.shape
            and profiles.data_ptr() == self.profiles.data_ptr()
            and mult.data_ptr() == self.mult.data_ptr()
            and lgamma_tab.data_ptr() == self.lgamma_tab.data_ptr()
        )

    def _launch_nll(self, scalars, grid: Optional[int], host_out) -> None:
        global NLL_LAUNCHES
        _check_scalars(scalars)
        if self.device.type == "cpu":
            self.out, self.flags = lynch_compound_nll_ref(self.profiles, self.mult, scalars, self.lgamma_tab)
            return
        self._scalars[:] = scalars
        same = torch.cuda.current_device() == self.device.index
        with contextlib.nullcontext() if same else torch.cuda.device(self.device):
            err = self._lib.sid_lynch_nll_launch(
                *self._nll_args, grid or self.grids[1], host_out, self.stream.cuda_stream)
        _raise_on(self._lib, err, "Lynch objective")
        NLL_LAUNCHES += 1

    def launch_nll(self, scalars, grid: Optional[int] = None) -> None:
        """Enqueue B2 at one theta and return at once: [sum of the unflagged
        terms, flagged count] lands in ``out`` and the rows' flags in
        ``flags``. ``grid`` sets the number of blocks (the result does not
        depend on it); by default the resident blocks."""
        self._launch_nll(scalars, grid, None)

    def nll(self, scalars) -> Tuple[float, float]:
        """B2 at one theta, waited for: (sum of the unflagged terms, flagged
        count); the rows' flags in ``flags``. On a card one ctypes call:
        the launch, an async copy into pinned memory, one stream sync."""
        if self.device.type == "cpu":
            self._launch_nll(scalars, None, None)
            total, n_flagged = self.out.tolist()
            return total, n_flagged
        self._launch_nll(scalars, None, self.host_out.data_ptr())
        return float(self._host_view[0]), float(self._host_view[1])

    def _marginals(self, scalars) -> torch.Tensor:
        """Launch B4 at one epsilon; its results in one (17 U,) uint8 device
        buffer (``_split``)."""
        global MARGINALS_LAUNCHES
        _check_scalars(scalars)
        u = self.u
        buf = torch.empty(17 * u, dtype=torch.uint8, device=self.device)
        lhom, lhet, flags = _split(buf, u)
        host = np.ascontiguousarray(scalars, np.float64)
        with torch.cuda.device(self.device):
            err = self._lib.sid_lynch_marginals_launch(
                self.records.data_ptr(), host.ctypes.data, u, lhom.data_ptr(), lhet.data_ptr(),
                flags.data_ptr(), self.grids[2], self.stream.cuda_stream,
            )
        _raise_on(self._lib, err, "Lynch marginals")
        if u:
            MARGINALS_LAUNCHES += 1
        return buf

    def marginals(self, scalars) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """B4 at one epsilon: (log L_hom, log L_het, uint8 flags), each (U,),
        on the workspace's device; the pi entries of ``scalars`` are not
        read."""
        if self.device.type == "cpu":
            _check_scalars(scalars)
            return lynch_marginals_ref(self.profiles, scalars, self.lgamma_tab)
        return _split(self._marginals(scalars), self.u)

    def marginals_host(self, scalars) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """B4 at one epsilon as host arrays (log L_hom, log L_het, uint8
        flags): on a card one copy of all three into pinned memory and one
        stream sync."""
        if self.device.type == "cpu":
            return tuple(t.numpy() for t in self.marginals(scalars))
        buf = self._marginals(scalars)
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        with torch.cuda.stream(self.stream):
            host.copy_(buf, non_blocking=True)
        self.stream.synchronize()
        return tuple(t.numpy() for t in _split(host, self.u))


def _split(buf: torch.Tensor, u: int):
    """(log L_hom, log L_het, flags) as views of a (17 U,) uint8 buffer."""
    return buf[: 8 * u].view(torch.float64), buf[8 * u : 16 * u].view(torch.float64), buf[16 * u :]


class LynchShardGroup:
    """The shards of a sharded fit that one device holds, for one launch of
    the sharded objective (csrc/lynch.cu ``lynch_nll_shards_kernel``) an
    evaluation.

    ``shards`` are (LynchWorkspace on ``device``, first global chunk) of
    each shard, in row order, each of at least one row and starting at a
    multiple of CHUNK_ROWS rows of the fit's histogram; ``n_chunks`` is the
    fit's chunk count C. An evaluation writes each chunk's sum and flagged
    count at its global index of ``part_sum`` (C,) f64 and ``part_cnt`` (C,)
    int32 and each shard's rows' flags into its workspace's ``flags``. With
    ``fold`` (the fold's device) it first copies in the chunk sums of
    ``peers``, the groups of the other devices, which are launched before
    it, and then folds all C chunk sums in B2's order into ``out``. On a
    CUDA device the shards' table is built once (each launch takes it as a
    kernel parameter), the grid comes from the occupancy API once, and the launch, with
    the peers' copies before it (each after the event its peer's call
    records), runs on the stream that was current when the group was made:
    one ctypes call an evaluation. On the CPU the plain versions run. At
    most SHARDS_PER_LAUNCH shards, on every device (ValueError).
    """

    def __init__(self, device, shards, n_chunks: int, fold: bool, peers=()):
        self.device = device = torch.device(device)
        if len(shards) > SHARDS_PER_LAUNCH:
            raise ValueError(f"at most {SHARDS_PER_LAUNCH} shards a launch group, not {len(shards)}")
        self.works = [w for w, _ in shards]
        self.n_chunks = n_chunks
        self.fold = fold
        self.peers = list(peers)
        if self.peers and not fold:
            raise ValueError("only the fold's group copies in other groups' chunk sums")
        self.chunks = [slice(int(c), int(c) - (-w.u // likelihoods.CHUNK_ROWS)) for w, c in shards]
        ends = [0] + [c.stop for c in self.chunks]
        for w, c, end in zip(self.works, self.chunks, ends):
            if w.device != device or w.u < 1 or c.start < end or c.stop > n_chunks:
                raise ValueError("shards must be non-empty, on the group's device, in row order inside the fit")
        # the group's chunks as runs of consecutive chunks (what the fold copies in)
        self.runs = []
        for c in self.chunks:
            if self.runs and self.runs[-1].stop == c.start:
                self.runs[-1] = slice(self.runs[-1].start, c.stop)
            else:
                self.runs.append(c)
        # the last evaluation's [sum of the unflagged terms, flagged count] (with fold)
        self.out: Optional[torch.Tensor] = None
        if device.type == "cpu":
            self.part_sum = torch.zeros(n_chunks, dtype=torch.float64)
            self.part_cnt = torch.zeros(n_chunks, dtype=torch.int32)
            return
        if device.type != "cuda":
            raise ValueError(f"no Lynch shards kernel for device {device}")
        lib = self._lib = _kernel_lib()
        if any(p.fold or p.device.type != "cuda" for p in self.peers):
            raise ValueError("the peers are the groups without the fold, on CUDA devices")
        self.table = table = np.zeros(max(len(shards), 1), SHARD_SLOT)
        for k, (w, c) in enumerate(zip(self.works, self.chunks)):
            table[k] = (w.records.data_ptr(), w.u, w.flags.data_ptr(), c.start, c.stop - c.start)
        table["walk_end"] = np.cumsum(table["walk_end"])
        with torch.cuda.device(device):
            self.stream = torch.cuda.current_stream(device)
            grid = ctypes.c_int(0)
            _raise_on(lib, lib.sid_lynch_shards_grid(int(table["walk_end"][-1]), ctypes.byref(grid)), "Lynch shards grid")
            self.grid = grid.value
            self.part_sum = torch.empty(max(n_chunks, 1), dtype=torch.float64, device=device)[:n_chunks]
            self.part_cnt = torch.empty(max(n_chunks, 1), dtype=torch.int32, device=device)[:n_chunks]
            ticket = out = done = None
            if fold:
                self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
                self.out = torch.empty(2, dtype=torch.float64, device=device)
                self.host_out = torch.empty(2, dtype=torch.float64, pin_memory=True)
                self._host_view = self.host_out.numpy()
                ticket, out = self.ticket.data_ptr(), self.out.data_ptr()
            else:
                # recorded by each launch's call, waited for by the fold's
                self.done = torch.cuda.Event()
                self.done.record(self.stream)
                done = self.done.cuda_event
        # the fold's copies of its peers' chunk sums and counts, by run
        self.pulls = np.zeros(max(2 * sum(len(p.runs) for p in self.peers), 1), PEER_PULL)
        k = 0
        for peer in self.peers:
            for r in peer.runs:
                for mine, theirs in ((self.part_sum, peer.part_sum), (self.part_cnt, peer.part_cnt)):
                    self.pulls[k] = (peer.done.cuda_event, mine[r].data_ptr(), theirs[r].data_ptr(),
                                     (r.stop - r.start) * mine.element_size(), peer.device.index)
                    k += 1
        self._scalars = np.zeros(16, np.float64)  # passed to the kernel by address
        self._args = (table.ctypes.data, len(shards), self._scalars.ctypes.data, self.part_sum.data_ptr(),
                      self.part_cnt.data_ptr(), n_chunks, ticket, out, int(fold), self.pulls.ctypes.data, k, done)

    def _launch(self, scalars, host_out) -> None:
        global NLL_SHARDS_LAUNCHES
        _check_scalars(scalars)
        if self.device.type == "cpu":
            for w, c in zip(self.works, self.chunks):
                self.part_sum[c], self.part_cnt[c], w.flags = lynch_nll_partials_ref(
                    w.profiles, w.mult, scalars, w.lgamma_tab)
            for peer in self.peers:
                for r in peer.runs:
                    self.part_sum[r], self.part_cnt[r] = peer.part_sum[r], peer.part_cnt[r]
            if self.fold:
                self.out = lynch_fold_ref(self.part_sum, self.part_cnt)
            return
        self._scalars[:] = scalars
        same = torch.cuda.current_device() == self.device.index
        with contextlib.nullcontext() if same else torch.cuda.device(self.device):
            err = self._lib.sid_lynch_nll_shards_launch(*self._args, self.grid, host_out, self.stream.cuda_stream)
        _raise_on(self._lib, err, "Lynch shards objective")
        NLL_SHARDS_LAUNCHES += 1

    def launch(self, scalars) -> None:
        """Enqueue the group's evaluation at one theta and return at once:
        the chunk sums land in ``part_sum``, ``part_cnt`` and, with fold,
        [sum of the unflagged terms, flagged count] in ``out``."""
        self._launch(scalars, None)

    def nll(self, scalars) -> Tuple[float, float]:
        """The fold's evaluation at one theta, waited for: (sum of the
        unflagged terms, flagged count) of the whole fit, the peers
        launched before. On a card one ctypes call: the peers' copies, the
        launch, an async copy into pinned memory, one stream sync."""
        if not self.fold:
            raise RuntimeError("only the fold's group returns the objective")
        if self.device.type == "cpu":
            self._launch(scalars, None)
            total, n_flagged = self.out.tolist()
            return total, n_flagged
        self._launch(scalars, self.host_out.data_ptr())
        return float(self._host_view[0]), float(self._host_view[1])


def lynch_compound_nll(
    profiles: torch.Tensor,
    mult: torch.Tensor,
    scalars: np.ndarray,
    lgamma_tab: torch.Tensor,
    work: Optional[LynchWorkspace] = None,
    grid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 at one theta: ((2,) f64 [sum of the unflagged terms, flagged
    count], (U,) uint8 flags) on the profiles' device.

    profiles (U, 4) int32 counts in 0..65535, mult (U,) int64 >= 0,
    lgamma_tab (T,) f64 (T > max coverage + 1), contiguous on one device;
    scalars from ``likelihoods.lynch_scalars``. On CUDA the results are
    views of ``work``, a workspace made for these tensors (made here when
    None), overwritten by its next evaluation; ``grid`` sets the number of
    blocks (the result does not depend on it).
    """
    _check(profiles, lgamma_tab, mult)
    _check_scalars(scalars)
    if work is not None and not work.bound_to(profiles, mult, lgamma_tab):
        raise ValueError("the workspace was made for other rows")
    if profiles.device.type == "cpu":
        _check_values(profiles, mult)
        return lynch_compound_nll_ref(profiles, mult, scalars, lgamma_tab)
    _cuda_checks(profiles, lgamma_tab, "Lynch objective")
    if work is None:
        work = LynchWorkspace(profiles, mult, lgamma_tab)
    work.launch_nll(scalars, grid)
    return work.out, work.flags


def lynch_marginals(
    profiles: torch.Tensor, scalars: np.ndarray, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4 at one epsilon: (log L_hom, log L_het, uint8 flags), each (U,), on
    the profiles' device; the pi entries of ``scalars`` are not read. On
    CUDA through a workspace made here (multiplicities 0: B4 reads none)."""
    mult = torch.zeros(profiles.shape[0], dtype=torch.int64, device=profiles.device)
    _check(profiles, lgamma_tab, mult)
    _check_scalars(scalars)
    if profiles.device.type == "cpu":
        _check_values(profiles, mult)
        return lynch_marginals_ref(profiles, scalars, lgamma_tab)
    _cuda_checks(profiles, lgamma_tab, "Lynch marginals")
    return LynchWorkspace(profiles, mult, lgamma_tab).marginals(scalars)


def _check_offsets(offsets: torch.Tensor, profiles: torch.Tensor) -> np.ndarray:
    """Lane row offsets: (S+1,) int64 on the profiles' device, 0 first, the
    row count last, non-decreasing, S >= 1. Returns them on the host."""
    if not isinstance(offsets, torch.Tensor) or offsets.dim() != 1 or offsets.shape[0] < 2:
        raise ValueError("offsets must be a (S+1,) tensor with S >= 1")
    if offsets.dtype != torch.int64:
        raise TypeError(f"offsets must be {torch.int64}, got {offsets.dtype}")
    if offsets.device != profiles.device:
        raise ValueError(f"offsets is on {offsets.device}, profiles on {profiles.device}")
    if not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous")
    if offsets.shape[0] > 2**31:
        raise ValueError("too many lanes for an int lane index")
    off = offsets.cpu().numpy()
    if off[0] != 0 or off[-1] != profiles.shape[0] or (np.diff(off) < 0).any():
        raise ValueError(f"offsets must rise from 0 to {profiles.shape[0]}")
    return off


def _check_lanes(lanes, n_lanes: int) -> list:
    lanes = [int(k) for k in lanes]
    if not lanes or lanes[0] < 0 or lanes[-1] >= n_lanes or any(a >= b for a, b in zip(lanes, lanes[1:])):
        raise ValueError(f"lanes must be distinct lanes of 0..{n_lanes - 1} in increasing order, got {lanes}")
    return lanes


def fill_lane_slots(slots: np.ndarray, offsets: np.ndarray, chunks: np.ndarray, scalars: np.ndarray,
                    lanes, per_launch: int) -> None:
    """The lane kernels' table of ``lanes`` (distinct lanes of the cohort in
    increasing order) into the first len(lanes) entries of ``slots``
    (``LANE_SLOT``): each lane's row of ``scalars`` (S, 16), its rows from
    the row ``offsets`` (S+1), and the end of its ``chunks`` (S,) in the
    walk of its launch; the lanes run in launches of ``per_launch``, each
    walk counting from 0."""
    lanes = np.asarray(lanes, np.int64)
    table = slots[: lanes.shape[0]]
    table["s"] = scalars[lanes]
    table["first_row"] = offsets[lanes]
    table["end_row"] = offsets[lanes + 1]
    walk = table["walk_end"]
    for first in range(0, lanes.shape[0], per_launch):
        np.cumsum(chunks[lanes[first : first + per_launch]], out=walk[first : first + per_launch])


class LynchLanesWorkspace:
    """A cohort's fits (lanes) bound to their device, checked once.

    profiles (N, 4) int32 counts in 0..65535 and mult (N,) int64 >= 0 hold
    the lanes' rows one after another; offsets (S+1,) int64 are the lanes'
    row offsets (lane l is rows offsets[l] .. offsets[l+1]-1, a lane may be
    empty); lgamma_tab (T,) f64 covers every lane; all contiguous on one
    device. On a CUDA device the set-up kernel writes one row record over
    all rows, the grids come from the occupancy API once, and the kernels
    launch on the stream that was current when the workspace was made; each
    launch takes a table of its lanes (``fill_lane_slots``) from pinned
    memory into the kernel library's constant bank, so the lane kernels of
    all workspaces on a device launch on one stream. On the CPU each method
    runs the plain version.
    """

    def __init__(self, profiles: torch.Tensor, mult: torch.Tensor, offsets: torch.Tensor,
                 lgamma_tab: torch.Tensor):
        _check(profiles, lgamma_tab, mult)
        device = profiles.device
        if device.type != "cpu":
            _cuda_checks(profiles, lgamma_tab, "Lynch lanes")
        self.offsets = _check_offsets(offsets, profiles)
        _check_values(profiles, mult)
        self.profiles, self.mult, self.lgamma_tab = profiles, mult, lgamma_tab
        self.n = n = profiles.shape[0]
        self.lanes = s = self.offsets.shape[0] - 1
        self.device = device
        # the rows' flags of the last objective (for the lanes it ran)
        self.flags: Optional[torch.Tensor] = None
        # the running lanes of the last objective's table, and whether the
        # marginals' table is filled (the kernel-only relaunches use them)
        self._nll_count: Optional[int] = None
        self._marginals_filled = False
        if device.type == "cpu":
            return
        self._key = next(_workspace_keys)
        lib = self._lib = _kernel_lib()
        self.per_launch = lib.sid_lynch_lanes_per_launch()
        # each lane's chunks in the objective's walk and in the marginals'
        rows = np.diff(self.offsets)
        self._chunks = likelihoods.lane_chunks(rows)
        self._marginals_chunks = likelihoods.lane_chunks(rows, lib.sid_lynch_marginals_chunk_rows())
        n_chunks = int(self._chunks.sum())
        with torch.cuda.device(device):
            self.stream = torch.cuda.current_stream(device)
            grids = (ctypes.c_int * 3)()
            _raise_on(lib, lib.sid_lynch_grids(n, grids), "Lynch grid")
            self.records_grid = grids[0]
            lane_grids = (ctypes.c_int * 2)()
            err = lib.sid_lynch_lanes_grids(n_chunks, int(self._marginals_chunks.sum()), lane_grids)
            _raise_on(lib, err, "Lynch lanes grid")
            self.grids = tuple(lane_grids)  # the lanes' objective, the lanes' marginals
            self.records = torch.empty((RECORD_PLANES, n), dtype=torch.float64, device=device)
            self.flags = torch.zeros(n, dtype=torch.uint8, device=device)
            # one entry a chunk of the longest walk, at most every lane's
            self.part_sum = torch.empty(n_chunks, dtype=torch.float64, device=device)
            self.part_cnt = torch.empty(n_chunks, dtype=torch.int32, device=device)
            self.ticket = torch.zeros(self.per_launch, dtype=torch.int32, device=device)
            self.out = torch.empty((s, 2), dtype=torch.float64, device=device)
            self.host_out = torch.empty((s, 2), dtype=torch.float64, pin_memory=True)
            self._host_view = self.host_out.numpy()
            # the pinned tables of the objective (the running lanes) and of
            # the marginals (every lane), each free again to be refilled
            # once its event has passed
            self.nll_table = torch.empty(s * LANE_SLOT.itemsize, dtype=torch.uint8, pin_memory=True)
            self.marginals_table = torch.empty(s * LANE_SLOT.itemsize, dtype=torch.uint8, pin_memory=True)
            self._nll_slots = self.nll_table.numpy().view(LANE_SLOT)
            self._marginals_slots = self.marginals_table.numpy().view(LANE_SLOT)
            self._read = {"nll": torch.cuda.Event(), "marginals": torch.cuda.Event()}
        self.write_records()

    def write_records(self) -> None:
        """Enqueue the set-up kernel that writes the row record over every
        lane's rows (done once when the workspace is made)."""
        global RECORD_LAUNCHES
        with torch.cuda.device(self.device):
            err = self._lib.sid_lynch_records_launch(
                self.profiles.data_ptr(), self.mult.data_ptr(), self.lgamma_tab.data_ptr(),
                self.lgamma_tab.shape[0], self.n, self.records.data_ptr(), self.records_grid,
                self.stream.cuda_stream,
            )
        _raise_on(self._lib, err, "Lynch record")
        if self.n:
            RECORD_LAUNCHES += 1

    def _check_scalars(self, scalars) -> np.ndarray:
        scalars = np.ascontiguousarray(scalars, np.float64)
        if scalars.shape != (self.lanes, 16):
            raise ValueError(f"scalars must be ({self.lanes}, 16): lynch_scalars per lane")
        return scalars

    def _bank_holds(self, kind: str) -> bool:
        """Whether the constant bank holds ``kind``'s table of this
        workspace (as one launch's worth)."""
        return _bank.get((id(self._lib), self.device.index)) == (self._key, kind)

    def _banked(self, kind: str, count: int) -> None:
        """Record that ``kind``'s table of ``count`` lanes was launched:
        the bank holds it if it took one launch."""
        _bank[(id(self._lib), self.device.index)] = (self._key, kind) if count <= self.per_launch else None

    def _launch_nll(self, count: int, upload: int, grid: Optional[int], host_out) -> None:
        global NLL_LANES_LAUNCHES
        same = torch.cuda.current_device() == self.device.index
        with contextlib.nullcontext() if same else torch.cuda.device(self.device):
            err = self._lib.sid_lynch_nll_lanes_launch(
                self.records.data_ptr(), self.n, self.nll_table.data_ptr(), count, upload,
                self.flags.data_ptr(), self.part_sum.data_ptr(), self.part_cnt.data_ptr(),
                self.ticket.data_ptr(), self.out.data_ptr(), grid or self.grids[0], host_out,
                self.stream.cuda_stream,
            )
            self._read["nll"].record(self.stream)
        _raise_on(self._lib, err, "Lynch lanes objective")
        self._banked("nll", count)
        NLL_LANES_LAUNCHES += -(-count // self.per_launch)

    def nll_lanes(self, scalars, lanes, grid: Optional[int] = None) -> np.ndarray:
        """The objective of ``lanes`` (distinct, increasing), each at its
        own row of ``scalars`` (S, 16), waited for: a (len(lanes), 2) f64
        array of [sum of the unflagged terms, flagged count], each lane's
        bitwise B2 over its rows alone; the lanes' rows' flags in
        ``flags``. ``grid`` sets the number of blocks (the results do not
        depend on it); by default the resident blocks."""
        return self.enqueue_nll_lanes(scalars, lanes, grid)()

    def enqueue_nll_lanes(self, scalars, lanes, grid: Optional[int] = None):
        """``nll_lanes`` in two halves, so that several workspaces (a
        cohort over a mesh) run at once: enqueue the round and return a
        callable that waits for it and returns the (len(lanes), 2) array.
        On a card one ctypes call enqueues the lanes' table into the
        constant bank, the launch (one for each ``per_launch`` lanes) and
        the copy of the results into pinned memory; the callable syncs the
        stream. On the CPU the plain version, run here."""
        scalars = self._check_scalars(scalars)
        lanes = _check_lanes(lanes, self.lanes)
        if self.device.type == "cpu":
            out, self.flags = lynch_compound_nll_lanes_ref(
                self.profiles, self.mult, self.offsets, scalars, self.lgamma_tab, lanes)
            host = out.numpy()
            return lambda: host
        a = len(lanes)
        self._fill_nll(scalars, lanes)
        self._launch_nll(a, 1, grid, self.host_out.data_ptr())

        def wait():
            self.stream.synchronize()
            return self._host_view[:a].copy()

        return wait

    def _fill_nll(self, scalars: np.ndarray, lanes: list) -> None:
        """The objective's table of ``lanes`` into its pinned buffer, once
        the last launch has read it."""
        self._read["nll"].synchronize()
        fill_lane_slots(self._nll_slots, self.offsets, self._chunks, scalars, lanes, self.per_launch)
        self._nll_count = len(lanes)

    def launch_nll_lanes(self, grid: Optional[int] = None) -> None:
        """Enqueue the lanes' objective again on the table of the last
        ``nll_lanes`` call (copied into the constant bank again only if
        another table went there since) and return at once, with no copy
        of results: the kernel alone, for timing it."""
        if self._nll_count is None:
            raise RuntimeError("launch_nll_lanes needs an nll_lanes call first")
        self._launch_nll(self._nll_count, int(not self._bank_holds("nll")), grid, None)

    def _marginals(self, scalars: Optional[np.ndarray]) -> torch.Tensor:
        """Launch the lanes' marginals at ``scalars``, or None: on the
        table of the last call; the results in one (17 N,) uint8 device
        buffer (``_split``)."""
        global MARGINALS_LANES_LAUNCHES
        n, s = self.n, self.lanes
        buf = torch.empty(17 * n, dtype=torch.uint8, device=self.device)
        lhom, lhet, flags = _split(buf, n)
        if scalars is not None:
            self._read["marginals"].synchronize()
            fill_lane_slots(self._marginals_slots, self.offsets, self._marginals_chunks, scalars, range(s),
                            self.per_launch)
            self._marginals_filled = True
        upload = int(scalars is not None or not self._bank_holds("marginals"))
        with torch.cuda.device(self.device):
            err = self._lib.sid_lynch_marginals_lanes_launch(
                self.records.data_ptr(), n, self.marginals_table.data_ptr(), s, upload, lhom.data_ptr(),
                lhet.data_ptr(), flags.data_ptr(), self.grids[1], self.stream.cuda_stream,
            )
            self._read["marginals"].record(self.stream)
        _raise_on(self._lib, err, "Lynch lanes marginals")
        if n:
            self._banked("marginals", s)
            MARGINALS_LANES_LAUNCHES += -(-s // self.per_launch)
        return buf

    def launch_marginals_lanes(self) -> None:
        """Enqueue the lanes' marginals again on the table of the last
        call and return at once, with no copy of results: the kernel
        alone, for timing it."""
        if not self._marginals_filled:
            raise RuntimeError("launch_marginals_lanes needs a marginals_lanes call first")
        self._marginals(None)

    def marginals_lanes(self, scalars) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """B4 over every lane's rows at its row of ``scalars`` (S, 16), one
        launch: (log L_hom, log L_het, uint8 flags), each (N,), on the
        workspace's device; the pi entries are not read."""
        scalars = self._check_scalars(scalars)
        if self.device.type == "cpu":
            return lynch_marginals_lanes_ref(self.profiles, self.offsets, scalars, self.lgamma_tab)
        return _split(self._marginals(scalars), self.n)

    def marginals_lanes_host(self, scalars) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``marginals_lanes`` as host arrays: on a card one copy of all
        three into pinned memory and one stream sync."""
        scalars = self._check_scalars(scalars)
        if self.device.type == "cpu":
            return tuple(t.numpy() for t in self.marginals_lanes(scalars))
        buf = self._marginals(scalars)
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        with torch.cuda.stream(self.stream):
            host.copy_(buf, non_blocking=True)
        self.stream.synchronize()
        return tuple(t.numpy() for t in _split(host, self.n))


# ---- the fit's loop on the card (B3) ----


def clamp_total(total: float) -> float:
    """An objective's sum clamped to +-DBL_MAX (NaN stays), as sid_tpu
    clamps it; the objective's value is its negation."""
    if total > likelihoods.DBL_MAX:
        return likelihoods.DBL_MAX
    if total < -likelihoods.DBL_MAX:
        return -likelihoods.DBL_MAX
    return total


def fit_lane_table(offsets: np.ndarray, unit_rows: int) -> np.ndarray:
    """The lanes' FIT_LANE table of a fit over lanes of rows offsets[l] ..
    offsets[l+1]-1: the running totals of their chunks and of their units
    of ``unit_rows`` rows (csrc/lynch.cuh lane_chunks, FitLane)."""
    sizes = np.diff(np.asarray(offsets, np.int64))
    table = np.zeros(sizes.shape[0], FIT_LANE)
    table["first_row"], table["end_row"] = offsets[:-1], offsets[1:]
    table["walk_end"] = np.cumsum(likelihoods.lane_chunks(sizes))
    table["unit_end"] = np.cumsum(likelihoods.lane_chunks(sizes, unit_rows))
    return table


def history_entries(dims: int, max_iterations: int) -> int:
    """The most evaluations a lane of nmsimplex2 in ``dims`` dimensions
    makes: P = dims + 1 for the start, at most P + 1 an iteration
    (reflection, expansion or contraction, the other corners shrunk)."""
    return max_iterations * (dims + 2) + dims + 1


@dataclasses.dataclass
class FitLanes:
    """A fit's loop over S lanes in N dimensions, per lane: the best corner
    ``x`` (S, N), ``fval``, ``converged``, ``iterations`` (of a lane that
    ended; a handed-over lane's are unset), ``evaluations`` (its history
    entries) and ``status`` (FIT_DONE or FIT_HANDOVER); ``rounds``, the
    most evaluations of a lane."""
    x: np.ndarray
    fval: np.ndarray
    converged: np.ndarray
    iterations: np.ndarray
    evaluations: np.ndarray
    status: np.ndarray
    rounds: int

    @classmethod
    def from_rows(cls, rows: np.ndarray, dims: int, rounds: Optional[int] = None) -> "FitLanes":
        """From the kernel's (S, N + 5) result rows (csrc/lynch.cuh
        fit_result); ``rounds`` by default the most evaluations of a lane."""
        evaluations = rows[:, dims + 3].astype(np.int64)
        return cls(rows[:, :dims].copy(), rows[:, dims].copy(), rows[:, dims + 1] != 0,
                   rows[:, dims + 2].astype(np.int64), evaluations, rows[:, dims + 4].astype(np.int64),
                   int(evaluations.max()) if rounds is None else int(rounds))

    def result(self, lane: int) -> nmsimplex.MinimizeResult:
        """The minimizer's result of a lane that ended on the card."""
        if self.status[lane] != FIT_DONE:
            raise ValueError(f"lane {lane} was handed over, it has no result of the card's loop")
        return nmsimplex.MinimizeResult(x=self.x[lane].copy(), fval=float(self.fval[lane]),
                                        converged=bool(self.converged[lane]), iterations=int(self.iterations[lane]))


def lynch_fit_lanes_ref(
    profiles: torch.Tensor, mult: torch.Tensor, offsets: np.ndarray, scalars: np.ndarray, lgamma_tab: torch.Tensor,
    starts: np.ndarray, tol: float = nmsimplex.TOL, max_iterations: int = nmsimplex.MAX_ITERATIONS,
) -> Tuple[FitLanes, np.ndarray, torch.Tensor]:
    """Plain version of a fit's loop on the card: each lane's host loop
    (``exact.nmsimplex``) in lockstep, every running lane's point in the
    box evaluated each round by ``lynch_compound_nll_lanes_ref`` at the
    scalars ``likelihoods.theta_scalars`` gives and the lane's eleven fixed
    ones (``scalars`` (S, 16)), one outside DBL_MAX; each lane's value
    -clamp(sum, +-DBL_MAX) while it flags no rows; the evaluation that
    flags rows ends the lane there (a handover). ``starts`` (S, 2 N + 1):
    each lane's x0, step and, for N = 1, the epsilon it holds. Returns
    (the lanes' ``FitLanes``, their (S, H, N + 2) histories of (point,
    value or flagged evaluation's sum, flagged rows), the (rows,) uint8
    flags of each lane's last evaluation in the box)."""
    starts = np.asarray(starts, np.float64)
    n_lanes = starts.shape[0]
    dims = (starts.shape[1] - 1) // 2
    scal = np.array(scalars, np.float64, copy=True)
    runs = {k: nmsimplex._minimize(starts[k, :dims], starts[k, dims : 2 * dims], tol, max_iterations)
            for k in range(n_lanes)}
    pending = {k: next(run) for k, run in runs.items()}
    history = np.zeros((n_lanes, history_entries(dims, max_iterations), dims + 2))
    rows = np.zeros((n_lanes, dims + 5))
    flags = torch.zeros(profiles.shape[0], dtype=torch.uint8, device=profiles.device)
    while pending:
        lanes = sorted(pending)
        thetas = {k: (float(pending[k][0]), float(pending[k][dims - 1]) if dims == 2 else float(starts[k, 2]))
                  for k in lanes}
        inside = [k for k in lanes if 0.0 <= thetas[k][0] <= 1.0 and 0.0 <= thetas[k][1] <= 1.0]
        sums = {}
        if inside:
            for k in inside:
                scal[k, :5] = likelihoods.theta_scalars(*thetas[k])
            out, fl = lynch_compound_nll_lanes_ref(profiles, mult, offsets, scal, lgamma_tab, inside)
            for k, (total, n_flagged) in zip(inside, out.tolist()):
                r = slice(int(offsets[k]), int(offsets[k + 1]))
                flags[r] = fl[r]
                sums[k] = (total, n_flagged)
        for k in lanes:
            e = int(rows[k, dims + 3])
            history[k, e, :dims] = pending[k]
            rows[k, dims + 3] = e + 1
            total, n_flagged = sums.get(k, (None, 0))
            if n_flagged:
                history[k, e, dims:] = total, n_flagged
                rows[k, dims + 4] = FIT_HANDOVER
                del pending[k]
                continue
            value = likelihoods.DBL_MAX if total is None else -clamp_total(total)
            history[k, e, dims] = value
            try:
                pending[k] = runs[k].send(value)
            except StopIteration as done:
                res = done.value
                rows[k, :dims] = res.x
                rows[k, dims : dims + 3] = res.fval, res.converged, res.iterations
                rows[k, dims + 4] = FIT_DONE
                del pending[k]
    return FitLanes.from_rows(rows, dims), history, flags


class LynchFitWorkspace:
    """Fits on the card: S lanes of nmsimplex2 over the rows of ``work``, a
    ``LynchWorkspace`` (one lane, all its rows) or a ``LynchLanesWorkspace``
    (its lanes), each lane from its row of ``starts`` (S, 2 N + 1: x0 (N),
    step (N), and for N = 1 the epsilon its pi fit holds) with the eleven
    scalars of its base composition (``nts`` (S, 4)), tolerance ``tol`` and
    ``max_iterations``.

    On a CUDA device the workspace uploads the lanes' table, starts and
    fixed scalars once, allocates the lanes' state, histories, results, the
    rows' terms, tickets and generations, and plans the fit's launch
    (csrc/lynch.cu ``sid_lynch_fit_create``: its grid, every block resident)
    on ``work``'s device; ``run`` launches it on ``work``'s stream, copies
    the lanes' results into pinned memory and syncs once, and raises if a
    block's wait for a lane timed out (after ``wait_ns``). The rows' flags
    land in ``work.flags`` as B2's do (a handed-over lane's: those of its
    flagged evaluation). On the CPU ``run`` is the plain version,
    ``lynch_fit_lanes_ref``. A fit on the card uses numpy's dot rounding
    (``exact.nmsimplex.dot_mode``), so its points are the host loop's.
    """

    def __init__(self, work, starts, nts, tol: float = nmsimplex.TOL,
                 max_iterations: int = nmsimplex.MAX_ITERATIONS, wait_ns: int = FIT_WAIT_NS):
        self.work = work
        self.starts = np.ascontiguousarray(starts, np.float64)
        if self.starts.ndim != 2 or self.starts.shape[1] not in (3, 5):
            raise ValueError("starts must be (S, 2 N + 1) for N = 1 or 2")
        self.dims = dims = (self.starts.shape[1] - 1) // 2
        self.lanes = s = self.starts.shape[0]
        self.offsets = work.offsets if isinstance(work, LynchLanesWorkspace) else np.array([0, work.u], np.int64)
        if self.offsets.shape[0] - 1 != s:
            raise ValueError(f"{s} starts for {self.offsets.shape[0] - 1} lanes")
        nts = np.asarray(nts, np.float64).reshape(s, 4)
        self.scalars = np.stack([likelihoods.lynch_scalars(0.0, 0.0, nt) for nt in nts])
        self.tol, self.max_iterations = float(tol), int(max_iterations)
        self.entries = history_entries(dims, self.max_iterations)
        self.device = device = work.device
        self._plan = None
        self._history_ref: Optional[np.ndarray] = None
        self.last: Optional[FitLanes] = None  # the last run's
        if device.type == "cpu":
            return
        lib = self._lib = _kernel_lib()
        if lib.sid_lynch_fit_state_bytes(dims) <= 0:
            raise RuntimeError(f"no fit state for {dims} dimensions")
        table = fit_lane_table(self.offsets, lib.sid_lynch_fit_unit_rows())
        n_chunks, n_units = int(table["walk_end"][-1]), int(table["unit_end"][-1])
        if work.part_sum.shape[0] < n_chunks:
            raise ValueError("the workspace's chunk sums do not cover the lanes' walk")
        n = work.records.shape[1]
        with torch.cuda.device(device):
            self.stream = work.stream
            up = dict(device=device, non_blocking=False)
            self._table = torch.from_numpy(table.view(np.uint8)).to(**up)
            self._starts = torch.from_numpy(self.starts).to(**up)
            self._scalars = torch.from_numpy(self.scalars).to(**up)
            self._state = torch.zeros(s * lib.sid_lynch_fit_state_bytes(dims), dtype=torch.uint8, device=device)
            self.history_dev = torch.zeros((s, self.entries, dims + 2), dtype=torch.float64, device=device)
            self._terms = torch.empty(max(n, 1), dtype=torch.float64, device=device)
            self._chunk_ticket = torch.zeros(n_chunks, dtype=torch.int32, device=device)
            self._lane_ticket = torch.zeros(s, dtype=torch.int32, device=device)
            self._gen = torch.zeros(s, dtype=torch.int64, device=device)
            self._results = torch.zeros((s, dims + 5), dtype=torch.float64, device=device)
            self._counters = torch.zeros(2, dtype=torch.int64, device=device)
            self._results_host = torch.empty((s, dims + 5), dtype=torch.float64, pin_memory=True)
            self._counters_host = torch.empty(2, dtype=torch.int64, pin_memory=True)
            plan = ctypes.c_void_p()
            err = lib.sid_lynch_fit_create(
                dims, work.records.data_ptr(), n, self._table.data_ptr(), s, self._starts.data_ptr(),
                self._state.data_ptr(), self._scalars.data_ptr(), self.history_dev.data_ptr(), self.entries,
                work.flags.data_ptr(), self._terms.data_ptr(), work.part_sum.data_ptr(), work.part_cnt.data_ptr(),
                self._chunk_ticket.data_ptr(), self._lane_ticket.data_ptr(), self._gen.data_ptr(),
                self._results.data_ptr(), self._counters.data_ptr(), n_units, n_chunks, self.tol,
                self.max_iterations, nmsimplex.dot_mode(), int(wait_ns), ctypes.byref(plan))
            _raise_on(lib, err, "Lynch fit plan")
            self._plan = plan.value
            self.grid = lib.sid_lynch_fit_grid(self._plan)

    def __del__(self):
        if getattr(self, "_plan", None):
            self._lib.sid_lynch_fit_destroy(self._plan)
            self._plan = None

    def run(self) -> FitLanes:
        """Every lane's fit from its start: on a card one launch, one copy
        of the results, one stream sync; on the CPU the plain version."""
        global FIT_LAUNCHES, FIT_LANES_LAUNCHES, FIT_ROUNDS, FIT_HANDOVERS
        w = self.work
        if self.device.type == "cpu":
            out, self._history_ref, flags = lynch_fit_lanes_ref(
                w.profiles, w.mult, self.offsets, self.scalars, w.lgamma_tab, self.starts, self.tol,
                self.max_iterations)
            w.flags = flags
        else:
            with torch.cuda.device(self.device):
                err = self._lib.sid_lynch_fit_run(self._plan, self._results_host.data_ptr(),
                                                  self._counters_host.data_ptr(), self.stream.cuda_stream)
            if err in (0, self._lib.sid_lynch_fit_timed_out()):
                FIT_LANES_LAUNCHES += 1  # the kernel ran (to its end, or to a timed-out wait)
            _raise_on(self._lib, err, "Lynch fit")
            out = FitLanes.from_rows(self._results_host.numpy(), self.dims)
            FIT_LAUNCHES += 1
            FIT_ROUNDS += out.rounds
        FIT_HANDOVERS += int((out.status == FIT_HANDOVER).sum())
        self.last = out
        return out

    def launch(self) -> None:
        """Launch the fit again and return at once, with no copy of
        results: the loop on the card alone, for timing it."""
        global FIT_LANES_LAUNCHES
        with torch.cuda.device(self.device):
            err = self._lib.sid_lynch_fit_enqueue(self._plan, self.stream.cuda_stream)
        _raise_on(self._lib, err, "Lynch fit")
        FIT_LANES_LAUNCHES += 1

    def history(self, lanes: Sequence[int]):
        """The histories of ``lanes`` in the last ``run``, each as (points
        (E, N), values (E,), flagged rows (E,)) of its E evaluations there;
        copied from the card in one copy."""
        lanes = [int(k) for k in lanes]
        if not lanes:
            return []
        evaluations = self.last.evaluations[lanes]
        top = int(evaluations.max())
        if self.device.type == "cpu":
            rows = self._history_ref[lanes, :top]
        else:
            rows = self.history_dev[torch.as_tensor(lanes, device=self.device), :top].cpu().numpy()
        d = self.dims
        return [(h[:e, :d].copy(), h[:e, d].copy(), h[:e, d + 1].astype(np.int64))
                for h, e in zip(rows, (int(e) for e in evaluations))]
