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

``RECORD_LAUNCHES``, ``NLL_LAUNCHES``, ``MARGINALS_LAUNCHES``,
``NLL_LANES_LAUNCHES`` and ``MARGINALS_LANES_LAUNCHES`` count kernel
launches (not plain-version calls), so a run can show that it went through
the kernels; the kernel library keeps its own count (``kernel_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from sid_tpu_torch.native import build
from sid_tpu_torch.ops import likelihoods

RECORD_LAUNCHES = 0
NLL_LAUNCHES = 0
MARGINALS_LAUNCHES = 0
NLL_LANES_LAUNCHES = 0
MARGINALS_LANES_LAUNCHES = 0

# counts arrive as uint16; the record packs them so
MAX_COUNT = 65535
# the record: m, the signed multiplicity, the packed counts (csrc/lynch.cuh)
RECORD_PLANES = 3
# the kernel library's launch counters (csrc/lynch.cu)
KERNELS = ("records", "nll", "marginals", "nll_lanes", "marginals_lanes")
# one running lane of a launch of a lane kernel (csrc/lynch.cuh LaneSlot):
# its scalars, its rows, the end of its chunks in the launch's walk
LANE_SLOT = np.dtype([("s", "<f8", (16,)), ("first_row", "<i8"), ("end_row", "<i8"), ("walk_end", "<i8")])

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
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    lib.sid_lynch_launches.restype = ctypes.c_longlong
    lib.sid_lynch_launches.argtypes = [i32]
    lib.sid_lynch_error_string.restype = ctypes.c_char_p
    lib.sid_lynch_error_string.argtypes = [i32]
    if lib.sid_lynch_chunk_rows() != likelihoods.CHUNK_ROWS:
        raise RuntimeError("csrc/lynch.cuh and ops/likelihoods.py disagree on the chunk size")
    if lib.sid_lynch_record_planes() != RECORD_PLANES:
        raise RuntimeError("csrc/lynch.cuh and ops/lynch_objective.py disagree on the record")
    if lib.sid_lynch_lane_slot_bytes() != LANE_SLOT.itemsize:
        raise RuntimeError("csrc/lynch.cuh and ops/lynch_objective.py disagree on the lane slot")
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
    "marginals_lanes": n}."""
    lib = _kernel_lib()
    return {name: lib.sid_lynch_launches(k) for k, name in enumerate(KERNELS)}


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
        ``flags``. On a card one ctypes call: the lanes' table into the
        constant bank, one launch (one for each ``per_launch`` lanes), the
        copy of the results into pinned memory, one stream sync. ``grid``
        sets the number of blocks (the results do not depend on it); by
        default the resident blocks."""
        scalars = self._check_scalars(scalars)
        lanes = _check_lanes(lanes, self.lanes)
        if self.device.type == "cpu":
            out, self.flags = lynch_compound_nll_lanes_ref(
                self.profiles, self.mult, self.offsets, scalars, self.lgamma_tab, lanes)
            return out.numpy()
        a = len(lanes)
        self._read["nll"].synchronize()
        fill_lane_slots(self._nll_slots, self.offsets, self._chunks, scalars, lanes, self.per_launch)
        self._launch_nll(a, 1, grid, self.host_out.data_ptr())
        self._nll_count = a
        return self._host_view[:a].copy()

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
