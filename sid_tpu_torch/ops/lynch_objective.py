"""The Lynch fit's device kernels: the compound objective (B2) and the
marginals at the fitted error rate (B4).

For CUDA tensors ``lynch_compound_nll`` and ``lynch_marginals`` launch the
hand-written Hopper kernels of ``csrc/lynch.cu`` (the counterparts of
sid_tpu's XLA programs ``ops/likelihoods.py::compound_neg_log_likelihood`` and
``log_{hom,het}_marginal``), built with nvcc at first use; for CPU tensors
they run the plain torch f64 versions ``*_ref``. Any other device, dtype,
shape or layout raises; so does a failed build or launch.

Both apply the long-double range screen (csrc/lynch.cuh): the objective
leaves the rows it flags out of its sum and counts them, the marginals flag
theirs; the caller evaluates the flagged rows in host long double
(``models/lynch.py``). The theta-dependent scalars come from
``ops.likelihoods.lynch_scalars``.

``NLL_LAUNCHES`` and ``MARGINALS_LAUNCHES`` count kernel launches (not
plain-version calls), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from sid_tpu_torch.native import build
from sid_tpu_torch.ops import likelihoods

NLL_LAUNCHES = 0
MARGINALS_LAUNCHES = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class NllWorkspace:
    """The objective's device buffers for U profiles, allocated once per
    fit: per-row flags, per-chunk partial sums and counts, and the (2,)
    result [sum of unflagged terms, flagged count]."""

    def __init__(self, u: int, device):
        n_chunks = -(-u // likelihoods.CHUNK_ROWS)
        self.u = u
        self.flags = torch.empty(u, dtype=torch.uint8, device=device)
        self.part_sum = torch.empty(max(n_chunks, 1), dtype=torch.float64, device=device)
        self.part_cnt = torch.empty(max(n_chunks, 1), dtype=torch.int32, device=device)
        self.out = torch.empty(2, dtype=torch.float64, device=device)


def lynch_compound_nll_ref(
    profiles: torch.Tensor, mult: torch.Tensor, scalars: np.ndarray, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch f64 version of B2: ([sum of the unflagged terms, flagged
    count] as a (2,) f64 tensor, (U,) uint8 flags)."""
    rows = likelihoods.lynch_rows(profiles, scalars, lgamma_tab)
    flags = rows.flag_mixture
    terms = torch.where(flags, 0.0, likelihoods.lynch_terms(rows.log_mix, mult))
    total = likelihoods.fixed_order_sum(terms)
    out = torch.stack([total, flags.sum().to(torch.float64)])
    return out, flags.to(torch.uint8)


def lynch_marginals_ref(
    profiles: torch.Tensor, scalars: np.ndarray, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch f64 version of B4: (log L_hom, log L_het, uint8 flags)."""
    rows = likelihoods.lynch_rows(profiles, scalars, lgamma_tab)
    return rows.lhom, rows.lhet, rows.flag_marginals.to(torch.uint8)


def _check(profiles, lgamma_tab, scalars, mult=None) -> None:
    if profiles.dim() != 2 or profiles.shape[1] != 4:
        raise ValueError(f"profiles must be (U, 4), got {tuple(profiles.shape)}")
    if lgamma_tab.dim() != 1:
        raise ValueError("lgamma_tab must be 1-D")
    if np.shape(scalars) != (16,):
        raise ValueError("scalars must be the 16 values of lynch_scalars")
    checks = [("profiles", profiles, torch.int32), ("lgamma_tab", lgamma_tab, torch.float64)]
    if mult is not None:
        if mult.shape != (profiles.shape[0],):
            raise ValueError(f"mult must be ({profiles.shape[0]},), got {tuple(mult.shape)}")
        checks.append(("mult", mult, torch.int64))
    for name, t, dtype in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != profiles.device:
            raise ValueError(f"{name} is on {t.device}, profiles on {profiles.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _cuda_checks(profiles, lgamma_tab, what: str) -> None:
    if profiles.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {profiles.device}")
    if profiles.data_ptr() % 16:
        raise ValueError("profiles must be 16-byte aligned (one int4 load per row)")
    if lgamma_tab.shape[0] >= 2**31:
        raise ValueError("lgamma_tab is too long for an int index")


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build.kernel_library("lynch"))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.sid_lynch_chunk_rows.restype = ctypes.c_int
            lib.sid_lynch_chunk_rows.argtypes = []
            lib.sid_lynch_nll_launch.restype = ctypes.c_int
            lib.sid_lynch_nll_launch.argtypes = [
                p, p, p, p, ctypes.c_int, i64, p, p, p, p, ctypes.c_int, p,
            ]
            lib.sid_lynch_marginals_launch.restype = ctypes.c_int
            lib.sid_lynch_marginals_launch.argtypes = [
                p, p, p, ctypes.c_int, i64, p, p, p, p,
            ]
            lib.sid_lynch_error_string.restype = ctypes.c_char_p
            lib.sid_lynch_error_string.argtypes = [ctypes.c_int]
            if lib.sid_lynch_chunk_rows() != likelihoods.CHUNK_ROWS:
                raise RuntimeError("csrc/lynch.cuh and ops/likelihoods.py disagree on the chunk size")
            _lib = lib
        return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sid_lynch_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def lynch_compound_nll(
    profiles: torch.Tensor,
    mult: torch.Tensor,
    scalars: np.ndarray,
    lgamma_tab: torch.Tensor,
    work: Optional[NllWorkspace] = None,
    grid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 at one theta: ((2,) f64 [sum of the unflagged terms, flagged
    count], (U,) uint8 flags) on the profiles' device.

    profiles (U, 4) int32, mult (U,) int64, lgamma_tab (T,) f64 (T > max
    coverage + 1), contiguous on one device; scalars from
    ``likelihoods.lynch_scalars``. On CUDA the results are views of
    ``work`` (allocated here when None), overwritten by the next call with
    the same workspace; ``grid`` sets the number of blocks (the result does
    not depend on it).
    """
    global NLL_LAUNCHES
    _check(profiles, lgamma_tab, scalars, mult)
    if profiles.device.type == "cpu":
        return lynch_compound_nll_ref(profiles, mult, scalars, lgamma_tab)
    _cuda_checks(profiles, lgamma_tab, "Lynch objective")
    u = profiles.shape[0]
    if work is None:
        work = NllWorkspace(u, profiles.device)
    elif work.u != u or work.flags.device != profiles.device:
        raise ValueError("the workspace was made for other profiles")
    host = np.ascontiguousarray(scalars, np.float64)
    lib = _kernel_lib()
    with torch.cuda.device(profiles.device):
        stream = torch.cuda.current_stream(profiles.device).cuda_stream
        err = lib.sid_lynch_nll_launch(
            profiles.data_ptr(), mult.data_ptr(), host.ctypes.data, lgamma_tab.data_ptr(),
            lgamma_tab.shape[0], u, work.flags.data_ptr(), work.part_sum.data_ptr(),
            work.part_cnt.data_ptr(), work.out.data_ptr(), int(grid or 0), stream,
        )
    _raise_on(lib, err, "Lynch objective")
    NLL_LAUNCHES += 1
    return work.out, work.flags


def lynch_marginals(
    profiles: torch.Tensor, scalars: np.ndarray, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4 at one epsilon: (log L_hom, log L_het, uint8 flags), each (U,), on
    the profiles' device; the pi entries of ``scalars`` are not read."""
    global MARGINALS_LAUNCHES
    _check(profiles, lgamma_tab, scalars)
    if profiles.device.type == "cpu":
        return lynch_marginals_ref(profiles, scalars, lgamma_tab)
    _cuda_checks(profiles, lgamma_tab, "Lynch marginals")
    u = profiles.shape[0]
    device = profiles.device
    lhom = torch.empty(u, dtype=torch.float64, device=device)
    lhet = torch.empty(u, dtype=torch.float64, device=device)
    flags = torch.empty(u, dtype=torch.uint8, device=device)
    if u == 0:
        return lhom, lhet, flags
    host = np.ascontiguousarray(scalars, np.float64)
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sid_lynch_marginals_launch(
            profiles.data_ptr(), host.ctypes.data, lgamma_tab.data_ptr(),
            lgamma_tab.shape[0], u, lhom.data_ptr(), lhet.data_ptr(),
            flags.data_ptr(), stream,
        )
    _raise_on(lib, err, "Lynch marginals")
    MARGINALS_LAUNCHES += 1
    return lhom, lhet, flags
