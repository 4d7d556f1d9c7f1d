"""The quality finalize's het side: per site, the allele-balance binomial
ln C(n, k) - n ln 2 added to the per-read het sum, the 80-bit underflow
clamp and the prior's log (call.cpp:344-369).

``quality_finalize`` takes (N, 4) uint16 counts, (N,) uint8 alleles (major
in bits 0-1, second in bits 2-3: ``pack_alleles``) and (N,) f64 het sums
and returns lpp2, (N,) f64. For CUDA tensors it launches the hand-written
Hopper kernel in ``csrc/quality_finalize.cu`` (the counterpart of sid_tpu's
XLA program ``models/quality.py::finalize_quality_het_nk``), built with nvcc
at first use, and waits for it; for CPU tensors it runs
``quality_finalize_ref``, the plain torch f64 version. Both are bitwise
libsidtpu's ``sidtpu_quality_finalize`` and sid_tpu's ``finalize_quality_np``
(the same operations in the same order). Any other device, dtype, shape or
layout raises, and so does a table that does not reach index max(n) + 1 (the
kernel counts such sites; the plain version checks first).

``finalize_het`` is the device stage of ``-m quality`` around it: counts,
het sums and alleles go into one pinned buffer and one async copy, the
kernel runs, lpp2 and the miss count come back in one copy into pinned
memory, with one stream sync.

``quality_finalize_lrt`` is the full form for ``exact_pvalues=False``
(sid_tpu's XLA program ``models/quality.py::finalize_quality``): the same
het side, then the hom clamp and prior, both LRT p-values and is_het =
p2 < alpha. It returns (p1, p2, is_het uint8); on a card it launches
``quality_finalize_lrt_kernel`` of the same source (one erfc a site), on
the CPU it runs ``quality_finalize_lrt_ref``. ``finalize_lrt`` is its
device stage: 25 B a site in one copy, 17 B a site and the miss count back
in one copy.

``finalize_het_sharded`` and ``finalize_lrt_sharded`` run either stage
over a mesh (``--devices``), one contiguous block of sites a device.

``LAUNCHES`` and ``LRT_LAUNCHES`` count launches of the two kernels (not
plain-version calls), so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sid_tpu_torch.models.common import LONG_DOUBLE_UNDERFLOW_LOG
from sid_tpu_torch.native import build
from sid_tpu_torch.ops import stats
from sid_tpu_torch.ops.lgamma import lgamma_table

LAUNCHES = 0
LRT_LAUNCHES = 0

# the largest n = c[major] + c[second] of uint16 counts: one table of
# lgamma_table(MAX_TOP2) covers every site, so the stage sizes no table from
# the data (sid_tpu sizes it from twice the largest coverage; the entries
# the sites read are the same values)
MAX_TOP2 = 2 * 65535

# counts (8 B), het sum (8 B) and the allele byte in; lpp2 (8 B) out
BYTES_IN_PER_SITE = 17
BYTES_PER_SITE = 25
# the full form: log_hom too in (25 B); p1, p2 and is_het out (17 B)
LRT_BYTES_IN_PER_SITE = 25
LRT_BYTES_OUT_PER_SITE = 17

_COUNT_DTYPES = (torch.uint16, torch.int16)  # int16: the uint16 bits

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_resident: Dict[Tuple[int, bool], int] = {}  # (device index, full form) -> resident blocks


def host_constants(snp_prior: float):
    """(ln2, underflow line, log prior or None): numpy's log of the f64
    arguments sid_tpu's finalize_quality_np takes, and its clamp line."""
    log_prior = float(np.log(np.float64(snp_prior))) if snp_prior > 0 else None
    return float(np.log(2.0)), LONG_DOUBLE_UNDERFLOW_LOG, log_prior


def log_prior_hom(snp_prior: float) -> float:
    """log(1 - prior) as the host pass adds it (0.0 without a prior)."""
    return float(np.log(np.float64(1.0 - snp_prior))) if snp_prior > 0 else 0.0


def pack_alleles(major: np.ndarray, second: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """(N,) uint8 alleles: major | second << 2, each masked with 3 as
    sidtpu_quality_finalize masks them."""
    if out is None:
        out = np.empty(np.shape(major), np.uint8)
    np.bitwise_and(major, 3, out=out, casting="unsafe")
    out |= (np.asarray(second) & 3).astype(np.uint8) << 2
    return out


def quality_finalize_ref(
    counts: torch.Tensor,
    alleles: torch.Tensor,
    log_het: torch.Tensor,
    lgamma_tab: torch.Tensor,
    snp_prior: float = -1.0,
) -> torch.Tensor:
    """Plain torch f64 version of the kernel (any device): lpp2 of (N, 4)
    uint16 counts (or int16 holding their bits), (N,) uint8 alleles and
    (N,) f64 het sums. Raises if the table does not reach max(n) + 1."""
    ln2, underflow, log_prior = host_constants(snp_prior)
    c = counts.view(torch.int16).to(torch.int64) & 0xFFFF
    a = alleles.to(torch.int64)
    k = torch.gather(c, 1, ((a >> 2) & 3)[:, None])[:, 0]
    n = torch.gather(c, 1, (a & 3)[:, None])[:, 0] + k
    if n.numel() and int(n.max()) + 1 >= lgamma_tab.shape[0]:
        raise ValueError(
            f"the lgamma table ({lgamma_tab.shape[0]} entries) does not reach index "
            f"{int(n.max()) + 1}"
        )
    log_c = (lgamma_tab[n + 1] - lgamma_tab[n - k + 1]) - lgamma_tab[k + 1]
    lt = (log_het + log_c) - n.to(torch.float64) * ln2
    lpp2 = torch.where(lt < underflow, -math.inf, lt)
    if log_prior is not None:
        lpp2 = lpp2 + log_prior
    return lpp2


def quality_finalize_lrt_ref(
    counts: torch.Tensor,
    alleles: torch.Tensor,
    log_het: torch.Tensor,
    log_hom: torch.Tensor,
    lgamma_tab: torch.Tensor,
    snp_prior: float,
    alpha: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch f64 version of the full form (any device): lpp2 of
    ``quality_finalize_ref``, lpp1 = clamp(log_hom) + log(1 - prior) with a
    prior, p1 = lrt(lpp2, lpp1), p2 = lrt(lpp1, lpp2)
    (``stats.lrt_pvalues_ref``), is_het = p2 < alpha: (p1, p2, is_het
    uint8)."""
    lpp2 = quality_finalize_ref(counts, alleles, log_het, lgamma_tab, snp_prior)
    lpp1 = torch.where(log_hom < LONG_DOUBLE_UNDERFLOW_LOG, -math.inf, log_hom)
    if snp_prior > 0:
        lpp1 = stats.add_keep_nan(lpp1, log_prior_hom(snp_prior))
    p1 = stats.lrt_pvalues_ref(lpp2, lpp1)
    p2 = stats.lrt_pvalues_ref(lpp1, lpp2)
    return p1, p2, (p2 < alpha).to(torch.uint8)


def _check(counts, alleles, log_het, lgamma_tab) -> None:
    if counts.dim() != 2 or counts.shape[1] != 4:
        raise ValueError(f"counts must be (N, 4), got {tuple(counts.shape)}")
    if counts.dtype not in _COUNT_DTYPES:
        raise TypeError(f"counts must be uint16 (torch.uint16, or int16 holding the bits), got {counts.dtype}")
    n = counts.shape[0]
    for name, t, dtype in (("alleles", alleles, torch.uint8), ("log_het", log_het, torch.float64)):
        if t.shape != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if lgamma_tab.dim() != 1 or lgamma_tab.dtype != torch.float64:
        raise TypeError("lgamma_tab must be 1-D torch.float64")
    for name, t in (("counts", counts), ("alleles", alleles), ("log_het", log_het),
                    ("lgamma_tab", lgamma_tab)):
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, counts on {counts.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def load_kernel_library(path: str) -> ctypes.CDLL:
    """A build of csrc/quality_finalize.cu at ``path`` with its functions'
    types set."""
    lib = ctypes.CDLL(path)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sid_quality_finalize_launch.restype = i32
    lib.sid_quality_finalize_launch.argtypes = [
        p, p, p, ctypes.c_int64, p, i32, p, i32, p, p, i32, p,
    ]
    lib.sid_quality_finalize_lrt_launch.restype = i32
    lib.sid_quality_finalize_lrt_launch.argtypes = [
        p, p, p, p, ctypes.c_int64, p, i32, p, p, i32, p, p, i32, p,
    ]
    for query in (lib.sid_quality_finalize_resident_blocks,
                  lib.sid_quality_finalize_lrt_resident_blocks):
        query.restype = i32
        query.argtypes = [p]
    lib.sid_cuda_error_string.restype = ctypes.c_char_p
    lib.sid_cuda_error_string.argtypes = [i32]
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_kernel_library(build.kernel_library("quality_finalize"))
        return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sid_cuda_error_string(err).decode()
        raise RuntimeError(f"quality finalize {what} failed: {msg} ({err})")


def resident_blocks(device: torch.device, lrt: bool = False) -> int:
    """The kernel's (the full form's with ``lrt``) resident blocks on the
    whole card (occupancy x SMs), asked of the device once and kept."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    blocks = _resident.get((index, lrt))
    if blocks is None:
        lib = _kernel_lib()
        query = (lib.sid_quality_finalize_lrt_resident_blocks if lrt
                 else lib.sid_quality_finalize_resident_blocks)
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_on(lib, query(ctypes.byref(out)), "occupancy query")
        blocks = _resident[(index, lrt)] = out.value
    return blocks


def launch(counts, alleles, log_het, lgamma_tab, snp_prior, out, misses) -> None:
    """Enqueue the kernel (checked tensors on a card) into ``out`` (N f64)
    and ``misses`` (one int32, zeroed on the stream first); no sync."""
    global LAUNCHES
    device = counts.device
    if counts.data_ptr() % 8:
        raise ValueError("counts must be 8-byte aligned (one 8-byte load per site)")
    if lgamma_tab.shape[0] >= 2**31:
        raise ValueError("lgamma_tab is too long for an int index")
    lib = _kernel_lib()
    ln2, underflow, log_prior = host_constants(snp_prior)
    params = (ctypes.c_double * 3)(ln2, underflow, 0.0 if log_prior is None else log_prior)
    with torch.cuda.device(device):
        err = lib.sid_quality_finalize_launch(
            counts.data_ptr(), alleles.data_ptr(), log_het.data_ptr(), counts.shape[0],
            params, int(log_prior is not None), lgamma_tab.data_ptr(), lgamma_tab.shape[0],
            out.data_ptr(), misses.data_ptr(), resident_blocks(device),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "kernel launch")
    LAUNCHES += 1


def launch_lrt(counts, alleles, log_het, log_hom, lgamma_tab, snp_prior, alpha, out, misses) -> None:
    """Enqueue the full form (checked tensors on a card) into ``out`` (17 N
    bytes: p1, p2, is_het) and ``misses`` (one int32, zeroed on the stream
    first); no sync."""
    global LRT_LAUNCHES
    device = counts.device
    if counts.data_ptr() % 8:
        raise ValueError("counts must be 8-byte aligned (one 8-byte load per site)")
    if lgamma_tab.shape[0] >= 2**31:
        raise ValueError("lgamma_tab is too long for an int index")
    lib = _kernel_lib()
    ln2, underflow, log_prior = host_constants(snp_prior)
    params = (ctypes.c_double * 3)(ln2, underflow, 0.0 if log_prior is None else log_prior)
    lrt = (ctypes.c_double * 2)(log_prior_hom(snp_prior), float(alpha))
    with torch.cuda.device(device):
        err = lib.sid_quality_finalize_lrt_launch(
            counts.data_ptr(), alleles.data_ptr(), log_het.data_ptr(), log_hom.data_ptr(),
            counts.shape[0], params, int(log_prior is not None), lrt, lgamma_tab.data_ptr(),
            lgamma_tab.shape[0], out.data_ptr(), misses.data_ptr(), resident_blocks(device, True),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "kernel launch")
    LRT_LAUNCHES += 1


def _raise_on_misses(misses: int, tab_len: int) -> None:
    if misses:
        raise ValueError(
            f"the lgamma table ({tab_len} entries) does not reach n + 1 at {misses} sites"
        )


def quality_finalize(
    counts: torch.Tensor,
    alleles: torch.Tensor,
    log_het: torch.Tensor,
    lgamma_tab: torch.Tensor,
    snp_prior: float = -1.0,
) -> torch.Tensor:
    """lpp2 over the sites: the CUDA kernel on a CUDA device (launch, then
    the stream is synchronised to read the miss count), the plain version
    on the CPU. counts (N, 4) uint16 (or int16 holding the bits), alleles
    (N,) uint8 (``pack_alleles``), log_het (N,) f64, lgamma_tab (T,) f64
    (``ops.lgamma.lgamma_table``, reaching every site's n + 1), all
    contiguous on one device."""
    _check(counts, alleles, log_het, lgamma_tab)
    device = counts.device
    if device.type == "cpu":
        return quality_finalize_ref(counts, alleles, log_het, lgamma_tab, snp_prior)
    if device.type != "cuda":
        raise ValueError(f"no quality finalize kernel for device {device}")
    out = torch.empty(counts.shape[0], dtype=torch.float64, device=device)
    misses = torch.empty(1, dtype=torch.int32, device=device)
    launch(counts, alleles, log_het, lgamma_tab, snp_prior, out, misses)
    _raise_on_misses(int(misses.item()), lgamma_tab.shape[0])
    return out


def finalize_het(
    counts: np.ndarray,
    major: np.ndarray,
    second: np.ndarray,
    log_het: np.ndarray,
    snp_prior: float,
    device,
) -> np.ndarray:
    """The device stage: lpp2 (N,) f64 on the host, from (N, 4) uint16 host
    counts, the alleles and the het sums, on ``device``, with the table of
    ``MAX_TOP2``. On a card: one pinned buffer of 17 B a site, one async
    copy in, the kernel, one copy of lpp2 and the miss count into pinned
    memory, one stream sync. On the CPU the plain version."""
    return _enqueue_het(counts, major, second, log_het, snp_prior, torch.device(device))()[0]


def finalize_het_sharded(counts, major, second, log_het, snp_prior: float, mesh) -> np.ndarray:
    """``finalize_het`` over a mesh (``--devices``, sid_tpu's site-sharded
    finalize): contiguous blocks of sites, one a device of ``mesh``, all
    enqueued before any is waited for, lpp2 concatenated in site order;
    bitwise ``finalize_het`` (the kernel is elementwise)."""
    from sid_tpu_torch.parallel.mesh import run_sharded

    return run_sharded(int(np.shape(counts)[0]), mesh, lambda a, b, dev: _enqueue_het(
        counts[a:b], major[a:b], second[a:b], log_het[a:b], snp_prior, dev))[0]


def _check_counts(counts) -> np.ndarray:
    counts = np.asarray(counts)
    if counts.dtype != np.uint16:
        raise TypeError(f"counts must be uint16, got {counts.dtype}")
    return counts


def _enqueue_het(counts, major, second, log_het, snp_prior: float, device: torch.device):
    """Start ``finalize_het`` on ``device`` and return the callable that
    waits for it and returns (lpp2,)."""
    n = int(np.shape(counts)[0])
    if n == 0:
        return lambda: (np.zeros(0, np.float64),)
    counts = _check_counts(counts)
    if device.type != "cuda":
        tab = lgamma_table(MAX_TOP2, device)
        out = quality_finalize(
            torch.from_numpy(np.ascontiguousarray(counts)),
            torch.from_numpy(pack_alleles(major, second)),
            torch.from_numpy(np.ascontiguousarray(log_het, np.float64)), tab, snp_prior,
        ).numpy()
        return lambda: (out,)
    host_in = torch.empty(BYTES_IN_PER_SITE * n, dtype=torch.uint8, pin_memory=True)
    view = host_in.numpy()
    np.copyto(view[: 8 * n].view(np.uint16).reshape(n, 4), counts)
    np.copyto(view[8 * n : 16 * n].view(np.float64), log_het)
    pack_alleles(major, second, out=view[16 * n :])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        tab = lgamma_table(MAX_TOP2, device)
        dev_in = torch.empty(BYTES_IN_PER_SITE * n, dtype=torch.uint8, device=device)
        dev_in.copy_(host_in, non_blocking=True)
        dev_out = torch.empty(8 * n + 8, dtype=torch.uint8, device=device)
        launch(
            dev_in[: 8 * n].view(torch.int16).view(n, 4), dev_in[16 * n :],
            dev_in[8 * n : 16 * n].view(torch.float64), tab, snp_prior,
            dev_out[: 8 * n].view(torch.float64), dev_out[8 * n : 8 * n + 4].view(torch.int32),
        )
        host_out = torch.empty(8 * n + 8, dtype=torch.uint8, pin_memory=True)
        host_out.copy_(dev_out, non_blocking=True)

    def wait():
        stream.synchronize()
        out = host_out.numpy()
        _raise_on_misses(int(out[8 * n : 8 * n + 4].view(np.int32)[0]), tab.shape[0])
        return (out[: 8 * n].view(np.float64),)

    return wait


def quality_finalize_lrt(
    counts: torch.Tensor,
    alleles: torch.Tensor,
    log_het: torch.Tensor,
    log_hom: torch.Tensor,
    lgamma_tab: torch.Tensor,
    snp_prior: float,
    alpha: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p1, p2, is_het uint8) over the sites: the full form's CUDA kernel on
    a CUDA device (launch, then a sync to read the miss count), the plain
    version on the CPU; arguments as ``quality_finalize``'s, plus log_hom
    (N,) f64 on the same device."""
    _check(counts, alleles, log_het, lgamma_tab)
    stats.check_f64(log_het, log_hom=log_hom)
    device = counts.device
    if device.type == "cpu":
        return quality_finalize_lrt_ref(counts, alleles, log_het, log_hom, lgamma_tab, snp_prior, alpha)
    if device.type != "cuda":
        raise ValueError(f"no quality finalize kernel for device {device}")
    n = counts.shape[0]
    out = torch.empty(LRT_BYTES_OUT_PER_SITE * n, dtype=torch.uint8, device=device)
    misses = torch.empty(1, dtype=torch.int32, device=device)
    launch_lrt(counts, alleles, log_het, log_hom, lgamma_tab, snp_prior, alpha, out, misses)
    _raise_on_misses(int(misses.item()), lgamma_tab.shape[0])
    return out[: 8 * n].view(torch.float64), out[8 * n : 16 * n].view(torch.float64), out[16 * n :]


def finalize_lrt(
    counts: np.ndarray,
    major: np.ndarray,
    second: np.ndarray,
    log_hom: np.ndarray,
    log_het: np.ndarray,
    snp_prior: float,
    alpha: float,
    device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The full form's device stage: (is_het, p1, p2) host arrays from
    (N, 4) uint16 host counts, the alleles and both per-read sums, on
    ``device``, with the table of ``MAX_TOP2``. On a card: one pinned buffer
    of 25 B a site, one async copy in, the kernel, one copy of the 17 B a
    site and the miss count into pinned memory, one stream sync. On the CPU
    the plain version."""
    return _enqueue_lrt(counts, major, second, log_hom, log_het, snp_prior, alpha, torch.device(device))()


def finalize_lrt_sharded(counts, major, second, log_hom, log_het, snp_prior: float, alpha: float, mesh):
    """``finalize_lrt`` over a mesh, as ``finalize_het_sharded``: (is_het,
    p1, p2) concatenated in site order."""
    from sid_tpu_torch.parallel.mesh import run_sharded

    return run_sharded(int(np.shape(counts)[0]), mesh, lambda a, b, dev: _enqueue_lrt(
        counts[a:b], major[a:b], second[a:b], log_hom[a:b], log_het[a:b], snp_prior, alpha, dev))


def _enqueue_lrt(counts, major, second, log_hom, log_het, snp_prior: float, alpha: float, device: torch.device):
    """Start ``finalize_lrt`` on ``device`` and return the callable that
    waits for it and returns (is_het, p1, p2)."""
    n = int(np.shape(counts)[0])
    if n == 0:
        return lambda: (np.zeros(0, bool), np.zeros(0, np.float64), np.zeros(0, np.float64))
    counts = _check_counts(counts)
    if device.type != "cuda":
        p1, p2, het = quality_finalize_lrt(
            torch.from_numpy(np.ascontiguousarray(counts)),
            torch.from_numpy(pack_alleles(major, second)),
            torch.from_numpy(np.ascontiguousarray(log_het, np.float64)),
            torch.from_numpy(np.ascontiguousarray(log_hom, np.float64)),
            lgamma_table(MAX_TOP2, device), snp_prior, alpha,
        )
        return lambda: (het.numpy().astype(bool), p1.numpy(), p2.numpy())
    host_in = torch.empty(LRT_BYTES_IN_PER_SITE * n, dtype=torch.uint8, pin_memory=True)
    view = host_in.numpy()
    np.copyto(view[: 8 * n].view(np.uint16).reshape(n, 4), counts)
    np.copyto(view[8 * n : 16 * n].view(np.float64), log_het)
    np.copyto(view[16 * n : 24 * n].view(np.float64), log_hom)
    pack_alleles(major, second, out=view[24 * n :])
    out_len = LRT_BYTES_OUT_PER_SITE * n
    at = -(-out_len // 8) * 8  # the miss count, 8-byte aligned after the results
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        tab = lgamma_table(MAX_TOP2, device)
        dev_in = torch.empty(LRT_BYTES_IN_PER_SITE * n, dtype=torch.uint8, device=device)
        dev_in.copy_(host_in, non_blocking=True)
        dev_out = torch.empty(at + 8, dtype=torch.uint8, device=device)
        launch_lrt(
            dev_in[: 8 * n].view(torch.int16).view(n, 4), dev_in[24 * n :],
            dev_in[8 * n : 16 * n].view(torch.float64), dev_in[16 * n : 24 * n].view(torch.float64),
            tab, snp_prior, alpha, dev_out[:out_len], dev_out[at : at + 4].view(torch.int32),
        )
        host_out = torch.empty(at + 8, dtype=torch.uint8, pin_memory=True)
        host_out.copy_(dev_out, non_blocking=True)

    def wait():
        stream.synchronize()
        out = host_out.numpy()
        _raise_on_misses(int(out[at : at + 4].view(np.int32)[0]), tab.shape[0])
        return out[16 * n : out_len].astype(bool), out[: 8 * n].view(np.float64), out[8 * n : 16 * n].view(np.float64)

    return wait
