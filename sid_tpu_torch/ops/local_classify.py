"""The ``local`` classify: per unique profile, the top-2 alleles, the f64 log
likelihoods (l1, l2) and the long-double range screen.

``local_classify`` takes (U, 4) uint16 counts and returns ``(l1, l2,
packed)``: l1 and l2 f64, and one uint8 a row with ``major`` in bits 0-1,
``second`` in bits 2-3 and the range flag (``models/local.py::
long_double_range_rows``) in bit 4 (``unpack``). For CUDA tensors it
launches the hand-written Hopper kernel in ``csrc/local_classify.cu`` (the
counterpart of sid_tpu's Pallas kernel
``ops/pallas_classify.py::local_log_likelihoods_pallas`` and of its XLA
top-2 program ``models/common.py::major_allele_indices``), built with nvcc
at first use; for CPU tensors it runs ``local_classify_ref``, the plain
torch f64 version. Any other device, dtype, shape or layout raises; so does
a failed build or launch.

``classify_profiles`` is the device stage of ``-m local`` around it: the
int32 host profiles are checked and narrowed to uint16 into pinned memory,
sent with one async copy, classified, and the 17 bytes a row come back in
one copy into pinned memory, with one stream sync. The pinned buffers come
from torch's caching host allocator, which hands the same memory back on
the next call of the same size.

``local_classify_lrt`` is the fused on-device LRT's classify (B5, sid_tpu's
XLA program ``models/local.py::classify_local``, for ``exact_pvalues=False``):
the same row, then the prior, both LRT p-values and is_het. It returns
``(p1, p2, packed)`` with is_het in bit 5 of the byte; on a card it launches
``local_classify_lrt_kernel`` of the same source, on the CPU it runs
``local_classify_lrt_ref``. ``classify_profiles(..., alpha=...)`` is its
device stage, with the same copies. ``classify_profiles_sharded`` runs
either over a mesh (``--devices``), one contiguous block of rows a device.

``LAUNCHES`` and ``LRT_LAUNCHES`` count launches of the two kernels (not
plain-version calls), so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sid_tpu_torch.models import common
from sid_tpu_torch.native import build
from sid_tpu_torch.ops import likelihoods, stats
from sid_tpu_torch.ops.lgamma import lgamma_table

LAUNCHES = 0
LRT_LAUNCHES = 0

# counts travel as uint16
MAX_COUNT = 65535
# l1 and l2 (f64) and the byte
BYTES_PER_ROW = 17
FLAG_BIT = 16
HET_BIT = 32

_COUNT_DTYPES = (torch.uint16, torch.int16)  # int16: the uint16 bits

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_resident: Dict[Tuple[int, bool], int] = {}  # (device index, B5) -> the kernel's resident blocks


def local_log_likelihoods_ref(
    profiles: torch.Tensor,
    major: torch.Tensor,
    second: torch.Tensor,
    error_threshold: float,
    lgamma_tab: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l1, l2) in plain torch f64 for given alleles (sid_tpu/models/local.py:71-95,
    term for term).

    Plug-in error rates from the profiles, capped at ``error_threshold``
    (a select, so a NaN rate at zero coverage stays NaN), the fixed-allele
    log likelihoods, and the long-double underflow clamp. Runs on any
    device.
    """
    profiles = profiles.to(torch.int64)
    cov = profiles.sum(-1).to(torch.float64)
    n1 = torch.gather(profiles, -1, major.to(torch.int64)[:, None])[:, 0].to(torch.float64)
    n2 = torch.gather(profiles, -1, second.to(torch.int64)[:, None])[:, 0].to(torch.float64)
    thr = float(error_threshold)
    error1 = (cov - n1) / cov  # 0/0 -> NaN, reference edge case
    error1 = torch.where(error1 > thr, thr, error1)
    l1 = likelihoods.log_hom_fixed(profiles, error1, major, lgamma_tab)
    error2 = 1.5 * (cov - n1 - n2) / cov
    error2 = torch.where(error2 > thr, thr, error2)
    l2 = likelihoods.log_het_fixed(profiles, error2, major, second, lgamma_tab)
    return common.clamp_ld_underflow(l1), common.clamp_ld_underflow(l2)


def top2_ref(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(major, second) int32 of (U, 4) integer counts: the two largest of
    the keys count * 4 + i (``models/common.py::major_allele_indices_np``)."""
    keys = counts.to(torch.int64) * 4 + torch.arange(4, device=counts.device)
    order = torch.argsort(keys, dim=-1)  # keys are distinct: no tie to break
    return order[:, 3].to(torch.int32), order[:, 2].to(torch.int32)


def range_flags_ref(cov: torch.Tensor, error_threshold: float, snp_prior: float) -> torch.Tensor:
    """``models/local.py::long_double_range_rows`` in torch: the same f64
    operations on the same constants, so the same flags."""
    every, k, prior = common.long_double_screen(error_threshold, snp_prior)
    if every:
        return torch.ones(cov.shape[0], dtype=torch.bool, device=cov.device)
    c = cov.to(torch.float64)
    return (c * common.LN4 > common.LD_LOG_MAX) | (c * k + prior > -common.LD_LOG_MIN)


def local_classify_ref(
    counts: torch.Tensor, error_threshold: float, snp_prior: float, lgamma_tab: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch f64 version of the kernel: (l1, l2, packed) of (U, 4)
    uint16 counts (or int16 holding their bits). Runs on any device."""
    c = counts.view(torch.int16).to(torch.int64) & 0xFFFF
    major, second = top2_ref(c)
    l1, l2 = local_log_likelihoods_ref(c, major, second, error_threshold, lgamma_tab)
    flags = range_flags_ref(c.sum(-1), error_threshold, snp_prior)
    packed = major | second << 2 | flags.to(torch.int32) * FLAG_BIT
    return l1, l2, packed.to(torch.uint8)


def lrt_constants(snp_prior: float, alpha: float):
    """(log(1 - prior), log(prior), alpha, use_prior): the host glibc logs
    ``models/local.py`` adds, a prior being set when it is > 0."""
    use_prior = snp_prior > 0
    lp_hom, lp_het = stats.prior_logs(snp_prior) if use_prior else (0.0, 0.0)
    return lp_hom, lp_het, float(alpha), use_prior


def local_classify_lrt_ref(
    counts: torch.Tensor, error_threshold: float, snp_prior: float, alpha: float,
    lgamma_tab: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch f64 version of B5: ``local_classify_ref``'s row, then
    l1 += log(1 - prior) and l2 += log(prior) with a prior, p1 = lrt(l2, l1),
    p2 = lrt(l1, l2) (``stats.lrt_pvalues_ref``), is_het = l2 > l1 and
    p2 < alpha in bit 5: (p1, p2, packed). Runs on any device."""
    l1, l2, packed = local_classify_ref(counts, error_threshold, snp_prior, lgamma_tab)
    lp_hom, lp_het, alpha, use_prior = lrt_constants(snp_prior, alpha)
    if use_prior:
        l1 = stats.add_keep_nan(l1, lp_hom)
        l2 = stats.add_keep_nan(l2, lp_het)
    p1 = stats.lrt_pvalues_ref(l2, l1)
    p2 = stats.lrt_pvalues_ref(l1, l2)
    het = (l2 > l1) & (p2 < alpha)
    return p1, p2, packed | (het.to(torch.uint8) * HET_BIT)


def unpack(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(major int32, second int32, range flag bool) of the packed bytes."""
    return (
        (packed & 3).astype(np.int32),
        ((packed >> 2) & 3).astype(np.int32),
        (packed & FLAG_BIT).astype(bool),
    )


def het_flags(packed: np.ndarray) -> np.ndarray:
    """B5's is_het (bit 5) of the packed bytes."""
    return (packed & HET_BIT).astype(bool)


def narrow_counts(profiles: np.ndarray, out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """(U, 4) integer counts as uint16 in ``out`` (made when None), and the
    largest count; raises if a count is outside 0..65535 (never clips)."""
    profiles = np.asarray(profiles)
    if profiles.ndim != 2 or profiles.shape[1] != 4:
        raise ValueError(f"profiles must be (U, 4), got {profiles.shape}")
    if out is None:
        out = np.empty(profiles.shape, np.uint16)
    if not profiles.size:
        return out, 0
    lo, hi = int(profiles.min()), int(profiles.max())
    if lo < 0 or hi > MAX_COUNT:
        raise ValueError(f"counts must be in 0..{MAX_COUNT}, got {lo}..{hi}")
    np.copyto(out, profiles, casting="unsafe")
    return out, hi


def split(buf: torch.Tensor, u: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(l1, l2, packed) as views of a (17 U,) uint8 buffer."""
    return buf[: 8 * u].view(torch.float64), buf[8 * u : 16 * u].view(torch.float64), buf[16 * u :]


def _check(counts: torch.Tensor, lgamma_tab: torch.Tensor) -> None:
    if counts.dim() != 2 or counts.shape[1] != 4:
        raise ValueError(f"counts must be (U, 4), got {tuple(counts.shape)}")
    if counts.dtype not in _COUNT_DTYPES:
        raise TypeError(f"counts must be uint16 (torch.uint16, or int16 holding the bits), got {counts.dtype}")
    if lgamma_tab.dim() != 1:
        raise ValueError("lgamma_tab must be 1-D")
    if lgamma_tab.dtype != torch.float64:
        raise TypeError(f"lgamma_tab must be torch.float64, got {lgamma_tab.dtype}")
    if lgamma_tab.device != counts.device:
        raise ValueError(f"lgamma_tab is on {lgamma_tab.device}, counts on {counts.device}")
    for name, t in (("counts", counts), ("lgamma_tab", lgamma_tab)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def load_kernel_library(path: str) -> ctypes.CDLL:
    """A build of csrc/local_classify.cu at ``path`` with its functions'
    types set."""
    lib = ctypes.CDLL(path)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sid_local_classify_launch.restype = i32
    lib.sid_local_classify_launch.argtypes = [p, ctypes.c_int64, p, i32, p, i32, p, i32, p]
    lib.sid_local_classify_lrt_launch.restype = i32
    lib.sid_local_classify_lrt_launch.argtypes = [p, ctypes.c_int64, p, i32, p, i32, p, i32, p, i32, p]
    for query in (lib.sid_local_classify_resident_blocks, lib.sid_local_classify_lrt_resident_blocks):
        query.restype = i32
        query.argtypes = [p]
    lib.sid_cuda_error_string.restype = ctypes.c_char_p
    lib.sid_cuda_error_string.argtypes = [i32]
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_kernel_library(build.kernel_library("local_classify"))
        return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sid_cuda_error_string(err).decode()
        raise RuntimeError(f"local classify {what} failed: {msg} ({err})")


def resident_blocks(device: torch.device, lrt: bool = False) -> int:
    """The kernel's (B5's with ``lrt``) resident blocks on the whole card
    (occupancy x SMs), asked of the device once and kept."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    blocks = _resident.get((index, lrt))
    if blocks is None:
        lib = _kernel_lib()
        query = lib.sid_local_classify_lrt_resident_blocks if lrt else lib.sid_local_classify_resident_blocks
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_on(lib, query(ctypes.byref(out)), "occupancy query")
        blocks = _resident[(index, lrt)] = out.value
    return blocks


def _launch(counts, error_threshold, snp_prior, lgamma_tab, buf, alpha=None) -> None:
    """Enqueue the kernel over ``counts`` (checked, on a card) into ``buf``:
    B1, or B5 when ``alpha`` is given."""
    global LAUNCHES, LRT_LAUNCHES
    device = counts.device
    if counts.data_ptr() % 8:
        raise ValueError("counts must be 8-byte aligned (one 8-byte load per row)")
    if lgamma_tab.shape[0] >= 2**31:
        raise ValueError("lgamma_tab is too long for an int index")
    u = counts.shape[0]
    if u == 0:
        return
    lib = _kernel_lib()
    every, k, prior = common.long_double_screen(error_threshold, snp_prior)
    params = (ctypes.c_double * 6)(
        float(error_threshold), common.LN4, k, prior, common.LD_LOG_MAX, -common.LD_LOG_MIN
    )
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if alpha is None:
            err = lib.sid_local_classify_launch(
                counts.data_ptr(), u, params, int(every), lgamma_tab.data_ptr(),
                lgamma_tab.shape[0], buf.data_ptr(), resident_blocks(device), stream,
            )
        else:
            lp_hom, lp_het, alpha, use_prior = lrt_constants(snp_prior, alpha)
            lrt = (ctypes.c_double * 3)(lp_hom, lp_het, alpha)
            err = lib.sid_local_classify_lrt_launch(
                counts.data_ptr(), u, params, int(every), lrt, int(use_prior),
                lgamma_tab.data_ptr(), lgamma_tab.shape[0], buf.data_ptr(),
                resident_blocks(device, True), stream,
            )
    _raise_on(lib, err, "kernel launch")
    if alpha is None:
        LAUNCHES += 1
    else:
        LRT_LAUNCHES += 1


def local_classify(
    counts: torch.Tensor,
    error_threshold: float,
    snp_prior: float,
    lgamma_tab: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(l1, l2, packed) over the profiles: the CUDA kernel on a CUDA device,
    the plain version on the CPU.

    counts (U, 4) uint16 (torch.uint16, or int16 holding the bits),
    lgamma_tab (T,) f64 (``ops.lgamma.lgamma_table``, T > max coverage + 1),
    both contiguous on one device. On CUDA the three results are views of
    one (17 U,) uint8 buffer (``split``), and the grid is the kernel's
    resident blocks (``resident_blocks``), or fewer where U needs fewer.
    """
    _check(counts, lgamma_tab)
    device = counts.device
    if device.type == "cpu":
        return local_classify_ref(counts, error_threshold, snp_prior, lgamma_tab)
    if device.type != "cuda":
        raise ValueError(f"no local classify kernel for device {device}")
    buf = torch.empty(BYTES_PER_ROW * counts.shape[0], dtype=torch.uint8, device=device)
    _launch(counts, error_threshold, snp_prior, lgamma_tab, buf)
    return split(buf, counts.shape[0])


def local_classify_lrt(
    counts: torch.Tensor,
    error_threshold: float,
    snp_prior: float,
    alpha: float,
    lgamma_tab: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p1, p2, packed) over the profiles (B5): the CUDA kernel on a CUDA
    device, ``local_classify_lrt_ref`` on the CPU; arguments and results as
    ``local_classify``'s, with is_het in bit 5 of the byte."""
    _check(counts, lgamma_tab)
    device = counts.device
    if device.type == "cpu":
        return local_classify_lrt_ref(counts, error_threshold, snp_prior, alpha, lgamma_tab)
    if device.type != "cuda":
        raise ValueError(f"no local classify kernel for device {device}")
    buf = torch.empty(BYTES_PER_ROW * counts.shape[0], dtype=torch.uint8, device=device)
    _launch(counts, error_threshold, snp_prior, lgamma_tab, buf, alpha)
    return split(buf, counts.shape[0])


def classify_profiles(
    profiles: np.ndarray, error_threshold: float, snp_prior: float, device,
    alpha: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The device stage: (l1, l2, packed) host arrays of (U, 4) host counts
    in 0..65535 (raises otherwise) on ``device``, the table sized from the
    largest count; with ``alpha``, B5's (p1, p2, packed). On a card: uint16
    counts into pinned memory, one async copy in, the kernel, one copy of
    the 17 bytes a row into pinned memory, one stream sync. On the CPU the
    same narrowing, then the plain version.
    """
    return _enqueue_classify(profiles, error_threshold, snp_prior, torch.device(device), alpha)()


def classify_profiles_sharded(
    profiles: np.ndarray, error_threshold: float, snp_prior: float, mesh,
    alpha: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``classify_profiles`` over a mesh (``--devices``, sid_tpu's
    row-sharded classify): the rows cut into contiguous shards, one a
    device of ``mesh``, each shard's copies and kernel enqueued on its
    device before any is waited for, the results concatenated in row
    order. The kernel is elementwise, so the bits are ``classify_profiles``'s."""
    from sid_tpu_torch.parallel.mesh import run_sharded

    return run_sharded(np.shape(profiles)[0], mesh, lambda a, b, dev: _enqueue_classify(
        profiles[a:b], error_threshold, snp_prior, dev, alpha))


def _enqueue_classify(profiles, error_threshold: float, snp_prior: float, device: torch.device,
                      alpha: Optional[float]):
    """Start ``classify_profiles`` on ``device`` (on a card: the copy in,
    the kernel and the copy out, enqueued) and return the callable that
    waits for it and returns the host arrays."""
    u = np.shape(profiles)[0]
    if device.type != "cuda":
        counts, hi = narrow_counts(profiles)
        tab = lgamma_table(4 * hi, device)
        if alpha is None:
            out = local_classify(torch.from_numpy(counts), error_threshold, snp_prior, tab)
        else:
            out = local_classify_lrt(torch.from_numpy(counts), error_threshold, snp_prior, alpha, tab)
        return lambda: tuple(t.numpy() for t in out)
    host_in = torch.empty((u, 4), dtype=torch.int16, pin_memory=True)
    _, hi = narrow_counts(profiles, host_in.numpy().view(np.uint16))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        tab = lgamma_table(4 * hi, device)
        counts = torch.empty((u, 4), dtype=torch.int16, device=device)
        counts.copy_(host_in, non_blocking=True)
        buf = torch.empty(BYTES_PER_ROW * u, dtype=torch.uint8, device=device)
        _launch(counts, error_threshold, snp_prior, tab, buf, alpha)
        host_out = torch.empty(BYTES_PER_ROW * u, dtype=torch.uint8, pin_memory=True)
        host_out.copy_(buf, non_blocking=True)

    def wait():
        stream.synchronize()
        return tuple(t.numpy() for t in split(host_out, u))

    return wait
