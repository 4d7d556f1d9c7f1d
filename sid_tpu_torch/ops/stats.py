"""LRT p-values and multiple-testing corrections, on the host and the device.

``Q_chisq(x, df=1) = erfc(sqrt(x/2))`` (gsl_cdf_chisq_Q at stats.cpp:33).
The ``*_np`` functions are the host path (``Options.exact_pvalues``, the
default): libsidtpu's threaded LRT with the libm erfc the long-double
oracle uses, so CSV parity never depends on a device erfc, and the host
Benjamini-Hochberg of sid_tpu's ``ops/stats.py``.

The tensor functions are the fused on-device LRT (``exact_pvalues=False``,
sid_tpu's ``lrt_pvalue_from_logs`` and ``adjust_benjamini_hochberg``). For
CUDA tensors they launch the hand-written kernels of ``csrc/lrt_bh.cu``
(built with nvcc at first use): ``lrt_pvalues_kernel`` (the clamp, the -R
prior and both p-values with one erfc a row, ``csrc/lrt_bh.cuh``) and BH
with its own order
(``csrc/bh_sort.cuh``): up to ``BH_SMALL_MAX`` p-values one block an array
(``bh_small_kernel``: the key, a radix sort in shared memory, the scan),
above it a stable LSD radix sort of (key, position) pairs over the card
(a histogram, a plan, one pass a digit) and a chained scan
(``bh_scan_kernel``); no library sort and no torch elementwise op. For CPU
tensors they run their plain torch versions (``*_ref``). Any other device,
a failed build or a failed launch raises. The device's erfc is not glibc's,
so these p-values are held to the host path by a tolerance; BH itself is
exact (a scaled running min), so it is bitwise the host BH for the same p.

``lrt_benjamini_hochberg`` is the device stage of ``-m likelihood_ratio``
under ``exact_pvalues=False``: the marginals up in one copy, the LRT, both
BH corrections (one launch for both arrays up to ``BH_SMALL_MAX``
profiles), and (adj_p1, adj_p2, is_het) back in one copy.

The rest is the reference's dead-code API (stats.cpp:10-27, 48-56;
call.cpp:344-347), plain torch: Bonferroni, AIC, relative likelihoods, the
log binomial coefficient and the binomial pmf.

``LRT_LAUNCHES`` and ``BH_LAUNCHES`` count kernel launches (each BH
kernel launch counts one, ``bh_launches``), not plain-version calls.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sid_tpu_torch.io import native
from sid_tpu_torch.models.common import LONG_DOUBLE_UNDERFLOW_LOG
from sid_tpu_torch.native import bridge, build

LRT_LAUNCHES = 0
BH_LAUNCHES = 0

# csrc/bh_sort.cuh: positions of the sorted order a thread of the scan
# walks (kScanItems), the scan's threads, the sort's tile, the one-block
# path's largest m, the sort's bits a digit (kSortBits)
BH_ITEMS = 4
BH_SCAN_THREADS = 256
BH_SORT_TILE = 4096
BH_SMALL_MAX = 8192
BH_BITS = 8
BH_MAX = 2**31 - 1

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_resident: Dict[int, int] = {}  # device index -> lrt_pvalues_kernel's resident blocks


# ---- host path ----

def lrt_pvalue_from_logs_np(log_l0, log_l1) -> np.ndarray:
    """likelihoodRatioTest (stats.cpp:29-37) on log-likelihoods:
    chisq = 2 max(0, ln l1 - ln l0), p = erfc(sqrt(chisq/2)); a log_l0 of
    -inf (l0 == 0) gives 0."""
    return bridge.lrt_pvalues_libm(native.load(), log_l0, log_l1)


def adjust_benjamini_hochberg_np(p_values) -> np.ndarray:
    """Benjamini-Hochberg, reference semantics (stats.cpp:68-80): sort
    descending; adjusted[sorted[i]] = running min of p*m/(m-i), the i = 0
    entry the raw p; values > 1 clamp to 1. The running min propagates NaN
    (sid_tpu/ops/stats.py:99, element for element)."""
    p_values = np.asarray(p_values, np.float64)
    m = p_values.shape[0]
    if m == 0:
        return p_values
    order = np.argsort(-p_values, kind="stable")
    sorted_p = p_values[order]
    i = np.arange(m, dtype=np.float64)
    scaled = sorted_p * np.float64(m) / (np.float64(m) - i)
    scaled[0] = sorted_p[0]
    adj = np.minimum.accumulate(scaled)
    out = np.empty_like(p_values)
    out[order] = adj
    return np.where(out > 1.0, 1.0, out)


def prior_logs(pi: float) -> Tuple[float, float]:
    """(log(1 - pi), log(pi)): numpy's log of the f64 arguments the host
    path adds (-inf at pi == 0)."""
    with np.errstate(divide="ignore"):
        return float(np.log(np.float64(1.0 - pi))), float(np.log(np.float64(pi)))


# ---- plain torch versions ----

def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as glibc's and the card's f64
    sqrt give it: torch.sqrt on a card; on the CPU numpy's, since torch's
    CPU sqrt is one ulp off on some 0.7 % of f64 inputs, which erfc's
    slope near 0 (about 2x^2 in relative terms, ~1000 at x = 23) turns into
    1e-13 of the p-value."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def lrt_pvalues_ref(log_l0: torch.Tensor, log_l1: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``sid::lrt_pvalue`` (csrc/lrt.cuh): d = l1 -
    l0, m = max(0, d) keeping NaN, p = erfc(sqrt(m)), 0 where l0 is -inf; a
    NaN log comes out as itself (l1's first). Runs on any device."""
    d = log_l1 - log_l0
    m = torch.where((d > 0) | torch.isnan(d), d, torch.zeros_like(d))
    p = torch.special.erfc(sqrt_rn(m))
    p = torch.where(torch.isnan(log_l0), log_l0, p)
    p = torch.where(torch.isnan(log_l1), log_l1, p)
    return torch.where(log_l0 == -math.inf, torch.zeros_like(p), p)


def _clamp(x: torch.Tensor, line: float) -> torch.Tensor:
    return torch.where(x < line, -math.inf, x)


def add_keep_nan(x: torch.Tensor, y: float) -> torch.Tensor:
    """x + y, a NaN x kept as it is (csrc/lrt.cuh ``add_keep_nan``)."""
    return torch.where(torch.isnan(x), x, x + y)


def lrt_pair_ref(
    log_l_hom: torch.Tensor,
    log_l_het: torch.Tensor,
    log_priors: Optional[Tuple[float, float]] = None,
    underflow_log: float = LONG_DOUBLE_UNDERFLOW_LOG,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``lrt_pvalues_kernel`` (csrc/lrt_bh.cuh
    ``lrt_pair``): both logs clamped at ``underflow_log``; with
    ``log_priors`` = (log(1 - pi), log(pi)) the prior added and clamped
    again (models/likelihood_ratio.py's -R); (p1, p2) = (lrt(het, hom),
    lrt(hom, het)). Runs on any device."""
    hom = _clamp(log_l_hom, underflow_log)
    het = _clamp(log_l_het, underflow_log)
    if log_priors is not None:
        het = _clamp(add_keep_nan(het, log_priors[1]), underflow_log)
        hom = _clamp(add_keep_nan(hom, log_priors[0]), underflow_log)
    return lrt_pvalues_ref(het, hom), lrt_pvalues_ref(hom, het)


def bh_order(p: torch.Tensor) -> torch.Tensor:
    """The descending order of p, NaN last, stable (int64): argsort of the
    key -p made +0 at zeros and the positive NaN at NaN, so a radix sort of
    the key's bits and numpy's comparison sort of -p give one order. The
    plain version of the kernels' order (``csrc/bh_sort.cuh``
    ``bh_radix_key``)."""
    key = torch.where(torch.isnan(p), torch.full_like(p, math.nan), 0.0 - p)
    return torch.argsort(key, stable=True)


def _scaled(sorted_p: torch.Tensor) -> torch.Tensor:
    m = sorted_p.shape[0]
    i = torch.arange(m, dtype=torch.float64, device=sorted_p.device)
    s = sorted_p * float(m) / (float(m) - i)
    s = torch.where(torch.isnan(sorted_p), sorted_p, s)
    s[0] = sorted_p[0]
    return s


def adjust_benjamini_hochberg_ref(p: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the BH kernels: sid_tpu/ops/stats.py:78-99 in
    torch, bitwise ``adjust_benjamini_hochberg_np``. Runs on any device."""
    m = p.shape[0]
    if m == 0:
        return p.clone()
    order = bh_order(p)
    s = _scaled(p[order])
    nan = torch.nonzero(torch.isnan(s))
    k = int(nan[0, 0]) if nan.numel() else m  # the first NaN stays to the end
    run = torch.empty_like(s)
    if k:
        run[:k] = torch.cummin(s[:k], 0).values
    if k < m:
        run[k:] = s[k]
    out = torch.empty_like(p)
    out[order] = torch.where(run > 1.0, 1.0, run)
    return out


# ---- the kernels ----

def load_kernel_library(path: str) -> ctypes.CDLL:
    """A build of csrc/lrt_bh.cu at ``path`` with its functions' types set."""
    lib = ctypes.CDLL(path)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sid_lrt_resident_blocks.restype = i32
    lib.sid_lrt_resident_blocks.argtypes = [p]
    lib.sid_lrt_pvalues_launch.restype = i32
    lib.sid_lrt_pvalues_launch.argtypes = [p, p, i64, p, i32, p, p, i32, p]
    lib.sid_bh_scratch_bytes.restype = i64
    lib.sid_bh_scratch_bytes.argtypes = [i64, i32]
    lib.sid_bh_adjust_launch.restype = i32
    lib.sid_bh_adjust_launch.argtypes = [p, p, i64, ctypes.c_double, p, p, p, p]
    lib.sid_bh_order_launch.restype = i32
    lib.sid_bh_order_launch.argtypes = [p, i64, p, p, p]
    lib.sid_bh_small_pair_launch.restype = i32
    lib.sid_bh_small_pair_launch.argtypes = [p, p, i64, ctypes.c_double, p, p, p, p, p]
    lib.sid_cuda_error_string.restype = ctypes.c_char_p
    lib.sid_cuda_error_string.argtypes = [i32]
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_kernel_library(build.kernel_library("lrt_bh"))
        return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sid_cuda_error_string(err).decode()
        raise RuntimeError(f"device LRT {what} failed: {msg} ({err})")


def resident_blocks(device: torch.device) -> int:
    """lrt_pvalues_kernel's resident blocks on the whole card, asked of the
    device once and kept."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    blocks = _resident.get(index)
    if blocks is None:
        lib = _kernel_lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_on(lib, lib.sid_lrt_resident_blocks(ctypes.byref(out)), "occupancy query")
        blocks = _resident[index] = out.value
    return blocks


def check_f64(device_of: torch.Tensor, **tensors) -> None:
    """Raise unless every tensor is 1-D f64 of device_of's length, on its
    device, contiguous."""
    n = device_of.shape[0]
    for name, t in tensors.items():
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be torch.float64, got {t.dtype}")
        if t.device != device_of.device:
            raise ValueError(f"{name} is on {t.device}, expected {device_of.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_lrt(log_l_hom, log_l_het, log_priors, underflow_log, p1, p2=None) -> None:
    """Enqueue lrt_pvalues_kernel (checked f64 tensors on a card) into p1
    and, when given, p2; no sync."""
    global LRT_LAUNCHES
    device = log_l_hom.device
    lib = _kernel_lib()
    lp = log_priors or (0.0, 0.0)
    params = (ctypes.c_double * 3)(underflow_log, lp[0], lp[1])
    with torch.cuda.device(device):
        err = lib.sid_lrt_pvalues_launch(
            log_l_hom.data_ptr(), log_l_het.data_ptr(), log_l_hom.shape[0], params,
            int(log_priors is not None), p1.data_ptr(), 0 if p2 is None else p2.data_ptr(),
            resident_blocks(device), torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "kernel launch")
    LRT_LAUNCHES += 1


def bh_launches(m: int, ordered: bool = False) -> int:
    """Kernel launches of one BH call over m p-values: for a given order a
    zeroing kernel and the scan; for the hand order one launch up to
    ``BH_SMALL_MAX``, else the histogram, the plan, one pass a digit and
    the scan (none for m == 0)."""
    if m == 0:
        return 0
    if ordered:
        return 2
    if m <= BH_SMALL_MAX:
        return 1
    return 3 + -(-64 // BH_BITS)


def _check_bh(p) -> None:
    if p.shape[0] > BH_MAX:
        raise ValueError(f"BH on the card takes at most {BH_MAX} p-values, got {p.shape[0]}")


def _scratch(lib, m: int, kind: int, device) -> torch.Tensor:
    """A BH launch's scratch from torch's caching allocator
    (``sid_bh_scratch_bytes``: kind 0 the hand order, 1 a given order, 2
    the order alone)."""
    return torch.empty(max(lib.sid_bh_scratch_bytes(m, kind), 1), dtype=torch.uint8, device=device)


def launch_bh(p, order, out, het=None, alpha: float = 0.0) -> None:
    """Enqueue BH over p (f64) into out (f64) and, when given, het (uint8:
    out < alpha); no sync. ``order``: None for the hand order (the radix
    sort, or the one-block path up to ``BH_SMALL_MAX``), or the descending
    order of p (int64), which the scan then takes as it is."""
    global BH_LAUNCHES
    m = p.shape[0]
    if m == 0:
        return
    _check_bh(p)
    if order is not None and (order.dtype != torch.int64 or order.shape != p.shape or not order.is_contiguous()):
        raise ValueError("order must be a contiguous int64 permutation of p's positions")
    lib = _kernel_lib()
    ordered = order is not None
    scratch = _scratch(lib, m, int(ordered), p.device)
    with torch.cuda.device(p.device):
        err = lib.sid_bh_adjust_launch(
            p.data_ptr(), order.data_ptr() if ordered else 0, m, float(alpha), out.data_ptr(),
            0 if het is None else het.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    _raise_on(lib, err, "BH launch")
    BH_LAUNCHES += bh_launches(m, ordered)


def launch_bh_pair(p1, p2, out1, out2, het2, alpha: float) -> None:
    """Enqueue BH over p1 into out1 and over p2 into out2 and het2 (out2 <
    alpha), p1 and p2 of one length m: up to ``BH_SMALL_MAX`` one launch of
    bh_small_kernel with a block for each, else ``launch_bh`` for each."""
    global BH_LAUNCHES
    m = p1.shape[0]
    if m > BH_SMALL_MAX:
        launch_bh(p1, None, out1)
        launch_bh(p2, None, out2, het2, alpha)
        return
    if m == 0:
        return
    lib = _kernel_lib()
    with torch.cuda.device(p1.device):
        err = lib.sid_bh_small_pair_launch(
            p1.data_ptr(), p2.data_ptr(), m, float(alpha), out1.data_ptr(), out2.data_ptr(), 0,
            het2.data_ptr(), torch.cuda.current_stream(p1.device).cuda_stream,
        )
    _raise_on(lib, err, "BH launch")
    BH_LAUNCHES += 1


def bh_radix_order(p: torch.Tensor) -> torch.Tensor:
    """The kernels' radix order of p on a card (int64; the multi-block
    sort at any m, then its positions written out), for checks against
    ``bh_order``, its plain version. Launches are not counted: the BH path
    does not call it."""
    check_f64(p, p=p)
    out = torch.empty(p.shape[0], dtype=torch.int64, device=p.device)
    if p.shape[0] == 0:
        return out
    _check_bh(p)
    lib = _kernel_lib()
    scratch = _scratch(lib, p.shape[0], 2, p.device)
    with torch.cuda.device(p.device):
        err = lib.sid_bh_order_launch(p.data_ptr(), p.shape[0], out.data_ptr(), scratch.data_ptr(),
                                      torch.cuda.current_stream(p.device).cuda_stream)
    _raise_on(lib, err, "BH order launch")
    return out


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no device LRT kernel for device {t.device}")
    return t.device.type


# ---- tensor entry points ----

def lrt_pvalues(log_l0: torch.Tensor, log_l1: torch.Tensor) -> torch.Tensor:
    """LRT p-values of H0 (log_l0) against H1 (log_l1), f64 tensors on one
    device: lrt_pvalues_kernel (no clamp, no prior) on a card, the plain
    version on the CPU."""
    check_f64(log_l0, log_l0=log_l0, log_l1=log_l1)
    if _device_of(log_l0) == "cpu":
        return lrt_pvalues_ref(log_l0, log_l1)
    out = torch.empty_like(log_l0)
    launch_lrt(log_l1, log_l0, None, -math.inf, out)
    return out


def lrt_pair(
    log_l_hom: torch.Tensor,
    log_l_het: torch.Tensor,
    log_priors: Optional[Tuple[float, float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p1, p2) of models/likelihood_ratio.py's LRT: the clamp, the prior
    when ``log_priors`` = (log(1 - pi), log(pi)), both p-values;
    lrt_pvalues_kernel on a card, ``lrt_pair_ref`` on the CPU."""
    check_f64(log_l_hom, log_l_hom=log_l_hom, log_l_het=log_l_het)
    if _device_of(log_l_hom) == "cpu":
        return lrt_pair_ref(log_l_hom, log_l_het, log_priors)
    p1, p2 = torch.empty_like(log_l_hom), torch.empty_like(log_l_hom)
    launch_lrt(log_l_hom, log_l_het, log_priors, LONG_DOUBLE_UNDERFLOW_LOG, p1, p2)
    return p1, p2


def adjust_benjamini_hochberg(p: torch.Tensor) -> torch.Tensor:
    """BH-adjusted p (f64 tensor): on a card the hand kernels
    (``launch_bh`` with its own order); on the CPU the plain version.
    Bitwise the host BH either way."""
    check_f64(p, p=p)
    if _device_of(p) == "cpu":
        return adjust_benjamini_hochberg_ref(p)
    out = torch.empty_like(p)
    launch_bh(p, None, out)
    return out


def lrt_benjamini_hochberg(
    log_l_hom: np.ndarray,
    log_l_het: np.ndarray,
    log_priors: Optional[Tuple[float, float]],
    alpha: float,
    device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The device stage of the likelihood_ratio classification from host
    marginals: (is_het, adj_p1, adj_p2) host arrays. On a card: both logs
    into one pinned buffer and one async copy, the LRT kernel, both BH
    corrections with their own orders (``launch_bh_pair``: one launch up to
    ``BH_SMALL_MAX`` profiles; the second writing is_het = adj_p2 < alpha),
    the 17 B a profile back in one copy into pinned memory, one stream sync.
    On the CPU the plain versions."""
    device = torch.device(device)
    u = int(np.shape(log_l_hom)[0])
    if device.type != "cuda":
        p1, p2 = lrt_pair_ref(torch.from_numpy(np.ascontiguousarray(log_l_hom, np.float64)),
                              torch.from_numpy(np.ascontiguousarray(log_l_het, np.float64)), log_priors)
        adj1, adj2 = adjust_benjamini_hochberg_ref(p1).numpy(), adjust_benjamini_hochberg_ref(p2).numpy()
        return adj2 < alpha, adj1, adj2
    if u == 0:
        return np.zeros(0, bool), np.zeros(0), np.zeros(0)
    host_in = torch.empty(16 * u, dtype=torch.uint8, pin_memory=True)
    view = host_in.numpy()
    np.copyto(view[: 8 * u].view(np.float64), log_l_hom)
    np.copyto(view[8 * u :].view(np.float64), log_l_het)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        dev_in = torch.empty(16 * u, dtype=torch.uint8, device=device)
        dev_in.copy_(host_in, non_blocking=True)
        lhom, lhet = dev_in[: 8 * u].view(torch.float64), dev_in[8 * u :].view(torch.float64)
        p = torch.empty(2 * u, dtype=torch.float64, device=device)
        p1, p2 = p[:u], p[u:]
        launch_lrt(lhom, lhet, log_priors, LONG_DOUBLE_UNDERFLOW_LOG, p1, p2)
        dev_out = torch.empty(17 * u, dtype=torch.uint8, device=device)
        adj1, adj2 = dev_out[: 8 * u].view(torch.float64), dev_out[8 * u : 16 * u].view(torch.float64)
        launch_bh_pair(p1, p2, adj1, adj2, dev_out[16 * u :], alpha)
        host_out = torch.empty(17 * u, dtype=torch.uint8, pin_memory=True)
        host_out.copy_(dev_out, non_blocking=True)
        stream.synchronize()
    out = host_out.numpy()
    return out[16 * u :].astype(bool), out[: 8 * u].view(np.float64), out[8 * u : 16 * u].view(np.float64)


# ---- the reference's dead-code API (sid_tpu/ops/stats.py:119-152) ----

def adjust_bonferroni(p_values: torch.Tensor, n: int = 0) -> torch.Tensor:
    """Bonferroni correction (stats.cpp:48-56): p * n, n = len(p) when n <= 0."""
    if n <= 0:
        n = p_values.shape[0]
    return p_values * float(n)


def aic(likelihood, num_params) -> torch.Tensor:
    """Akaike information criterion (stats.cpp:10-12): 2k - 2 ln L."""
    likelihood = torch.as_tensor(likelihood, dtype=torch.float64)
    return 2.0 * torch.as_tensor(num_params, dtype=torch.float64) - 2.0 * torch.log(likelihood)


def relative_likelihoods(likelihood_pairs) -> torch.Tensor:
    """AIC-based relative likelihoods (stats.cpp:14-27) of (m, 2)
    likelihood pairs: (m, 2), the better model at 1.0."""
    a = aic(likelihood_pairs, 2.0)
    first, second = a[..., 0], a[..., 1]
    one = torch.ones_like(first)
    rel_first = torch.where(first < second, one, torch.exp((second - first) / 2.0))
    rel_second = torch.where(first < second, torch.exp((first - second) / 2.0), one)
    return torch.stack([rel_first, rel_second], dim=-1)


def log_binomial_coefficient(n, k, lgamma_tab: torch.Tensor) -> torch.Tensor:
    """ln C(n, k) through the integer-lgamma table (call.cpp:344-347)."""
    n = torch.as_tensor(n, dtype=torch.int64)
    k = torch.as_tensor(k, dtype=torch.int64)
    return lgamma_tab[n + 1] - lgamma_tab[n - k + 1] - lgamma_tab[k + 1]


def binomial_pmf(n, k, p, lgamma_tab: torch.Tensor) -> torch.Tensor:
    """Binomial pmf through the lgamma table: exp(ln C(n, k) + k ln p +
    (n - k) ln(1 - p)) (test-likelihoods.cpp:22-52's spec)."""
    n = torch.as_tensor(n, dtype=torch.int32)
    k = torch.as_tensor(k, dtype=torch.int32)
    p = torch.as_tensor(p, dtype=torch.float64)
    logc = log_binomial_coefficient(n, k, lgamma_tab)
    return torch.exp(logc + k * torch.log(p) + (n - k) * torch.log1p(-p))
