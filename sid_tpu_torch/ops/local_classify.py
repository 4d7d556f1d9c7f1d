"""The slim ``local`` classify: per-profile f64 log likelihoods (l1, l2).

``local_log_likelihoods`` is the device stage of ``-m local``. For CUDA
tensors it launches the hand-written Hopper kernel in
``csrc/local_classify.cu`` (the counterpart of sid_tpu's Pallas kernel
``ops/pallas_classify.py::local_log_likelihoods_pallas``), built with nvcc
at first use; for CPU tensors it runs ``local_log_likelihoods_ref``, the
plain torch f64 version (the counterpart of ``sid_tpu/models/local.py``'s
XLA twin ``local_log_likelihoods``). Any other device, dtype, shape or
layout raises; so does a failed build or launch.

``LAUNCHES`` counts kernel launches (not plain-version calls), so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from sid_tpu_torch.models.common import clamp_ld_underflow
from sid_tpu_torch.native import build
from sid_tpu_torch.ops import likelihoods

LAUNCHES = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def local_log_likelihoods_ref(
    profiles: torch.Tensor,
    major: torch.Tensor,
    second: torch.Tensor,
    error_threshold: float,
    lgamma_tab: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch f64 version (sid_tpu/models/local.py:71-95, term for term).

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
    return clamp_ld_underflow(l1), clamp_ld_underflow(l2)


def _check(profiles, major, second, lgamma_tab) -> None:
    if profiles.dim() != 2 or profiles.shape[1] != 4:
        raise ValueError(f"profiles must be (U, 4), got {tuple(profiles.shape)}")
    u = profiles.shape[0]
    for name, t in (("major", major), ("second", second)):
        if t.shape != (u,):
            raise ValueError(f"{name} must be ({u},), got {tuple(t.shape)}")
    if lgamma_tab.dim() != 1:
        raise ValueError("lgamma_tab must be 1-D")
    for name, t, dtype in (
        ("profiles", profiles, torch.int32),
        ("major", major, torch.int32),
        ("second", second, torch.int32),
        ("lgamma_tab", lgamma_tab, torch.float64),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != profiles.device:
            raise ValueError(f"{name} is on {t.device}, profiles on {profiles.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build.kernel_library("local_classify"))
            lib.sid_local_classify_launch.restype = ctypes.c_int
            lib.sid_local_classify_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_double, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p,
            ]
            lib.sid_cuda_error_string.restype = ctypes.c_char_p
            lib.sid_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def local_log_likelihoods(
    profiles: torch.Tensor,
    major: torch.Tensor,
    second: torch.Tensor,
    error_threshold: float,
    lgamma_tab: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l1, l2) f64 over the profiles: the CUDA kernel on a CUDA device,
    the plain version on the CPU.

    profiles (U, 4) int32, major and second (U,) int32, lgamma_tab (T,) f64
    (``ops.lgamma.lgamma_table``, T > max coverage + 1), all contiguous on
    one device.
    """
    global LAUNCHES
    _check(profiles, major, second, lgamma_tab)
    device = profiles.device
    if device.type == "cpu":
        return local_log_likelihoods_ref(profiles, major, second, error_threshold, lgamma_tab)
    if device.type != "cuda":
        raise ValueError(f"no local classify kernel for device {device}")
    if profiles.data_ptr() % 16:
        raise ValueError("profiles must be 16-byte aligned (one int4 load per row)")
    if lgamma_tab.shape[0] >= 2**31:
        raise ValueError("lgamma_tab is too long for an int index")
    u = profiles.shape[0]
    l1 = torch.empty(u, dtype=torch.float64, device=device)
    l2 = torch.empty(u, dtype=torch.float64, device=device)
    if u == 0:
        return l1, l2
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sid_local_classify_launch(
            profiles.data_ptr(), major.data_ptr(), second.data_ptr(),
            float(error_threshold), lgamma_tab.data_ptr(), lgamma_tab.shape[0],
            l1.data_ptr(), l2.data_ptr(), u, stream,
        )
    if err != 0:
        msg = lib.sid_cuda_error_string(err).decode()
        raise RuntimeError(f"local classify kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return l1, l2
