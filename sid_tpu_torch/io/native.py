"""Loaders of the native host libraries (libsidtpu, libsidtpu_csv).

The library implements the mpileup grammar of ``io.pileup_py`` with a
multithreaded byte-range scanner, plus the dedup, libm LRT, long-double
classifier and ``%g`` writers. It is built at first use from the shared
source (``native.build.host_library``) and loaded once per process; a
failed build raises. ``csv_writer`` loads the port's in-place indexed CSV
writer the same way (``native.build.csv_library``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from sid_tpu_torch.native import bridge, build

_lib: Optional[ctypes.CDLL] = None
_csv: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The configured library, building it first when it is stale."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bridge.configure(ctypes.CDLL(build.host_library()))
        return _lib


def csv_writer() -> ctypes.CDLL:
    """The configured in-place indexed CSV writer, built first when it is
    stale."""
    global _csv
    with _lock:
        if _csv is None:
            _csv = bridge.configure_csv(ctypes.CDLL(build.csv_library()))
        return _csv
