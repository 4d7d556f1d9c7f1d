"""Loader of the native host library (libsidtpu).

The library implements the mpileup grammar of ``io.pileup_py`` with a
multithreaded byte-range scanner, plus the dedup, libm LRT, long-double
classifier and ``%g`` writers. It is built at first use from the shared
source (``native.build.host_library``) and loaded once per process; a
failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from sid_tpu_torch.native import bridge, build

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The configured library, building it first when it is stale."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bridge.configure(ctypes.CDLL(build.host_library()))
        return _lib
