"""Build sid_tpu's host library once, before any test worker starts.

``sid_tpu/io/native.py`` builds ``sid_tpu/native/libsidtpu.so`` at first use,
straight onto its final path and with no lock, and keeps a failed load for the
life of the process. Under pytest-xdist several workers can then build at once,
and a worker that opens a half-written library loses every native test it runs.

Pytest loads this file in the xdist controller before it starts the workers,
so the library is built here, once, by ``sid_tpu/native/build.py`` (the JAX
package's own build command, run as a script: it imports neither jax nor
``sid_tpu``), under a file lock beside the library. Workers never build. A
failed build is reported on stderr and the session runs on, as it would
without this file.
"""

import fcntl
import os
import subprocess
import sys

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sid_tpu", "native")
_LIB = os.path.join(_NATIVE, "libsidtpu.so")


def _build_libsidtpu() -> None:
    with open(_LIB + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB):
            return
        proc = subprocess.run([sys.executable, os.path.join(_NATIVE, "build.py")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"conftest: building libsidtpu.so failed:\n{proc.stderr}", file=sys.stderr)


if "PYTEST_XDIST_WORKER" not in os.environ and not os.path.exists(_LIB):
    _build_libsidtpu()
