"""Build the host library (g++) and the CUDA kernels (nvcc) at first use.

The host library is compiled from the port's own copy of sid_tpu's host
C++ (``csrc/host/parser.cpp`` and ``fmt_g_pow10.h``, line for line
``sid_tpu/native/``'s but for one comment, which a test checks), with the flags of
``sid_tpu/native/build.py`` (``-ffp-contract=off`` keeps per-operation IEEE
rounding), into ``sid_tpu_torch/_build/libsidtpu.so``. The port's own
indexed CSV writer (``csrc/host/csv_writer.cpp``, no copy of sid_tpu's) is
built with the same flags into ``libsidtpu_csv.so``. Each kernel source in
``sid_tpu_torch/csrc`` is compiled for Hopper (``sm_90a``) into a shared
library of its own with a plain C interface, loaded with ctypes;
``kernel_libraries`` starts one nvcc per source, all at once. Each output is
rebuilt when the hash of its sources and command changes. A file lock per
output serialises concurrent builds of it (test workers), and a failed
build raises.

    python -m sid_tpu_torch.native.build          # host libraries
    python -m sid_tpu_torch.native.build --cuda   # and the kernels
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG, "_build")
CSRC = os.path.join(PKG, "csrc")

HOST_SRC = os.path.join(CSRC, "host", "parser.cpp")
HOST_DEPS = [HOST_SRC, os.path.join(CSRC, "host", "fmt_g_pow10.h")]
HOST_LIB = os.path.join(BUILD_DIR, "libsidtpu.so")

CSV_SRC = os.path.join(CSRC, "host", "csv_writer.cpp")
CSV_DEPS = [CSV_SRC]
CSV_LIB = os.path.join(BUILD_DIR, "libsidtpu_csv.so")

# kernel name -> the headers its source (csrc/<name>.cu) includes
KERNELS = {
    "local_classify": ["local_classify.cuh", "lrt.cuh"],
    "lynch": ["lynch.cuh", "local_classify.cuh", "lrt.cuh", "nmsimplex.cuh"],
    "quality_finalize": ["quality_finalize.cuh", "local_classify.cuh", "lrt.cuh"],
    "lrt_bh": ["lrt_bh.cuh", "bh_sort.cuh", "lrt.cuh"],
}


def _host_cmd(out: str, src: str = HOST_SRC) -> List[str]:
    return [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-ffp-contract=off", "-march=native", "-o", out, src,
    ]


def _csv_cmd(out: str) -> List[str]:
    return _host_cmd(out, CSV_SRC)


def _cpu_fingerprint() -> str:
    """The CPU model and feature flags: ``-march=native`` output is only
    valid on a CPU like the one that built it."""
    keep = ("model name", "flags")
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(keep)]
    except OSError:
        return platform.machine()
    return "".join(sorted(set(lines)))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def kernel_paths(name: str):
    """(library, compiler log) of kernel ``name``; the log keeps ptxas's
    register and spill report."""
    lib = os.path.join(BUILD_DIR, f"libsid_{name}.so")
    return lib, lib[: -len(".so")] + ".log"


def nvcc_command(src: str, out: str, extra: Optional[List[str]] = None) -> List[str]:
    """The nvcc command that builds ``src`` for Hopper into the shared
    library ``out`` with the kernels' flags (ptxas's register report on)."""
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
        # no fused multiply-add: the kernel's mul/add sequence must round
        # like the host and torch f64 compositions it is held against
        "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", *(extra or []), "-o", out, src,
    ]


def _kernel_cmd(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    return lambda out: nvcc_command(src, out)


def _digest(deps: List[str], cmd: List[str], salt: str) -> str:
    h = hashlib.sha256()
    for path in deps:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(cmd + [salt]).encode())
    return h.hexdigest()


def _build(out: str, deps: List[str], make_cmd, log: str = "", salt: str = "") -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    stamp = out + ".sha256"
    # the command with a placeholder output, since builds go to a temp name
    want = _digest(deps, make_cmd("OUT"), salt)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out) and os.path.exists(stamp):
                with open(stamp) as f:
                    if f.read().strip() == want:
                        return out
            tmp = f"{out}.tmp{os.getpid()}"
            proc = subprocess.run(make_cmd(tmp), capture_output=True, text=True)
            if log:
                with open(log, "w") as f:
                    f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"build of {os.path.basename(out)} failed "
                    f"(exit {proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, out)
            with open(stamp, "w") as f:
                f.write(want + "\n")
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def host_library() -> str:
    """Path of libsidtpu.so, built from ``csrc/host`` when stale or built on
    another CPU."""
    return _build(HOST_LIB, HOST_DEPS, _host_cmd, salt=_cpu_fingerprint())


def csv_library() -> str:
    """Path of libsidtpu_csv.so (the in-place indexed CSV writer), built
    from ``csrc/host/csv_writer.cpp`` when stale or built on another CPU."""
    return _build(CSV_LIB, CSV_DEPS, _csv_cmd, salt=_cpu_fingerprint())


def kernel_deps(name: str) -> List[str]:
    """The sources kernel ``name``'s library is built from."""
    return [os.path.join(CSRC, f) for f in [f"{name}.cu"] + KERNELS[name]]


def kernel_library(name: str) -> str:
    """Path of kernel ``name``'s library, built with nvcc when stale."""
    lib, log = kernel_paths(name)
    return _build(lib, kernel_deps(name), _kernel_cmd(name), log=log)


def kernel_libraries() -> Dict[str, str]:
    """Every kernel library, the stale ones built by one nvcc each, all
    started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = {name: pool.submit(kernel_library, name) for name in KERNELS}
        return {name: fut.result() for name, fut in futures.items()}


if __name__ == "__main__":
    print(host_library())
    print(csv_library())
    if "--cuda" in sys.argv[1:]:
        for path in kernel_libraries().values():
            print(path)
