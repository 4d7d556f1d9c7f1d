#!/usr/bin/env python3
"""Variants of the local classify kernel, timed in turns on one CUDA card.

    python3 scripts/local_classify_variants.py [--parent DIR]

Each variant is sid_tpu_torch/csrc/local_classify.cu with one design
choice taken out or changed by a text substitution, built with the port's
nvcc flags into sid_tpu_torch/_build/ and checked bitwise against the
unchanged kernel at chip_smoke.py's U = 1M profiles (-E 0.1, prior 1e-3).
The device-only time of each (chip_smoke.device_only_ms) is read in two
rounds, the second in reverse order; with --parent, the parent tree's
kernel (chip_smoke.parent_local_kernel) runs first and last.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BOUNDS = "constexpr int kMinBlocks = 5;"
STAGE = "  for (int k = threadIdx.x; k < head_len; k += kThreads) cp_async8(head + k, tab + k);\n"
TABLE = "  const sid::StagedTable table{head, head_len, tab, tab_len};\n"
PREFETCH = "    const uint2 row = next;\n    if (i + stride < n) next = __ldg(counts + i + stride);\n"

# name -> [(text, replacement)]
VARIANTS = {
    "as committed": [],
    "launch bounds 4 blocks": [(BOUNDS, "constexpr int kMinBlocks = 4;")],
    "launch bounds 6 blocks": [(BOUNDS, "constexpr int kMinBlocks = 6;")],
    "no launch-bound minimum": [(BOUNDS, "constexpr int kMinBlocks = 1;")],
    "128-thread blocks, 10 an SM": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
                                    (BOUNDS, "constexpr int kMinBlocks = 10;")],
    "no shared-memory table": [(STAGE, ""), (TABLE, "  const sid::GlobalTable table{tab, tab_len};\n")],
    "no prefetch": [(PREFETCH, "    const uint2 row = __ldg(counts + i);\n")],
    "no table, no prefetch": [(STAGE, ""), (TABLE, "  const sid::GlobalTable table{tab, tab_len};\n"),
                              (PREFETCH, "    const uint2 row = __ldg(counts + i);\n")],
}


def build_variant(build, name: str, edits) -> tuple:
    with open(os.path.join(build.CSRC, "local_classify.cu")) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"{name}: the text to replace is not in the source once: {old!r}")
        src = src.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    path = os.path.join(build.BUILD_DIR, f"variant_{tag}.cu")
    out = path[:-3] + ".so"
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    proc = subprocess.run(
        [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", build.CSRC, "-o", out, path],
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"{name} does not build: {proc.stderr}")
    return out, proc.stdout + proc.stderr


def main() -> int:
    import torch

    import chip_smoke
    from sid_tpu_torch.models import common
    from sid_tpu_torch.native import build
    from sid_tpu_torch.ops import local_classify
    from sid_tpu_torch.ops.lgamma import lgamma_table

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked tree of the parent commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {name: pool.submit(build_variant, build, name, edits) for name, edits in VARIANTS.items()}
        built = {name: fut.result() for name, fut in futures.items()}

    prof = chip_smoke.kernel_profiles()
    u = prof.shape[0]
    counts_np, hi = local_classify.narrow_counts(prof)
    tab = lgamma_table(4 * hi, dev)
    sets = [torch.from_numpy(np.ascontiguousarray(np.roll(counts_np, 7919 * k, 0)).view(np.int16)).to(dev)
            for k in range(chip_smoke.INPUT_SETS)]
    every, k, prior = common.long_double_screen(0.1, 1e-3)
    params = (ctypes.c_double * 6)(0.1, common.LN4, k, prior, common.LD_LOG_MAX, -common.LD_LOG_MIN)
    out = torch.empty(17 * u, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    launches = {}
    for name, (path, log) in built.items():
        lib = ctypes.CDLL(path)
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sid_local_classify_launch.restype = i32
        lib.sid_local_classify_launch.argtypes = [p, ctypes.c_int64, p, i32, p, i32, p, i32, p]
        lib.sid_local_classify_resident_blocks.restype = i32
        lib.sid_local_classify_resident_blocks.argtypes = [p]
        resident = ctypes.c_int(0)
        if lib.sid_local_classify_resident_blocks(ctypes.byref(resident)):
            raise AssertionError(f"{name}: occupancy query failed")

        def launch(c, lib=lib, resident=resident.value):
            err = lib.sid_local_classify_launch(c.data_ptr(), u, params, int(every), tab.data_ptr(), tab.shape[0],
                                                out.data_ptr(), resident, torch.cuda.current_stream().cuda_stream)
            if err:
                raise AssertionError(f"launch failed ({err})")

        launches[name] = launch
        for fn, r in chip_smoke.ptxas_report(log).items():
            print(f"# {name}: {r['registers']} registers, {r['spill_stores']} bytes spill stores, "
                  f"{resident.value // sms} blocks an SM", flush=True)
    want = None
    for name, launch in launches.items():
        launch(sets[0])
        torch.cuda.synchronize()
        got = out.cpu().numpy()
        if want is None:
            want = got
        elif not np.array_equal(got, want):
            raise AssertionError(f"{name} differs from the committed kernel")

    order = list(launches.items())
    turns = order + order[::-1]
    if args.parent:
        plib, _, _ = chip_smoke.parent_local_kernel(build, args.parent)
        old = []
        for kk in range(chip_smoke.INPUT_SETS):
            p_k = np.roll(prof, 7919 * kk, 0)
            m_k, s_k = common.major_allele_indices_np(p_k)
            old.append([torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (p_k, m_k, s_k)])
        l12 = torch.empty(2 * u, dtype=torch.float64, device=dev)

        def parent_launch(i):
            pk, mk, sk = old[i]
            err = plib.sid_local_classify_launch(pk.data_ptr(), mk.data_ptr(), sk.data_ptr(), 0.1, tab.data_ptr(),
                                                 tab.shape[0], l12.data_ptr(), l12[u:].data_ptr(), u,
                                                 torch.cuda.current_stream().cuda_stream)
            if err:
                raise AssertionError(f"the parent's kernel did not launch ({err})")

        parent = ("parent", parent_launch)
        turns = [parent] + turns + [parent]
    index_sets = [(i,) for i in range(chip_smoke.INPUT_SETS)]
    readings = {}
    for name, fn in turns:
        arg_sets = index_sets if name == "parent" else [(s,) for s in sets]
        readings.setdefault(name, []).append(chip_smoke.device_only_ms(torch, fn, arg_sets))
    for name, ts in readings.items():
        print(f"# {name}: device only {statistics.median(ts):.4f} ms at U={u} (readings "
              f"{', '.join(f'{t:.4f}' for t in ts)}); on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
