"""Multi-host scale-out on torch.distributed: byte-range sharding, the
all-gathered histogram, the ordered merge (``sid_tpu/parallel/distributed.py``).

Each process parses its newline-aligned byte ranges of the pileup; the
unique-profile histograms are all-gathered (gloo, on the host) and merged
so every process computes the identical global fit and class table; each
process writes its own coordinate-ordered CSV part, and process 0
concatenates the parts in range order. The only payloads between processes
are the histograms and one flag; the device work (classify, fit, finalize)
runs in each process on its own torch device.

Processes meet at ``SIDTPU_COORDINATOR`` (host:port of process 0), as
``SIDTPU_NUM_PROCESSES`` processes numbered by ``SIDTPU_PROCESS_ID``. One
process (or none initialized) degenerates to the local pipeline.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sid_tpu_torch import engine
from sid_tpu_torch.config import Options
from sid_tpu_torch.io.pileup import parse_pileup
from sid_tpu_torch.io.stream import (
    accumulate_histogram_chunks,
    iter_range_chunks,
    pack_profiles,
    unpack_profiles,
)
from sid_tpu_torch.models.common import CSV_HEADER
from sid_tpu_torch.utils import checkpoint as ckpt
from sid_tpu_torch.utils import profiling


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """torch.distributed bring-up: a gloo group over
    ``tcp://coordinator_address``.

    torch has no cluster auto-detection, so with no arguments the run is
    one process, with a warning; that escalates to an error when the
    environment asked for several (SIDTPU_NUM_PROCESSES > 1): a silently
    degraded wrong-world-size run is worse than no run. A failure with
    explicit arguments is fatal.
    """
    if coordinator_address is None and num_processes is None:
        reason = "no coordinator address (SIDTPU_COORDINATOR) and no process count"
        env_n = os.environ.get("SIDTPU_NUM_PROCESSES")
        if env_n and int(env_n) > 1:
            raise RuntimeError(
                "torch.distributed auto-initialization failed but "
                f"SIDTPU_NUM_PROCESSES={env_n} requested a multi-process run: {reason}"
            )
        logging.getLogger("sid_tpu_torch.distributed").warning(
            "torch.distributed auto-initialization failed (%s); continuing single-process", reason,
        )
        return
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
    except Exception as exc:
        raise RuntimeError(
            "torch.distributed initialization failed for coordinator="
            f"{coordinator_address!r} num_processes={num_processes} "
            f"process_id={process_id}: {exc}"
        ) from exc


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def byte_ranges(path: str, n: int) -> List[Tuple[int, int]]:
    """Split a file into n newline-aligned (start, end) byte ranges."""
    size = os.path.getsize(path)
    if n <= 1 or size == 0:
        return [(0, size)]
    bounds = [0]
    with open(path, "rb") as f:
        for k in range(1, n):
            guess = size * k // n
            if guess <= bounds[-1]:
                continue
            f.seek(guess)
            f.readline()  # advance to the next newline
            b = f.tell()
            if b > bounds[-1] and b < size:
                bounds.append(b)
    bounds.append(size)
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def merge_histograms(parts: List[Tuple[np.ndarray, np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
    """Merge (profiles, mult) histograms: (profiles (U,4) int32 sorted,
    mult (U,) int64), by packed profile key. Population mode's pooled fit
    runs on the merge of its samples' histograms."""
    keys = np.concatenate([pack_profiles(p) for p, _ in parts]) if parts else np.zeros(0, np.uint64)
    weights = np.concatenate([m for _, m in parts]) if parts else np.zeros(0, np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    mult = np.zeros(uniq.shape[0], np.int64)
    np.add.at(mult, inv, weights.astype(np.int64))
    return unpack_profiles(uniq), mult


def _allgather(values: np.ndarray) -> np.ndarray:
    """(k,) int64 from every process -> (P, k), in process order."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.int64))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allgather_histogram(profiles: np.ndarray, mult: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All-gather every process's histogram and merge; the same merged
    histogram on every process. Each is padded to the largest U; the
    uint64 keys travel as their int64 view."""
    if process_count() == 1:
        return merge_histograms([(profiles, mult)])
    u = profiles.shape[0]
    u_all = _allgather(np.array([u]))[:, 0]
    u_max = max(int(u_all.max()), 1)
    keys = np.zeros(u_max, np.uint64)
    keys[:u] = pack_profiles(profiles)
    mults = np.zeros(u_max, np.int64)
    mults[:u] = mult
    keys_all = _allgather(keys.view(np.int64)).view(np.uint64)
    mults_all = _allgather(mults)
    return merge_histograms(
        [(unpack_profiles(keys_all[p, :k]), mults_all[p, :k]) for p, k in enumerate(u_all)]
    )


def _all_true(flag: bool) -> bool:
    if process_count() == 1:
        return flag
    return bool(_allgather(np.array([int(flag)])).min() == 1)


def _part_path(out_path: str, start: int) -> str:
    return f"{out_path}.part{start:016d}"


def run_multihost(
    path: str,
    options: Options,
    out_path: str,
    diag=None,
    ranges_per_process: int = 1,
) -> Optional[str]:
    """Data-parallel calling over byte ranges of one pileup file.

    Every process: fold its ranges' chunks into a histogram -> all-gather
    and merge -> the identical global class table -> call its ranges chunk
    by chunk -> write its part files. After a barrier, process 0
    concatenates the parts in range order and returns the output path; the
    others return None. Memory is bounded by the chunk size
    (``options.chunk_mb``, or ``SIDTPU_CHUNK_BYTES``).

    ``--checkpoint`` keeps the merged histogram (keyed by the input's
    fingerprint); under ``--resume`` pass 1 and the all-gather are skipped
    only when every process loaded it (the decision is itself all-gathered,
    so no process waits on a collective the others skip), and a range
    whose part and ``.done`` marker (holding the fingerprint and the
    range's end) exist is not called again.
    """
    engine.check_ported(options)
    pid = process_index()
    nproc = process_count()
    ranges = byte_ranges(path, nproc * ranges_per_process)
    my_ranges = [r for i, r in enumerate(ranges) if i % nproc == pid]
    method = options.method
    if method not in engine.METHODS:
        raise ValueError(f"run_multihost does not support method {method!r}")
    chunk_bytes = int(os.environ.get("SIDTPU_CHUNK_BYTES", options.chunk_mb << 20))
    fp = ckpt.input_fingerprint(path) if options.checkpoint or options.resume else ""

    # ---- pass 1: the global histogram (quality: only under -R) ----
    profiles = mult = None
    if method != "quality" or options.estimate_prior:
        loaded = None
        if options.checkpoint and options.resume:
            state = ckpt.load_fit_state(options.checkpoint, fingerprint=fp)
            if state is not None:
                loaded = (state["profiles"], state["mult"])
        if _all_true(loaded is not None):
            profiles, mult = loaded
        else:
            with profiling.maybe_stage("histogram"):
                chunks = (c for start, end in my_ranges
                          for c in iter_range_chunks(path, start, end, chunk_bytes))
                lp, lm, _ = accumulate_histogram_chunks(chunks, options.io_backend)
                profiles, mult = allgather_histogram(lp, lm)
            if options.checkpoint and pid == 0:
                ckpt.save_fit_state(options.checkpoint, profiles, mult, fingerprint=fp)
    table = engine.class_table(profiles, mult, options, diag)

    # ---- pass 2: call my ranges chunk by chunk into .tmp parts ----
    needs_reads = method == "quality"
    for start, end in my_ranges:
        part = _part_path(out_path, start)
        done = part + ".done"
        # the marker holds the range's end too: a part of a run with other
        # ranges that starts where this range starts is not this range (C11)
        marker = f"{fp} {end}"
        if options.resume and os.path.exists(done) and os.path.exists(part):
            with open(done) as df:
                if df.read().strip() == marker:
                    continue
        tmp = part + ".tmp"
        with open(tmp, "wb") as f:
            for chunk in iter_range_chunks(path, start, end, chunk_bytes):
                with profiling.maybe_stage("parse"):
                    batch = parse_pileup(chunk, needs_reads, needs_reads, backend=options.io_backend,
                                         quality_terms_only=needs_reads)
                with profiling.maybe_stage("call"):
                    res = engine.call_chunk(batch, table)
                with profiling.maybe_stage("serialize"):
                    f.write(res.to_csv_bytes(include_header=False))
        os.replace(tmp, part)
        with open(done, "w") as df:
            df.write(marker)

    if nproc > 1:
        dist.barrier()
    if pid != 0:
        return None

    # ordered merge: only the parts of this run's ranges (a stale part of an
    # aborted run with other ranges is never picked up), streamed
    with profiling.maybe_stage("merge"), open(out_path, "wb") as f:
        f.write((CSV_HEADER + "\n").encode())
        for start, _ in ranges:
            part = _part_path(out_path, start)
            with open(part, "rb") as pf:
                shutil.copyfileobj(pf, f, 8 << 20)
            os.remove(part)
            try:
                os.remove(part + ".done")
            except OSError:
                pass
    return out_path
