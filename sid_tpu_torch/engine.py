"""Top-level dispatch: parsed batch + options -> CallResult -> CSV.

Mirrors the reference's method dispatch (sid.cpp:92-100), including the
quirk that an unrecognized method produces no records (the CLI then prints
only the CSV header). ``options.engine`` selects the device path (default)
or the host long-double oracle. ``run`` calls a whole input in memory,
or, for ``local`` and ``quality`` on an input of at least
``PIPELINE_MIN_BYTES``, in one pass over newline-aligned chunks whose
parse overlaps the call of the chunk before (the chunk pipeline);
``run_streaming`` calls it in two passes over chunks. All three give the
same output. ``--per-shard-fit`` calls each chromosome alone
(``parallel.pipeline``); ``run_streaming`` does not read it, as sid_tpu's
does not (``ROADMAP.md`` C9). Population mode (many samples) is
``models.population`` and ``--multihost`` ``parallel.distributed``, which
the CLI dispatches to. ``--devices`` (``Options.mesh``) runs each method's
device work over a mesh of devices (``parallel.mesh``, ``parallel.fit``);
the exact engine does not read it, as sid_tpu's does not.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.exact import engine as exact_engine
from sid_tpu_torch.io.pileup import PileupBatch, parse_pileup
from sid_tpu_torch.io.stream import accumulate_histogram, iter_chunks, pack_profiles, parse_chunk, with_offsets
from sid_tpu_torch.models import bayes, common, likelihood_ratio, local, quality
from sid_tpu_torch.models.common import CSV_HEADER, CallResult
from sid_tpu_torch.models.lynch import estimate_prior_heterozygosity
from sid_tpu_torch.ops.profiles import filter_min_coverage
from sid_tpu_torch.parallel.pipeline import call_per_shard
from sid_tpu_torch.utils import checkpoint as ckpt
from sid_tpu_torch.utils import profiling

METHODS = ("local", "bayes", "likelihood_ratio", "quality")

# The chunk pipeline's size gate and chunk size, from the walls of
# scripts/pipeline_variants.py (this design: "main reads") on an NVIDIA
# H100 80GB HBM3 at 700 W with 8 host cores, medians of three runs in
# turns; chip_smoke.py phase 10b measures them again. At 1.11 GB (10M
# sites) with 128 MB chunks -m local took 1379 ms pipelined against 1494
# monolithic and -m quality 1649 against 2008 (32 MB chunks: 1465 and
# 1755); at 110 MB (1M sites, 32 MB chunks) -m local took 161 against 150.
# So the gate is the 10M-site file's size, rounded down.
PIPELINE_MIN_BYTES = 1_100_000_000
PIPELINE_CHUNK_BYTES = 128 << 20

_TABLES = {
    "device": {
        "local": local.call_local,
        "bayes": bayes.call_bayes,
        "likelihood_ratio": likelihood_ratio.call_likelihood_ratio,
        "quality": quality.call_quality,
    },
    "exact": {
        "local": exact_engine.call_local_exact,
        "bayes": exact_engine.call_bayes_exact,
        "likelihood_ratio": exact_engine.call_likelihood_ratio_exact,
        "quality": exact_engine.call_quality_exact,
    },
}


def call_batch(
    batch: PileupBatch,
    options: Options,
    diag: Optional[Callable[[str], None]] = None,
) -> Optional[CallResult]:
    """Dispatch one parsed batch to the selected method implementation;
    None for an unknown method (header-only output, sid.cpp:92-102).
    ``--per-shard-fit`` calls each chromosome alone (sid_tpu/engine.py:51-54)."""
    fn = _TABLES[options.engine].get(options.method)
    if fn is None:
        return None
    if options.per_shard_fit:
        return call_per_shard(batch, options, fn, diag)
    return fn(batch, options, diag)


@profiling.in_request
def run(
    src,
    options: Optional[Options] = None,
    diag: Optional[Callable[[str], None]] = None,
    binary: bool = False,
):
    """Parse + call + serialize: the whole tool as a function returning CSV.

    ``src`` is a path, bytes or a binary file object. ``binary=True``
    returns the native serializer's bytes (the CLI's path); default
    returns str. ``-m quality`` parses both quality columns: terms only
    under the device engine, the per-read arrays for the exact engine.
    Bytes and paths of at least ``PIPELINE_MIN_BYTES`` (a ``.gz`` path by
    its size on disk) take the chunk pipeline where ``_pipeline_eligible``
    allows it (sid_tpu/engine.py:72-78); a file object never does.
    """
    options = options or Options()
    if isinstance(src, (bytes, bytearray)) and _pipeline_eligible(options, len(src)):
        return _run_pipelined_single_pass(bytes(src), options, diag, binary, PIPELINE_CHUNK_BYTES)
    if isinstance(src, (str, os.PathLike)) and _pipeline_eligible(options, os.path.getsize(src)):
        return _run_pipelined_single_pass(src, options, diag, binary, PIPELINE_CHUNK_BYTES)
    return _run_monolithic(src, options, diag, binary)


def _run_monolithic(src, options: Options, diag, binary: bool):
    """``run`` on the whole input at once: one parse, one call, one CSV."""
    needs_reads = options.method == "quality"
    with profiling.maybe_stage("parse"):
        batch = parse_pileup(
            src, needs_reads, needs_reads, backend=options.io_backend,
            quality_terms_only=needs_reads and options.engine == "device",
        )
    profiling.count("sites", batch.num_sites)
    with profiling.maybe_stage("call"):
        result = call_batch(batch, options, diag)
    if result is None:
        header = CSV_HEADER + "\n"
        return header.encode() if binary else header
    with profiling.maybe_stage("serialize"):
        return result.to_csv_bytes() if binary else result.to_csv()


def _pipeline_eligible(options: Options, size: int) -> bool:
    """Methods whose calls are independent per chunk (no fitted prior, no
    per-shard fit) on the device engine, at ``PIPELINE_MIN_BYTES`` or more
    (sid_tpu/engine.py:313-320; ``--devices`` does not exclude it)."""
    return (
        options.method in ("local", "quality")
        and not options.estimate_prior
        and not options.per_shard_fit
        and options.engine == "device"
        and size >= PIPELINE_MIN_BYTES
    )


def _run_pipelined_single_pass(src, options: Options, diag, binary: bool, chunk_bytes: int):
    """The chunk pipeline (sid_tpu/engine.py:271-310): one worker thread
    parses chunk k+1 (libsidtpu's parser releases the GIL) while this
    thread calls chunk k on the device and serializes it; the parts are
    joined after the header, byte-equal to ``_run_monolithic``. The worker
    touches neither CUDA nor a pinned buffer. Under ``--profile`` the pass
    is one top-level ``pipeline`` stage and the join of the parts a
    top-level ``join`` after it. This thread's spans nest in ``pipeline``
    and follow each other: ``pipeline:read`` (each next chunk from the
    input, and the read that finds its end), ``pipeline:parse_wait``,
    ``pipeline:call`` and ``pipeline:serialize``; the worker's parse of
    each chunk, ``worker:parse``, hangs under ``pipeline`` too. A chunk's
    part is the writer's buffer as it is (``CallResult.to_csv_buffer``;
    decoded in text mode), its length added to the counter
    ``serialize:bytes``; the join copies each part once. A parse
    error names the file's line; it is raised here after the worker's
    parse of the next chunk ends."""
    needs_reads = options.method == "quality"

    def read():
        with profiling.maybe_stage("pipeline:read"):
            return next(chunks, None)

    def parse(offset, chunk):
        with adopt(), profiling.maybe_stage("worker:parse"):
            return parse_chunk(src, offset, chunk, needs_reads, needs_reads, backend=options.io_backend,
                               quality_terms_only=needs_reads)

    def process(fut):
        with profiling.maybe_stage("pipeline:parse_wait"):
            batch = fut.result()
        profiling.count("sites", batch.num_sites)
        if batch.num_sites == 0:
            return b"" if binary else ""
        with profiling.maybe_stage("pipeline:call"):
            result = call_batch(batch, options, diag)
        with profiling.maybe_stage("pipeline:serialize"):
            part = result.to_csv_buffer(include_header=False)
            if not binary:
                part = str(part, "latin1")
        profiling.count("serialize:bytes", len(part))
        return part

    header = CSV_HEADER + "\n"
    parts = [header.encode() if binary else header]
    with profiling.maybe_stage("pipeline"), ThreadPoolExecutor(1) as ex:
        adopt = profiling.handover()
        chunks = with_offsets(iter_chunks(src, chunk_bytes))
        located = read()
        if located is None:
            return parts[0]
        fut = ex.submit(parse, *located)
        while (located := read()) is not None:
            nxt = ex.submit(parse, *located)
            parts.append(process(fut))
            fut = nxt
        parts.append(process(fut))
    with profiling.maybe_stage("join"):
        out = (b"" if binary else "").join(parts)
        parts.clear()  # the chunks' parts are freed here, inside the span
    return out


@dataclasses.dataclass
class ClassTable:
    """What pass 1 of a two-pass run gives pass 2: the sorted packed keys
    and per-class arrays (is_het, major, second, conf_hom, conf_het) that
    chunks are joined through, or for ``quality`` (a per-site method) the
    options each chunk is called with, the -R prior fixed."""

    options: Options
    keys: Optional[np.ndarray] = None
    cls: Optional[tuple] = None
    conf_type: str = "p_value"


def class_table(profiles, mult, options: Options, diag=None) -> ClassTable:
    """Pass 1's table from the whole input's histogram (profiles, mult):
    ``local`` through the classify kernel, bayes and likelihood_ratio
    through the fit over the cov >= 4 profiles, ``quality`` only its -R
    prior (no histogram needed without -R: pass None)."""
    method = options.method
    snp_prior = options.snp_prior
    if method == "quality":  # no fit or classify: outside the stage
        if options.estimate_prior:
            snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)
        return ClassTable(dataclasses.replace(options, estimate_prior=False, snp_prior=snp_prior))
    with profiling.maybe_stage("fit+classify"):
        if method == "local":
            if options.estimate_prior:
                snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)
            cls = local.classify_profiles_local(profiles, options, snp_prior)
            return ClassTable(options, pack_profiles(profiles), cls)
        fprof, fmult, _ = filter_min_coverage(profiles, mult, 4)
        if method == "bayes":
            cls = bayes.classify_profiles_bayes(fprof, fmult, options, diag)
            return ClassTable(options, pack_profiles(fprof), cls, "probability")
        cls = likelihood_ratio.classify_profiles_lr(fprof, fmult, options, diag)
        return ClassTable(options, pack_profiles(fprof), cls)


def call_chunk(batch: PileupBatch, table: ClassTable) -> CallResult:
    """Pass 2 on one parsed chunk: ``quality`` calls it, the other methods
    join it through the class table."""
    if table.cls is None:
        return quality.call_quality(batch, table.options)
    return common.join_class_table(batch, table.keys, table.cls, table.conf_type)


@profiling.in_request
def run_streaming(
    src,
    options: Optional[Options] = None,
    out=None,
    diag: Optional[Callable[[str], None]] = None,
    chunk_bytes: int = 64 << 20,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    progress=None,
) -> int:
    """Memory-bounded whole-genome calling (sid_tpu/engine.py:100-250).

    Pass 1 folds chunks into the unique-profile histogram (the fit's
    sufficient statistic); the per-class table is computed once (``local``
    through the classify kernel, bayes and likelihood_ratio through the fit
    of the run's backend); pass 2 re-parses chunk by chunk and appends CSV
    rows joined through a packed-key binary search (``quality`` calls each
    chunk, which runs its finalize kernel). The output is the in-memory
    path's, byte for byte, including the global BH correction and the cov>=4
    omission. Returns the number of records written. The fit is global
    under ``per_shard_fit`` too: sid_tpu's run_streaming does not read it
    (``ROADMAP.md`` C9), and this one follows its bytes.

    ``src`` is a path or bytes (read twice). ``checkpoint`` persists the
    pass-1 histogram (.npz) so reruns with ``resume=True`` skip pass 1;
    ``progress`` (a ``utils.checkpoint.StreamProgress``) adds chunk-level
    pass-2 resume for file outputs. ``out`` is a binary or text file object
    (default: stdout). An unknown method writes the header alone.
    """
    if not isinstance(src, (str, bytes, os.PathLike)):
        raise TypeError("run_streaming needs a re-readable source (path or bytes)")
    options = options or Options()
    out = out or sys.stdout
    is_binary = "b" in getattr(out, "mode", "") or isinstance(
        out, (_io.RawIOBase, _io.BufferedIOBase)
    )
    # binary sinks take the serializer's bytes untranscoded; text sinks decode
    write = out.write if is_binary else (lambda b: out.write(str(b, "latin1")))
    method = options.method

    start_chunk = 0
    if progress is not None and resume:
        start_chunk, bytes_written = progress.load()
        if start_chunk > 0:
            out.seek(bytes_written)
            out.truncate()
        else:
            # absent or corrupt sidecar: restart, dropping any stale output
            try:
                out.seek(0)
                out.truncate()
            except (OSError, ValueError):
                pass
    if start_chunk == 0:
        write((CSV_HEADER + "\n").encode())
    if method not in METHODS:
        return 0  # header-only, like the reference's unknown-method path

    def histogram():
        fp = ckpt.input_fingerprint(src) if checkpoint else ""
        if checkpoint and resume:
            state = ckpt.load_fit_state(checkpoint, fingerprint=fp)
            if state is not None:
                return state["profiles"], state["mult"]
        with profiling.maybe_stage("histogram"):
            profiles, mult, _ = accumulate_histogram(src, chunk_bytes, options.io_backend)
        if checkpoint:
            ckpt.save_fit_state(checkpoint, profiles, mult, fingerprint=fp)
        return profiles, mult

    # ---- pass 1: histogram and the per-class table (quality: only -R) ----
    needs_histogram = method != "quality" or options.estimate_prior
    profiles, mult = histogram() if needs_histogram else (None, None)
    table = class_table(profiles, mult, options, diag)

    # ---- pass 2: classify or join chunk by chunk ----
    needs_reads = method == "quality"
    emitted = 0
    for chunk_no, (offset, chunk) in enumerate(with_offsets(iter_chunks(src, chunk_bytes))):
        if chunk_no < start_chunk:
            continue
        with profiling.maybe_stage("parse"):
            batch = parse_chunk(src, offset, chunk, needs_reads, needs_reads, backend=options.io_backend,
                                quality_terms_only=needs_reads)
        profiling.count("sites", batch.num_sites)
        if batch.num_sites == 0:
            continue
        with profiling.maybe_stage("call"):
            res = call_chunk(batch, table)
        with profiling.maybe_stage("serialize"):
            write(res.to_csv_buffer(include_header=False))
        emitted += res.num_records
        if progress is not None:
            out.flush()
            progress.save(chunk_no + 1, out.tell())
    if progress is not None:
        progress.finish()
    return emitted
