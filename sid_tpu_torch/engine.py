"""Top-level dispatch: parsed batch + options -> CallResult -> CSV.

Mirrors the reference's method dispatch (sid.cpp:92-100), including the
quirk that an unrecognized method produces no records (the CLI then prints
only the CSV header). ``options.engine`` selects the device path (default)
or the host long-double oracle. ``run`` calls a whole input in memory;
``run_streaming`` calls it in two passes over newline-aligned chunks, with
the same output. ``--per-shard-fit`` calls each chromosome alone
(``parallel.pipeline``); ``run_streaming`` does not read it, as sid_tpu's
does not (``ROADMAP.md`` C9). Population mode (many samples) is
``models.population`` and ``--multihost`` ``parallel.distributed``, which
the CLI dispatches to. ``--devices``, which this package does not run yet,
raises ``NotPortedError`` instead of doing something else.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
import sys
from typing import Callable, Optional

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.exact import engine as exact_engine
from sid_tpu_torch.io.pileup import PileupBatch, parse_pileup
from sid_tpu_torch.io.stream import accumulate_histogram, iter_chunks, pack_profiles
from sid_tpu_torch.models import bayes, common, likelihood_ratio, local, quality
from sid_tpu_torch.models.common import CSV_HEADER, CallResult
from sid_tpu_torch.models.lynch import estimate_prior_heterozygosity
from sid_tpu_torch.ops.profiles import filter_min_coverage
from sid_tpu_torch.parallel.pipeline import call_per_shard
from sid_tpu_torch.utils import checkpoint as ckpt
from sid_tpu_torch.utils import profiling
from sid_tpu_torch.utils.errors import NotPortedError

METHODS = ("local", "bayes", "likelihood_ratio", "quality")

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


def check_ported(options: Options) -> None:
    """Raise NotPortedError for an option this package cannot run yet:
    ``--devices``."""
    if options.mesh_devices is not None:
        raise NotPortedError("--devices")


def call_batch(
    batch: PileupBatch,
    options: Options,
    diag: Optional[Callable[[str], None]] = None,
) -> Optional[CallResult]:
    """Dispatch one parsed batch to the selected method implementation;
    None for an unknown method (header-only output, sid.cpp:92-102).
    ``--per-shard-fit`` calls each chromosome alone (sid_tpu/engine.py:51-54)."""
    check_ported(options)
    fn = _TABLES[options.engine].get(options.method)
    if fn is None:
        return None
    if options.per_shard_fit:
        return call_per_shard(batch, options, fn, diag)
    return fn(batch, options, diag)


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
    """
    options = options or Options()
    needs_reads = options.method == "quality"
    with profiling.maybe_stage("parse"):
        batch = parse_pileup(
            src, needs_reads, needs_reads, backend=options.io_backend,
            quality_terms_only=needs_reads and options.engine == "device",
        )
    with profiling.maybe_stage("call"):
        result = call_batch(batch, options, diag)
    if result is None:
        header = CSV_HEADER + "\n"
        return header.encode() if binary else header
    with profiling.maybe_stage("serialize"):
        return result.to_csv_bytes() if binary else result.to_csv()


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
    check_ported(options)
    out = out or sys.stdout
    is_binary = "b" in getattr(out, "mode", "") or isinstance(
        out, (_io.RawIOBase, _io.BufferedIOBase)
    )
    # binary sinks take the serializer's bytes untranscoded; text sinks decode
    write = out.write if is_binary else (lambda b: out.write(b.decode("latin1")))
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
    for chunk_no, chunk in enumerate(iter_chunks(src, chunk_bytes)):
        if chunk_no < start_chunk:
            continue
        with profiling.maybe_stage("parse"):
            batch = parse_pileup(chunk, needs_reads, needs_reads, backend=options.io_backend,
                                 quality_terms_only=needs_reads)
        if batch.num_sites == 0:
            continue
        with profiling.maybe_stage("call"):
            res = call_chunk(batch, table)
        with profiling.maybe_stage("serialize"):
            write(res.to_csv_bytes(include_header=False))
        emitted += res.num_records
        if progress is not None:
            out.flush()
            progress.save(chunk_no + 1, out.tell())
    if progress is not None:
        progress.finish()
    return emitted
