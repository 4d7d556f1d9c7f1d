"""Top-level dispatch: parsed batch + options -> CallResult -> CSV.

Mirrors the reference's method dispatch (sid.cpp:92-100), including the
quirk that an unrecognized method produces no records (the CLI then prints
only the CSV header). ``options.engine`` selects the device path (default)
or the host long-double oracle. ``run`` calls a whole input in memory,
or, on an input of at least ``PIPELINE_MIN_BYTES``, over newline-aligned
chunks whose parse overlaps the work on the chunk before: ``local`` and
``quality`` in one pass (the chunk pipeline), ``bayes`` and
``likelihood_ratio`` in two passes over what the first holds in memory,
with one fit between them (the fitted chunk pipeline);
``run_streaming`` calls it in two passes over chunks read twice. All give
the same output. ``--per-shard-fit`` calls each chromosome alone
(``parallel.pipeline``); ``run_streaming`` does not read it, as sid_tpu's
does not (``ROADMAP.md`` C9). Population mode (many samples) is
``models.population`` and ``--multihost`` ``parallel.distributed``, which
the CLI dispatches to. ``--devices`` (``Options.mesh``) runs each method's
device work over a mesh of devices (``parallel.mesh``, ``parallel.fit``);
the exact engine does not read it, as sid_tpu's does not.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import io as _io
import mmap
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Deque, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.exact import engine as exact_engine
from sid_tpu_torch.io.pileup import PileupBatch, parse_pileup
from sid_tpu_torch.io.stream import (
    accumulate_histogram, chunk_views, iter_chunks, merge_profile_tables, pack_profiles, parse_chunk,
    unpack_profiles, with_offsets,
)
from sid_tpu_torch.models import bayes, common, likelihood_ratio, local, quality
from sid_tpu_torch.models.common import CSV_HEADER, CallResult
from sid_tpu_torch.models.lynch import estimate_prior_heterozygosity
from sid_tpu_torch.ops.profiles import coverage_of, filter_min_coverage, unique_profiles
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
    its size on disk) take a chunk path; a file object never does.
    ``local`` and ``quality`` take the chunk pipeline where
    ``_pipeline_eligible`` allows it (sid_tpu/engine.py:72-78); ``bayes``
    and ``likelihood_ratio`` take the fitted chunk pipeline where
    ``_fitted_pipeline_eligible`` allows it, where sid_tpu calls them
    monolithic. Every path gives the same output.
    """
    options = options or Options()
    if isinstance(src, (bytes, bytearray)):
        size = len(src)
    elif isinstance(src, (str, os.PathLike)):
        size = os.path.getsize(src)
    else:
        return _run_monolithic(src, options, diag, binary)
    for eligible, chunked in ((_pipeline_eligible, _run_pipelined_single_pass),
                              (_fitted_pipeline_eligible, _run_fitted_pipeline)):
        if eligible(options, size):
            return chunked(bytes(src) if isinstance(src, bytearray) else src, options, diag, binary,
                           PIPELINE_CHUNK_BYTES)
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
    (sid_tpu/engine.py:313-320; ``--devices`` does not exclude it).
    ``bayes`` and ``likelihood_ratio`` take ``_fitted_pipeline_eligible``'s
    path instead; sid_tpu calls them monolithic. The output is the same."""
    return (
        options.method in ("local", "quality")
        and not options.estimate_prior
        and not options.per_shard_fit
        and options.engine == "device"
        and size >= PIPELINE_MIN_BYTES
    )


def _fitted_pipeline_eligible(options: Options, size: int) -> bool:
    """The fitted methods (``bayes``, ``likelihood_ratio``, with or without
    -R) on the device engine with one global fit (no per-shard fit), at
    ``PIPELINE_MIN_BYTES`` or more: ``_run_fitted_pipeline``'s inputs
    (``--devices`` does not exclude it)."""
    return (
        options.method in ("bayes", "likelihood_ratio")
        and not options.per_shard_fit
        and options.engine == "device"
        and size >= PIPELINE_MIN_BYTES
    )


def _parsed_chunks(src, options: Options, chunk_bytes: int) -> Iterator[PileupBatch]:
    """The chunk pipeline's read loop: this thread takes each next chunk of
    ``src`` (``pipeline:read``, and the read that finds its end), a view
    of the bytes or of the mapped file where ``io.stream.chunk_views``
    gives one (the newline search and the view, no copy) and bytes of a
    gzip input, and hands it to one worker thread, which parses it in
    place (``worker:parse``, hung under the span open here; libsidtpu's
    parser releases the GIL) while the caller works on the chunk before,
    which it gets after ``pipeline:parse_wait``, each chunk's sites counted
    (``sites``). The worker touches neither CUDA nor a pinned buffer, and
    no batch refers to a chunk. The worker is joined before the views are
    released and the file unmapped, on every way out: the end, a parse
    error, a caller that closes this generator early. A parse error names
    the file's line; it is raised after the worker's parse of the next
    chunk ends."""
    needs_reads = options.method == "quality"

    def read():
        with profiling.maybe_stage("pipeline:read"):
            return next(chunks, None)

    def parse(offset, chunk):
        with adopt(), profiling.maybe_stage("worker:parse"):
            return parse_chunk(src, offset, chunk, needs_reads, needs_reads, backend=options.io_backend,
                               quality_terms_only=needs_reads)

    with chunk_views(src, chunk_bytes) as views, ThreadPoolExecutor(1) as ex:
        adopt = profiling.handover()
        chunks = with_offsets(views)
        located = read()
        fut = None if located is None else ex.submit(parse, *located)
        while fut is not None:
            located = read()
            nxt = None if located is None else ex.submit(parse, *located)
            with profiling.maybe_stage("pipeline:parse_wait"):
                batch = fut.result()
            profiling.count("sites", batch.num_sites)
            yield batch
            fut = nxt


def _run_pipelined_single_pass(src, options: Options, diag, binary: bool, chunk_bytes: int):
    """The chunk pipeline (sid_tpu/engine.py:271-310): ``_parsed_chunks``
    parses chunk k+1 while this thread calls chunk k on the device and
    writes its rows into the request's output (``_Output``) after the
    header, byte-equal to ``_run_monolithic``. Under ``--profile`` the
    pass is one top-level ``pipeline`` stage and the output's hand-over a
    top-level ``join`` after it. This thread's spans nest in ``pipeline``
    and follow each other: ``pipeline:read``, ``pipeline:parse_wait``,
    ``pipeline:call`` and ``pipeline:serialize``; the worker's
    ``worker:parse`` hangs under ``pipeline`` too."""
    with _Output() as out:
        with profiling.maybe_stage("pipeline"):
            for batch in _parsed_chunks(src, options, chunk_bytes):
                if batch.num_sites == 0:
                    continue
                with profiling.maybe_stage("pipeline:call"):
                    result = call_batch(batch, options, diag)
                out.write(result)
        return out.take(binary)


# CPython's and libc's entry points that ``_Output`` grows and advises its
# bytes with, as prototypes of this module's own (``ctypes.pythonapi``'s
# function objects are shared, with whatever declarations others give them)
_bytes_new = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_char_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_resize = ctypes.PYFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_ssize_t)(
    ("_PyBytes_Resize", ctypes.pythonapi))
_bytes_data = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p)(("PyBytes_AsString", ctypes.pythonapi))
_decref = ctypes.PYFUNCTYPE(None, ctypes.c_void_p)(("Py_DecRef", ctypes.pythonapi))
_madvise = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int)(
    ("madvise", ctypes.CDLL(None)))
_MADV_HUGEPAGE = getattr(mmap, "MADV_HUGEPAGE", None)


@functools.lru_cache(maxsize=None)
def _huge_pages_need_advice() -> bool:
    """Whether a large block is backed by huge pages only where advised
    ``MADV_HUGEPAGE``: the kernel's transparent huge pages in ``madvise``
    mode. In ``always`` mode it is without advice; in ``never`` mode, or
    on a kernel without them (no such file), advice changes nothing."""
    if _MADV_HUGEPAGE is None:
        return False
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as f:
            return "[madvise]" in f.read()
    except OSError:
        return False


def _mapping_of(address: int) -> Optional[Tuple[int, int]]:
    """The start and end of the memory mapping that holds ``address``
    (``/proc/self/maps``), or None where it cannot be read."""
    try:
        with open("/proc/self/maps", "rb") as f:
            for line in f:
                lo, _, hi = line.partition(b" ")[0].partition(b"-")
                if int(lo, 16) <= address < int(hi, 16):
                    return int(lo, 16), int(hi, 16)
    except OSError:
        pass
    return None


class _Output:
    """A request's CSV as one ``bytes`` object, written in place: it
    starts as the header and grows by each chunk's part, which the chunk's
    writer fills at its offset; ``take`` hands the object back, nothing
    joined. Left without ``take`` (an error), the exit drops it.

    Writing into a ``bytes`` is sound because nothing else can see it
    before ``take``: its one reference is this object's raw pointer, no
    Python name, so nothing hashes, interns or shares it while it is
    resized or written, and ``_PyBytes_Resize`` requires that one
    reference. glibc's ``realloc`` of a block of its own mapping remaps
    the pages (``mremap``) and copies nothing, but may move them, so the
    data's address is taken after every growth. Where huge pages need
    advice, such a mapping is advised ``MADV_HUGEPAGE`` whole, as numpy
    advises its large arrays: on 4 KiB pages the writer's fills took ~1.6x
    as long. Advice on part of it would split the mapping, which
    ``mremap`` cannot resize: glibc would then copy the whole block at
    each growth (``PERF.md`` §6). Elsewhere the mapping is not looked up
    (a read of ``/proc/self/maps`` took 2–3 ms on the card's host). The
    exit counts ``serialize:in_place_bytes`` (parts filled in place),
    ``serialize:copied_bytes`` (parts copied in: the per-site writer's)
    and ``serialize:resizes`` (growths)."""

    def __init__(self):
        header = (CSV_HEADER + "\n").encode()
        self._ob = ctypes.c_void_p(_bytes_new(header, len(header)))  # the one reference
        self._size = len(header)
        self._counts = {"serialize:in_place_bytes": 0, "serialize:copied_bytes": 0, "serialize:resizes": 0}

    def __enter__(self) -> "_Output":
        return self

    def __exit__(self, *exc) -> None:
        if self._ob.value is not None:
            _decref(self._ob)
            self._ob.value = None
        for name, n in self._counts.items():
            profiling.count(name, n)

    def _grow(self, n: int) -> int:
        """The address of n more bytes at the end."""
        old = self._size
        _bytes_resize(ctypes.byref(self._ob), old + n)  # on failure it frees the object, and raises
        self._size += n
        self._counts["serialize:resizes"] += 1
        data = _bytes_data(self._ob)
        mapping = _mapping_of(data) if _huge_pages_need_advice() else None
        # the block's own mapping starts on the page of its object (glibc
        # maps a large block alone); a block in a shared heap is not advised
        if mapping is not None and mapping[0] == self._ob.value // mmap.PAGESIZE * mmap.PAGESIZE:
            _madvise(mapping[0], mapping[1] - mapping[0], _MADV_HUGEPAGE)  # advice: a refusal changes no byte
        return data + old

    def write(self, result: CallResult) -> None:
        """A chunk's rows after the rows before, under
        ``pipeline:serialize`` (the plan, the growth, the advice and the
        fill), counted in ``serialize:bytes``. An index outside its table
        raises before the output grows."""
        with profiling.maybe_stage("pipeline:serialize"):
            if result.class_idx is None:
                part = result.to_csv_buffer(include_header=False)
                size = len(part)
                if size:
                    ctypes.memmove(self._grow(size), part, size)
                self._counts["serialize:copied_bytes"] += size
            else:
                with result.csv_plan(include_header=False) as (size, fill):
                    if size:
                        fill(self._grow(size))
                self._counts["serialize:in_place_bytes"] += size
        profiling.count("serialize:bytes", size)

    def take(self, binary: bool):
        """The output under a top-level ``join``: the ``bytes`` itself, or
        in text mode decoded once."""
        with profiling.maybe_stage("join"):
            out = ctypes.cast(self._ob, ctypes.py_object).value  # a reference of its own
            _decref(self._ob)
            self._ob.value = None
            return out if binary else str(out, "latin1")


class _HeldChunk(NamedTuple):
    """What the fitted pipeline keeps of a chunk between its passes: the
    sites' chromosomes and positions, and each site's row (``inverse``)
    in the chunk's sorted unique profiles (``keys``, packed)."""

    chrom_id: np.ndarray
    chrom_table: List[str]
    pos: np.ndarray
    keys: np.ndarray
    inverse: np.ndarray

    @property
    def nbytes(self) -> int:
        return self.chrom_id.nbytes + self.pos.nbytes + self.keys.nbytes + self.inverse.nbytes


def _run_fitted_pipeline(src, options: Options, diag, binary: bool, chunk_bytes: int):
    """``bayes`` and ``likelihood_ratio`` on chunks, in two passes over
    what pass 1 holds in memory, byte-equal to ``_run_monolithic`` (its
    CSV and its ``diag`` lines); each site is parsed once and deduped once.

    Pass 1 takes ``_parsed_chunks``'s batches; under ``pipeline:dedup``
    each chunk's sites are deduped (``ops.profiles.unique_profiles``), its
    sorted profiles merged into the request's table and its chromosomes,
    positions, unique profiles and int32 inverse held (``_HeldChunk``; the
    counts and the chunk's bytes are freed). Between the passes
    ``class_table`` fits the table's coverage >= 4 profiles once
    (``fit+classify``, BH over all of the input's profiles). Pass 2, under
    ``pipeline:gather`` a chunk, maps the chunk's unique profiles onto the
    table's class rows and coverage mask with one search and gathers once
    a site (``common.gather_result``: the monolithic path's rows, order
    and coverage < 4 omission), then writes its rows into the request's
    output (``_Output``, under ``pipeline:serialize``), handed back under
    ``join`` as the chunk pipeline's is. Counters: ``fitted:profiles``
    (the profiles the fit was given) and ``fitted:held_bytes`` (what pass
    1 held)."""
    held: Deque[_HeldChunk] = collections.deque()
    keys, mult = np.zeros(0, np.uint64), np.zeros(0, np.int64)
    with _Output() as out:
        with profiling.maybe_stage("pipeline"):
            for batch in _parsed_chunks(src, options, chunk_bytes):
                if batch.num_sites == 0:
                    continue
                with profiling.maybe_stage("pipeline:dedup"):
                    profiles, chunk_mult, inverse = unique_profiles(batch.counts)
                    chunk_keys = pack_profiles(profiles)
                    keys, mult = merge_profile_tables(keys, mult, chunk_keys, chunk_mult)
                    held.append(_HeldChunk(batch.chrom_id, batch.chrom_table, batch.pos, chunk_keys, inverse))
            profiling.count("fitted:held_bytes", sum(h.nbytes for h in held))
            profiles = unpack_profiles(keys)
            table = class_table(profiles, mult, options, diag)
            profiling.count("fitted:profiles", table.keys.shape[0])
            keep = coverage_of(profiles) >= 4
            class_rows = np.where(keep, np.cumsum(keep) - 1, -1)  # the table's profiles' class rows
            while held:
                chunk = held.popleft()
                with profiling.maybe_stage("pipeline:gather"):
                    rows = class_rows[np.searchsorted(keys, chunk.keys)]
                    kept = rows >= 0
                    chunk_cls = (c[rows[kept]] for c in table.cls)
                    result = common.gather_result(chunk, table.conf_type, chunk.inverse, *chunk_cls, keep_u=kept)
                out.write(result)
        return out.take(binary)


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
