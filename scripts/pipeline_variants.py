#!/usr/bin/env python3
"""Designs of the chunk pipeline, timed in turns on one CUDA card.

    python3 scripts/pipeline_variants.py

Writes chip_smoke.py's 10M-site (1.11 GB) and 1M-site (110 MB) Phred files
under .smoke/pipeline_variants/ (removed at the end) and runs -m local and
-m quality on each through the monolithic engine.run
(engine._run_monolithic) and through each design of the chunk pipeline,
three runs each, in turns (the order reversed every other round), with 32
and 128 MB chunks at 10M sites and 32 MB at 1M. Every output is held
byte-equal to the monolithic run's. The designs:

- "main reads": engine._run_pipelined_single_pass as committed: the main
  thread cuts chunk k+1 and hands it to the worker, then calls and writes
  chunk k;
- "worker reads": the worker cuts and parses chunk k+1; the main thread
  only calls and writes;
- "worker reads, parser n-1": the same, libsidtpu's parser on one thread
  fewer than the host's cores;
- "worker reads, cores halved": the same, the parser and the CSV writer
  on half the cores each.

Prints each way's median wall and its ratio to the monolithic median, with
the card's name and power limit.
"""

import contextlib
import os
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ROUNDS = 3
SIZES = ((1_000_000, 8, (32 << 20,)), (10_000_000, 20, (32 << 20, 128 << 20)))
METHODS = ("local", "quality")


@contextlib.contextmanager
def native_threads(lib, parse: int, write: int):
    """libsidtpu's parser and CSV writers on ``parse`` and ``write``
    threads (0: the host's cores, as committed)."""
    names = ("sidtpu_parse_ex", "sidtpu_write_csv", "sidtpu_write_csv_indexed")
    real = {name: getattr(lib, name) for name in names}

    def at(fn, index, n):
        return lambda *a: fn(*a[:index], n, *a[index + 1:]) if n else fn(*a)

    lib.sidtpu_parse_ex = at(real["sidtpu_parse_ex"], 5, parse)
    lib.sidtpu_write_csv = at(real["sidtpu_write_csv"], 12, write)
    lib.sidtpu_write_csv_indexed = at(real["sidtpu_write_csv_indexed"], 14, write)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(lib, name, fn)


def worker_reads(src, options, chunk_bytes):
    """The pipeline with the chunk's cut in the worker too."""
    from sid_tpu_torch import engine
    from sid_tpu_torch.io.stream import iter_chunks, parse_chunk, with_offsets
    from sid_tpu_torch.models.common import CSV_HEADER

    reads = options.method == "quality"
    chunks = with_offsets(iter_chunks(src, chunk_bytes))

    def parse_next():
        located = next(chunks, None)
        if located is None:
            return None
        return parse_chunk(src, *located, reads, reads, quality_terms_only=reads)

    parts = [(CSV_HEADER + "\n").encode()]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(parse_next)
        while True:
            nxt = ex.submit(parse_next)
            batch = fut.result()
            if batch is None:
                break
            if batch.num_sites:
                parts.append(engine.call_batch(batch, options).to_csv_bytes(include_header=False))
            fut = nxt
    return b"".join(parts)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pipeline_variants: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from sid_tpu_torch import engine
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.io import native

    card = chip_smoke.card_line()
    lib = native.load()
    cores = os.cpu_count()
    print(f"# {card}; {cores} host cores; torch {torch.__version__}", flush=True)
    designs = {
        "main reads": lambda src, o, c: engine._run_pipelined_single_pass(src, o, None, True, c),
        "worker reads": worker_reads,
        "worker reads, parser n-1": lambda src, o, c: with_threads(cores - 1, 0, worker_reads, src, o, c),
        "worker reads, cores halved": lambda src, o, c: with_threads(cores // 2, cores // 2, worker_reads, src, o, c),
    }

    def with_threads(parse, write, fn, *args):
        with native_threads(lib, parse, write):
            return fn(*args)

    workdir = os.path.join(HERE, ".smoke", "pipeline_variants")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        for sites, seed, chunks in SIZES:
            path = os.path.join(workdir, f"phred_{sites}.pileup")
            size = chip_smoke.write_phred_pileup(path, sites, seed=seed)
            for method in METHODS:
                opts = Options(method=method)
                ways = ["monolithic"] + [(name, c) for c in chunks for name in designs]
                walls = {w: [] for w in ways}
                want = None
                for r in range(ROUNDS):
                    for way in ways if r % 2 == 0 else ways[::-1]:
                        t0 = time.perf_counter()
                        if way == "monolithic":
                            out = engine._run_monolithic(path, opts, None, True)
                        else:
                            out = designs[way[0]](path, opts, way[1])
                        walls[way].append(time.perf_counter() - t0)
                        if want is None:
                            want = out
                        elif out != want:
                            raise AssertionError(f"{method} at {sites} sites: {way} differs from the monolithic run")
                        del out
                mono = statistics.median(walls["monolithic"])
                for way in ways:
                    med = statistics.median(walls[way])
                    label = way if way == "monolithic" else f"{way[0]}, {way[1] >> 20} MB chunks"
                    print(f"# -m {method}, {sites} sites ({size / 1e6:.0f} MB), {label}: median {med * 1e3:.1f} ms "
                          f"({med / mono:.3f} of monolithic); runs "
                          + ", ".join(f"{w * 1e3:.1f}" for w in walls[way]) + f"; on {card}", flush=True)
                del want
            os.remove(path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
