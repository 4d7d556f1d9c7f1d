"""Shard orchestration: chromosome and range splitting, per-shard calling
(``sid_tpu/parallel/pipeline.py``).

The reference pipeline runs one sid process per chromosome with GNU
parallel (scripts/sid-pipeline/parallel-run-sid.sh), which makes every
statistic, the Lynch fit included, per chromosome. ``call_per_shard``
gives those semantics in one process (``--per-shard-fit``): each shard is
called alone and the results are concatenated in coordinate order, with
their class tables kept so the CSV stays on the indexed writer.

A sliced batch carries the sites' quality-method terms of the native parser
(``q_log_hom``, ``q_log_het``, ``q_major``, ``q_second``) beside the read
CSR. ``sid_tpu``'s ``_slice_batch`` keeps only the reads, so its
``--per-shard-fit -m quality`` under the device engine, whose parse keeps
the terms alone, has nothing to sum and fails (``ROADMAP.md`` C10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from sid_tpu_torch.config import Options
from sid_tpu_torch.io.pileup import PileupBatch
from sid_tpu_torch.models.common import ANSWER, CallResult

_SITE_TERMS = ("q_log_hom", "q_log_het", "q_major", "q_second")


def _slice_batch(batch: PileupBatch, idx: np.ndarray) -> PileupBatch:
    """Sub-batch over a site index array; the read CSR and the sites'
    quality terms follow the sites."""
    sub = PileupBatch(
        chrom_id=batch.chrom_id[idx],
        chrom_table=batch.chrom_table,
        pos=batch.pos[idx],
        ref_base=batch.ref_base[idx],
        counts=batch.counts[idx],
    )
    for name in _SITE_TERMS:
        values = getattr(batch, name)
        if values is not None:
            setattr(sub, name, values[idx])
    if batch.read_offsets is not None:
        starts = batch.read_offsets[:-1][idx]
        lens = batch.read_offsets[1:][idx] - starts
        sub.read_offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        # read j of the sub-batch is read j - sub_start + start of its site
        gather = np.arange(int(sub.read_offsets[-1]), dtype=np.int64) + np.repeat(
            starts - sub.read_offsets[:-1], lens)
        sub.read_code = batch.read_code[gather]
        sub.read_strand = batch.read_strand[gather]
        sub.read_bq = batch.read_bq[gather]
        sub.read_mq = batch.read_mq[gather]
    return sub


def split_by_chromosome(batch: PileupBatch) -> List[PileupBatch]:
    """One shard per chromosome, in first-appearance order (the script's
    semantics)."""
    return [
        _slice_batch(batch, np.nonzero(batch.chrom_id == cid)[0])
        for cid in range(len(batch.chrom_table))
    ]


def split_ranges(batch: PileupBatch, k: int) -> List[PileupBatch]:
    """k contiguous site-range shards."""
    idx = np.arange(batch.num_sites)
    return [_slice_batch(batch, part) for part in np.array_split(idx, k)]


def concat_results(parts: List[CallResult]) -> CallResult:
    """The shards' results in order, one CallResult. Where every part has
    a class table, the tables are concatenated and each part's
    ``class_idx`` offset into them, so the CSV stays on the indexed writer
    (``sidtpu_write_csv_indexed``); otherwise the parts' answers are
    concatenated a site each."""
    if not all(p.class_idx is not None for p in parts):
        parts = [p.per_site() for p in parts]
    first = parts[0]
    merged = CallResult(
        chrom_id=np.concatenate([p.chrom_id for p in parts]),
        chrom_table=first.chrom_table,
        pos=np.concatenate([p.pos for p in parts]),
        conf_type=first.conf_type,
        **{name: np.concatenate([getattr(p, name) for p in parts]) for name in ANSWER},
    )
    if first.class_idx is not None:
        offsets = np.cumsum([0] + [p.is_het.shape[0] for p in parts[:-1]], dtype=np.int32)
        merged.class_idx = np.concatenate([p.class_idx + off for p, off in zip(parts, offsets)])
    return merged


def call_per_shard(
    batch: PileupBatch,
    options: Options,
    call_one: Callable[[PileupBatch, Options, Optional[Callable]], CallResult],
    diag: Optional[Callable[[str], None]] = None,
) -> CallResult:
    """Run a method on each chromosome alone and merge in coordinate order:
    parallel-run-sid.sh's per-chromosome statistics. An input with no sites
    is called whole.
    """
    shards = split_by_chromosome(batch)
    opts = dataclasses.replace(options, per_shard_fit=False)
    parts = [call_one(s, opts, diag) for s in shards if s.num_sites > 0]
    if not parts:
        return call_one(batch, opts, diag)
    return concat_results(parts)
