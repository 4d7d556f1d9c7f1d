"""PileupBatch: dense array representation of a parsed mpileup stream.

Raw mpileup text becomes
- ``counts``  (N, 4) uint16   per-site A/C/G/T occurrence profile
- ``pos``     (N,)  int32     1-based genome coordinate
- ``chrom_id``(N,)  int32     index into ``chrom_table``
- ``ref_base``(N,)  uint8     reference base byte
and, only when base or mapping qualities are asked for, the per-read CSR
arrays (``read_offsets``, ``read_code``, ``read_strand``, ``read_bq``,
``read_mq``; call.cpp:291-372 pairing semantics). With both quality
columns the native parser also sums the quality method's per-site terms
inline (``q_log_hom``, ``q_log_het``, ``q_major``, ``q_second``); the Python
backend carries the reads and no terms.

Backends: "native" (or "auto") = the multithreaded C++ parser of libsidtpu,
"python" = the exact-grammar spec (``pileup_py``). Both implement the
identical grammar. The arrays live on the host; the models move what the
device needs.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import List, Optional, Union

import numpy as np

from sid_tpu_torch.io import native, pileup_py
from sid_tpu_torch.native import bridge
from sid_tpu_torch.utils.errors import ErrorChannel


@dataclasses.dataclass
class PileupBatch:
    chrom_id: np.ndarray
    chrom_table: List[str]
    pos: np.ndarray
    ref_base: np.ndarray
    counts: np.ndarray
    read_offsets: Optional[np.ndarray] = None
    read_code: Optional[np.ndarray] = None
    read_strand: Optional[np.ndarray] = None
    read_bq: Optional[np.ndarray] = None
    read_mq: Optional[np.ndarray] = None
    # quality-method per-site terms from the native parser (bitwise
    # models/quality.accumulate_read_terms; None from the Python backend)
    q_log_hom: Optional[np.ndarray] = None
    q_log_het: Optional[np.ndarray] = None
    q_major: Optional[np.ndarray] = None
    q_second: Optional[np.ndarray] = None
    errors: Optional[ErrorChannel] = None

    @property
    def num_sites(self) -> int:
        return int(self.counts.shape[0])


def _parse_python(
    data: bytes,
    parse_bq: bool,
    parse_mq: bool,
    errors: ErrorChannel,
) -> PileupBatch:
    """Exact-grammar parser over a whole buffer."""
    with_reads = parse_bq or parse_mq
    chrom_table: List[str] = []
    chrom_index = {}
    chrom_id: List[int] = []
    pos: List[int] = []
    ref_base: List[int] = []
    counts: List[List[int]] = []
    read_lens: List[int] = []
    read_code: List[int] = []
    read_strand: List[int] = []
    read_bq: List[int] = []
    read_mq: List[int] = []

    line_no = 0
    for line in data.split(b"\n"):
        line_no += 1
        if len(line) == 0:  # readFile skips empty lines (call.cpp:14)
            continue
        parsed = pileup_py.parse_pileup_line(line, parse_bq, parse_mq, errors, line_no)
        if parsed is None:
            continue
        name = parsed.chrom.decode("latin1")
        cid = chrom_index.get(name)
        if cid is None:
            cid = len(chrom_table)
            chrom_index[name] = cid
            chrom_table.append(name)
        chrom_id.append(cid)
        pos.append(parsed.pos)
        ref_base.append(parsed.ref_base)
        counts.append(parsed.counts)
        if with_reads:
            nb = len(parsed.codes)
            read_lens.append(nb)
            read_code.extend(parsed.codes)
            read_strand.extend(parsed.strands)
            bq = parsed.base_qualities or []
            mq = parsed.mapping_qualities or []
            # positional pairing with filtered bases; missing -> clamp-min 1,
            # the value any sub-33 byte decodes to (pileup.cpp:159-163)
            for j in range(nb):
                read_bq.append(bq[j] if j < len(bq) else 1)
                read_mq.append(mq[j] if j < len(mq) else 1)

    batch = PileupBatch(
        chrom_id=np.asarray(chrom_id, np.int32),
        chrom_table=chrom_table,
        pos=np.asarray(pos, np.int32),
        ref_base=np.asarray(ref_base, np.uint8),
        counts=np.asarray(counts, np.uint16).reshape(-1, 4),
        errors=errors,
    )
    if with_reads:
        batch.read_offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(read_lens, np.int64))]
        ).astype(np.int64)
        batch.read_code = np.asarray(read_code, np.int8)
        batch.read_strand = np.asarray(read_strand, np.uint8)
        batch.read_bq = np.asarray(read_bq, np.uint8)
        batch.read_mq = np.asarray(read_mq, np.uint8)
    return batch


def parse_pileup(
    src: Union[str, bytes, os.PathLike, _io.IOBase],
    parse_base_qualities: bool = False,
    parse_mapping_qualities: bool = False,
    backend: str = "auto",
    strict: bool = True,
    quality_terms_only: bool = False,
) -> PileupBatch:
    """Parse mpileup text into a PileupBatch.

    ``src`` may be a path, a bytes buffer, or a binary file object; gzip
    input is detected by its magic bytes. ``backend``: "auto"/"native"
    (C++ parser, built at first use) or "python" (the grammar spec).
    ``quality_terms_only``: with both quality columns, the native parser
    returns the quality method's per-site terms without the per-read
    arrays; the Python backend ignores it (reads, no terms).
    """
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            data = f.read()
    elif isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        data = src.read()
        if isinstance(data, str):
            data = data.encode()
    if data[:2] == b"\x1f\x8b":  # transparent gzip input (magic-detected)
        import gzip

        data = gzip.decompress(data)

    errors = ErrorChannel(strict=strict)
    if backend == "python":
        return _parse_python(data, parse_base_qualities, parse_mapping_qualities, errors)
    if backend not in ("auto", "native"):
        raise ValueError(f"unknown io backend: {backend!r}")
    fields = bridge.parse(
        native.load(), data, parse_base_qualities, parse_mapping_qualities, errors,
        terms_only=quality_terms_only,
    )
    return PileupBatch(errors=errors, **fields)
