"""Synonymous/nonsynonymous classification of exonic SNPs.

Port of the reference pipeline's codon logic (scripts/nonsynonymous.py,
behavior per SURVEY §2.3): for each exonic SNP with a known exon phase, the
site's position within its codon is derived from the phase and strand, the
3-site codon context is pulled from the raw per-site CSV via a 5-line
sliding window (2-site halo), every combination of the three diploid
genotypes is translated, and the site is labeled ``nonsyn`` iff the
translations disagree.

Output row: chrom,pos,gene_id,label,strand,phase,codons,translations.

The reference stalls when a phase record's position never appears in the
raw CSV and crashes on duplicate trailing records; this port skips
unmatched records once the stream passes them (``strict=False``, default)
or reproduces the stalling scan (``strict=True``).
"""

from __future__ import annotations

import csv
import gzip
import itertools
import sys
from collections import deque
from itertools import chain, islice, repeat
from typing import Iterable, Iterator, List, NamedTuple, Optional, TextIO


class SitePhase(NamedTuple):
    chrom: str
    position: int
    gene_id: str
    phase: int
    strand: int


class Translation(NamedTuple):
    chrom: str
    pos: int
    gene_id: str
    strand: int
    phase: int
    codons: List[str]
    translations: List[str]


# standard genetic code; equivalence with the reference's decision chain is
# asserted by tests/test_tools.py over all 64 codons
_CODON_TABLE = {}


def _build_codon_table():
    bases = "TCAG"
    aas = (
        "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
    )
    i = 0
    for b1 in bases:
        for b2 in bases:
            for b3 in bases:
                aa = aas[i]
                _CODON_TABLE[b1 + b2 + b3] = "stop" if aa == "*" else aa
                i += 1


_build_codon_table()


def translate(codon) -> str:
    codon = "".join(codon)
    if len(codon) != 3 or not set(codon) <= set("ACGT"):
        raise ValueError(f"Invalid base in codon {codon}")
    return _CODON_TABLE[codon]


def reverse_complement(codon: List[str]) -> List[str]:
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    return [s.translate(comp).upper() for s in codon][::-1]


def all_combinations(pairs):
    return sorted(set(itertools.product(*pairs)))


def site_phase_from_exon(
    chrom: str,
    pos: int,
    gene_id: str,
    exon_start: int,
    exon_end: int,
    strand: int,
    exon_phase: int,
    exon_end_phase: int,
) -> Optional[SitePhase]:
    """Codon phase of a site from Ensembl exon phase fields.

    Reference predicates (scripts/nonsynonymous.py parse_ensembl_data):
    forward strand uses the start phase when defined, else works backwards
    from the end phase, else assumes phase 0 at exon start; mirrored for the
    reverse strand. Returns None for strandless exons.
    """
    if strand == 1:
        if exon_phase != -1:
            phase = (pos - exon_start + exon_phase) % 3
        elif exon_end_phase != -1:
            phase = (exon_end - pos + exon_end_phase + 1) % 3
        else:
            phase = (pos - exon_start) % 3
    elif strand == -1:
        if exon_phase != -1:
            phase = (exon_end - pos + exon_phase) % 3
        elif exon_end_phase != -1:
            phase = (pos - exon_start + exon_end_phase + 1) % 3
        else:
            phase = (exon_end - pos) % 3
    else:
        return None
    return SitePhase(chrom, pos, gene_id, phase, strand)


def parse_ensembl_data(path: str) -> Iterator[SitePhase]:
    """SitePhase records from an exon-annotation CSV (tools.exons output)."""
    with open(path) as f:
        for row in csv.DictReader(f):
            sp = site_phase_from_exon(
                row["site.chrom"],
                int(row["site.pos"]),
                row["gene.stable_id"],
                int(row["exon.seq_region_start"]),
                int(row["exon.seq_region_end"]),
                int(row["exon.seq_region_strand"]),
                int(row["exon.phase"]),
                int(row["exon.end_phase"]),
            )
            if sp is not None:
                yield sp


def line_context(iterable: Iterable[str], context: int = 2) -> Iterator[tuple]:
    """Sliding (2*context+1)-line window; every line appears once at center.

    Deque windowing: seed the window with ``context+1`` empty slots plus the
    first ``context`` lines right of center, then each appended line (input
    followed by ``context`` empty flush slots) shifts the window one step
    and emits it. Windows whose center is an empty pad slot can occur for
    very short inputs; consumers skip empty centers.
    """
    width = 2 * context + 1
    it = iter(iterable)
    padded = chain(it, repeat(""))
    window = deque(
        chain(repeat("", context + 1), islice(padded, context)), maxlen=width
    )
    for line in chain(it, repeat("", context)):
        window.append(line)
        yield tuple(window)


def generate_site_codons(
    sid_lines: Iterable[str],
    phase_records: Iterable[SitePhase],
    strict: bool = False,
) -> Iterator[Translation]:
    """Join phase records against the raw per-site CSV's 3-site windows.

    ``sid_lines`` is the raw sid CSV including header (one row per genome
    site, coordinate-ordered); records must be sorted by (chrom, position).
    """
    records = sorted(phase_records, reverse=True)
    if not records:
        return
    lines = iter(sid_lines)
    header = next(lines)
    gt_col = header.strip().split(",").index("gt")
    current = records.pop()
    for context in line_context(lines, 2):
        center = context[2]
        if not center:
            continue
        ref_chrom, ref_pos, *_ = center.split(",")
        try:
            ref_pos_i = int(ref_pos)
        except ValueError:
            continue
        # robust mode: drop records the ordered stream has already passed
        if not strict:
            while (
                records is not None
                and current.chrom == ref_chrom
                and current.position < ref_pos_i
            ):
                if not records:
                    return
                current = records.pop()
        if ref_chrom != current.chrom or ref_pos_i != current.position:
            continue
        if current.strand == 1:
            offset = 2 - current.phase
        else:
            offset = current.phase
        multicodon = [
            (line.split(",")[gt_col] if line else "") for line in context[offset : offset + 3]
        ]
        if any(len(gt) == 0 for gt in multicodon):
            # window truncated at stream boundary: cannot form a codon
            if not records:
                return
            current = records.pop()
            continue
        if current.strand == -1:
            multicodon = reverse_complement(multicodon)
        translations = sorted(set(map(translate, all_combinations(multicodon))))
        yield Translation(
            current.chrom, current.position, current.gene_id, current.strand,
            current.phase, multicodon, translations,
        )
        if not records:
            return
        old = current
        current = records.pop()
        # duplicate positions (several genes/exons) share the codon context
        while current.chrom == old.chrom and current.position == old.position:
            yield Translation(
                current.chrom, current.position, current.gene_id, current.strand,
                current.phase, multicodon, translations,
            )
            if not records:
                return
            current = records.pop()


def format_record(r: Translation) -> str:
    label = "nonsyn" if len(r.translations) > 1 else "syn"
    return ",".join(
        [r.chrom, str(r.pos), r.gene_id, label, str(r.strand), str(r.phase),
         ":".join(r.codons), ":".join(r.translations)]
    )


def run(ensembl_csv: str, raw_csv: str, out: TextIO = sys.stdout) -> int:
    phases = parse_ensembl_data(ensembl_csv)
    opener = gzip.open if raw_csv.endswith(".gz") else open
    n = 0
    with opener(raw_csv, "rt") as f:
        for rec in generate_site_codons(f, phases):
            print(format_record(rec), file=out)
            n += 1
    return n


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(
            "usage: python -m sid_tpu_torch.tools.nonsynonymous exon_snps.csv raw.csv[.gz]",
            file=sys.stderr,
        )
        sys.exit(1)
    run(sys.argv[1], sys.argv[2])
