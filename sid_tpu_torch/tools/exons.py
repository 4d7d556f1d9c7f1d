"""Exon lookup for called SNPs (scripts/ensembl_exons.py equivalent).

Given (chrom, pos) sites, find containing exons of each gene's canonical
transcript, restricted to the translated region (the reference's SQL WHERE
predicates on first/last coding exon and translation offsets). Two backends:

- ``ExonTable``: a local exon annotation file (CSV with one row per exon of
  a canonical transcript, including translation bounds) — works offline and
  is what the tests use.
- ``ensembl_mysql_lookup``: the reference's live Ensembl Core MySQL query
  (requires the optional ``mysql-connector`` package and network access;
  cleanly gated).

Output CSV columns match the reference tool so the nonsynonymous classifier
can consume either source.
"""

from __future__ import annotations

import bisect
import csv
import sys
from typing import Iterable, Iterator, List, NamedTuple, TextIO, Tuple

OUTPUT_COLUMNS = [
    "site.chrom", "site.pos",
    "gene.stable_id", "gene.biotype",
    "exon.exon_id", "exon.seq_region_start", "exon.seq_region_end",
    "exon.seq_region_strand", "exon.phase", "exon.end_phase",
]


class Exon(NamedTuple):
    chrom: str
    start: int
    end: int
    strand: int
    phase: int
    end_phase: int
    exon_id: str
    gene_id: str
    biotype: str
    # translated-region bounds of the canonical transcript, in genome
    # coordinates (derived from first/last coding exon + tr offsets)
    coding_start: int
    coding_end: int


class ExonTable:
    """In-memory exon interval table with per-chromosome sorted search."""

    def __init__(self, exons: Iterable[Exon]):
        self._by_chrom = {}
        for e in exons:
            self._by_chrom.setdefault(e.chrom, []).append(e)
        self._starts = {}
        for chrom, lst in self._by_chrom.items():
            lst.sort(key=lambda e: (e.start, e.end))
            self._starts[chrom] = [e.start for e in lst]

    @staticmethod
    def from_csv(path: str) -> "ExonTable":
        """Columns: chrom,start,end,strand,phase,end_phase,exon_id,gene_id,
        biotype,coding_start,coding_end."""
        exons = []
        with open(path) as f:
            for row in csv.DictReader(f):
                exons.append(
                    Exon(
                        row["chrom"], int(row["start"]), int(row["end"]),
                        int(row["strand"]), int(row["phase"]),
                        int(row["end_phase"]), row["exon_id"], row["gene_id"],
                        row.get("biotype", "protein_coding"),
                        int(row["coding_start"]), int(row["coding_end"]),
                    )
                )
        return ExonTable(exons)

    def lookup(self, chrom: str, pos: int) -> List[Exon]:
        """Exons containing pos whose translated region covers it."""
        lst = self._by_chrom.get(chrom)
        if not lst:
            return []
        hi = bisect.bisect_right(self._starts[chrom], pos)
        out = []
        for e in lst[:hi]:
            if e.start <= pos <= e.end and e.coding_start <= pos <= e.coding_end:
                out.append(e)
        return out


def annotate_sites(
    sites: Iterable[Tuple[str, int]], table: ExonTable, out: TextIO = sys.stdout
) -> int:
    """Write the reference-format annotation CSV for sites inside exons."""
    print(",".join(OUTPUT_COLUMNS), file=out)
    n = 0
    for chrom, pos in sites:
        for e in table.lookup(chrom, int(pos)):
            print(
                ",".join(
                    map(str, [chrom, pos, e.gene_id, e.biotype, e.exon_id,
                              e.start, e.end, e.strand, e.phase, e.end_phase])
                ),
                file=out,
            )
            n += 1
    return n


def sites_from_snp_csv(lines: Iterable[str]) -> Iterator[Tuple[str, int]]:
    """(chrom, pos) pairs from a sid SNP CSV stream (skips # and header)."""
    it = iter(lines)
    first = True
    for line in it:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if first:
            first = False
            if line.startswith("chrom,"):
                continue
        parts = line.split(",")
        yield parts[0], int(parts[1])


def ensembl_mysql_lookup(
    sites: Iterable[Tuple[str, int]],
    out: TextIO = sys.stdout,
    host: str = "ensembldb.ensembl.org",
    user: str = "anonymous",
    database: str = "mus_musculus_core_90_38",
) -> int:
    """Live Ensembl Core lookup (reference behavior); needs mysql-connector."""
    try:
        import mysql.connector as mc
    except ImportError as e:
        raise RuntimeError(
            "mysql-connector is not installed; use ExonTable.from_csv with a "
            "local exon annotation instead"
        ) from e

    # This SQL is the behavioral spec of the reference lookup — the WHERE
    # predicates (canonical-transcript join, translated-region bounds per
    # strand) define which exon contains a coding site, so the statement is
    # necessarily the same as scripts/ensembl_exons.py:21-38. One deliberate
    # divergence: the reference's column list is missing a comma between
    # exon.phase and exon.end_phase (producing a bogus
    # "exon.phaseexon.end_phase" column); OUTPUT_COLUMNS fixes that.
    query_template = """
SELECT DISTINCT {cols}
FROM gene as gene
    JOIN exon_transcript AS et ON (gene.canonical_transcript_id = et.transcript_id)
    JOIN exon AS exon USING (exon_id)
    JOIN seq_region AS r ON (exon.seq_region_id = r.seq_region_id)
    JOIN translation AS tr ON (gene.canonical_transcript_id = tr.transcript_id)
    JOIN exon AS first ON (first.exon_id = tr.start_exon_id)
    JOIN exon AS last ON (last.exon_id = tr.end_exon_id)
    JOIN ({positions}) as site
WHERE exon.seq_region_start <= site.pos
    AND exon.seq_region_end >= site.pos
    AND (exon.seq_region_strand != 1 OR
        (site.pos >= first.seq_region_start + tr.seq_start - 1 AND site.pos <= last.seq_region_start + tr.seq_end - 1))
    AND (exon.seq_region_strand != -1 OR
        (site.pos >= last.seq_region_end - tr.seq_end + 1 AND site.pos <= first.seq_region_end - tr.seq_start + 1))
    AND r.name = CONVERT(site.chrom USING latin1) AND r.coord_system_id = 3
ORDER BY site.chrom, site.pos ASC
"""
    cols = ",".join(OUTPUT_COLUMNS)
    cn = mc.connect(user=user, host=host, db=database)
    cursor = cn.cursor()
    print(",".join(OUTPUT_COLUMNS), file=out)
    n = 0
    for chrom, pos in sites:
        positions = f"select '{chrom}' as chrom, {int(pos)} as pos"
        cursor.execute(query_template.format(cols=cols, positions=positions))
        for row in cursor.fetchall():
            print(",".join(map(str, row)), file=out)
            n += 1
    cursor.close()
    cn.close()
    return n


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="annotate SNP sites with containing canonical-transcript exons"
    )
    ap.add_argument("--exon-table", help="local exon annotation CSV")
    ap.add_argument("--mysql", action="store_true", help="query Ensembl Core MySQL")
    args = ap.parse_args()
    sites = sites_from_snp_csv(sys.stdin)
    if args.mysql:
        ensembl_mysql_lookup(sites)
    elif args.exon_table:
        annotate_sites(sites, ExonTable.from_csv(args.exon_table))
    else:
        ap.error("one of --exon-table or --mysql is required")
