"""The whole-genome SNP pipeline in one process (scripts/sid-pipeline port).

Reference chain (run.sh): per-chromosome `sid -R -m likelihood_ratio` ->
gzip raw CSV -> grep ,het, -> exon filter (Ensembl) -> nonsyn labels. Here
the same stages run in-process over the streaming engine, with a choice of
per-chromosome statistics (reference semantics, ``--per-shard-fit``) or one
global fit, and the exon/nonsyn stages consuming a local exon table (or
live Ensembl when available). The calling stage runs on the torch device
``--platform`` names (default ``SIDTPU_PLATFORM``, else cuda).

CLI: python -m sid_tpu_torch.tools.pipeline input.plp[.gz] --workdir out/
         [--method likelihood_ratio] [--estimate-prior] [--per-chromosome]
         [--exon-table exons.csv] [--platform cpu]
"""

from __future__ import annotations

import argparse
import gzip
import io
import os
import sys
from typing import Optional

from sid_tpu_torch import engine
from sid_tpu_torch.config import Options
from sid_tpu_torch.tools.exons import ExonTable, annotate_sites, sites_from_snp_csv
from sid_tpu_torch.tools.nonsynonymous import run as nonsyn_run


def extract_snps(raw_csv_path: str, snps_path: str) -> int:
    """``zgrep ,het,`` (run-sid.sh:18): het rows from the raw CSV."""
    opener = gzip.open if raw_csv_path.endswith(".gz") else open
    n = 0
    with opener(raw_csv_path, "rt") as f, open(snps_path, "w") as out:
        for line in f:
            if ",het," in line:
                out.write(line)
                n += 1
    return n


def run_pipeline(
    input_path: str,
    workdir: str,
    method: str = "likelihood_ratio",
    estimate_prior: bool = True,
    per_chromosome: bool = False,
    exon_table: Optional[str] = None,
    diag=None,
    platform: Optional[str] = None,
) -> dict:
    """Full pipeline; returns paths + counts of each stage's artifact.
    ``platform`` is the calling stage's torch device (None:
    SIDTPU_PLATFORM, else cuda)."""
    os.makedirs(workdir, exist_ok=True)
    diag = diag or (lambda s: print(s, file=sys.stderr))

    # stage 1: calling (gzip raw CSV, like run-sid.sh)
    raw_path = os.path.join(workdir, "raw.csv.gz")
    opts = Options(
        method=method, estimate_prior=estimate_prior, per_shard_fit=per_chromosome,
        platform=platform or os.environ.get("SIDTPU_PLATFORM"),
    )
    src: object = input_path
    if input_path.endswith(".gz"):
        with gzip.open(input_path, "rb") as f:
            src = f.read()
    if per_chromosome:
        # per-chromosome statistics need the in-memory path (chromosome split)
        if isinstance(src, str):
            with open(src, "rb") as f:
                src = f.read()
        csv_text = engine.run(src, opts, diag)
        with gzip.open(raw_path, "wt") as out:
            out.write(csv_text)
        n_sites = csv_text.count("\n") - 1
    else:
        buf = io.StringIO()
        n_sites = engine.run_streaming(src, opts, buf, diag)
        with gzip.open(raw_path, "wt") as out:
            out.write(buf.getvalue())

    # stage 2: SNP extraction
    snps_path = os.path.join(workdir, "snps.csv")
    n_snps = extract_snps(raw_path, snps_path)
    diag(f"# pipeline: {n_snps} SNPs of {n_sites} sites")

    result = {
        "raw": raw_path, "snps": snps_path,
        "n_sites": int(n_sites), "n_snps": n_snps,
    }
    if exon_table is None:
        return result

    # stage 3: exon filter
    table = ExonTable.from_csv(exon_table)
    exon_path = os.path.join(workdir, "exon_snps.csv")
    with open(snps_path) as f, open(exon_path, "w") as out:
        n_exonic = annotate_sites(sites_from_snp_csv(f), table, out)
    result["exon_snps"] = exon_path
    result["n_exonic"] = n_exonic

    # stage 4: nonsyn labels
    nonsyn_path = os.path.join(workdir, "nonsynonymous_exon_snps.csv")
    with open(nonsyn_path, "w") as out:
        n_labeled = nonsyn_run(exon_path, raw_path, out)
    result["nonsyn"] = nonsyn_path
    result["n_labeled"] = n_labeled
    diag(f"# pipeline: {n_exonic} exonic, {n_labeled} codon-labeled")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--method", default="likelihood_ratio")
    ap.add_argument("--estimate-prior", action="store_true", default=True)
    ap.add_argument("--no-estimate-prior", dest="estimate_prior", action="store_false")
    ap.add_argument("--per-chromosome", action="store_true",
                    help="independent per-chromosome statistics (reference script semantics)")
    ap.add_argument("--exon-table")
    ap.add_argument("--platform", help="torch device of the calling stage: 'cuda' (default) or 'cpu'; "
                    "also honored from SIDTPU_PLATFORM")
    args = ap.parse_args(argv)
    out = run_pipeline(
        args.input, args.workdir, args.method, args.estimate_prior,
        args.per_chromosome, args.exon_table, platform=args.platform,
    )
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
