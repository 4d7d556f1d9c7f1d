"""Downstream pipeline tools: SNP extraction, exon annotation, nonsyn labeling.

The port's copy of ``sid_tpu/tools`` (the reference's scripts/ layer,
SURVEY §2.3), with the calling stage on this package's engine. Importable
modules with CLI entry points:

- ``sid_tpu_torch.tools.nonsynonymous`` — codon-context syn/nonsyn classifier
  (scripts/nonsynonymous.py behavior: exon-phase -> codon offset, 3-site
  genotype window from the raw CSV, genotype-combination translation).
- ``sid_tpu_torch.tools.exons`` — exon lookup for called SNPs (Ensembl Core MySQL
  when available, or a local exon-table file; scripts/ensembl_exons.py).
- ``sid_tpu_torch.tools.pipeline`` — the run.sh chain in-process: call -> extract
  het rows -> exon filter -> nonsyn labels.
"""
