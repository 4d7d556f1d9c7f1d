"""Shared calling-method machinery: allele selection, results, CSV assembly.

``CallResult`` is a struct-of-arrays over output sites (the reference's
vector<OutputRecord>, call.hpp:23-38); its CSV comes from libsidtpu's
multithreaded writer, byte-for-byte the reference's ostream output with
``%g`` floats. ``to_csv_lines`` is the Python spec of the same format.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from sid_tpu_torch.io import native
from sid_tpu_torch.io.stream import pack_profiles
from sid_tpu_torch.native import bridge
from sid_tpu_torch.utils.format import fmt_g

CSV_HEADER = "chrom,pos,label,gt,hom_conf,het_conf,conf_type"

# natural log of the smallest positive 80-bit-extended subnormal (2^-16445):
# linear long-double likelihoods below this underflow to exactly 0 in the
# reference, which flips its l2>l1 and LRT l_H0==0 branches. The log-space
# kernels clamp to -inf at this point to reproduce that behavior.
LONG_DOUBLE_UNDERFLOW_LOG = -16445.0 * math.log(2.0)

ALLELES = np.frombuffer(b"ACGT", np.uint8)

# natural logs of the normal long-double range (x86 80-bit: 2^-16382 to
# just under 2^16384), with a margin far wider than any rounding
LD_LOG_MAX = 16384 * math.log(2.0) - 1.0
LD_LOG_MIN = -16382 * math.log(2.0) + 1.0
LN4 = math.log(4.0)


def major_allele_indices_np(counts: np.ndarray):
    """Top-2 allele indices with the reference's tie-break (call.cpp:52-60).

    The reference ascending-sorts {0,1,2,3} by count with what is in practice
    a stable sort (libstdc++ insertion sort at n=4) and takes positions 3, 2:
    among tied counts the *higher* base index wins. Encoding count*4+index
    makes that tie-break explicit.
    """
    counts = np.asarray(counts, np.int64)
    scores = counts * 4 + np.arange(4, dtype=np.int64)
    order = np.argsort(scores, axis=-1)
    return order[..., 3].astype(np.int32), order[..., 2].astype(np.int32)


def long_double_screen(error_threshold: float, snp_prior: float) -> Tuple[bool, float, float]:
    """The constants of the long-double range screen
    (``models/local.py::long_double_range_rows``): (every, K, prior).

    A profile of coverage c is flagged when c ln 4 > LD_LOG_MAX or
    c K + prior > -LD_LOG_MIN, or always when ``every`` (a negative -E, so
    negative bases, or a prior of 1 or more). K is ln 4 for uncapped error
    rates and -ln of the smallest base a capped rate gives; ``prior`` is
    the larger -log of the prior's two factors, 0 without a prior. The
    local classify kernel takes these values as they are.
    """
    thr = float(error_threshold)
    if thr < 0 or snp_prior >= 1:
        return True, LN4, 0.0
    k = LN4
    if thr > 0:  # a capped rate gives the bases 1-thr, thr/3, (1-2thr/3)/2
        k = max(k, -math.log(thr / 3.0))
        if thr < 1:
            k = max(k, -math.log1p(-thr))
        if thr < 1.5:
            k = max(k, -math.log((1.0 - 2.0 / 3.0 * thr) / 2.0))
    prior = 0.0
    if snp_prior > 0:
        prior = max(-math.log(snp_prior), -math.log1p(-snp_prior))
    return False, k, prior


def clamp_ld_underflow(log_l: torch.Tensor) -> torch.Tensor:
    """Map log-likelihoods the reference would underflow to 0 onto -inf."""
    return torch.where(log_l < LONG_DOUBLE_UNDERFLOW_LOG, -math.inf, log_l)


def clamp_ld_underflow_np(log_l) -> np.ndarray:
    """Host version of clamp_ld_underflow (same 80-bit subnormal line)."""
    log_l = np.asarray(log_l, np.float64)
    return np.where(log_l < LONG_DOUBLE_UNDERFLOW_LOG, -np.inf, log_l)


@dataclasses.dataclass
class CallResult:
    """Struct-of-arrays over the emitted sites, in output order."""

    chrom_id: np.ndarray  # (M,) int32 -> chrom_table
    chrom_table: List[str]
    pos: np.ndarray  # (M,) int32
    is_het: np.ndarray  # (M,) bool
    major: np.ndarray  # (M,) int32  allele index
    second: np.ndarray  # (M,) int32
    conf_hom: np.ndarray  # (M,) float64
    conf_het: np.ndarray  # (M,) float64
    conf_type: str  # "p_value" | "probability"
    # optional per-unique-profile payload: when present, the serializer
    # formats each class once and joins via class_idx (M,) -> class row
    class_idx: Optional[np.ndarray] = None
    cls_is_het: Optional[np.ndarray] = None
    cls_major: Optional[np.ndarray] = None
    cls_second: Optional[np.ndarray] = None
    cls_conf_hom: Optional[np.ndarray] = None
    cls_conf_het: Optional[np.ndarray] = None

    @property
    def num_records(self) -> int:
        return int(self.pos.shape[0])

    def to_csv_lines(self) -> List[str]:
        """One CSV line per record (operator<<, call.hpp:29-38) in Python."""
        table = self.chrom_table
        out = []
        for k in range(self.num_records):
            het = bool(self.is_het[k])
            a = chr(ALLELES[self.major[k]])
            b = chr(ALLELES[self.second[k]]) if het else a
            out.append(
                f"{table[self.chrom_id[k]]},{self.pos[k]},{'het' if het else 'hom'},{a}{b},"
                f"{fmt_g(float(self.conf_hom[k]))},{fmt_g(float(self.conf_het[k]))},"
                f"{self.conf_type}"
            )
        return out

    def to_csv_bytes(self, include_header: bool = True) -> bytes:
        """CSV as bytes from the native writer (no transcoding)."""
        return bridge.write_csv(native.load(), self, include_header)

    def to_csv(self, include_header: bool = True) -> str:
        return self.to_csv_bytes(include_header).decode("latin1")


def join_class_table(batch, keys: np.ndarray, cls, conf_type: str) -> CallResult:
    """Join a per-class table onto a batch through packed-profile search
    (sid_tpu/models/common.py:194-233).

    ``keys`` is the sorted packed-uint64 profile table
    (``io.stream.pack_profiles``); ``cls`` the 5-tuple (is_het, major,
    second, conf_hom, conf_het) over classes. Sites whose profile is absent
    from ``keys`` (cov<4-filtered) are omitted, in input order: the
    streaming analogue of the map<profile_t,size_t> join (call.cpp:129-140).
    """
    site_keys = pack_profiles(batch.counts)
    idx = np.searchsorted(keys, site_keys)
    idx_c = np.minimum(idx, max(len(keys) - 1, 0))
    found = keys[idx_c] == site_keys if len(keys) else np.zeros(len(site_keys), bool)
    class_idx = idx_c[found].astype(np.int32)
    cls_conf_hom = np.asarray(cls[3], np.float64)
    cls_conf_het = np.asarray(cls[4], np.float64)
    return CallResult(
        chrom_id=batch.chrom_id[found],
        chrom_table=batch.chrom_table,
        pos=batch.pos[found],
        is_het=cls[0][class_idx],
        major=cls[1][class_idx],
        second=cls[2][class_idx],
        conf_hom=cls_conf_hom[class_idx],
        conf_het=cls_conf_het[class_idx],
        conf_type=conf_type,
        class_idx=class_idx,
        cls_is_het=np.asarray(cls[0]),
        cls_major=np.asarray(cls[1]),
        cls_second=np.asarray(cls[2]),
        cls_conf_hom=cls_conf_hom,
        cls_conf_het=cls_conf_het,
    )


def gather_result(
    batch,
    conf_type: str,
    inverse: np.ndarray,
    is_het_u: np.ndarray,
    major_u: np.ndarray,
    second_u: np.ndarray,
    p1_u: np.ndarray,
    p2_u: np.ndarray,
    keep_u: Optional[np.ndarray] = None,
) -> CallResult:
    """Join per-unique-profile classifications back onto input sites.

    Replaces the reference's map<profile_t,size_t> join (call.cpp:129-140):
    ``inverse`` maps each site to its unique-profile row; sites whose profile
    was filtered out (``keep_u`` False) are omitted from the output, in input
    order, like the cov<4 drop of bayes and likelihood_ratio.
    """
    chrom_id, pos = batch.chrom_id, batch.pos
    if keep_u is not None:
        site_keep = keep_u[inverse]
        # site -> unfiltered row -> filtered row
        filtered_row = np.cumsum(keep_u) - 1
        inverse = filtered_row[inverse[site_keep]]
        chrom_id, pos = chrom_id[site_keep], pos[site_keep]
    is_het_u = np.asarray(is_het_u)
    major_u = np.asarray(major_u)
    second_u = np.asarray(second_u)
    p1_u = np.asarray(p1_u, np.float64)
    p2_u = np.asarray(p2_u, np.float64)
    return CallResult(
        chrom_id=chrom_id,
        chrom_table=batch.chrom_table,
        pos=pos,
        is_het=is_het_u[inverse],
        major=major_u[inverse],
        second=second_u[inverse],
        conf_hom=p1_u[inverse],
        conf_het=p2_u[inverse],
        conf_type=conf_type,
        class_idx=np.ascontiguousarray(inverse, np.int32),
        cls_is_het=is_het_u,
        cls_major=major_u,
        cls_second=second_u,
        cls_conf_hom=p1_u,
        cls_conf_het=p2_u,
    )
