"""Shared calling-method machinery: allele selection, results, CSV assembly.

``CallResult`` is the reference's vector<OutputRecord> (call.hpp:23-38):
the sites and one class table, each site's int32 row in it, or the table
over the sites where there are no rows (``-m quality``). Its CSV comes
from a multithreaded native writer (the port's in-place indexed writer, or
libsidtpu's per-site one), byte-for-byte the reference's ostream output
with ``%g`` floats. ``to_csv_lines`` is the Python spec of the same format.
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
from sid_tpu_torch.utils import profiling
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


# the five arrays of a call's answer, over classes or over sites
ANSWER = ("is_het", "major", "second", "conf_hom", "conf_het")


@dataclasses.dataclass
class CallResult:
    """The emitted sites, in output order, and their answer: row
    ``class_idx[k]`` of the five answer arrays is site k's, or row k where
    ``class_idx`` is None."""

    chrom_id: np.ndarray  # (M,) int32 -> chrom_table
    chrom_table: List[str]
    pos: np.ndarray  # (M,) int32
    is_het: np.ndarray  # (C,) bool
    major: np.ndarray  # (C,) int32  allele index
    second: np.ndarray  # (C,) int32
    conf_hom: np.ndarray  # (C,) float64
    conf_het: np.ndarray  # (C,) float64
    conf_type: str  # "p_value" | "probability"
    class_idx: Optional[np.ndarray] = None  # (M,) int32 row in the C classes; None: C = M

    @property
    def num_records(self) -> int:
        return int(self.pos.shape[0])

    def per_site(self) -> "CallResult":
        """This result with one class a site: the answer arrays gathered
        through ``class_idx`` (itself where it has none). The writers take
        the class table as it is; this is for the Python spec and tests."""
        if self.class_idx is None:
            return self
        return dataclasses.replace(
            self, class_idx=None, **{name: getattr(self, name)[self.class_idx] for name in ANSWER})

    def to_csv_lines(self) -> List[str]:
        """One CSV line per record (operator<<, call.hpp:29-38) in Python."""
        site = self.per_site()
        table = self.chrom_table
        out = []
        for k in range(self.num_records):
            het = bool(site.is_het[k])
            a = chr(ALLELES[site.major[k]])
            b = chr(ALLELES[site.second[k]]) if het else a
            out.append(
                f"{table[self.chrom_id[k]]},{self.pos[k]},{'het' if het else 'hom'},{a}{b},"
                f"{fmt_g(float(site.conf_hom[k]))},{fmt_g(float(site.conf_het[k]))},"
                f"{self.conf_type}"
            )
        return out

    def to_csv_buffer(self, include_header: bool = True):
        """The CSV as a bytes-like object, for a join or a write: with a
        class table the port's in-place writer's exact-size uint8 array,
        else libsidtpu's per-site writer's bytes."""
        if self.class_idx is None:
            return bridge.write_csv(native.load(), self, include_header)
        return bridge.write_csv_indexed(native.load(), native.csv_writer(), self, include_header)

    def csv_plan(self, include_header: bool = True):
        """The in-place writer's plan of a result with a class table, for a
        caller that owns the buffer: entered, (the CSV's exact size, a
        ``fill(address)`` that writes it there); ``bridge.csv_plan``."""
        return bridge.csv_plan(native.load(), native.csv_writer(), self, include_header)

    def to_csv_bytes(self, include_header: bool = True) -> bytes:
        """CSV as bytes from the native writer (no transcoding)."""
        return bytes(self.to_csv_buffer(include_header))

    def to_csv(self, include_header: bool = True) -> str:
        return str(self.to_csv_buffer(include_header), "latin1")


def join_class_table(batch, keys: np.ndarray, cls, conf_type: str) -> CallResult:
    """Join a class table onto a batch through packed-profile search
    (sid_tpu/models/common.py:194-233).

    ``keys`` is the sorted packed-uint64 profile table
    (``io.stream.pack_profiles``); ``cls`` the 5-tuple (is_het, major,
    second, conf_hom, conf_het) over classes, the result's class table.
    Sites whose profile is absent from ``keys`` (cov<4-filtered) are
    omitted, in input order: the streaming analogue of the
    map<profile_t,size_t> join (call.cpp:129-140).
    """
    site_keys = pack_profiles(batch.counts)
    idx = np.searchsorted(keys, site_keys)
    idx_c = np.minimum(idx, max(len(keys) - 1, 0), dtype=np.int32)
    found = keys[idx_c] == site_keys if len(keys) else np.zeros(len(site_keys), bool)
    return CallResult(
        chrom_id=batch.chrom_id[found],
        chrom_table=batch.chrom_table,
        pos=batch.pos[found],
        conf_type=conf_type,
        class_idx=idx_c[found],
        **_answer(*cls),
    )


def _answer(is_het, major, second, conf_hom, conf_het) -> dict:
    """A class table's five arrays as ``CallResult`` fields."""
    return dict(is_het=np.asarray(is_het), major=np.asarray(major), second=np.asarray(second),
                conf_hom=np.asarray(conf_hom, np.float64), conf_het=np.asarray(conf_het, np.float64))


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
    """Join per-unique-profile classifications onto input sites: the five
    arrays are the result's class table, ``inverse`` (int32, as
    ``ops.profiles`` returns it) its ``class_idx``.

    Replaces the reference's map<profile_t,size_t> join (call.cpp:129-140):
    sites whose profile was filtered out (``keep_u`` False; the arrays then
    run over the kept profiles) are omitted, in input order, like the cov<4
    drop of bayes and likelihood_ratio. Under ``--profile`` the stage
    ``call:gather_result``.
    """
    with profiling.maybe_stage("call:gather_result"):
        chrom_id, pos = batch.chrom_id, batch.pos
        if keep_u is not None:
            # site -> unfiltered row -> filtered row, -1 where filtered out:
            # one gather a site, and the sites compressed only if one drops
            inverse = np.where(keep_u, np.cumsum(keep_u, dtype=np.int32) - 1, -1)[inverse]
            site_keep = inverse >= 0
            if not site_keep.all():
                inverse, chrom_id, pos = inverse[site_keep], chrom_id[site_keep], pos[site_keep]
        return CallResult(
            chrom_id=chrom_id,
            chrom_table=batch.chrom_table,
            pos=pos,
            conf_type=conf_type,
            class_idx=inverse,
            **_answer(is_het_u, major_u, second_u, p1_u, p2_u),
        )
