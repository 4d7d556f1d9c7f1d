"""Host-side profile compaction.

The key algorithmic dedup of the engine (pileup.cpp:169-217): genome-scale
site counts collapse to a small set of unique (A,C,G,T) profiles, so all
per-profile device math is O(U) with U << N. The ordering is the
reference's lexicographic profile order (profile_t operator<), and the
inverse index replaces its ``std::map<profile_t, size_t>`` join
(call.cpp:82-86).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sid_tpu_torch.io import native
from sid_tpu_torch.native import bridge

# from this many sites on, the threaded native histogram beats the sort
_NATIVE_MIN_SITES = 65536


def unique_profiles(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact per-site base-count rows into unique profiles.

    Returns ``(profiles (U,4) int32 lexicographically sorted, multiplicity
    (U,) int64, inverse (N,) int64)`` with ``profiles[inverse] == counts``.
    Large inputs go to libsidtpu's threaded flat-hash histogram; the numpy
    path is the spec, and both give identical arrays.
    """
    counts = np.asarray(counts)
    if counts.shape[0] == 0:
        return (
            np.zeros((0, 4), np.int32),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
        )
    if counts.shape[0] >= _NATIVE_MIN_SITES:
        return bridge.unique_profiles(native.load(), counts)
    return _unique_profiles_np(counts)


def _unique_profiles_np(counts: np.ndarray):
    # pack each (c0,c1,c2,c3) row into one uint64 whose numeric order equals
    # the row's lexicographic order, then group via one sort
    c = counts.astype(np.uint64)
    keys = (c[:, 0] << 48) | (c[:, 1] << 32) | (c[:, 2] << 16) | c[:, 3]
    uniq = np.unique(keys)
    inverse = np.searchsorted(uniq, keys)
    mult = np.bincount(inverse, minlength=uniq.shape[0]).astype(np.int64)
    inverse = inverse.astype(np.int64)
    prof = np.empty((uniq.shape[0], 4), np.int32)
    prof[:, 0] = (uniq >> 48) & 0xFFFF
    prof[:, 1] = (uniq >> 32) & 0xFFFF
    prof[:, 2] = (uniq >> 16) & 0xFFFF
    prof[:, 3] = uniq & 0xFFFF
    return prof, mult, inverse


def coverage_of(profiles: np.ndarray) -> np.ndarray:
    """Per-profile coverage as int64: four column adds, the integers of
    ``profiles.sum(1)`` without numpy's slow length-4 axis reduction."""
    cov = profiles[:, 0].astype(np.int64)
    cov += profiles[:, 1]
    cov += profiles[:, 2]
    cov += profiles[:, 3]
    return cov


def filter_min_coverage(
    profiles: np.ndarray, mult: np.ndarray, min_coverage: int = 4
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop profiles below the coverage threshold (call.cpp:66-70).

    Returns (profiles, mult, kept mask over the original U axis).
    """
    keep = coverage_of(profiles) >= min_coverage
    return profiles[keep], mult[keep], keep


def nucleotide_distribution(profiles: np.ndarray, mult: np.ndarray) -> np.ndarray:
    """Weighted base composition over unique profiles (pileup.cpp:198-217):
    acc[i] = sum(mult * profile[:, i]) over the total base count, exact in
    uint64; uniform 0.25 each when the total is zero."""
    profiles = np.asarray(profiles, np.uint64)
    mult = np.asarray(mult, np.uint64)
    acc = (profiles * mult[:, None]).sum(axis=0, dtype=np.uint64)
    total = acc.sum(dtype=np.uint64)
    if total == 0:
        return np.array([0.25, 0.25, 0.25, 0.25])
    return acc.astype(np.float64) / np.float64(total)
