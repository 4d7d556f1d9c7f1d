"""Merging unique-profile histograms.

``merge_histograms`` is ``sid_tpu/parallel/distributed.py:92-103``: the sum
of (profiles, mult) histograms, by packed profile key, in the keys' order.
Population mode's pooled fit runs on the merge of its samples' histograms.
The rest of that module (multi-host ranges, the all-gather) waits for
``--multihost``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sid_tpu_torch.io.stream import pack_profiles, unpack_profiles


def merge_histograms(parts: List[Tuple[np.ndarray, np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
    """Merge (profiles, mult) histograms: (profiles (U,4) int32 sorted,
    mult (U,) int64)."""
    keys = np.concatenate([pack_profiles(p) for p, _ in parts]) if parts else np.zeros(0, np.uint64)
    weights = np.concatenate([m for _, m in parts]) if parts else np.zeros(0, np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    mult = np.zeros(uniq.shape[0], np.int64)
    np.add.at(mult, inv, weights.astype(np.int64))
    return unpack_profiles(uniq), mult
