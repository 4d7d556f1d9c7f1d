"""The device mesh of ``--devices`` and how rows are cut over it.

The port of ``sid_tpu/parallel/mesh.py``. sid_tpu's mesh is a 1-D
``jax.sharding.Mesh`` over the site axis, and XLA places each shard of a
row-sharded array on its device. Here the mesh is a plain list of indexed
torch devices, and the callers cut their rows into contiguous shards
(``shard_bounds``) and run each shard's kernels on its device: the fit
(``parallel.fit``), the local classify (``ops.local_classify``), the quality
finalize (``ops.quality_finalize``) and population mode's sample axis
(``models.population``). A list may name one device more than once
(``[cuda:0] * 4``, ``[cpu] * 8``): shard counts above the card count run
as partitions on one card, with the bits of any other count.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from sid_tpu_torch.ops.likelihoods import CHUNK_ROWS


def platform_devices(device: torch.device) -> List[torch.device]:
    """Every device of ``device``'s type that this process sees, indexed:
    ``cuda:0 .. cuda:count-1``, or the one ``cpu``."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def make_site_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The 1-D mesh over the site axis: ``devices`` (default: every CUDA
    device, or the CPU without CUDA), cut to ``n_devices`` as sid_tpu cuts
    its list (``devices[:n_devices]``, so ``--devices 4`` on one card is a
    mesh of one). Index-less CUDA devices get the current device's index.
    Raises ValueError when nothing is left."""
    if devices is None:
        devices = platform_devices(torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError(f"--devices {n_devices} selects no device")
    return [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in devs]


def shard_bounds(n_rows: int, n_shards: int, multiple: int = 1) -> np.ndarray:
    """(n_shards + 1,) row offsets of ``n_rows`` rows cut into contiguous
    shards: each shard ceil(ceil(n_rows / multiple) / n_shards) blocks of
    ``multiple`` rows, the last ones short or empty (sid_tpu's row
    sharding, without its power-of-two padding)."""
    blocks = -(-n_rows // multiple)
    per = -(-blocks // n_shards) * multiple
    return np.minimum(np.arange(n_shards + 1, dtype=np.int64) * per, n_rows)


def chunk_bounds(n_rows: int, n_shards: int) -> np.ndarray:
    """``shard_bounds`` at multiples of the Lynch objective's chunk
    (``likelihoods.CHUNK_ROWS``, 1,024 rows), so every shard's chunk sums
    are the whole histogram's; shards are empty when n_rows < n_shards *
    1,024."""
    return shard_bounds(n_rows, n_shards, CHUNK_ROWS)


def run_sharded(n_rows: int, mesh: Sequence[torch.device], enqueue: Callable) -> tuple:
    """Rows 0..n_rows-1 over ``mesh`` in contiguous shards: ``enqueue(a, b,
    device)`` starts shard [a, b)'s work on its device and returns a
    callable that waits for it and returns its results. Every shard is
    enqueued before any is waited for; empty shards run nothing (no rows
    at all run as one empty shard on the first device). Returns the tuple
    of results, each part concatenated over the shards in row order."""
    bounds = shard_bounds(n_rows, len(mesh))
    waits = [enqueue(int(a), int(b), dev) for a, b, dev in zip(bounds[:-1], bounds[1:], mesh) if b > a]
    parts = [w() for w in (waits or [enqueue(0, 0, mesh[0])])]
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(len(parts[0])))
