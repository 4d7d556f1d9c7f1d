"""The Lynch fit over a device mesh (``--devices``): sid_tpu's one
cross-shard reduction.

The port of ``sid_tpu/parallel/fit.py``. sid_tpu shards the profile
histogram over its mesh and lets XLA all-reduce each shard's sum once an
evaluation; its (pi, epsilon) then agree across mesh sizes to rel 1e-6 on
the CPU. Here the histogram is cut into contiguous shards at multiples of
the objective's chunk (``mesh.chunk_bounds``), each bound to its device once
(``LynchWorkspace``: its rows and row record). ``ShardedLynchWorkspace``
holds the shards behind the one-device workspace's interface, so
``models.lynch.DeviceObjective`` evaluates it as it does one device's.

The shards are grouped by device in mesh order (``device_groups``); the
fold's device is the mesh's first, and its group comes last. Each group
(``lynch_objective.LynchShardGroup``) builds once a table of its shards,
which each of its launches takes as a kernel parameter, and an evaluation
is one launch of the sharded objective a device (csrc/lynch.cu
``lynch_nll_shards_kernel``; a device with more than 32 shards, the table
one launch takes, launches once for each 32): it walks every chunk of the device's shards,
each chunk reduced as the one-device kernel reduces it and stored at its
global chunk index. The other devices launch first,
into buffers of their own; the fold device's one call then copies their
chunk sums into its buffers after the events their calls recorded,
launches, and its last block folds all the fit's chunk sums in the
one-device order, then copies the result into pinned memory and waits. So
one card ([cuda:0] * k) makes one launch and one call an evaluation for
every k, and D cards D launches and no fold kernel. Each chunk sum is the
one the one-device kernel stores, so the objective's bits, and the fit's
(pi, epsilon) and likelihoods, are those of the one-device ``--fit device``
fit for every mesh. The rows the range screen flags in any shard (fault
C2, ROADMAP.md) are gathered by their row in the whole histogram and
evaluated in long double over those rows, as the one-device fit does. The
marginals at the fitted epsilon run per shard (B4) and are concatenated.
The simplex runs on the host, once.

Rejected: merging a device's consecutive shards into one workspace when
the fit is made. On one card ``[cuda:0] * k`` would then be the one-device
fit, and nothing of the sharded path (the shard walk, the global chunk
index, the copies into the fold's buffers) would run on the only card
there is to hold it against the one-device fit.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sid_tpu_torch.models.lynch import DeviceObjective, fit_objective
from sid_tpu_torch.ops import likelihoods, lynch_objective
from sid_tpu_torch.ops.lgamma import lgamma_table
from sid_tpu_torch.ops.profiles import coverage_of, nucleotide_distribution
from sid_tpu_torch.parallel.mesh import chunk_bounds, make_site_mesh
from sid_tpu_torch.utils import profiling


class Shard(NamedTuple):
    """One shard of a sharded fit: its workspace and its chunks' global
    place."""

    work: lynch_objective.LynchWorkspace
    chunks: slice


def device_groups(devices: Sequence[torch.device], fold: torch.device,
                  per_launch: int = lynch_objective.SHARDS_PER_LAUNCH) -> List[Tuple[torch.device, List[int]]]:
    """The indices of shards on ``devices`` (one device each, in row order)
    grouped by device: the groups in the order their devices first appear,
    each group's shards in row order, and the group of ``fold`` (the fold's
    device, present even without shards) last. A device with more than
    ``per_launch`` shards (the table one launch takes) has a group for each
    ``per_launch`` of them in row order; the fold device's last group is the
    fold's."""
    groups = {fold: []}
    for k, dev in enumerate(devices):
        groups.setdefault(dev, []).append(k)
    cut = {dev: [idx[a:a + per_launch] for a in range(0, len(idx), per_launch)] or [[]] for dev, idx in groups.items()}
    return [(dev, idx) for dev, pieces in cut.items() if dev != fold for idx in pieces] + [
        (fold, idx) for idx in cut[fold]]


class ShardedLynchWorkspace:
    """``LynchWorkspace``'s interface for the Lynch fit (``nll``, ``flags``,
    ``marginals_host``) over a mesh, for ``DeviceObjective``: the same
    values, bit for bit, from the histogram cut into ``len(mesh)`` shards
    at multiples of ``likelihoods.CHUNK_ROWS`` (empty shards bind nothing).
    ``nll`` is one launch a device that holds shards (on one card, one
    launch and one sync), or one for each ``SHARDS_PER_LAUNCH`` (32) shards
    of a device that holds more."""

    def __init__(self, profiles: np.ndarray, mult: np.ndarray, mesh: Sequence[torch.device]):
        mesh = make_site_mesh(devices=mesh)
        profiles = np.ascontiguousarray(profiles, np.int32)
        mult = np.ascontiguousarray(mult, np.int64)
        self.u = u = profiles.shape[0]
        max_cov = int(coverage_of(profiles).max()) if u else 0
        self.device = fold = mesh[0]
        self.n_chunks = n_chunks = -(-u // likelihoods.CHUNK_ROWS)
        self.shards: List[Shard] = []
        bounds = chunk_bounds(u, len(mesh))
        for a, b, dev in zip(bounds[:-1].tolist(), bounds[1:].tolist(), mesh):
            if b == a:
                continue
            work = lynch_objective.LynchWorkspace(
                torch.from_numpy(profiles[a:b]).to(dev), torch.from_numpy(mult[a:b]).to(dev),
                lgamma_table(max_cov, dev))
            self.shards.append(Shard(work, slice(a // likelihoods.CHUNK_ROWS, -(-b // likelihoods.CHUNK_ROWS))))
        groups = device_groups([s.work.device for s in self.shards], fold)
        peers = [self.group(dev, idx) for dev, idx in groups[:-1]]
        self.groups = peers + [self.group(fold, groups[-1][1], peers)]

    def group(self, device: torch.device, shards: Sequence[int], peers=None) -> lynch_objective.LynchShardGroup:
        """The launch group of the shards ``shards`` (indices into
        ``shards``) on ``device``: with ``peers`` (the other groups) the
        fold's group, else one whose chunk sums the fold copies in."""
        return lynch_objective.LynchShardGroup(
            device, [(self.shards[k].work, self.shards[k].chunks.start) for k in shards], self.n_chunks,
            peers is not None, peers or ())

    def nll(self, scalars) -> Tuple[float, float]:
        """(sum of the unflagged terms, flagged count) at one theta, bitwise
        one-device B2's over the whole histogram: every other device's
        launch, then the fold's (its copies, launch, fetch and sync)."""
        for g in self.groups[:-1]:
            g.launch(scalars)
        return self.groups[-1].nll(scalars)

    @property
    def flags(self) -> torch.Tensor:
        """The last evaluation's (U,) uint8 range-screen flags on the host,
        every shard's in row order."""
        return torch.cat([torch.zeros(0, dtype=torch.uint8)] + [s.work.flags.cpu() for s in self.shards])

    def marginals_host(self, scalars) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """B4 at one epsilon per shard, as host arrays concatenated in row
        order (log L_hom, log L_het, uint8 flags)."""
        parts = [s.work.marginals_host(scalars) for s in self.shards]
        if not parts:
            return np.zeros(0), np.zeros(0), np.zeros(0, np.uint8)
        lhom, lhet, flags = (np.concatenate([p[k] for p in parts]) for k in range(3))
        return lhom, lhet, flags


def fit_lynch_global(
    profiles: np.ndarray,
    mult: np.ndarray,
    mesh: Sequence[torch.device],
    diag: Optional[Callable[[str], None]] = None,
) -> Tuple[float, float, np.ndarray, np.ndarray, np.ndarray]:
    """Fit (pi, epsilon) with the profile histogram sharded over ``mesh`` (a
    list of torch devices, ``parallel.mesh.make_site_mesh``). Returns (pi,
    eps, log_l_hom, log_l_het, nt) like ``models.lynch.fit_on_filtered_profiles``,
    bitwise its values for any mesh; ``diag`` gets the minimizer's line. An
    evaluation is one launch a device, or one for each
    ``lynch_objective.SHARDS_PER_LAUNCH`` (32) shards of a device that the
    mesh lists more often."""
    nt = nucleotide_distribution(profiles, mult)
    work = ShardedLynchWorkspace(profiles, mult, mesh)
    with profiling.device_stage("fit_lynch", work.device):
        res, log_l_hom, log_l_het = fit_objective(DeviceObjective(profiles, mult, nt, work=work), diag)
    return float(res.x[0]), float(res.x[1]), log_l_hom, log_l_het, nt
