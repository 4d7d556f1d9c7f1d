"""The Lynch fit over a device mesh (``--devices``): sid_tpu's one
cross-shard reduction.

The port of ``sid_tpu/parallel/fit.py``. sid_tpu shards the profile
histogram over its mesh and lets XLA all-reduce each shard's sum once an
evaluation; its (pi, epsilon) then agree across mesh sizes to rel 1e-6 on
the CPU. Here the histogram is cut into contiguous shards at multiples of
the objective's chunk (``mesh.chunk_bounds``), each bound to its device once
(``LynchWorkspace``). ``ShardedLynchWorkspace`` holds the shards behind the
one-device workspace's interface, so ``models.lynch.DeviceObjective``
evaluates it as it does one device's. An evaluation enqueues every shard's B2 in its
partials-only mode, which writes the shard's chunk sums into its place in
one buffer on the first device (a view there, a device-to-device copy from
any other), then one launch of the fold kernel, which folds them in global
chunk order exactly as one-device B2's last block does, and one sync. Each
chunk sum is the one the one-device kernel stores, so the objective's bits,
and the fit's (pi, epsilon) and likelihoods, are those of the one-device
``--fit device`` fit for every shard count. The rows the range screen flags
in any shard (fault C2, ROADMAP.md) are gathered by their row in the whole
histogram and evaluated in long double over those rows, as the one-device
fit does. The marginals at the fitted epsilon run per shard (B4) and are
concatenated. The simplex runs on the host, once.
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
    """One shard of a sharded fit: its first row in the histogram, its
    workspace, the buffers its partials launch writes, its chunks' place in
    the fold's buffers, and whether those buffers are its own (on another
    device than the fold's: copied into the fold's buffers each
    evaluation) or views of the fold's."""

    first_row: int
    work: lynch_objective.LynchWorkspace
    sums: torch.Tensor
    cnts: torch.Tensor
    chunks: slice
    copied: bool


class ShardedLynchWorkspace:
    """``LynchWorkspace``'s interface for the Lynch fit (``nll``, ``flags``,
    ``marginals_host``) over a mesh, for ``DeviceObjective``: the same
    values, bit for bit, from the histogram cut into ``len(mesh)`` shards
    at multiples of ``likelihoods.CHUNK_ROWS`` (empty shards bind nothing).
    ``nll`` launches each shard's partials, one fold and one sync (on a
    card)."""

    def __init__(self, profiles: np.ndarray, mult: np.ndarray, mesh: Sequence[torch.device]):
        mesh = make_site_mesh(devices=mesh)
        profiles = np.ascontiguousarray(profiles, np.int32)
        mult = np.ascontiguousarray(mult, np.int64)
        self.u = u = profiles.shape[0]
        max_cov = int(coverage_of(profiles).max()) if u else 0
        self.device = fold = mesh[0]
        n_chunks = -(-u // likelihoods.CHUNK_ROWS)
        # every shard's chunk sums in global chunk order, on the fold's device
        self.part_sum = torch.empty(n_chunks, dtype=torch.float64, device=fold)
        self.part_cnt = torch.empty(n_chunks, dtype=torch.int32, device=fold)
        self.shards: List[Shard] = []
        bounds = chunk_bounds(u, len(mesh))
        for a, b, dev in zip(bounds[:-1].tolist(), bounds[1:].tolist(), mesh):
            if b == a:
                continue
            work = lynch_objective.LynchWorkspace(
                torch.from_numpy(profiles[a:b]).to(dev), torch.from_numpy(mult[a:b]).to(dev),
                lgamma_table(max_cov, dev))
            chunks = slice(a // likelihoods.CHUNK_ROWS, -(-b // likelihoods.CHUNK_ROWS))
            copied = dev != fold
            if copied:
                n = chunks.stop - chunks.start
                sums = torch.empty(n, dtype=torch.float64, device=dev)
                cnts = torch.empty(n, dtype=torch.int32, device=dev)
            else:
                sums, cnts = self.part_sum[chunks], self.part_cnt[chunks]
            self.shards.append(Shard(a, work, sums, cnts, chunks, copied))
        self.out = self.host_out = None
        if fold.type == "cuda":
            with torch.cuda.device(fold):
                self.out = torch.empty(2, dtype=torch.float64, device=fold)
                self.host_out = torch.empty(2, dtype=torch.float64, pin_memory=True)

    def nll(self, scalars) -> Tuple[float, float]:
        """(sum of the unflagged terms, flagged count) at one theta, bitwise
        one-device B2's over the whole histogram."""
        for shard in self.shards:
            shard.work.launch_partials(scalars, shard.sums, shard.cnts)
        for shard in self.shards:
            if shard.copied:
                self.part_sum[shard.chunks].copy_(shard.sums, non_blocking=True)
                self.part_cnt[shard.chunks].copy_(shard.cnts, non_blocking=True)
        res = lynch_objective.lynch_fold(self.part_sum, self.part_cnt, self.out, self.host_out)
        total, n_flagged = (res if self.host_out is None else self.host_out).tolist()
        return total, n_flagged

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
    bitwise its values for any mesh; ``diag`` gets the minimizer's line."""
    nt = nucleotide_distribution(profiles, mult)
    work = ShardedLynchWorkspace(profiles, mult, mesh)
    with profiling.device_stage("fit_lynch", work.device):
        res, log_l_hom, log_l_het = fit_objective(DeviceObjective(profiles, mult, nt, work=work), diag)
    return float(res.x[0]), float(res.x[1]), log_l_hom, log_l_het, nt
