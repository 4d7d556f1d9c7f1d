"""Per-stage wall-clock timers and sites/sec counters (``--profile``).

A run records stage timings (parse, call, serialize, the device block) and
derived throughput, printable as a stderr report or a dict;
``SIDTPU_TRACE=<dir>`` also records a ``torch.profiler`` trace of the work
between ``start_device_trace`` and ``stop_device_trace`` into that
directory (Chrome trace JSON; they replace sid_tpu's jax.profiler hook, and
the CLI brackets a ``--profile`` run with them). On a CUDA
device, ``device_stage`` also brackets its block with CUDA events on the
current stream, so the report carries the stream's own time for the block
beside the host's wall time.

Device stages carry sid_tpu's names where sid_tpu has the stage:
``local_log_likelihoods``, ``fit_lynch``, ``finalize_quality_het`` and
population mode's ``population_marginals``; ``population_fit`` (the cohort's
lockstep fits) has no sid_tpu counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


class StageProfile:
    """Accumulates named stage durations for one pipeline run."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: List[tuple] = []  # (name, seconds)
        self.counters: Dict[str, float] = {}
        self._trace_dir = os.environ.get("SIDTPU_TRACE")
        self._trace = None

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def count(self, name: str, value: float) -> None:
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def start_device_trace(self) -> None:
        """Start a torch.profiler trace (host, and the card's kernels and
        copies where CUDA is present) when SIDTPU_TRACE names a directory."""
        if self._trace_dir and self._trace is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=activities)
            self._trace.start()

    def stop_device_trace(self) -> Optional[str]:
        """Stop the trace and write it under SIDTPU_TRACE; returns its path."""
        if self._trace is None:
            return None
        self._trace.stop()
        os.makedirs(self._trace_dir, exist_ok=True)
        path = os.path.join(self._trace_dir, f"sid_tpu_torch.{os.getpid()}.{time.time_ns()}.trace.json")
        self._trace.export_chrome_trace(path)
        self._trace = None
        return path

    def total(self) -> float:
        """Wall seconds of the top-level stages (device stages nest inside
        "call" and are not counted twice)."""
        return sum(s for name, s in self.stages if not name.startswith("device:"))

    def report(self, log=None) -> str:
        lines = []
        total = self.total()
        for name, sec in self.stages:
            pct = 100.0 * sec / total if total else 0.0
            lines.append(f"# stage {name}: {sec*1e3:.1f} ms ({pct:.0f}%)")
        for name, value in self.counters.items():
            if name.endswith("_ms"):
                lines.append(f"# {name}: {value:.3f}")
        n = self.counters.get("sites")
        if n and total > 0:
            lines.append(f"# throughput: {n/total:,.0f} sites/s over {int(n)} sites")
        text = "\n".join(lines)
        if log:
            for line in lines:
                log(line)
        return text


_active: Optional[StageProfile] = None


def activate(profile: Optional[StageProfile]) -> None:
    global _active
    _active = profile


@contextlib.contextmanager
def maybe_stage(name: str):
    """Record a stage on the active profile, if any (library-internal hook)."""
    p = _active
    if p is None:
        yield
    else:
        with p.stage(name):
            yield


@contextlib.contextmanager
def device_stage(name: str, device: torch.device):
    """Record a device block: host wall time under ``device:{name}``, a
    ``device_dispatches`` counter, and on CUDA the stream time between two
    events around the block under ``device:{name}:cuda_ms``.

    Wrap the whole transfer + kernel + fetch block, so the stage is what the
    device costs the pipeline (h2d, launch, d2h), not just kernel time.
    """
    p = _active
    if p is None:
        yield
        return
    p.count("device_dispatches", 1)
    if device.type != "cuda":
        with p.stage(f"device:{name}"):
            yield
        return
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with p.stage(f"device:{name}"):
        start.record(stream)
        yield
        end.record(stream)
        end.synchronize()
    p.count(f"device:{name}:cuda_ms", start.elapsed_time(end))


def device_seconds(profile: StageProfile) -> float:
    """Total wall seconds spent in device stages of one run."""
    return sum(sec for name, sec in profile.stages if name.startswith("device:"))
