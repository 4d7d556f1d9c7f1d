"""The traced window: the port's stage spans, marked in a ``torch.profiler``
trace, and what the trace says the card did.

In a ``--trace 1`` run the port's ``StageProfile`` is active (the spans it
records under ``--profile``) and each span, like each request, is also a
``record_function`` range in the profiler's trace, so device time and host
spans share one clock. ``summarise`` reads from that trace the union of the
card's kernel, copy and set intervals over the window (``busy_s``), the
kernels' time by name, and the idle gaps, each named by the innermost span
open on the host at its middle.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from sid_tpu_torch.utils import profiling

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
REQUEST = "request"


class AnnotatedStages(profiling.StageProfile):
    """The port's stage profile, each stage also a profiler range."""

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function("stage:" + name), super().stage(name):
            yield


@contextlib.contextmanager
def annotate(name: str, enabled: bool):
    if not enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profiler(platform: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if platform == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof


def kernel_name(name: str) -> str:
    """A kernel's function name without its namespaces, return type,
    template arguments and parameters."""
    base = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return base.split("<", 1)[0].strip().rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _activity(e) -> str:
    """The kind of a trace event: its ``activity_type`` where torch gives
    one; else (torch 2.11) a device event is a copy or a set by its name,
    a synchronisation or one of the ranges below is no device work, and
    any other is a kernel."""
    get = getattr(e, "activity_type", None)
    if get is not None:
        return get()
    name = e.name()
    if name == REQUEST or name.startswith("stage:"):
        return "gpu_user_annotation" if e.device_type() == torch.autograd.DeviceType.CUDA else "user_annotation"
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "cpu"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if "Sync" in name or "Wait" in name:
        return "cuda_sync"
    return "kernel"


def summarise(prof, platform: str) -> Dict:
    """busy_s, window_s, kernels {name: [launches, seconds]} and the
    breakdown (device ops by time, the longest idle gaps by span)."""
    events = prof.profiler.kineto_results.events()
    spans, device = [], []
    kernels: Dict[str, List[float]] = {}
    for e in events:
        kind = _activity(e)
        if kind == "user_annotation" and (e.name() == REQUEST or e.name().startswith("stage:")):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif kind in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            key = kernel_name(e.name()) if kind == "kernel" else kind
            k = kernels.setdefault(key, [0, 0.0])
            k[0] += 1
            k[1] += e.duration_ns() * 1e-9
    requests = [s for s in spans if s[2] == REQUEST]
    w0 = min(s[0] for s in requests)
    w1 = max(s[1] for s in requests)
    busy = [(max(a, w0), min(b, w1)) for a, b in _union(device) if b > w0 and a < w1]
    busy_ns = sum(b - a for a, b in busy)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(t: int) -> str:
        open_ = [s for s in spans if s[0] <= t < s[1]]
        if not open_:
            return "between requests"
        name = max(open_, key=lambda s: s[0])[2]
        return name[len("stage:"):] if name.startswith("stage:") else name

    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[name, secs] for name, (_, secs) in ops],
            "idle_gaps": [[label((a + b) // 2), (b - a) * 1e-9] for a, b in gaps[:10]],
        },
    }


def stage_report(run) -> List[str]:
    """The traced window's spans and kernels, per request, for stderr."""
    lines = []
    names = sorted({n for n, _ in run.stages})
    for name in names:
        lines.append(f"# stage {name}: {run.stage_seconds(name) * 1e3 / run.requests:.3f} ms a request")
    for name, (count, secs) in sorted(run.device["kernels"].items(), key=lambda kv: -kv[1][1]):
        lines.append(f"# device {name}: {count / run.requests:.2f} a request, {secs * 1e3 / max(count, 1):.4f} ms each")
    return lines
