"""Stage spans and counters of a run (``--profile``).

A run records one span a stage: its name, its start and end on one
monotonic clock (``time.perf_counter_ns``), the thread that recorded it,
its parent and its request. The parent is the innermost span open on the
same thread, or, for work handed to another thread (``handover``), the
span open where it was handed over: the chunk pipeline's worker parses
under the ``pipeline`` span. A span opened inside no other is a root;
every span of one request (``request``, one ``engine.run``) shares its
identifier, and a root opened outside any request is a request of its
own. ``stages`` keeps the same spans as ``(name, seconds)`` pairs, in the
order they closed.

The stages: the whole-input path's ``parse``, ``call`` and ``serialize``;
the chunk pipeline's ``pipeline`` and, on its main thread,
``pipeline:read`` (the next chunk from the file), ``pipeline:parse_wait``,
``pipeline:call`` and ``pipeline:serialize``, its worker's
``worker:parse``, and the ``join`` of its parts after it; the fitted chunk
pipeline's (``bayes``, ``likelihood_ratio``) ``pipeline:dedup`` (a chunk's
dedup and merge into the request's table), ``fit+classify`` (the fit, once
between its passes, as in ``--stream``) and ``pipeline:gather`` in place
of ``pipeline:call``; inside a call,
``call:unique_profiles`` (the dedup), ``call:gather_result``, host blocks
(``host:<name>``: ``host:lrt_bh``, ``likelihood_ratio``'s host LRT and BH)
and device blocks (``device:<name>``). Device stages
carry sid_tpu's names where sid_tpu has the stage:
``local_log_likelihoods``, ``fit_lynch``, ``finalize_quality_het`` and
population mode's ``population_marginals``; ``population_fit`` (the
cohort's lockstep fits) has no sid_tpu counterpart. On a CUDA device,
``device_stage`` also brackets its block with CUDA events on the current
stream, so the report carries the stream's own time for the block beside
the host's wall time. The engine counts the input sites it parses
(``sites``); the fitted chunk pipeline the profiles its fit was given
(``fitted:profiles``) and the bytes it held between its passes
(``fitted:held_bytes``).

``SIDTPU_TRACE=<dir>`` also records a ``torch.profiler`` trace of the work
between ``start_device_trace`` and ``stop_device_trace`` into that
directory (Chrome trace JSON; they replace sid_tpu's jax.profiler hook,
and the CLI brackets a ``--profile`` run with them). While that trace
records, each stage is also a ``record_function`` range named
``stage:<name>`` on the thread that ran it, so the trace holds the host's
spans beside the card's kernels and copies, on the trace's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import threading
import time
from typing import Callable, ContextManager, Dict, List, NamedTuple, Optional, Tuple

import torch


class Span(NamedTuple):
    """One recorded stage; times in nanoseconds of the profile's clock."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident() of the recording thread
    id: int
    parent: Optional[int]  # the id of the span it hangs under; None for a root
    request: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass(frozen=True)
class StageTotals:
    """All spans of one name: how many, their nanoseconds, and their self
    nanoseconds (each span's own time, less its children's on its thread)."""

    count: int
    ns: int
    self_ns: int

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9

    @property
    def self_seconds(self) -> float:
        return self.self_ns * 1e-9


class StageProfile:
    """The spans and counters of one run. ``clock`` gives nanoseconds of a
    monotonic clock."""

    def __init__(self, enabled: bool = True, clock: Callable[[], int] = time.perf_counter_ns):
        self.enabled = enabled
        self.stages: List[tuple] = []  # (name, seconds), as each span closes
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self._clock = clock
        self._ids = itertools.count()
        self._local = threading.local()  # per thread: the stack of open (span id, request)
        self._lock = threading.Lock()
        self._trace_dir = os.environ.get("SIDTPU_TRACE")
        self._trace = None

    def _open(self) -> List[Tuple[Optional[int], int]]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        stack = self._open()
        span_id = next(self._ids)
        parent, request = stack[-1] if stack else (None, span_id)
        stack.append((span_id, request))
        ranged = torch.profiler.record_function("stage:" + name) if self._trace is not None else None
        try:
            with ranged or contextlib.nullcontext():
                t0 = self._clock()
                try:
                    yield
                finally:
                    t1 = self._clock()
                    self.spans.append(Span(name, t0, t1, threading.get_ident(), span_id, parent, request))
                    self.stages.append((name, (t1 - t0) * 1e-9))
        finally:
            stack.pop()

    @contextlib.contextmanager
    def request(self):
        """One request: the spans opened inside it on this thread, and the
        work handed over from them, share one identifier."""
        if not self.enabled:
            yield
            return
        stack = self._open()
        stack.append((None, next(self._ids)))
        try:
            yield
        finally:
            stack.pop()

    def handover(self) -> Callable[[], ContextManager]:
        """For work handed to another thread: called where the work is
        handed over, it returns a context manager factory which that
        thread enters around the work, so its spans hang under the span
        open here (and share its request)."""
        if not self.enabled:
            return contextlib.nullcontext
        stack = self._open()
        entry = stack[-1] if stack else None

        @contextlib.contextmanager
        def adopt():
            own = self._open()
            if entry is not None:
                own.append(entry)
            try:
                yield
            finally:
                if entry is not None:
                    own.pop()

        return adopt

    def count(self, name: str, value: float) -> None:
        if self.enabled:
            with self._lock:
                self.counters[name] = self.counters.get(name, 0.0) + value

    def start_device_trace(self) -> None:
        """Start a torch.profiler trace (host, and the card's kernels and
        copies where CUDA is present) when SIDTPU_TRACE names a directory.
        The trace takes the ranges of every thread, the pipeline's worker
        too (a profiler's default is the thread that starts it)."""
        if self._trace_dir and self._trace is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            self._trace = torch.profiler.profile(activities=activities, experimental_config=config)
            self._trace.start()

    def stop_device_trace(self) -> Optional[str]:
        """Stop the trace and write it under SIDTPU_TRACE; returns its path."""
        if self._trace is None:
            return None
        trace, self._trace = self._trace, None
        trace.stop()
        os.makedirs(self._trace_dir, exist_ok=True)
        path = os.path.join(self._trace_dir, f"sid_tpu_torch.{os.getpid()}.{time.time_ns()}.trace.json")
        trace.export_chrome_trace(path)
        return path

    def total(self) -> float:
        """Wall seconds of the top-level stages (the spans with no parent):
        a nested span is not counted twice."""
        return sum(s.seconds for s in self.spans if s.parent is None)

    def wall(self) -> float:
        """Seconds from the first span's start to the last one's end."""
        if not self.spans:
            return 0.0
        return (max(s.end_ns for s in self.spans) - min(s.start_ns for s in self.spans)) * 1e-9

    def summary(self) -> Dict[str, StageTotals]:
        """Each stage's totals, in the order the stages first started. A
        span's self time is its duration less the part of it that its
        children on the same thread cover; a child on another thread
        (the pipeline's worker) runs beside it, and takes none."""
        children: Dict[int, List[Span]] = {}
        for s in self.spans:
            if s.parent is not None:
                children.setdefault(s.parent, []).append(s)
        totals: Dict[str, List[float]] = {}
        for s in sorted(self.spans, key=lambda s: s.start_ns):
            covered = _covered([(c.start_ns, c.end_ns) for c in children.get(s.id, ()) if c.thread == s.thread],
                               s.start_ns, s.end_ns)
            t = totals.setdefault(s.name, [0, 0, 0])
            t[0] += 1
            t[1] += s.end_ns - s.start_ns
            t[2] += s.end_ns - s.start_ns - covered
        return {name: StageTotals(*t) for name, t in totals.items()}

    def report(self, log=None) -> str:
        """Each stage's total and self time and its share of the run's
        wall, the ``*_ms`` counters, each ``<stem>:bytes`` counter with its
        rate over the stages named ``<stem>`` or ``*:<stem>``, every other
        counter but ``sites``, and the rate: the sites the engine parsed
        over the wall."""
        wall = self.wall()
        summary = self.summary()
        lines = []
        for name, t in summary.items():
            pct = 100.0 * t.seconds / wall if wall else 0.0
            lines.append(f"# stage {name}: {t.seconds * 1e3:.1f} ms, self {t.self_seconds * 1e3:.1f} ms, "
                         f"{t.count} span{'s' if t.count > 1 else ''} ({pct:.0f}% of the wall)")
        for name, value in self.counters.items():
            if name.endswith("_ms"):
                lines.append(f"# {name}: {value:.3f}")
            elif name.endswith(":bytes"):
                stem = name[: -len(":bytes")]
                seconds = sum(t.seconds for n, t in summary.items() if n == stem or n.endswith(":" + stem))
                rate = f", {value / seconds * 1e-9:.2f} GB/s over its stages" if seconds > 0 else ""
                lines.append(f"# {name}: {int(value):,}{rate}")
            elif name != "sites":
                lines.append(f"# {name}: {int(value):,}" if value == int(value) else f"# {name}: {value:g}")
        n = self.counters.get("sites")
        if n and wall > 0:
            lines.append(f"# throughput: {n / wall:,.0f} sites/s over {int(n)} sites in {wall * 1e3:.1f} ms")
        text = "\n".join(lines)
        if log:
            for line in lines:
                log(line)
        return text


def _covered(intervals: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """The length of the union of ``intervals`` within [lo, hi]."""
    covered, reach = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            covered += b - a
            reach = b
    return covered


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


def in_request(fn):
    """Run each call of ``fn`` as one request (``StageProfile.request``) of
    the active profile, if any."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        p = _active
        with contextlib.nullcontext() if p is None else p.request():
            return fn(*args, **kwargs)

    return wrapper


def handover() -> Callable[[], ContextManager]:
    """``StageProfile.handover`` on the active profile, if any."""
    p = _active
    return contextlib.nullcontext if p is None else p.handover()


def count(name: str, value: float) -> None:
    """Add to a counter of the active profile, if any."""
    p = _active
    if p is not None:
        p.count(name, value)


@contextlib.contextmanager
def device_stage(name: str, device: torch.device):
    """Record a device block: host wall time under ``device:{name}``, and
    on CUDA the stream time between two events around the block under
    ``device:{name}:cuda_ms``.

    Wrap the whole transfer + kernel + fetch block, so the stage is what the
    device costs the pipeline (h2d, launch, d2h), not just kernel time.
    """
    p = _active
    if p is None:
        yield
        return
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
