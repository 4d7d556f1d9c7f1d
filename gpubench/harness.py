"""One run of one cell: set-up, the measured window, the traced window's
readings, and the check against the reference.

Everything a cell names is found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration (``gpubench/configs/<name>.json``)
and traffic (``gpubench/traffic/<name>.json``), and each metric is read by
``gpubench/metrics/<name>.py``; a traced run wraps the port's functions that
the roofline models ``gpubench/rooflines/<name>.py`` name. A request is the
path of one pileup file, written once a run, handed to
``sid_tpu_torch.engine.run(path, options, diag, binary=True)``, the call the
port's CLI makes; one client sends them back to back (a closed loop).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import json
import math
import os
import resource
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "sid_tpu")


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def find_cell(spec: dict, workload: str, root: str = ROOT) -> dict:
    """The cell's entry with its configuration and traffic files loaded."""
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"gpubench: no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": load_json(root, entry["file"]),
        "traffic": load_json(root, "gpubench", "traffic", cell["traffic"] + ".json"),
    }


def cell_metrics(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (those listing the cell, or listing
    no cells and moving a metric the cell reports)."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m["workloads"] or ("workloads" not in m and m["moves"] in names)]


def load_file(path: str, name: str):
    """The module in ``path``, under ``name``."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reader(name: str, root: str = ROOT) -> Callable:
    """``read`` of ``gpubench/metrics/<name>.py``."""
    path = os.path.join(root, "gpubench", "metrics", name + ".py")
    return load_file(path, "gpubench_metric_" + name.replace(".", "_")).read


def forbidden_modules(names) -> List[str]:
    """The top-level names among ``names`` that are JAX's or the JAX
    package's, each compared whole (``sid_tpu_torch`` is not ``sid_tpu``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def process_start() -> float:
    """This process's start on the ``time.time`` clock (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    setup: Dict[str, float]
    request_walls: List[float]
    window_s: float
    sites_per_request: int
    stages: List[tuple] = dataclasses.field(default_factory=list)
    device: Optional[dict] = None  # the traced window: trace.summarise
    calls: Dict[str, list] = dataclasses.field(default_factory=dict)  # roofline model: its calls' records

    @property
    def requests(self) -> int:
        return len(self.request_walls)

    def stage_seconds(self, name: str) -> float:
        return sum(s for n, s in self.stages if n == name)

    def has_stage(self, name: str) -> bool:
        return any(n == name for n, _ in self.stages)


def device_info(chips: int) -> dict:
    """The card's name, the device count and the power limit."""
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


@contextlib.contextmanager
def recording(run: Run, root: str = ROOT):
    """Wrap the port's function that each roofline model names
    (``rooflines/<name>.py``'s ``WRAPS``) and keep its ``record`` of each
    call in ``run.calls[<name>]``."""
    from gpubench import rooflines

    with contextlib.ExitStack() as stack:
        for name in rooflines.names(root):
            work_model = rooflines.model(name, root)
            stack.enter_context(_wrapped(work_model.WRAPS, work_model.record, run.calls.setdefault(name, [])))
        yield


@contextlib.contextmanager
def _wrapped(target: str, record: Callable, records: list):
    module_name, attr = target.split(":")
    module = importlib.import_module(module_name)
    inner = getattr(module, attr)

    @functools.wraps(inner)
    def wrapper(*args, **kwargs):
        records.append(record(*args, **kwargs))
        return inner(*args, **kwargs)

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, inner)


def cpu_seconds() -> float:
    """User and system CPU seconds of all this process's threads."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return usage.ru_utime + usage.ru_stime


def steal_seconds() -> Optional[float]:
    """Steal time of all CPUs so far (``/proc/stat``), in seconds."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def host_reading() -> Dict[str, Optional[float]]:
    """The host's pace so far: this process's user and system CPU seconds,
    and the seconds the hypervisor took the machine's CPUs away (steal)."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return {"user": usage.ru_utime, "sys": usage.ru_stime, "steal": steal_seconds()}


# a request's output is compared with the first request's at these many
# blocks of this many bytes, drawn from the seed, and its last block
PROBES, PROBE_BYTES = 64, 4096


def _same(out: bytes, diag: List[str], first: tuple, offsets: List[int]) -> bool:
    """Whether an output and its diagnostics agree with ``first``'s at the
    probed blocks (and in length)."""
    ref, ref_diag = first
    return (len(out) == len(ref) and diag == ref_diag and out[-PROBE_BYTES:] == ref[-PROBE_BYTES:]
            and all(out[o : o + PROBE_BYTES] == ref[o : o + PROBE_BYTES] for o in offsets))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """Set up, measure, check. Returns the result (the contract's keys and
    ``checks``). ``device`` is ``device_info``'s card; without one the same
    steps run on the CPU, on the port's plain versions (for tests). The
    input is written once to a file under the temporary directory
    (``TMPDIR``) and removed when the run ends."""
    fd, path = tempfile.mkstemp(prefix="gpubench-", suffix=".pileup")
    os.close(fd)
    try:
        return _run_cell(cell, seed, seconds, trace, device, t_start, path)
    finally:
        os.unlink(path)


def _run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: Optional[dict], t_start: Optional[float],
              path: str) -> dict:
    platform = "cuda" if device else "cpu"
    import numpy as np
    import torch

    from gpubench import trace as tracing
    from gpubench.reference import check
    from gpubench.traffic import generate

    t_start = process_start() if t_start is None else t_start
    setup: Dict[str, float] = {}
    from sid_tpu_torch import engine
    from sid_tpu_torch.config import Options
    from sid_tpu_torch.native import build
    from sid_tpu_torch.utils import profiling

    if platform == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup["imports_and_context"] = time.time() - t_start

    t = time.time()
    build.host_library()
    if platform == "cuda":
        build.kernel_libraries()
    setup["kernel_libraries"] = time.time() - t

    t = time.time()
    traffic = cell["traffic"]
    size = generate.write_pileup(traffic, seed, path)
    ratio = traffic.get("min_pipeline_ratio")
    if ratio is not None and size < ratio * engine.PIPELINE_MIN_BYTES:
        raise SystemExit(f"gpubench: input of {size} bytes is under {ratio} x the chunk pipeline's "
                         f"gate ({engine.PIPELINE_MIN_BYTES} bytes)")
    setup["input"] = time.time() - t
    log(f"# input: {traffic['sites']} sites, {size} bytes written and synced, {setup['input']:.3f} s")
    options = Options(platform=platform, **cell["config"]["options"])

    def request(diag: List[str]) -> bytes:
        return engine.run(path, options, diag.append, binary=True)

    t = time.time()
    request([])
    if platform == "cuda":
        torch.cuda.synchronize()
    setup["warmup"] = time.time() - t
    setup["total"] = time.time() - t_start
    for name, value in setup.items():
        log(f"# setup {name}: {value:.3f} s")

    # kept for the check: the first output, one of the later ones drawn
    # from the seed, and every one that differs from the first at a probe
    draw = np.random.default_rng([seed & (2**64 - 1), 2**32])
    first, drawn, differ, offsets = None, None, [], []
    walls: List[float] = []
    stages = tracing.AnnotatedStages()
    with contextlib.ExitStack() as stack:
        run = Run(setup, walls, 0.0, traffic["sites"])
        if trace:
            profiling.activate(stages)
            stack.callback(profiling.activate, None)
            stack.enter_context(recording(run))
            prof = stack.enter_context(tracing.profiler(platform))
        host0, cpus = host_reading(), []
        w0 = time.perf_counter()
        while True:
            diag: List[str] = []
            t0, c0 = time.perf_counter(), cpu_seconds()
            with tracing.annotate("request", trace):
                out = request(diag)
            walls.append(time.perf_counter() - t0)
            cpus.append(cpu_seconds() - c0)
            if first is None:
                first = (out, diag)
                offsets = draw.integers(0, max(len(out) - PROBE_BYTES, 1), PROBES).tolist()
            elif not _same(out, diag, first, offsets):
                differ.append((out, diag))
            elif draw.random() * (len(walls) - 1) < 1:  # each later request alike
                drawn = (out, diag)
            del out
            if time.perf_counter() - w0 >= seconds:
                break
        run.window_s = time.perf_counter() - w0
        host = {k: None if v is None or host0[k] is None else v - host0[k] for k, v in host_reading().items()}
    log(f"# window: {len(walls)} requests in {run.window_s:.3f} s, {len(differ)} differing from the first "
        "at a probe; request walls (s): " + " ".join(f"{w:.3f}" for w in walls))
    # the host's pace: CPU seconds of the process's threads, a request and a
    # Msite, and the seconds the hypervisor took the machine's CPUs away
    cpu_s = host["user"] + host["sys"]
    log("# window: request CPU s: " + " ".join(f"{c:.2f}" for c in cpus))
    log(f"# window: {cpu_s:.3f} CPU s ({host['user']:.3f} user, {host['sys']:.3f} system), "
        f"{1e6 * cpu_s / (len(walls) * traffic['sites']):.6f} a Msite; steal {host['steal']!r} s")
    if trace:
        run.stages = list(stages.stages)
        run.device = tracing.summarise(prof, platform)
    peak = int(torch.cuda.max_memory_allocated()) if platform == "cuda" else 0
    if platform == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the window has closed, from the file the port read
    t = time.time()
    stated = cell["config"]["options"]
    exp = check.expected(stated, *check.parse(stated, np.fromfile(path, np.uint8)))
    numbers = _check_outputs([first] + ([drawn] if drawn else []) + differ, exp, check)
    log(f"# reference: {time.time() - t:.3f} s")

    limits = cell["config"]["limits"]
    for k in sorted(set(numbers) - set(limits)):
        log(f"# {k} (not compared): {numbers[k]!r}")
    # JSON has no infinity: a number past every limit reads as the largest double
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else sys.float_info.max, "limit": limits[k]}
              for k in limits}
    correct = all(numbers[k] <= limits[k] for k in limits)
    metrics = {}
    for m in cell_metrics(load_spec(), cell["cell"]["name"], trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device or {"platform": "cpu", "kind": "cpu", "count": 0}, memory_peak_bytes=peak)
    result = {"correct": correct, "attempted": len(walls), "failed": 0, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.device["busy_s"]
        device["window_s"] = run.device["window_s"]
        result["breakdown"] = run.device["breakdown"]
        for line in tracing.stage_report(run):
            log(line)
    result["checks"] = checks
    return result


def _check_outputs(outputs: List[tuple], exp, check) -> Dict[str, float]:
    """The worst of each number over the distinct (output, diagnostics)
    pairs (equal ones compared once)."""
    distinct: List[tuple] = []
    for pair in outputs:
        if pair not in distinct:
            distinct.append(pair)
    worst: Dict[str, float] = {}
    for out, diag in distinct:
        for k, v in check.compare(out, diag, exp).items():
            worst[k] = max(worst.get(k, v), v)
    if len(distinct) > 1:
        log(f"# {len(distinct)} distinct outputs among {len(outputs)} compared")
    return worst


def main(args) -> int:
    t_start = process_start()
    spec = load_spec()
    cell = find_cell(spec, args.workload)
    chips = cell["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"gpubench: the cell needs {chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    info = device_info(chips)
    log(f"# device: {info['kind']} (count {torch.cuda.device_count()}, using {chips}), "
        f"power limit {info['power_limit']}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), info, t_start)
    found = forbidden_modules(list(sys.modules))
    if found:
        log(f"gpubench: modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0
