"""Command-line interface, flag-compatible with the reference ``sid``.

Reproduces sid.cpp:11-110 as ``sid_tpu.cli`` does: the same short flags with
the same defaults and help text (-m method, -r fixed prior, -R estimated
prior, -p significance level, -E site error cap, -h), the header-only output
for unrecognized methods, "No file name given!" on missing input, and the
exit codes. Long options are sid_tpu's. ``--platform`` names the torch
device (default cuda); without CUDA the run exits 1 unless ``--platform
cpu`` was given. ``--devices N`` runs the device work over the first N
devices of that platform (one CPU device; every card the process sees),
and exits 1 when N selects none. ``--multihost`` (or
``SIDTPU_NUM_PROCESSES`` in the environment) runs this process as one of a
torch.distributed group.
"""

from __future__ import annotations

import getopt
import os
import sys
from typing import List, Optional

from sid_tpu_torch import engine
from sid_tpu_torch.config import Options
from sid_tpu_torch.utils.checkpoint import StreamProgress
from sid_tpu_torch.utils.errors import SidParseError
from sid_tpu_torch.utils.profiling import StageProfile, activate

# (name-for-help, takes_arg, description) in the reference's map order
# (std::map<char, ...> iterates in char order: E R h m p r; sid.cpp:26-58)
_REF_OPTIONS = [
    ("E", "ERROR", True,
     "Maximum allowed site error rate for 'local' method. Default: 0.1"),
    ("R", "", False,
     "Estimate SNP prior from data, applicable for methods 'likelihood_ratio', 'local', 'quality'. Conflicts -r."),
    ("h", "help", False, "Print this help message"),
    ("m", "METHOD", True,
     "Select the method to use for SNP calling: 'likelihood_ratio' , 'bayes', 'local' or 'quality', default: local"),
    ("p", "LEVEL", True,
     "Significance level for statistical tests, only applicable for methods 'likelihood_ratio', 'local'. Default: 0.05"),
    ("r", "PRIOR", True,
     "Use the given prior for SNPs, applicable for methods 'local', 'quality'. Conflicts -R. Default: no prior"),
]

_LONG_OPTIONS = [
    ("engine=", "Compute engine: 'device' (torch device, default) or 'exact' (host long-double oracle)"),
    ("fit=", "Lynch fit backend: 'auto' (default), 'device', or 'exact'"),
    ("io=", "Pileup parser backend: 'auto' (default), 'native', 'python'"),
    ("output=", "Output CSV path ('-' = stdout, default)"),
    ("devices=", "Number of mesh devices for the site axis (default: one device, no mesh)"),
    ("per-shard-fit", "Fit the Lynch model per chromosome (reference-script semantics) instead of globally"),
    ("stream", "Two-pass streaming mode: memory bounded by --chunk-mb, identical output"),
    ("chunk-mb=", "Streaming chunk size in MB (default 64)"),
    ("profile", "Print per-stage timing report to stderr"),
    ("platform=", "Torch device: 'cuda' (default) or 'cpu'; also honored from SIDTPU_PLATFORM"),
    ("checkpoint=", "Persist/reuse the pass-1 histogram (.npz) in streaming or multihost mode"),
    ("resume", "Resume a streaming/multihost run: reuse checkpoint + completed chunks/parts"),
    ("population=", "Joint multi-sample calling: 'pooled' (shared error rate) or 'independent'; all positional args are sample pileups, outputs <input>.calls.csv"),
    ("multihost", "Multi-host data-parallel run (torch.distributed, gloo): requires --output; reads SIDTPU_COORDINATOR/SIDTPU_NUM_PROCESSES/SIDTPU_PROCESS_ID"),
    ("help", "Print this help message"),
]


def _print_help(out=None) -> None:
    out = out if out is not None else sys.stdout
    print("sid [flags] input_file", file=out)
    for char, name, has_arg, desc in _REF_OPTIONS:
        arg = f" {name}" if has_arg else ""
        print(f"\t-{char}{arg}\t{desc}", file=out)
    for name, desc in _LONG_OPTIONS:
        arg = name.rstrip("=")
        suffix = " VALUE" if name.endswith("=") else ""
        print(f"\t--{arg}{suffix}\t{desc}", file=out)


def _atof(s: str) -> float:
    """C atof: parse a leading float, 0.0 on garbage (sid.cpp uses atof)."""
    import re

    m = re.match(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|"
                 r"0[xX][0-9a-fA-F]+|inf(inity)?|nan)", s)
    if not m:
        return 0.0
    try:
        return float(m.group(0))
    except ValueError:
        return 0.0


def _fail(message: str) -> None:
    print(f"sid: {message}", file=sys.stderr)
    sys.exit(1)


def parse_args(argv: List[str]) -> tuple:
    """Returns (options, input_path); exits on usage errors."""
    opts = Options()
    shortopts = "E:Rhm:p:r:"
    longopts = [name for name, _ in _LONG_OPTIONS]
    try:
        parsed, rest = getopt.gnu_getopt(argv, shortopts, longopts)
    except getopt.GetoptError as e:
        # C getopt prints its own diagnostic before the reference exits
        _fail(e.msg)  # unknown flag: exit(EXIT_FAILURE) (sid.cpp:80)

    for flag, value in parsed:
        if flag in ("-h", "--help"):
            # the reference prints help and keeps going: `sid -h` with no
            # file still errors with "No file name given!" (sid.cpp:75-108)
            _print_help()
        elif flag == "-m":
            opts.method = value
        elif flag == "-r":
            opts.snp_prior = _atof(value)
        elif flag == "-R":
            opts.estimate_prior = True
        elif flag == "-p":
            opts.significance_level = _atof(value)
        elif flag == "-E":
            opts.site_error_threshold = _atof(value)
        elif flag == "--engine":
            opts.engine = value
        elif flag == "--fit":
            opts.fit_backend = value
        elif flag == "--io":
            opts.io_backend = value
        elif flag == "--output":
            opts.output = value
        elif flag == "--devices":
            opts.mesh_devices = int(value)
        elif flag == "--per-shard-fit":
            opts.per_shard_fit = True
        elif flag == "--stream":
            opts.stream = True
        elif flag == "--chunk-mb":
            opts.chunk_mb = int(value)
        elif flag == "--profile":
            opts.profile = True
        elif flag == "--platform":
            opts.platform = value
        elif flag == "--checkpoint":
            opts.checkpoint = value
        elif flag == "--resume":
            opts.resume = True
        elif flag == "--population":
            opts.population = value
        elif flag == "--multihost":
            opts.multihost = True

    if not rest:
        print("No file name given!", file=sys.stderr)
        sys.exit(1)
    try:
        # unknown -m keeps the reference's header-only behavior (sid.cpp:92-102)
        opts.validate(allow_unknown_method=True)
    except ValueError as e:
        _fail(str(e))
    if opts.population:
        return opts, rest
    return opts, rest[0]


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    options, input_path = parse_args(argv)
    options.platform = options.platform or os.environ.get("SIDTPU_PLATFORM")
    try:
        # the streaming engine's fit and classify, and population mode, run
        # on the device under either engine, as sid_tpu's do
        if options.engine == "device" or options.stream or options.population:
            options.device()
            if options.method in engine.METHODS:
                options.mesh()  # a --devices that selects no device
    except (RuntimeError, ValueError) as e:
        _fail(str(e))
    if options.population:
        return _main_population(options, input_path)
    if options.multihost or os.environ.get("SIDTPU_NUM_PROCESSES"):
        return _main_multihost(options, input_path)
    try:
        open(input_path, "rb").close()
    except OSError:
        print(f"Could not open file: {input_path}", file=sys.stderr)
        sys.exit(1)

    def diag(line: str) -> None:
        if options.diagnostics:
            print(line, file=sys.stderr)

    prof = _start_profile(options)
    try:
        if options.stream:
            _stream(options, input_path, diag)
        else:
            _write(options.output, engine.run(input_path, options, diag, binary=True))
    except SidParseError as e:
        # the reference dies on the uncaught std::invalid_argument; we
        # report the same message with the offending line number
        print(f"{e} (line {e.line_number})", file=sys.stderr)
        sys.exit(1)
    finally:
        _stop_profile(prof)
    if options.profile:
        prof.report(log=lambda line: print(line, file=sys.stderr))
    return 0


def _start_profile(options: Options) -> StageProfile:
    """The run's stage profile, active under ``--profile``; with
    ``SIDTPU_TRACE=<dir>`` set, ``--profile`` also records a torch.profiler
    trace of the run into that directory."""
    prof = StageProfile(enabled=options.profile)
    if options.profile:
        activate(prof)
        prof.start_device_trace()
    return prof


def _stop_profile(prof: StageProfile) -> None:
    activate(None)
    path = prof.stop_device_trace()
    if path:
        print(f"# trace: {path}", file=sys.stderr)


def _write(output: str, csv: bytes) -> None:
    if output in ("-", ""):
        sys.stdout.buffer.write(csv)
        sys.stdout.buffer.flush()
    else:
        with open(output, "wb") as out:
            out.write(csv)


def _stream(options: Options, input_path: str, diag) -> None:
    """``--stream`` (sid_tpu/cli.py:197-217): the two-pass engine into
    stdout, or into ``--output`` with chunk-level progress for ``--resume``
    (the file is reopened in place when it exists)."""
    kw = dict(chunk_bytes=options.chunk_mb << 20, checkpoint=options.checkpoint,
              resume=options.resume)
    if options.output in ("-", ""):
        engine.run_streaming(input_path, options, sys.stdout.buffer, diag, **kw)
        sys.stdout.buffer.flush()
        return
    mode = "r+b" if options.resume and os.path.exists(options.output) else "wb"
    with open(options.output, mode) as out:
        engine.run_streaming(input_path, options, out, diag, progress=StreamProgress(options.output), **kw)


def _main_multihost(options: Options, input_path: str) -> int:
    """One process of a multi-host run (sid_tpu/cli.py:246-273): every
    process runs this same command line, with its SIDTPU_PROCESS_ID; process
    0 writes ``--output``. ``--profile`` reports each process's stages."""
    from sid_tpu_torch.parallel import distributed

    if options.output in ("-", ""):
        _fail("--multihost requires --output PATH")
    nprocs = os.environ.get("SIDTPU_NUM_PROCESSES")
    procid = os.environ.get("SIDTPU_PROCESS_ID")
    distributed.initialize(
        os.environ.get("SIDTPU_COORDINATOR"),
        int(nprocs) if nprocs else None,
        int(procid) if procid else None,
    )

    def diag(line: str) -> None:
        if options.diagnostics:
            print(line, file=sys.stderr)

    prof = _start_profile(options)
    try:
        out = distributed.run_multihost(input_path, options, options.output, diag)
    finally:
        _stop_profile(prof)
        distributed.shutdown()
    if out is not None:
        diag(f"# wrote {out}")
    if options.profile:
        prof.report(log=lambda line: print(line, file=sys.stderr))
    return 0


def _main_population(options: Options, paths: List[str]) -> int:
    """Joint multi-sample calling (sid_tpu/cli.py:279-315): one output CSV
    per sample, ``<input>.calls.csv``. ``--fit`` and ``--engine`` are not
    read, as in sid_tpu."""
    from sid_tpu_torch.io.pileup import parse_pileup
    from sid_tpu_torch.models.population import call_population, call_population_streaming

    def diag(line: str) -> None:
        if options.diagnostics:
            print(line, file=sys.stderr)

    for p in paths:
        if not os.path.exists(p):
            print(f"Could not open file: {p}", file=sys.stderr)
            sys.exit(1)
    if options.stream:
        # streamed ingest: histograms accumulate chunk by chunk
        call_population_streaming(
            paths, options, mode=options.population, diag=diag, chunk_bytes=options.chunk_mb << 20,
        )
        return 0
    needs_reads = options.method == "quality"
    batches = []
    for p in paths:
        with open(p, "rb") as f:
            batches.append(parse_pileup(f, needs_reads, needs_reads, backend=options.io_backend,
                                        quality_terms_only=needs_reads))
    results = call_population(batches, options, mode=options.population, diag=diag)
    for p, res in zip(paths, results):
        out_path = p + ".calls.csv"
        with open(out_path, "wb") as out:
            out.write(res.to_csv_buffer())
        diag(f"# wrote {out_path} ({res.num_records} records)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
