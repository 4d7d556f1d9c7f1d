"""Top-level dispatch: parsed batch + options -> CallResult -> CSV.

Mirrors the reference's method dispatch (sid.cpp:92-100), including the
quirk that an unrecognized method produces no records (the CLI then prints
only the CSV header). ``options.engine`` selects the device path (default)
or the host long-double oracle. Methods and options of sid_tpu that this
package does not run yet raise ``NotPortedError`` instead of doing
something else.
"""

from __future__ import annotations

from typing import Callable, Optional

from sid_tpu_torch.config import Options
from sid_tpu_torch.exact import engine as exact_engine
from sid_tpu_torch.io.pileup import PileupBatch, parse_pileup
from sid_tpu_torch.models import bayes, likelihood_ratio, local
from sid_tpu_torch.models.common import CSV_HEADER, CallResult
from sid_tpu_torch.utils import profiling
from sid_tpu_torch.utils.errors import NotPortedError

_TABLES = {
    "device": {
        "local": local.call_local,
        "bayes": bayes.call_bayes,
        "likelihood_ratio": likelihood_ratio.call_likelihood_ratio,
    },
    "exact": {
        "local": exact_engine.call_local_exact,
        "bayes": exact_engine.call_bayes_exact,
        "likelihood_ratio": exact_engine.call_likelihood_ratio_exact,
    },
}


def check_ported(options: Options) -> None:
    """Raise NotPortedError for the first option this package cannot run."""
    unported = (
        (options.method == "quality", "-m quality"),
        (options.stream, "--stream"),
        (bool(options.population), "--population"),
        (options.multihost, "--multihost"),
        (options.per_shard_fit, "--per-shard-fit"),
        (options.mesh_devices is not None, "--devices"),
        (
            options.engine == "device" and not options.exact_pvalues
            and options.method in ("local", "likelihood_ratio"),
            "the fused on-device LRT (exact_pvalues=False)",
        ),
    )
    for flag, name in unported:
        if flag:
            raise NotPortedError(name)


def call_batch(
    batch: PileupBatch,
    options: Options,
    diag: Optional[Callable[[str], None]] = None,
) -> Optional[CallResult]:
    """Dispatch one parsed batch to the selected method implementation;
    None for an unknown method (header-only output, sid.cpp:92-102)."""
    check_ported(options)
    fn = _TABLES[options.engine].get(options.method)
    if fn is None:
        return None
    return fn(batch, options, diag)


def run(
    src,
    options: Optional[Options] = None,
    diag: Optional[Callable[[str], None]] = None,
    binary: bool = False,
):
    """Parse + call + serialize: the whole tool as a function returning CSV.

    ``src`` is a path, bytes or a binary file object. ``binary=True``
    returns the native serializer's bytes (the CLI's path); default
    returns str.
    """
    options = options or Options()
    with profiling.maybe_stage("parse"):
        batch = parse_pileup(src, backend=options.io_backend)
    with profiling.maybe_stage("call"):
        result = call_batch(batch, options, diag)
    if result is None:
        header = CSV_HEADER + "\n"
        return header.encode() if binary else header
    with profiling.maybe_stage("serialize"):
        return result.to_csv_bytes() if binary else result.to_csv()
