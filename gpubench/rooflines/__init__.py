"""Roofline shares of kernels: the least time an NVIDIA H100 SXM could
take for a call's work over the time the kernel took.

Each kernel's work model is ``rooflines/<name>.py``, found by name. It
names the kernel as the trace shows it (``KERNEL``) and the port's
function whose calls carry the shapes (``WRAPS``, ``module:function``);
in a traced run the harness wraps every model's function and keeps
``record(*args, **kwargs)`` of each call, and ``work(records)`` gives the
bytes and f64 operations of those calls, worked out from the algorithm and
the shapes (each input byte read once, each output byte written once, the
f64 operations sid's math needs, an elementary function counted as one),
never from the compiled code, so it stays the same whatever implements the
kernel. The counts are lower bounds, so a share is too.
"""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# NVIDIA H100 SXM5 data sheet, at its 700 W power limit: HBM3 bandwidth and
# the FP64 rate outside the tensor cores (the kernels use no FP64 MMA)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12


def share(bytes_moved: float, flops: float, seconds: float) -> float:
    """100 x max(bytes / bandwidth, flops / FP64 peak) / seconds."""
    return 100.0 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S) / seconds


def names(root: str = ROOT):
    """The work models in ``gpubench/rooflines``, by name."""
    folder = os.path.join(root, "gpubench", "rooflines")
    return sorted(f[:-3] for f in os.listdir(folder) if f.endswith(".py") and f != "__init__.py")


def model(name: str, root: str = ROOT):
    """The work model ``gpubench/rooflines/<name>.py``, found by name."""
    from gpubench.harness import load_file

    return load_file(os.path.join(root, "gpubench", "rooflines", name + ".py"), "gpubench_roofline_" + name)


def read(run, name: str, root: str = ROOT):
    """The share of model ``name``'s kernel over the traced window: the work
    of every call recorded there over the kernel's time in the trace;
    nothing where the window traced no launch or recorded no call."""
    if run.device is None:
        return None
    work_model = model(name, root)
    launches, seconds = run.device["kernels"].get(work_model.KERNEL, (0, 0.0))
    records = run.calls.get(name) or []
    if not launches or not records:
        return None
    bytes_moved, flops = work_model.work(records)
    return share(bytes_moved, flops, seconds) if bytes_moved or flops else None
