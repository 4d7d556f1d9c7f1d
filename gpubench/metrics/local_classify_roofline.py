"""``local_classify_kernel`` (B1)'s share of its roofline over the traced
window: the work of every call (``rooflines/local_classify.py``) over the
kernel's time in the trace."""

from gpubench import rooflines


def read(run):
    return rooflines.read(run, "local_classify")
