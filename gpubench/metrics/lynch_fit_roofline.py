"""``lynch_fit_lanes_kernel`` (B3, a Lynch fit as one launch)'s share of
its roofline over the traced window: the work of every fit
(``rooflines/lynch_fit.py``) over the kernel's time in the trace."""

from gpubench import rooflines


def read(run):
    return rooflines.read(run, "lynch_fit")
