"""C++-ostream-compatible float formatting.

The reference prints confidences with std::cout's defaults — printf ``%g``
semantics, 6 significant digits (call.hpp:33-36). Python's ``%g`` is
identical for finite values; NaN needs the glibc sign convention (x86
0.0/0.0 produces a negative-signed quiet NaN that ostream prints as
``-nan``, the local method's zero-coverage edge case, call.cpp:243).
"""

from __future__ import annotations

import math


def fmt_g(x: float) -> str:
    """Format a double exactly like ``std::cout << x`` (default precision)."""
    if math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    return "%g" % x
