"""The host long-double oracle (``--engine exact`` and the exact Lynch fit).

No device: the reference's linear long-double arithmetic through libsidtpu,
the NumPy-f64 GSL nmsimplex2 loop and libm statistics, as sid_tpu's
``exact`` package runs them.
"""
