"""The host long-double oracle (``--engine exact`` and the exact Lynch fit).

No device: the reference's linear long-double arithmetic through libsidtpu,
the NumPy-f64 GSL nmsimplex2 loop (which also drives the device fits,
one at a time or a cohort's in lockstep) and libm statistics, as sid_tpu's
``exact`` package runs them.
"""
