"""The traffic mixes (``<name>.json``, parameters only) and the one generator
that reads them (``generate.py``)."""
