"""The benchmark of sid_tpu_torch, the PyTorch and CUDA port, on NVIDIA H100 cards.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout, on the machine it is started on:

    python3 -m gpubench.run --workload local.chrom17M --seed 7 --seconds 30 --trace 0

It prints the card, the set-up's parts and the numbers the check compared on
standard error, and one JSON line last on standard output. It imports no
JAX and nothing of the JAX package ``sid_tpu``; the reference it checks the
port's output against (``gpubench/reference``) imports nothing of the port.
"""
