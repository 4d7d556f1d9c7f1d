"""sid-tpu-torch: the PyTorch / CUDA port of sid-tpu's genotype caller.

Reads ``samtools mpileup`` text and emits one CSV row per genome site with
the most likely diploid genotype and LRT confidences, byte-equal to
``sid_tpu`` (the JAX package, which stays the reference). The port mirrors
``sid_tpu`` module for module; its one device stage, the ``local`` method's
per-profile slim classify, is a hand-written CUDA kernel for Hopper
(``csrc/local_classify.cu``) with a plain torch f64 twin for CPU tensors.

Host work (parse, dedup, libm LRT, ``%g`` CSV) runs in the same C++ library
as ``sid_tpu``, built by this package from ``sid_tpu/native/parser.cpp``
into ``sid_tpu_torch/_build``. Importing this package imports no JAX and no
``sid_tpu`` module.
"""

__version__ = "0.1.0"

from sid_tpu_torch.config import Options  # noqa: E402,F401
