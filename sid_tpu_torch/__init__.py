"""sid-tpu-torch: the PyTorch / CUDA port of sid-tpu's genotype caller.

Reads ``samtools mpileup`` text and emits one CSV row per genome site with
the most likely diploid genotype and LRT confidences, byte-equal to
``sid_tpu`` (the JAX package, which stays the reference). The port mirrors
``sid_tpu`` module for module. Its device stages are hand-written CUDA
kernels for Hopper, each with a plain torch f64 twin for CPU tensors: the
``local`` method's per-profile classify (top-2 alleles, the slim log
likelihoods and the long-double range screen; ``csrc/local_classify.cu``),
the Lynch fit's objective and marginals and their lane forms for a cohort
of samples (``csrc/lynch.cu``) and the ``quality`` method's finalize
(``csrc/quality_finalize.cu``). Population mode (``models.population``)
calls many samples with a pooled or per-sample fit.

Host work (parse, dedup, libm LRT, ``%g`` CSV) runs in the same C++ code as
``sid_tpu``: the package keeps a copy of ``sid_tpu/native/parser.cpp``,
byte-equal but for one comment line, in ``csrc/host`` and builds it into
``sid_tpu_torch/_build``. Importing this package imports no JAX and no
``sid_tpu`` module.
"""

__version__ = "0.1.0"

from sid_tpu_torch.config import Options  # noqa: E402,F401
