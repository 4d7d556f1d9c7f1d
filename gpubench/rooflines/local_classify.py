"""The work of ``csrc/local_classify.cu`` ``local_classify_kernel`` (B1):
sid's ``local`` classification of U unique profiles (call.cpp:238-273),
a launch for each call of ``ops/local_classify.py::classify_profiles``.

A row reads its four counts (16-bit, as sid's profile_t holds them) and
writes l1, l2 (f64) and one byte (the two alleles and the long-double
range flag). Its f64 operations: the plug-in error rates (cov - n1) / cov
and 1.5 (cov - n1 - n2) / cov, 6; the log multinomial coefficient, four
lgamma and four adds, 8; the hom likelihood, log1p(-e1), e1 / 3 and its
log, two products and two sums, 7; the het likelihood, (1 - 2 e2 / 3) / 2
and its log, e2 / 3 and its log, two products and two sums, 10.
"""

KERNEL = "local_classify_kernel"
WRAPS = "sid_tpu_torch.ops.local_classify:classify_profiles"
BYTES_PER_ROW = 4 * 2 + 2 * 8 + 1
FLOPS_PER_ROW = 6 + 8 + 7 + 10


def record(profiles, *args, **kwargs) -> int:
    """The profile rows a call was given."""
    return int(profiles.shape[0])


def work(records):
    """(bytes, f64 operations) of the launches over ``records`` rows."""
    rows = sum(records)
    return BYTES_PER_ROW * rows, FLOPS_PER_ROW * rows
