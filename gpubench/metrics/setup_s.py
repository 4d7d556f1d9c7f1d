"""Seconds from the process's start to the window's: imports and the CUDA
context, the kernel libraries (loaded from the checkout's build cache, or
built), the input made from the seed, and one warm-up request."""


def read(run):
    return run.setup["total"]
