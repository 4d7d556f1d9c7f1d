"""Native code: the shared host C++ library (libsidtpu) and the CUDA kernels.

``build`` compiles both into ``sid_tpu_torch/_build`` at first use;
``bridge`` is the ctypes interface to the host library.
"""
