"""Hand-written CUDA kernels for the hot paths, with their plain versions.

Nothing here builds or loads a kernel at import: the sources in `csrc/`
are compiled with nvcc at first launch (`_build.py`).
"""
