"""CUDA C++ sources of the port's kernels and the script that compiles them (``_build``)."""
