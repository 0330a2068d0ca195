"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their dispatch.

``ops`` picks the kernel for a CUDA tensor and its plain version for a CPU
tensor; ``ref`` holds the oracles; ``_build`` compiles the sources at first
use.
"""
