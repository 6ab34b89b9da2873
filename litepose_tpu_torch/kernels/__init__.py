"""nvcc build and ctypes loading of the CUDA sources in ``csrc/``."""
