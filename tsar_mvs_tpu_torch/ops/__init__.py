"""Operators: checkerboard, sampling, NCC, s-volume, WMF, SLIC and the two CUDA kernels."""
