"""Kernels of the port: CUDA C++ sources (``csrc``), their nvcc build and
wrappers with the plain PyTorch version beside each kernel."""
