"""Tensor operations: quantized weights, norms, rope and the kernel wrappers."""
