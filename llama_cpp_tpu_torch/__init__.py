"""PyTorch/CUDA port of the llama.cpp-on-TPU engine for NVIDIA Hopper.

Imports torch and numpy only: nothing of JAX or of the llama_cpp_tpu
package, which stays the reference the tests compare against.
"""
