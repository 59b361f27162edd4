"""PyTorch + CUDA port of the AdaNeRF renderer for one NVIDIA H100.

The JAX package ``adanerf_tpu`` is the reference; this package imports
nothing of it (and never ``jax``). Module paths mirror the JAX package so
each function's counterpart is easy to find.
"""
