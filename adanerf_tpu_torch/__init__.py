"""PyTorch + CUDA port of AdaNeRF (the renderer and the dense trainer) for
one NVIDIA H100.

The JAX package ``adanerf_tpu`` is the reference; this package imports
nothing of it (and never ``jax``). Module paths mirror the JAX package so
each function's counterpart is easy to find.
"""
