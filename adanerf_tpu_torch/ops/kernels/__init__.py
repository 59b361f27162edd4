"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, built by ``build.py`` with nvcc and bound with ctypes."""
