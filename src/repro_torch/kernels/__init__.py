"""Kernels written by hand for NVIDIA Hopper, each beside its plain PyTorch
version. ``build.py`` compiles the CUDA sources at first use."""
