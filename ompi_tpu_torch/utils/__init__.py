"""Utilities of the PyTorch/CUDA port (mirrors ompi_tpu.utils)."""
