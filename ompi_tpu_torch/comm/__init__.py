"""Communicators of the PyTorch/CUDA port (mirrors ompi_tpu.comm)."""
