"""One-sided communication of the PyTorch/CUDA port (mirrors ompi_tpu.osc)."""
