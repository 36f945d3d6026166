"""Command-line tools of the PyTorch/CUDA port (mirrors ompi_tpu.tools)."""
