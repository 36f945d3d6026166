"""Runtime services of the PyTorch/CUDA port (mirrors ompi_tpu.runtime)."""
