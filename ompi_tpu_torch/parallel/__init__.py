"""In-mesh verbs of the PyTorch/CUDA port (mirrors ompi_tpu.parallel)."""
