"""MPI objects of the PyTorch/CUDA port (mirrors ompi_tpu.core)."""
