"""Collectives of the PyTorch/CUDA port (mirrors ompi_tpu.coll)."""
