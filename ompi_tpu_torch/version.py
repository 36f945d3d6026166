"""Version of the PyTorch/CUDA port (its own, apart from ompi_tpu's)."""

__version__ = "0.1.0"
