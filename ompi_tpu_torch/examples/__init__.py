"""Examples of the PyTorch/CUDA port (mirrors the repo's ``examples/``)."""
