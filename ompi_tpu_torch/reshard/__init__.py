"""Resharding of mesh-mode distributed buffers between layouts (mirrors
ompi_tpu.reshard; only the mesh lowering is ported)."""
