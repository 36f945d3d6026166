"""Byte transfer layer: the self, sm and tcp transports of process mode
(the port of ``ompi_tpu/btl/``)."""
