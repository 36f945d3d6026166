"""MCA, the Modular Component Architecture, of the PyTorch/CUDA port.

The port of ``ompi_tpu/mca`` (reference: opal/mca/base): every concern is
a framework of components selected by priority (``component.py``), and
every setting is a typed variable sourced from defaults, the param file,
the environment and ``set_var`` (``var.py``).
"""
