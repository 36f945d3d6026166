"""Introspection: the versions the port runs on.

The port of ``print_header`` (``ompi_tpu/tools/info.py:65-76``); the
component and parameter listings wait for the MCA variable system.
"""

from __future__ import annotations

import sys

import torch


def print_header(out) -> None:
    from ompi_tpu_torch.version import __version__

    print(f"ompi_tpu_torch: {__version__}", file=out)
    print(f"python:   {sys.version.split()[0]}", file=out)
    print(f"torch:    {torch.__version__}", file=out)
    print(f"cuda:     {torch.version.cuda or 'unavailable'}", file=out)
