"""Per-subsystem logging with verbosity from the environment.

The port of ``ompi_tpu/utils/output.py`` (reference: opal/util/output.c):
every framework gets its own output stream whose verbosity comes from
``OMPI_TPU_MCA_<name>_verbose`` (or ``OMPI_TPU_VERBOSE``), and lines carry
the rank prefix so that interleaved multi-rank output stays attributable.
The streams hang under the ``ompi_tpu_torch`` logger.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict

_loggers: Dict[str, logging.Logger] = {}
_configured = False


def _rank_prefix() -> str:
    rank = os.environ.get("OMPI_TPU_RANK")
    return f"[rank {rank}] " if rank is not None else ""


class _RankFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return f"{_rank_prefix()}[{record.name}] {record.getMessage()}"


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_RankFormatter())
    root = logging.getLogger("ompi_tpu_torch")
    root.addHandler(handler)
    root.propagate = False
    root.setLevel(logging.WARNING)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    """The named output stream, at the verbosity of
    ``OMPI_TPU_MCA_<name>_verbose`` (0 warn, 1 info, 2 and up debug)."""
    _configure_root()
    full = f"ompi_tpu_torch.{name}"
    log = _loggers.get(full)
    if log is None:
        log = logging.getLogger(full)
        env = os.environ.get(
            f"OMPI_TPU_MCA_{name.replace('.', '_')}_verbose",
            os.environ.get("OMPI_TPU_VERBOSE"))
        if env is not None:
            try:
                lvl = int(env)
            except ValueError:
                lvl = 0
            log.setLevel(logging.DEBUG if lvl >= 2
                         else logging.INFO if lvl == 1 else logging.WARNING)
        _loggers[full] = log
    return log
