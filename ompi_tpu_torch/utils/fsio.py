"""The one writer of the observability exports.

The port of ``atomic_write_json`` (``ompi_tpu/utils/fsio.py``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any


def atomic_write_json(path: str, doc: Any, **dump_kwargs) -> str:
    """Write ``doc`` as JSON to a uniquely named temporary file, then
    rename it over ``path``, so that a reader never sees a torn file and
    two writers never interleave. A failed write removes its temporary
    file. Returns ``path``."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, **dump_kwargs)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
