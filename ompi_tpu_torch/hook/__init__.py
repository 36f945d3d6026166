"""hook framework: callables run at the init and finalize phases.

The port of ``ompi_tpu/hook/__init__.py`` (reference: ompi/mca/hook).
Mesh mode has no Init or Finalize; the multi-slice comm registers its
worker's shutdown at ``finalize_top`` as the reference does, for the
process mode that will run the phases.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

_hooks: Dict[str, List[Callable[[], None]]] = defaultdict(list)

PHASES = ("init_top", "init_bottom", "finalize_top", "finalize_bottom")


def register_hook(phase: str, fn: Callable[[], None]) -> None:
    if phase not in PHASES:
        raise ValueError(f"unknown hook phase {phase!r} (one of {PHASES})")
    _hooks[phase].append(fn)


def run_hooks(phase: str) -> None:
    for fn in list(_hooks[phase]):
        fn()
