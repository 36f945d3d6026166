"""Frameworks of components, selected by priority.

The port of ``ompi_tpu/mca/component.py`` (reference:
opal/mca/base/mca_base_framework.c, mca_base_components_select.c and, for
the slot-by-slot model of the collectives, coll_base_comm_select.c:216).
A ``Framework`` owns named ``Component`` instances; selection asks each to
``query(**ctx)`` and orders the modules it gets by priority. The framework's
selection variable (``OMPI_TPU_MCA_<framework>_<framework>``, e.g.
``coll_coll``) restricts and orders the candidates: ``a,b`` allows those
names in that order, ``^c`` excludes ``c``.

One difference from the reference: a component whose ``query`` raises is
not logged and skipped (``ompi_tpu/mca/component.py:105-108``); the
exception propagates, so a device fault never quietly drops a component.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.mca.var import get_var, register_var
from ompi_tpu_torch.utils.output import get_logger


class Component:
    """Base class of MCA components: ``NAME``, ``PRIORITY``, and ``query``,
    which returns a module (the framework's contract) or None to decline."""

    NAME: str = "base"
    PRIORITY: int = 0

    def query(self, **ctx: Any) -> Optional[Any]:
        raise NotImplementedError


class Framework:
    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self.components: Dict[str, Component] = {}
        self.log = get_logger(f"mca.{name}")
        register_var(name, name, "", str,
                     help=f"Comma list of {name} components to allow "
                          f"(empty=all; prefix ^ to exclude)",
                     level=2)

    def register(self, component: Component) -> Component:
        self.components[component.NAME] = component
        return component

    def _candidates(self) -> List[Component]:
        spec = get_var(self.name, self.name).strip()
        comps = list(self.components.values())
        if spec:
            if spec.startswith("^"):
                banned = set(spec[1:].split(","))
                comps = [c for c in comps if c.NAME not in banned]
            else:
                by_name = {c.NAME: c for c in comps}
                comps = [by_name[n] for n in spec.split(",") if n in by_name]
        return comps

    def select_all(self, **ctx: Any) -> List[Tuple[int, str, Any]]:
        """Query every candidate: [(priority, name, module)], highest
        priority first (reference: coll_base_comm_select.c:358)."""
        out: List[Tuple[int, str, Any]] = []
        for comp in self._candidates():
            module = comp.query(**ctx)
            if module is not None:
                out.append((comp.PRIORITY, comp.NAME, module))
        out.sort(key=lambda t: (-t[0], t[1]))
        if out:
            from ompi_tpu_torch.mpit import emit

            emit("mca", "component_selected", framework=self.name,
                 component=out[0][1], priority=out[0][0])
        return out

    def select_one(self, **ctx: Any) -> Tuple[str, Any]:
        """Winner takes all (reference: pml_base_select.c:70)."""
        mods = self.select_all(**ctx)
        if not mods:
            raise RuntimeError(
                f"no usable component in framework '{self.name}' "
                f"(registered: {sorted(self.components)})")
        prio, name, module = mods[0]
        self.log.debug("selected %s/%s (priority %d)", self.name, name, prio)
        return name, module


_lock = threading.Lock()
_frameworks: Dict[str, Framework] = {}


def framework(name: str, description: str = "") -> Framework:
    with _lock:
        fw = _frameworks.get(name)
        if fw is None:
            fw = Framework(name, description)
            _frameworks[name] = fw
        return fw


def all_frameworks() -> Dict[str, Framework]:
    return dict(_frameworks)
