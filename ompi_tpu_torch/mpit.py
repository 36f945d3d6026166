"""MPI_T, the MPI tool information interface.

The port of ``ompi_tpu/mpit.py`` (reference: ompi/mpi/tool, over the
opal/mca/base registries). The backends are ``mca/var.py``'s; this module
is the handle-based surface a tool binds to, and the MPI-4 events:

- cvars: stable indices over the registered variables; handles read and,
  unless read-only, write them;
- pvars: handles within a session, with start, stop, read and reset
  (reset re-baselines a numeric pvar, stop freezes its reading);
- categories: one a framework, grouping its cvars, pvars and events;
- events: typed sources fired at component selection, comm creation and
  revocation, and by the trace spans; a callback gets an immutable
  instance with a timestamp and the payload.

Indices are append-only for the life of the process (the MPI_T contract),
which the registries' insertion order guarantees.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List

from ompi_tpu_torch.core.errors import MPIError, ERR_ARG, ERR_OTHER
from ompi_tpu_torch.mca import var as _var

# ------------------------------------------------------------------ init
_init_count = 0
_init_lock = threading.Lock()


def init_thread() -> None:
    """MPI_T_init_thread: reference counted, independent of MPI_Init."""
    global _init_count
    with _init_lock:
        _init_count += 1


def finalize() -> None:
    global _init_count
    with _init_lock:
        if _init_count == 0:
            raise MPIError(ERR_OTHER, "MPI_T finalize without init")
        _init_count -= 1


def _check_init() -> None:
    if _init_count == 0:
        raise MPIError(ERR_OTHER, "MPI_T not initialized")


# ----------------------------------------------------------------- cvars
@dataclasses.dataclass(frozen=True)
class CvarInfo:
    index: int
    name: str
    help: str
    level: int
    typ: type
    scope: str
    default: Any


def _cvar_list() -> List[_var.Var]:
    return list(_var.all_vars().values())


def cvar_get_num() -> int:
    _check_init()
    return len(_cvar_list())


def cvar_get_info(index: int) -> CvarInfo:
    _check_init()
    vs = _cvar_list()
    if not 0 <= index < len(vs):
        raise MPIError(ERR_ARG, f"cvar index {index} out of range")
    v = vs[index]
    return CvarInfo(index, v.full_name, v.help, v.level, v.typ,
                    v.scope.value, v.default)


def cvar_get_index(name: str) -> int:
    _check_init()
    for i, v in enumerate(_cvar_list()):
        if v.full_name == name:
            return i
    raise MPIError(ERR_ARG, f"no cvar named {name}")


class CvarHandle:
    """A read/write handle onto one cvar (cvar_handle_alloc.c)."""

    def __init__(self, index: int):
        _check_init()
        vs = _cvar_list()
        if not 0 <= index < len(vs):
            raise MPIError(ERR_ARG, f"cvar index {index} out of range")
        self._var = vs[index]

    def read(self) -> Any:
        return self._var.value

    def write(self, value: Any) -> None:
        if self._var.scope == _var.VarScope.READONLY:
            raise MPIError(ERR_ARG, f"{self._var.full_name} is read-only")
        self._var._apply(value, _var.VarSource.SET)


def cvar_handle_alloc(index: int) -> CvarHandle:
    return CvarHandle(index)


# ----------------------------------------------------------------- pvars
@dataclasses.dataclass(frozen=True)
class PvarInfo:
    index: int
    name: str
    help: str


def _pvar_list() -> List[_var.Pvar]:
    return list(_var.all_pvars().values())


def pvar_get_num() -> int:
    _check_init()
    return len(_pvar_list())


def pvar_get_info(index: int) -> PvarInfo:
    _check_init()
    ps = _pvar_list()
    if not 0 <= index < len(ps):
        raise MPIError(ERR_ARG, f"pvar index {index} out of range")
    p = ps[index]
    return PvarInfo(index, p.full_name, p.help)


def pvar_get_index(name: str) -> int:
    _check_init()
    for i, p in enumerate(_pvar_list()):
        if p.full_name == name:
            return i
    raise MPIError(ERR_ARG, f"no pvar named {name}")


class PvarSession:
    """Handles live in a session, so concurrent tools keep their own
    baselines; freeing the session invalidates its handles."""

    def __init__(self):
        _check_init()
        self._handles: List[PvarHandle] = []
        self._freed = False

    def handle_alloc(self, index: int) -> "PvarHandle":
        if self._freed:
            raise MPIError(ERR_ARG, "pvar session already freed")
        h = PvarHandle(self, index)
        self._handles.append(h)
        return h

    def free(self) -> None:
        self._freed = True
        self._handles.clear()


class PvarHandle:
    """Start, stop, read and reset over a read-only reader: reset
    re-baselines (a numeric pvar reads as the delta from the baseline),
    stop freezes the reading until start."""

    def __init__(self, session: PvarSession, index: int):
        ps = _pvar_list()
        if not 0 <= index < len(ps):
            raise MPIError(ERR_ARG, f"pvar index {index} out of range")
        self._session = session
        self._pvar = ps[index]
        self._baseline: Any = 0
        self._started = True
        self._frozen: Any = None

    def _raw(self) -> Any:
        if self._session._freed:
            raise MPIError(ERR_ARG, "pvar handle's session was freed")
        return self._pvar.value

    def read(self) -> Any:
        if self._session._freed:
            raise MPIError(ERR_ARG, "pvar handle's session was freed")
        val = self._frozen if not self._started else self._raw()
        if isinstance(val, (int, float)) and isinstance(
                self._baseline, (int, float)):
            return val - self._baseline
        return val

    def reset(self) -> None:
        raw = self._raw()
        self._baseline = raw if isinstance(raw, (int, float)) else 0

    def start(self) -> None:
        self._started = True
        self._frozen = None

    def stop(self) -> None:
        self._frozen = self._raw()
        self._started = False


# ------------------------------------------------------------ categories
@dataclasses.dataclass(frozen=True)
class CategoryInfo:
    index: int
    name: str
    num_cvars: int
    num_pvars: int
    num_events: int


def _categories() -> List[str]:
    seen: Dict[str, None] = {}
    for v in _cvar_list():
        seen.setdefault(v.framework)
    for p in _pvar_list():
        seen.setdefault(p.framework)
    for e in _event_types:
        seen.setdefault(e.framework)
    return list(seen)


def category_get_num() -> int:
    _check_init()
    return len(_categories())


def category_get_info(index: int) -> CategoryInfo:
    _check_init()
    cats = _categories()
    if not 0 <= index < len(cats):
        raise MPIError(ERR_ARG, f"category index {index} out of range")
    name = cats[index]
    return CategoryInfo(
        index, name, len(category_get_cvars(index)),
        len(category_get_pvars(index)),
        len([e for e in _event_types if e.framework == name]))


def category_get_index(name: str) -> int:
    _check_init()
    cats = _categories()
    if name not in cats:
        raise MPIError(ERR_ARG, f"no category named {name}")
    return cats.index(name)


def _category_name(index: int) -> str:
    cats = _categories()
    if not 0 <= index < len(cats):
        raise MPIError(ERR_ARG, f"category index {index} out of range")
    return cats[index]


def category_get_cvars(index: int) -> List[int]:
    _check_init()
    name = _category_name(index)
    return [i for i, v in enumerate(_cvar_list()) if v.framework == name]


def category_get_pvars(index: int) -> List[int]:
    _check_init()
    name = _category_name(index)
    return [i for i, p in enumerate(_pvar_list()) if p.framework == name]


# ---------------------------------------------------------------- events
@dataclasses.dataclass(frozen=True)
class EventType:
    framework: str
    name: str
    help: str = ""

    @property
    def full_name(self) -> str:
        return f"{self.framework}_{self.name}"


@dataclasses.dataclass(frozen=True)
class EventInstance:
    """What a callback gets: an immutable snapshot with its timestamp."""
    type: EventType
    timestamp: float
    data: Dict[str, Any]


_event_types: List[EventType] = []
_event_handles: Dict[str, List["EventHandle"]] = {}
_event_lock = threading.Lock()


def register_event_type(framework: str, name: str, help: str = "") -> None:
    """Called by instrumented subsystems at import; idempotent."""
    with _event_lock:
        for e in _event_types:
            if e.framework == framework and e.name == name:
                return
        _event_types.append(EventType(framework, name, help))


def event_get_num() -> int:
    _check_init()
    return len(_event_types)


def event_get_info(index: int) -> EventType:
    _check_init()
    if not 0 <= index < len(_event_types):
        raise MPIError(ERR_ARG, f"event index {index} out of range")
    return _event_types[index]


def event_get_index(name: str) -> int:
    _check_init()
    for i, e in enumerate(_event_types):
        if e.full_name == name:
            return i
    raise MPIError(ERR_ARG, f"no event named {name}")


class EventHandle:
    """A subscription to one event type; ``dropped`` counts the instances
    lost to a callback that raised."""

    def __init__(self, index: int, cb: Callable[[EventInstance], None]):
        _check_init()
        if not 0 <= index < len(_event_types):
            raise MPIError(ERR_ARG, f"event index {index} out of range")
        self.type = _event_types[index]
        self._cb = cb
        self.dropped = 0
        with _event_lock:
            _event_handles.setdefault(self.type.full_name, []).append(self)

    def free(self) -> None:
        with _event_lock:
            hs = _event_handles.get(self.type.full_name, [])
            if self in hs:
                hs.remove(self)


def event_handle_alloc(index: int,
                       cb: Callable[[EventInstance], None]) -> EventHandle:
    return EventHandle(index, cb)


def emit(_fw: str, _name: str, **data: Any) -> None:
    """Fire an event to every subscribed handle; with none, one dict probe.
    The positional names are underscored so that the payload may use any
    key."""
    with _event_lock:
        handles = list(_event_handles.get(f"{_fw}_{_name}", ()))
    if not handles:
        return
    etype = None
    for e in _event_types:
        if e.framework == _fw and e.name == _name:
            etype = e
            break
    inst = EventInstance(etype or EventType(_fw, _name), time.monotonic(),
                         dict(data))
    for h in handles:
        try:
            h._cb(inst)
        except Exception:
            h.dropped += 1


# the event types of the port's instrumentation sites (mca/component.py,
# comm/communicator.py, ft/detector.py, ft/revoke.py, runtime/trace.py)
register_event_type("mca", "component_selected",
                    "A framework selected its component")
register_event_type("comm", "created", "A communicator was constructed")
register_event_type("comm", "revoked", "A communicator was revoked")
register_event_type("ft", "proc_failed",
                    "The detector declared a process failed")
register_event_type("trace", "span_begin", "A trace span opened")
register_event_type("trace", "span_end", "A trace span closed")
