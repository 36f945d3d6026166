"""Typed MCA variables and performance variables.

The port of ``ompi_tpu/mca/var.py`` (reference: opal/mca/base/mca_base_var.c,
``mca_base_var_register``). The names, the environment prefix and the
param file are the JAX package's, so one deployment's settings drive
either package.

Sources, lowest to highest precedence:

1. the registered default;
2. the param file (``$OMPI_TPU_PARAM_FILE``, else ``./mca-params.conf``),
   ``<framework>_<name> = value`` lines;
3. the environment, ``OMPI_TPU_MCA_<framework>_<name>``;
4. ``set_var`` (the reference's ``--mca`` on the command line).

Every variable has a help string and a level, 1 to 9 (1-3 end user, 4-6
admin, 7-9 developer), which ``tools/info.py`` shows.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import threading
from typing import Any, Callable, Dict, Optional


class VarScope(enum.Enum):
    READONLY = "readonly"
    LOCAL = "local"
    ALL = "all"


class VarSource(enum.Enum):
    DEFAULT = 0
    FILE = 1
    ENV = 2
    SET = 3  # programmatic, or the command line


_BOOL_TRUE = {"1", "true", "yes", "on", "enabled"}
_BOOL_FALSE = {"0", "false", "no", "off", "disabled"}


def _coerce(raw: Any, typ: type) -> Any:
    if typ is bool:
        if isinstance(raw, bool):
            return raw
        s = str(raw).strip().lower()
        if s in _BOOL_TRUE:
            return True
        if s in _BOOL_FALSE:
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    return typ(raw)


@dataclasses.dataclass
class Var:
    framework: str
    name: str
    default: Any
    typ: type
    help: str = ""
    level: int = 9
    scope: VarScope = VarScope.ALL
    enum_values: Optional[tuple] = None
    _value: Any = None
    _source: VarSource = VarSource.DEFAULT

    @property
    def full_name(self) -> str:
        return f"{self.framework}_{self.name}"

    @property
    def env_name(self) -> str:
        return f"OMPI_TPU_MCA_{self.full_name}"

    @property
    def value(self) -> Any:
        return self._value

    @property
    def source(self) -> VarSource:
        return self._source

    def _apply(self, raw: Any, source: VarSource) -> None:
        val = _coerce(raw, self.typ)
        if self.enum_values is not None and val not in self.enum_values:
            raise ValueError(
                f"{self.full_name}: {val!r} not in {self.enum_values}")
        self._value = val
        self._source = source


_lock = threading.Lock()
_registry: Dict[str, Var] = {}
_file_params: Optional[Dict[str, str]] = None
# full_name -> callbacks fired after a set_var lands; keyed by name so a
# watcher may be installed before its Var is registered
_watchers: Dict[str, list] = {}


def _load_param_file() -> Dict[str, str]:  # locked-by: _lock
    """Parse the param file once (reference: mca_base_parse_paramfile)."""
    global _file_params
    if _file_params is not None:
        return _file_params
    params: Dict[str, str] = {}
    path = os.environ.get("OMPI_TPU_PARAM_FILE", "mca-params.conf")
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" in line:
                    k, v = line.split("=", 1)
                    params[k.strip()] = v.strip()
    except OSError:
        pass
    _file_params = params
    return params


def register_var(framework: str, name: str, default: Any,
                 typ: Optional[type] = None, help: str = "",
                 level: int = 9, scope: VarScope = VarScope.ALL,
                 enum_values: Optional[tuple] = None) -> Var:
    """Register a typed variable and resolve its value from every source.

    Registering again with the same default and type returns the existing
    Var; a different default or type raises: two subsystems would each
    believe they own the name."""
    if typ is None:
        typ = type(default)
    with _lock:
        key = f"{framework}_{name}"
        if key in _registry:
            existing = _registry[key]
            if existing.default != default or existing.typ is not typ:
                raise ValueError(
                    f"cvar {key} re-registered with conflicting "
                    f"default/type: {existing.default!r} "
                    f"({existing.typ.__name__}) vs {default!r} "
                    f"({typ.__name__}) — cvar names must be registered "
                    "exactly once")
            return existing
        var = Var(framework=framework, name=name, default=default, typ=typ,
                  help=help, level=level, scope=scope,
                  enum_values=enum_values)
        var._apply(default, VarSource.DEFAULT)
        fileval = _load_param_file().get(key)
        if fileval is not None:
            var._apply(fileval, VarSource.FILE)
        envval = os.environ.get(var.env_name)
        if envval is not None:
            var._apply(envval, VarSource.ENV)
        _registry[key] = var
        return var


def get_var(framework: str, name: str) -> Any:
    return _registry[f"{framework}_{name}"].value


def set_var(framework: str, name: str, value: Any) -> None:
    """Programmatic override (the reference's ``--mca`` source)."""
    key = f"{framework}_{name}"
    _registry[key]._apply(value, VarSource.SET)
    with _lock:
        cbs = list(_watchers.get(key, ()))
    for cb in cbs:
        cb(_registry[key])


def watch_var(framework: str, name: str, cb: Callable[[Var], None]) -> None:
    """Call ``cb(var)`` after every successful ``set_var`` of the variable.
    File and environment values land at registration, before anything
    could have cached them, so only ``set_var`` notifies."""
    with _lock:
        _watchers.setdefault(f"{framework}_{name}", []).append(cb)


def all_vars() -> Dict[str, Var]:
    return dict(_registry)


# ---------------------------------------------------------------- pvars
# Performance variables (reference: opal/mca/base/mca_base_pvar.c): a pvar
# is a named read handle onto live state, a zero-argument reader.
@dataclasses.dataclass
class Pvar:
    framework: str
    name: str
    reader: Callable[[], Any]
    help: str = ""

    @property
    def full_name(self) -> str:
        return f"{self.framework}_{self.name}"

    @property
    def value(self) -> Any:
        return self.reader()


_pvar_registry: Dict[str, Pvar] = {}


def register_pvar(framework: str, name: str, reader: Callable[[], Any],
                  help: str = "") -> Pvar:
    """The first registration of a name wins; a later one returns it."""
    with _lock:
        key = f"{framework}_{name}"
        pv = _pvar_registry.get(key)
        if pv is None:
            pv = Pvar(framework, name, reader, help)
            _pvar_registry[key] = pv
        return pv


def all_pvars() -> Dict[str, Pvar]:
    """Every registered pvar, and every recorded spc counter as ``spc_<name>``
    (reference: ompi_spc.c:318 registers each counter as a pvar)."""
    from ompi_tpu_torch.runtime import spc

    with _lock:
        out = dict(_pvar_registry)
    for cname in spc.snapshot():
        key = f"spc_{cname}"
        if key not in out:
            out[key] = Pvar("spc", cname, (lambda n=cname: spc.get(n)),
                            help="SPC counter")
    return out


def _reset_for_testing() -> None:
    global _file_params
    with _lock:
        _registry.clear()
        _pvar_registry.clear()
        _file_params = None
