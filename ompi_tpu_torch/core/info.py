"""MPI_Info: string key/value hints.

The port of ``ompi_tpu/core/info.py`` (reference: ompi/info, with
subscriber callbacks: the dict surface plus subscription, which the
reference uses so components can react to info-key updates on
communicators, windows and files).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


class Info:
    def __init__(self, initial: Optional[Dict[str, str]] = None):
        self._kv: Dict[str, str] = dict(initial or {})
        self._subscribers: List[Callable[[str, str], None]] = []

    def Set(self, key: str, value: str) -> None:
        self._kv[key] = str(value)
        for cb in self._subscribers:
            cb(key, value)

    def Get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._kv.get(key, default)

    def Delete(self, key: str) -> None:
        self._kv.pop(key, None)

    def Get_nkeys(self) -> int:
        return len(self._kv)

    def Get_nthkey(self, n: int) -> str:
        return list(self._kv)[n]

    def Dup(self) -> "Info":
        return Info(self._kv)

    def Free(self) -> None:
        self._kv.clear()

    def subscribe(self, cb: Callable[[str, str], None]) -> None:
        self._subscribers.append(cb)

    def items(self):
        return self._kv.items()

    def __contains__(self, key: str) -> bool:
        return key in self._kv

    def __repr__(self) -> str:
        return f"Info({self._kv})"


INFO_NULL = Info()
