"""Communicator base classes.

The port of the part of ``ompi_tpu/comm/communicator.py:116-290`` that the
mesh-mode communicator (``parallel/mesh.py``) stands on: a comm owns a
group, a context id (CID), a name, an errhandler, cached attributes with
keyval copy/delete callbacks, the ULFM revoked flag, a collectives table
(``coll``) and a topology (``topo``); its QoS class and ``Dump_state``
(``:161-190``); and the live-comm registry (``lookup_comm``, ``:895-906``).
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Optional

import numpy as np

from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.errors import (
    MPIError,
    ERR_REVOKED,
    ERR_TOPOLOGY,
    ERRORS_ARE_FATAL,
    Errhandler,
)
from ompi_tpu_torch.core.group import Group
from ompi_tpu_torch.mpit import emit

PROC_NULL = -2
UNDEFINED = -32766


class _Keyval:
    __slots__ = ("copy_fn", "delete_fn")

    def __init__(self, copy_fn, delete_fn):
        self.copy_fn = copy_fn
        self.delete_fn = delete_fn


_keyvals: Dict[int, _Keyval] = {}
_next_keyval = [100]
_ATTR_UNSET = object()  # distinguishes "not set" from a stored None


class Communicator:
    def __init__(self, group: Group, cid: int, name: str = ""):
        self.group = group
        self.cid = cid
        self.name = name or f"comm-{cid}"
        self.errhandler: Errhandler = ERRORS_ARE_FATAL
        self.attributes: Dict[int, Any] = {}
        self.revoked = False  # ULFM
        self.coll = None  # verb -> collective, set by subclasses
        self.topo = None  # cartesian topology, set by the topology layer
        self._freed = False
        emit("comm", "created", name=self.name, cid=cid, size=group.size)

    # ------------------------------------------------------------- queries
    @property
    def size(self) -> int:
        return self.group.size

    def Get_size(self) -> int:
        return self.size

    def Get_group(self) -> Group:
        return self.group

    def Get_name(self) -> str:
        return self.name

    def Set_name(self, name: str) -> None:
        self.name = name

    def Get_errhandler(self) -> Errhandler:
        return self.errhandler

    def Set_errhandler(self, eh: Errhandler) -> None:
        self.errhandler = eh

    # ---------------------------------------------------------------- QoS
    def Set_qos_class(self, cls) -> None:
        """Pin this communicator's traffic to QoS class ``cls``
        ('latency' / 'normal' / 'bulk'): a latency-critical serving
        comm is promoted past background planes, a replication comm is
        demoted below foreground collectives."""
        from ompi_tpu_torch import qos as _qos

        _qos.set_comm_class(self, cls)

    def Get_qos_class(self) -> str:
        from ompi_tpu_torch import qos as _qos

        return _qos.NAMES[_qos.get_comm_class(self)]

    # ------------------------------------------------- stall forensics
    def Dump_state(self, reason: str = "Dump_state") -> Optional[str]:
        """Debug verb: write this rank's full per-subsystem forensics
        dump (``stall-rank<N>.json`` under metrics_dir) and — in
        process mode — request the same from every member of this
        communicator over the forensics system plane. Works with the
        stall sentinel disabled (``forensics_enable`` gates only the
        automatic machinery); returns the local dump path, or None if
        the dump could not be written."""
        from ompi_tpu_torch.runtime import forensics as _fx

        path = _fx.dump(reason=reason)
        pml = getattr(self, "pml", None)
        if pml is not None and self.size > 1:
            _fx.request_peer_dumps(pml, list(self.group.ranks), reason)
        return path

    # ---------------------------------------------------------- attributes
    def Set_attr(self, keyval: int, value: Any) -> None:
        # replacing a value fires the delete callback on the old one
        if keyval in self.attributes:
            self.Delete_attr(keyval)
        self.attributes[keyval] = value

    def Get_attr(self, keyval: int) -> Any:
        return self.attributes.get(keyval)

    def Delete_attr(self, keyval: int) -> None:
        value = self.attributes.pop(keyval, _ATTR_UNSET)
        if value is _ATTR_UNSET:
            return
        kv = _keyvals.get(keyval)
        if kv is not None and kv.delete_fn is not None:
            kv.delete_fn(self, keyval, value)

    @staticmethod
    def Create_keyval(copy_fn=None, delete_fn=None) -> int:
        """copy_fn(comm, keyval, value) -> (keep: bool, new_value) runs
        at Dup; None = MPI_COMM_NULL_COPY_FN (attribute not inherited).
        delete_fn(comm, keyval, value) runs at Delete_attr/Free."""
        kvid = _next_keyval[0]
        _next_keyval[0] += 1
        _keyvals[kvid] = _Keyval(copy_fn, delete_fn)
        return kvid

    @staticmethod
    def Free_keyval(keyval: int) -> None:
        _keyvals.pop(keyval, None)

    def _copy_attrs_to(self, new: "Communicator") -> None:
        """Attribute inheritance at Dup."""
        for kvid, value in list(self.attributes.items()):
            kv = _keyvals.get(kvid)
            if kv is None or kv.copy_fn is None:
                continue  # NULL_COPY_FN: not inherited
            keep, newval = kv.copy_fn(self, kvid, value)
            if keep:
                new.attributes[kvid] = newval

    def _delete_all_attrs(self) -> None:
        for kvid in list(self.attributes):
            self.Delete_attr(kvid)

    # ---------------------------------------------------------------- ULFM
    def _check_usable(self) -> None:
        if self.revoked:
            raise MPIError(ERR_REVOKED, self.name)

    def Revoke(self) -> None:
        """MPIX_Comm_revoke. One controller holds every rank, so the
        revocation is local: every later operation raises ERR_REVOKED."""
        if self.revoked:
            return
        self.revoked = True
        emit("comm", "revoked", name=self.name, cid=self.cid)

    # ------------------------------------------------------------ topology
    def Get_topology(self) -> int:
        return self.topo.kind if self.topo is not None else UNDEFINED

    def _cart(self):
        from ompi_tpu_torch.topo import CartTopo

        if not isinstance(self.topo, CartTopo):
            raise MPIError(ERR_TOPOLOGY, "communicator has no cartesian "
                                         "topology")
        return self.topo

    def Get_dim(self) -> int:
        return self._cart().ndims

    def Get_cart_rank(self, coords) -> int:
        return self._cart().rank(coords)


class Intracomm(Communicator):
    def Agree(self, flag: int) -> int:
        """MPIX_Comm_agree under the single controller: a BAND allreduce
        of the flag over the rank dim (the mesh branch of
        ``ompi_tpu/ft/agreement.py``)."""
        flag = int(flag)
        if not -2**31 <= flag < 2**31:
            # every position contributes the same controller-held value, so the
            # AND is the flag; the int32 payload would wrap it
            return flag
        x = self.shard(np.full((self.world_size, 1), flag, np.int32))
        return int(self.allreduce(x, _op.BAND)[0, 0])


# Live communicator registry: cid -> comm, used by the ULFM revoke handler,
# the QoS class lookup and the metrics plane (reference: the framework-wide
# comm table ompi_comm_lookup uses). In the reference only a process-mode
# ProcComm registers itself; mesh-mode comms never do, so until process
# mode is ported the registry stays empty.
_live_comms: "weakref.WeakValueDictionary[int, Communicator]" = (
    weakref.WeakValueDictionary()
)


def lookup_comm(cid: int) -> Optional[Communicator]:
    return _live_comms.get(cid)
