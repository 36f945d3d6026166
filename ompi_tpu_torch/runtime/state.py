"""Init / finalize state machine and the world communicators.

The port of ``ompi_tpu/runtime/state.py``: the same launch contract, so
the port's ranks run under either package's ``mpirun`` and beside the JAX
package's ranks in one job.

Reference: ompi/runtime/ompi_mpi_init.c:340 — an atomic state machine
(NOT_INITIALIZED → INIT_STARTED → INIT_COMPLETED → FINALIZE...) around the
instance bring-up (ompi/instance/instance.c:362 init_common: RTE init,
framework opens, PML select, modex fence, add_procs).

Two launch shapes:
- **process mode**: ``ompi_tpu_torch.tools.mpirun`` sets OMPI_TPU_RANK/SIZE and
  the modex address; init connects to the modex (PMIx_Init analog,
  ompi_rte.c:581), selects transports, exchanges business cards, wires
  endpoints (add_procs, instance.c:730).
- **singleton**: no launcher env — a 1-rank world over btl/self
  (reference: the is_singleton path, ompi_mpi_init.c:451).

``COMM_WORLD`` / ``COMM_SELF`` are lazy proxies that auto-initialize on
first use (the convenience the reference gets from mpi4py-style bindings).
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Optional

from ompi_tpu_torch.comm.communicator import ProcComm
from ompi_tpu_torch.core.errors import MPIError, ERR_OTHER
from ompi_tpu_torch.core.group import Group
from ompi_tpu_torch.utils.output import get_logger
from ompi_tpu_torch.utils.show_help import show_help

# Thread support levels (reference: mpi.h.in)
THREAD_SINGLE = 0
THREAD_FUNNELED = 1
THREAD_SERIALIZED = 2
THREAD_MULTIPLE = 3

_NOT_INITIALIZED = 0
_INITIALIZED = 1
_FINALIZED = 2

_lock = threading.RLock()
_state = _NOT_INITIALIZED
_world: Optional[ProcComm] = None
_self_comm: Optional[ProcComm] = None
_thread_level = THREAD_MULTIPLE
# Instance refcount (reference: ompi_mpi_instance_init/_finalize,
# instance.c:127-136 — the world model AND every MPI-4 session each hold
# one reference to the ONE shared instance; the last release tears the
# runtime down). MPI_Init holds a ref until MPI_Finalize; Session.Init
# holds one until Session.Finalize.
_instance_refs = 0
_torn_down = False  # teardown already ran in this process
_log = get_logger("runtime")

# import side effect: register built-in components (the components of
# later parts of the port are listed in wireup.PENDING_BINDS)
import ompi_tpu_torch.btl.self_btl  # noqa: F401,E402
import ompi_tpu_torch.btl.sm  # noqa: F401,E402
import ompi_tpu_torch.btl.tcp  # noqa: F401,E402
import ompi_tpu_torch.coll.self_coll  # noqa: F401,E402
import ompi_tpu_torch.coll.basic  # noqa: F401,E402
import ompi_tpu_torch.coll.tuned  # noqa: F401,E402
import ompi_tpu_torch.coll.nbc  # noqa: F401,E402
import ompi_tpu_torch.coll.neighbor  # noqa: F401,E402
import ompi_tpu_torch.coll.han  # noqa: F401,E402
import ompi_tpu_torch.coll.hier.compose  # noqa: F401,E402  (hierarchical composer)
import ompi_tpu_torch.coll.smcoll  # noqa: F401,E402
import ompi_tpu_torch.coll.adaptive  # noqa: F401,E402
import ompi_tpu_torch.coll.quant  # noqa: F401,E402  (quantized collectives)
import ompi_tpu_torch.hook.comm_method  # noqa: F401,E402
import ompi_tpu_torch.runtime.sanitizer  # noqa: F401,E402  (cvars + hooks)
import ompi_tpu_torch.runtime.wireup  # noqa: F401,E402  (ckpt cvar, refusals)


def _instance_up() -> None:  # locked-by: _lock
    """Idempotent instance bring-up (the body of the reference's
    ompi_mpi_instance_init: RTE init, framework opens, PML select,
    modex, add_procs)."""
    global _world, _self_comm
    if _world is not None:
        return
    if os.environ.get("OMPI_TPU_RANK") is not None:  # mpilint: disable=raw-environ — launch-shape detection (rank identity, not config)
        if _torn_down:
            # the job's other ranks fenced out of the modex during the
            # previous teardown; a fresh wireup would wait on a fence
            # no one else will ever reach (the reference's instance
            # init runs exactly once for the same reason)
            raise MPIError(ERR_OTHER,
                           "instance already torn down: sessions must "
                           "be created before the last holder finalizes")
        from ompi_tpu_torch.runtime.wireup import init_process_mode

        _world = init_process_mode()
    else:
        _world = _init_singleton()
    me = _world.pml.my_rank
    _self_comm = ProcComm(Group([me]), cid=1, pml=_world.pml,
                          name="MPI_COMM_SELF")


def acquire_instance() -> ProcComm:
    """Take one reference on the shared instance (bring it up on the
    first). Sessions use this WITHOUT touching the world-model state
    machine — MPI-4 allows sessions before/without/after MPI_Init."""
    global _instance_refs
    with _lock:
        _instance_up()  # refcount only a SUCCESSFUL bring-up: a raise
        _instance_refs += 1  # here must not leak an unreleasable ref
        return _world


def release_instance() -> None:
    """Drop one reference; the last one tears the runtime down
    (instance.c finalize ordering: the teardown runs exactly once, when
    neither the world model nor any session needs the instance)."""
    global _instance_refs, _world, _self_comm, _torn_down
    with _lock:
        _instance_refs -= 1
        if _instance_refs > 0 or _world is None:
            return
        from ompi_tpu_torch.runtime import wireup

        wireup.shutdown()
        _world = None
        _self_comm = None
        _torn_down = True


def Init(required: int = THREAD_MULTIPLE) -> int:
    """MPI_Init / MPI_Init_thread. Returns the provided thread level."""
    global _state, _thread_level
    with _lock:
        if _state == _FINALIZED:
            show_help("runtime", "already-finalized")
            raise MPIError(ERR_OTHER, "init after finalize")
        if _state == _INITIALIZED:
            return _thread_level
        # hook interposition point (reference: ompi_hook_base_mpi_init_top,
        # ompi_mpi_init.c:354)
        from ompi_tpu_torch.hook import run_hooks

        run_hooks("init_top")
        acquire_instance()  # the world model's reference
        _thread_level = THREAD_MULTIPLE if required is None else required
        _state = _INITIALIZED
        run_hooks("init_bottom")
        return _thread_level


def _init_singleton() -> ProcComm:
    from ompi_tpu_torch.btl.base import btl_framework
    from ompi_tpu_torch.pml.ob1 import Ob1Pml

    from ompi_tpu_torch.mca.var import get_var
    import ompi_tpu_torch.pml.vprotocol  # noqa: F401  (registers pml_v vars)
    from ompi_tpu_torch.runtime.wireup import refuse_unsupported

    refuse_unsupported()

    # pml/v standalone restart: the replayed process runs WITHOUT the
    # launcher but must see its original world geometry — rebuild the
    # world view from the logged metadata (receives come from the logs,
    # sends are suppressed, so no real endpoints are needed; collectives
    # are outside the replay contract)
    replay_rank = -1
    if get_var("pml_v", "enable") and get_var("pml_v", "replay"):
        replay_rank = int(get_var("pml_v", "replay_rank"))

    pml = Ob1Pml(my_rank=max(0, replay_rank))
    from ompi_tpu_torch.pml.monitoring import maybe_wrap
    from ompi_tpu_torch.pml.vprotocol import maybe_wrap as maybe_wrap_v

    # interpositions apply in EVERY init mode (v closest to the wire)
    pml = maybe_wrap(maybe_wrap_v(pml))
    _, self_btl = btl_framework.select_one(deliver=pml.handle_incoming)
    pml.add_endpoint(pml.my_rank, self_btl)
    if replay_rank >= 0:
        from ompi_tpu_torch.pml.vprotocol import VprotocolPml

        size, base = VprotocolPml.logged_world(
            get_var("pml_v", "logdir"), replay_rank)
        return ProcComm(Group(range(base, base + size)), cid=0, pml=pml,
                        name="MPI_COMM_WORLD")
    return ProcComm(Group([0]), cid=0, pml=pml, name="MPI_COMM_WORLD")


def Finalize() -> None:
    global _state
    with _lock:
        if _state != _INITIALIZED:
            return
        from ompi_tpu_torch.hook import run_hooks

        run_hooks("finalize_top")
        try:
            # freeze fabric telemetry BEFORE the exit fence: no peer
            # leaves the fence (and starts closing sockets) until every
            # rank has entered it, so this fold is guaranteed to see
            # the fabric's last healthy instant. After the fence, a
            # fast peer's teardown puts conns into their redial/
            # degraded shutdown states — shutdown mechanics, not link
            # weather, and folding them would make mpinet --check flag
            # healthy edges
            from ompi_tpu_torch.runtime import linkmodel

            linkmodel.quiesce()
        except Exception:
            pass
        if _world is not None:
            try:
                from ompi_tpu_torch.runtime import spc
                from ompi_tpu_torch.ft.detector import known_failed
                from ompi_tpu_torch.runtime.progress import progress_until

                # the exit fence cannot be met once a member died (a
                # ULFM program shrinks/revokes before Finalize; atexit
                # runs this on every clean exit, including FT-test
                # survivors) — run it nonblocking and abandon it the
                # moment a world member is declared failed, including a
                # death first detected mid-wait
                members = set(_world.group.ranks)
                if _world.size > 1 and not (known_failed() & members):
                    with spc.suppressed():
                        req = _world.Ibarrier()
                    progress_until(lambda: req.is_complete
                                   or bool(known_failed() & members))
            except Exception:
                pass
        # drop the world model's instance reference; live sessions keep
        # the runtime up until their own Finalize (instance refcounting)
        release_instance()
        _state = _FINALIZED
        run_hooks("finalize_bottom")


def Is_initialized() -> bool:
    return _state == _INITIALIZED


def Is_finalized() -> bool:
    return _state == _FINALIZED


def get_world() -> ProcComm:
    if _state != _INITIALIZED:
        Init()
    assert _world is not None
    return _world


def get_self_comm() -> ProcComm:
    if _state != _INITIALIZED:
        Init()
    assert _self_comm is not None
    return _self_comm


# lowercase aliases
init = Init
finalize = Finalize


class _CommProxy:
    """Lazy forwarding proxy so ``ompi_tpu_torch.COMM_WORLD`` exists at import
    time but only initializes the runtime on first use."""

    def __init__(self, getter, label: str):
        object.__setattr__(self, "_getter", getter)
        object.__setattr__(self, "_label", label)

    def __getattr__(self, item):
        return getattr(self._getter(), item)

    def __repr__(self):
        return f"<proxy {self._label}>"


COMM_WORLD = _CommProxy(get_world, "MPI_COMM_WORLD")
COMM_SELF = _CommProxy(get_self_comm, "MPI_COMM_SELF")

atexit.register(Finalize)
