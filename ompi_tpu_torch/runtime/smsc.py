"""smsc/cma analog — single-copy transfers of arbitrary USER memory.

The port of ``ompi_tpu/runtime/smsc.py``, whole.

Reference: opal/mca/smsc (smsc.h:74-105 — the map/copy contract every
single-copy component implements) with the cma component
(smsc/cma/smsc_cma_module.c:71-115) built on process_vm_readv/writev.
The mmap'd-segment paths elsewhere in this tree (btl/sm rings, coll/sm,
shared Win_allocate) only cover IMPLEMENTATION-owned memory; this module
is what lets a peer move bytes directly between two processes' existing
heaps — one copy, no intermediate segment.

Kernel permission model (what smsc_cma_component.c probes): the caller
needs PTRACE_MODE_ATTACH on the target — same uid suffices unless
Yama's ptrace_scope >= 1, in which case the TARGET opts in with
prctl(PR_SET_PTRACER, PR_SET_PTRACER_ANY). ``enable_peer_access()``
performs that opt-in; ``available()`` is the capability probe (syscall
present + a self-copy round trip). Cross-process permission is still
checked per-call — every user returns False / raises OSError and falls
back to its two-copy path when the kernel says no.
"""

from __future__ import annotations

import ctypes
import errno
import os
import threading
from typing import Optional

import numpy as np

from ompi_tpu_torch.mca.var import register_var, get_var
from ompi_tpu_torch.utils.output import get_logger

log = get_logger("runtime.smsc")

register_var("smsc", "enable", True,
             help="Allow single-copy user-memory transfers via "
                  "process_vm_readv/writev (reference: the smsc "
                  "framework's component gate). NOTE the ptrace "
                  "surface: on Yama-restricted hosts enabling this "
                  "opts the process in to being ptrace-attached — by "
                  "its one known same-node job peer when there is "
                  "exactly one (PR_SET_PTRACER <pid>), else by any "
                  "same-uid process (PR_SET_PTRACER_ANY; the kernel "
                  "holds only a single ptracer grant)", level=4)

_PR_SET_PTRACER = 0x59616d61  # "Yama"
_PR_SET_PTRACER_ANY = ctypes.c_ulong(-1).value


class _IoVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p),
                ("iov_len", ctypes.c_size_t)]


_lock = threading.Lock()
_cached: Optional[bool] = None
_libc = None


def _lib():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
        for name in ("process_vm_readv", "process_vm_writev"):
            fn = getattr(_libc, name)
            fn.restype = ctypes.c_ssize_t
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(_IoVec),
                           ctypes.c_ulong, ctypes.POINTER(_IoVec),
                           ctypes.c_ulong, ctypes.c_ulong]
    return _libc


def _xfer(fn, pid: int, local_addr: int, remote_addr: int,
          nbytes: int) -> None:
    """Drive one direction to completion (the kernel may return short
    counts at iovec boundaries; smsc_cma_module.c:88 loops the same
    way)."""
    done = 0
    while done < nbytes:
        liov = _IoVec(local_addr + done, nbytes - done)
        riov = _IoVec(remote_addr + done, nbytes - done)
        n = fn(pid, ctypes.byref(liov), 1, ctypes.byref(riov), 1, 0)
        if n <= 0:
            err = ctypes.get_errno() or errno.EIO
            raise OSError(err, f"{os.strerror(err)} (cma pid={pid})")
        done += n


def copy_from(pid: int, remote_addr: int, dst: np.ndarray) -> None:
    """Single-copy read of [remote_addr, +dst.nbytes) in process `pid`
    into the local contiguous array `dst` (smsc copy_from contract)."""
    assert dst.flags.c_contiguous
    _xfer(_lib().process_vm_readv, pid, dst.ctypes.data, remote_addr,
          dst.nbytes)


def copy_to(pid: int, remote_addr: int, src: np.ndarray) -> None:
    """Single-copy write of the local contiguous array `src` into
    [remote_addr, +src.nbytes) in process `pid` (smsc copy_to)."""
    assert src.flags.c_contiguous
    _xfer(_lib().process_vm_writev, pid, src.ctypes.data, remote_addr,
          src.nbytes)


_granted: Optional[str] = None  # None | "pid" | "any"


def enable_peer_access(peer_pids=None) -> None:
    """Target-side opt-in for Yama-restricted hosts (reference:
    smsc_cma's Yama handling), scoped as narrowly as the kernel allows:
    PR_SET_PTRACER holds exactly ONE grant, so with a single known peer
    pid (the modex-learned same-node job peer, see wireup) the grant is
    that pid only; with several peers — or when the per-pid grant fails
    — fall back to PR_SET_PTRACER_ANY as before. No-op where prctl is
    absent or the policy already allows attaching."""
    global _granted
    if peer_pids and len(peer_pids) == 1:
        try:
            if _lib().prctl(_PR_SET_PTRACER, int(peer_pids[0]),
                            0, 0, 0) == 0:
                _granted = "pid"
                log.debug("ptracer grant scoped to peer pid %s",
                          peer_pids[0])
                return
        except (OSError, AttributeError, ValueError):
            pass
    try:
        _lib().prctl(_PR_SET_PTRACER, _PR_SET_PTRACER_ANY, 0, 0, 0)
        _granted = "any"
    except (OSError, AttributeError):
        pass


def available() -> bool:
    """Capability probe, cached: syscalls resolvable AND a self-copy
    round trip succeeds. A True here still doesn't guarantee any given
    cross-process transfer (per-pid permission is checked by the
    kernel per call) — callers treat OSError as 'fall back'."""
    global _cached
    if _cached is not None:
        return _cached
    with _lock:
        if _cached is not None:
            return _cached
        if not get_var("smsc", "enable"):
            _cached = False
            return False
        try:
            src = np.arange(64, dtype=np.uint8)
            dst = np.zeros(64, np.uint8)
            copy_from(os.getpid(), src.ctypes.data, dst)
            _cached = bool((src == dst).all())
        except (OSError, AttributeError, ValueError):
            _cached = False
        if _cached:
            if _granted is None:
                # contexts outside wireup's scoped per-pid grant
                # (mesh-mode scripts, tests) still need the opt-in;
                # wireup's earlier grant, when present, is not widened
                enable_peer_access()
        else:
            log.debug("cma unavailable: falling back to two-copy paths")
    return _cached


def buffer_handle(arr: np.ndarray):
    """(pid, address, nbytes) for a C-contiguous array — the 'business
    card' a peer needs for copy_to/copy_from; None when the memory
    isn't single-copy eligible."""
    if not (isinstance(arr, np.ndarray) and arr.flags.c_contiguous
            and arr.nbytes > 0):
        return None
    return (os.getpid(), arr.ctypes.data, arr.nbytes)
