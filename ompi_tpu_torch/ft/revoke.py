"""Communicator revocation.

The port of ``ompi_tpu/ft/revoke.py`` without ``shrink_comm``, which
builds a process-mode ``ProcComm`` and comes with it. ``revoke_comm``
(the flood, its dedup and the drain through the pml's
``revoke_requests``), the notice handler that process mode's wireup binds
to ``REVOKE_TAG``, and the pml-level shrink agreement run now.

Reference: ompi/communicator/ft/comm_ft_revoke.c + the reliable
broadcast of comm_ft_reliable_bcast.c — revoke must reach every live
member even when the initiator dies mid-propagation. Redesign: a
FLOOD — every rank re-forwards the notice to all peers the first time
it learns of the revocation (the revoked flag is the dedup), so any
connected component of live ranks converges after one failure, which is
the rbcast property the reference's BMG topology provides.
"""

from __future__ import annotations

from ompi_tpu_torch.utils.show_help import show_help


REVOKE_TAG = -4242  # internal tag space (negative tags are framework-only)


def revoke_comm(comm) -> None:
    """Flip local revoked state and flood the notice to every peer.
    Re-entry (a notice for an already-revoked comm) stops the flood."""
    import numpy as np

    if comm.revoked:
        return
    comm.revoked = True
    show_help("comm", "revoked", name=comm.name)
    from ompi_tpu_torch.mpit import emit  # MPI_T event (mpit.py)

    emit("comm", "revoked", name=comm.name, cid=comm.cid)
    pml = getattr(comm, "pml", None)
    if pml is None:
        return  # mesh-mode comms revoke locally (single controller)
    token = np.array([comm.cid], dtype=np.int64)
    for r in comm.group.ranks:
        if r == pml.my_rank:
            continue
        try:
            pml.isend(token, 1, _int64(), r, REVOKE_TAG, comm.cid)
        except Exception:
            pass  # peer may already be dead; its detector will notice
    # fail every pending operation on the revoked comm NOW (ULFM: the
    # revocation completes pending operations with ERR_REVOKED). A rank
    # blocked mid-collective on a LIVE peer that left for recovery has
    # nothing the peer-death sweep can convert — without this drain it
    # waits out the era timeout while the recovering peers' agreement
    # stalls on it (the "agreement stalled on coordinator" soak class).
    # Runs on the initiator AND on every flood receipt (_on_revoke
    # re-enters here exactly once per rank — the revoked flag dedups).
    drain = getattr(pml, "revoke_requests", None)
    if drain is not None:
        drain(comm.cid)


def on_revoke_notice(hdr, payload) -> None:
    """System handler of ``REVOKE_TAG`` (bound by process mode's wireup,
    as ``ompi_tpu/runtime/wireup.py`` binds its ``_on_revoke``): the first
    receipt re-enters :func:`revoke_comm`, which forwards the notice to
    every peer (the flood is reliable propagation even if the initiator
    died mid-broadcast); the revoked flag dedups."""
    from ompi_tpu_torch.comm.communicator import lookup_comm

    comm = lookup_comm(hdr.cid)
    if comm is not None:
        revoke_comm(comm)


def _int64():
    from ompi_tpu_torch.core.datatype import INT64

    return INT64


# Shrink agreement plane: its own CID bit so agreement traffic on the
# (revoked) comm can't match user or collective traffic.
FT_CID_BIT = 1 << 25
_TAG_SHRINK = 90


def _agree_max_alive(pml, alive, cid: int, value: int,
                     timeout: float = 30.0) -> int:
    """MAX-agreement among the live members over direct pml exchange —
    the revoked comm's collectives are unusable, which is exactly why
    ftagree exists (reference: coll/ftagree ERA; this is the
    coordinator-based simplification over an already-shrunk live set).

    Failure handling (never silently return the local value —
    diverging members would adopt different CIDs and hang):
    - a contributor that dies mid-round is excluded once the detector
      confirms it;
    - a coordinator that dies mid-round triggers a retry with the next
      live coordinator on fresh tags;
    - an *undetected* stall raises MPIError after the timeout, with every
      outstanding irecv cancelled, instead of diverging.

    Known limit vs real ERA: a coordinator that dies after a PARTIAL
    result broadcast leaves the recipients returned while the rest retry
    a round the recipients no longer serve — those ranks raise after the
    timeout (fail-fast, not divergence). Full mid-call consensus is
    ft/era.py's job; this coordinator round remains only as the transport
    for already-shrunk live sets."""
    import time

    import numpy as np

    from ompi_tpu_torch.core.datatype import INT64
    from ompi_tpu_torch.core.errors import MPIError, ERR_PENDING
    from ompi_tpu_torch.ft.detector import known_failed

    plane = cid | FT_CID_BIT
    coords = sorted(alive)
    for rnd, coord in enumerate(coords):
        if coord in known_failed():
            continue
        tag_in = _TAG_SHRINK + 2 * rnd
        tag_out = tag_in + 1
        deadline = time.monotonic() + timeout

        def recv_from(peer: int, tag: int, who: str):
            """(value, None) on success, (None, 'dead') when the peer died
            (detector-confirmed); raises on an undetected stall. A reply
            racing the peer's detected death still counts: cancel_recv
            returns False when the request already completed, in which
            case the buffer holds the value."""
            buf = np.zeros(1, np.int64)
            req = pml.irecv(buf, 1, INT64, peer, tag, plane)
            while True:
                try:
                    req.Wait(timeout=0.25)
                    return int(buf[0]), None
                except MPIError:
                    if peer in known_failed():
                        if not pml.cancel_recv(req) and not req._error:
                            return int(buf[0]), None  # reply won the race
                        return None, "dead"
                    if time.monotonic() > deadline:
                        pml.cancel_recv(req)
                        raise MPIError(
                            ERR_PENDING,
                            f"shrink agreement stalled on {who} {peer}")

        if pml.my_rank == coord:
            vals = [value]
            for r in alive:
                if r == coord or r in known_failed():
                    continue
                v, dead = recv_from(r, tag_in, "rank")
                if dead is None:
                    vals.append(v)  # dead contributors are excluded
            agreed = max(vals)
            out = np.array([agreed], np.int64)
            for r in alive:
                if r != coord and r not in known_failed():
                    try:
                        pml.isend(out, 1, INT64, r, tag_out, plane)
                    except MPIError:
                        pass  # recipient's transport died: detector's job
            return agreed
        try:
            pml.isend(np.array([value], np.int64), 1, INT64, coord,
                      tag_in, plane)
        except MPIError:
            # coordinator's transport already dead (tcp marks connections
            # dead before the detector confirms): roll to the next round
            continue
        v, dead = recv_from(coord, tag_out, "coordinator")
        if dead is None:
            return v
        # coordinator died: next round, next coordinator
    raise MPIError(ERR_PENDING, "shrink agreement: no live coordinator")
