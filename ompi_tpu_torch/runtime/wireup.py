"""Process-mode wireup: modex connect, transport selection, endpoint setup.

The port of ``ompi_tpu/runtime/wireup.py``: the same modex cards and
fences, so the port's ranks and the JAX package's wire up in one job. It
binds the planes the port has (topology, sanitizer, metrics, hier's
retune plane, forensics, linkmodel, revoke, failure propagation,
heartbeat detector, the tcp link upcall, idle sources and the progress
thread); the binds of later parts
of the port are named in ``PENDING_BINDS``, and a launch that needs one
of them (a spawned child, diskless checkpointing) raises ``MPIError``
naming it instead of running half-wired.
Reference: the RTE/PMIx glue (ompi/runtime/ompi_rte.c:538-581 PMIx_Init,
OPAL_MODEX_SEND/RECV macros pmix-internal.h:266,577) and the instance
bring-up ordering of ompi/instance/instance.c:362-730 (framework opens →
PML select → modex fence → add_procs).
"""

from __future__ import annotations

import os
from typing import Optional

from ompi_tpu_torch.core.errors import MPIError, ERR_UNSUPPORTED_OPERATION
from ompi_tpu_torch.mca.var import register_var

_ctx: Optional[dict] = None

# The modules the reference's init binds that the port does not have yet:
# those ``ompi_tpu/runtime/state.py`` imports at module level and those
# ``ompi_tpu/runtime/wireup.py`` init_process_mode imports (the agreement
# engine, diskless checkpointing, the dpm bridge of a spawned child), each
# with the part of the port that brings it.
PENDING_BINDS = (
    ("runtime.dpm", "A.14.7"),
    ("ft.era", "A.14.8"),
    ("ft.diskless", "A.14.8"),
)

# registered here with the reference's default and help (its owner,
# ft/diskless.py, is pending) so that a setting of it is seen and refused
_ckpt_enable_var = register_var(
    "ft", "ckpt_enable", False,
    help="Replicate in-memory checkpoint epochs to peer ranks "
         "(diskless checkpointing) so ft/recovery can restore from "
         "survivor memory with no shared filesystem; disabled path is "
         "one attribute load per hook", level=3)


def refuse_unsupported() -> None:
    """Raise ``MPIError`` for a launch that needs a pending bind: a
    spawned child (``OMPI_TPU_BASE``/``OMPI_TPU_JOB`` set: the dpm bridge
    to its parent) or ``ft_ckpt_enable`` (diskless checkpointing)."""
    missing = []
    if os.environ.get("OMPI_TPU_BASE") is not None \
            or os.environ.get("OMPI_TPU_JOB") is not None:  # mpilint: disable=raw-environ — launcher wire-up plumbing
        missing.append("runtime.dpm (a spawned child job)")
    if _ckpt_enable_var._value:
        missing.append("ft.diskless (ft_ckpt_enable)")
    if missing:
        raise MPIError(ERR_UNSUPPORTED_OPERATION,
                       "this launch needs what the torch port does not "
                       "have yet: " + "; ".join(missing))


def init_process_mode():
    """Bring up this rank: connect modex, publish our business card, fence,
    wire an endpoint per peer, build MPI_COMM_WORLD."""
    global _ctx
    from ompi_tpu_torch.btl.base import btl_framework
    from ompi_tpu_torch.comm.communicator import ProcComm
    from ompi_tpu_torch.core.group import Group
    from ompi_tpu_torch.ft import detector as ft_detector
    from ompi_tpu_torch.ft.revoke import REVOKE_TAG
    from ompi_tpu_torch.mca.var import get_var
    from ompi_tpu_torch.pml.ob1 import Ob1Pml
    from ompi_tpu_torch.runtime.modex import ModexClient
    from ompi_tpu_torch.runtime.progress import ProgressThread, register_progress

    refuse_unsupported()
    rank = int(os.environ["OMPI_TPU_RANK"])  # mpilint: disable=raw-environ — launcher wire-up plumbing (env IS the launch channel)
    size = int(os.environ["OMPI_TPU_SIZE"])  # mpilint: disable=raw-environ — launcher wire-up plumbing (env IS the launch channel)
    modex_addr = os.environ["OMPI_TPU_MODEX"]  # mpilint: disable=raw-environ — launcher wire-up plumbing (env IS the launch channel)
    # die with the launcher (reference: prted kills its local ranks on
    # DVM teardown): a SIGKILLed mpirun must not leave ranks spinning
    # on a dead modex — PR_SET_PDEATHSIG covers the direct-spawn and
    # exec-chain (fake_rsh) cases; real ssh relies on its own teardown
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, 15, 0, 0, 0)  # PR_SET_PDEATHSIG, SIGTERM
        # close the set-after-death race: only exit if the REAL launcher
        # pid is gone (ppid==1 alone false-positives when mpirun itself
        # is pid 1, e.g. as a container entrypoint)
        launcher = int(os.environ.get("OMPI_TPU_LAUNCHER_PID", "0"))  # mpilint: disable=raw-environ — launcher wire-up plumbing (env IS the launch channel)
        if launcher and os.getppid() != launcher:
            try:
                os.kill(launcher, 0)
            except ProcessLookupError:
                os._exit(143)  # launcher already gone
            except OSError:
                pass
    except (OSError, AttributeError):
        pass
    # dynamic-process support (reference: PMIx nspace + job-level rank):
    # spawned jobs live at a universe-rank offset so every transport
    # endpoint and modex key stays in one flat namespace
    base = int(os.environ.get("OMPI_TPU_BASE", "0"))  # mpilint: disable=raw-environ — launcher wire-up plumbing (env IS the launch channel)
    job = int(os.environ.get("OMPI_TPU_JOB", "0"))  # mpilint: disable=raw-environ — launcher wire-up plumbing (env IS the launch channel)
    urank = base + rank

    # optional rank->cpuset binding (hwloc analog; reference: prte's
    # --bind-to core applied at launch) — before any threads start so
    # the mask is inherited by the progress/detector threads. Universe
    # coordinates (urank over base+size) so a spawned job's ranks don't
    # re-partition from zero onto the parent's cpus; a multi-job
    # universe still approximates (the parent's slices were fixed when
    # its smaller universe was the whole world — documented limit vs
    # the reference launcher's host-global view).
    from ompi_tpu_torch.runtime.topology import maybe_bind

    maybe_bind(urank, base + size)

    pml = Ob1Pml(my_rank=urank)
    # optional interpositions (reference: pml/monitoring and pml/v win
    # selection then forward to the real pml); v wraps closest to the
    # wire so monitoring counts replayed traffic too
    from ompi_tpu_torch.pml.monitoring import maybe_wrap
    from ompi_tpu_torch.pml.vprotocol import maybe_wrap as maybe_wrap_v

    pml = maybe_wrap(maybe_wrap_v(pml))
    modex = ModexClient(modex_addr, urank, size, job=job)

    # btl selection (reference: mca_pml_base_select opening BTLs via bml/r2)
    modules = btl_framework.select_all(deliver=pml.handle_incoming,
                                      my_rank=urank, n_ranks=size,
                                      local_rank=rank)
    by_name = {name: mod for _, name, mod in modules}
    self_btl = by_name.get("self")
    sm = by_name.get("sm")
    tcp = by_name.get("tcp")

    # business card: how peers reach us (reference: the modex endpoint blob
    # every btl publishes)
    if tcp is not None:
        modex.put("btl.tcp.addr", f"{tcp.host}:{tcp.port}")
    my_node = None
    if sm is not None:
        from ompi_tpu_torch.btl.sm import node_id

        my_node = node_id()
        modex.put("btl.sm.seg", sm.seg_path)
        modex.put("btl.sm.node", my_node)
        # pid card for the smsc/cma ptracer grant: peers that may
        # single-copy into this process are exactly the same-node job
        # peers, and scoping PR_SET_PTRACER needs their pids
        modex.put("smsc.pid", str(os.getpid()))
    # quant negotiation card: published BEFORE the fence so every rank
    # holds every member's config by the time any communicator selects
    # its coll table — the verdict becomes a pure local computation and
    # a rank with quant_enable unset can never tear a collective
    # (quant/negotiate.py)
    from ompi_tpu_torch.quant import negotiate as _qneg

    modex.put(_qneg.CARD_KEY, _qneg.card_json())
    modex.fence()  # reference: PMIx_Fence_nb at instance.c:575-625

    job_peers = [base + i for i in range(size)]  # universe ranks of my job
    if tcp is not None:
        peers = {r: modex.get(r, "btl.tcp.addr")
                 for r in job_peers if r != urank}
        tcp.set_peers(peers)
    sm_peers = {}
    if sm is not None:
        for r in job_peers:
            if r == urank:
                continue
            try:
                # post-fence, a missing card will never appear: don't wait
                if modex.get(r, "btl.sm.node", timeout=0.0) != my_node:
                    continue
                seg = modex.get(r, "btl.sm.seg", timeout=0.0)
                # boot_id matches across containers that share a kernel
                # but not /dev/shm — only bind sm if the segment is
                # actually reachable; otherwise fall through to tcp
                if os.path.exists(seg):
                    sm_peers[r] = seg
            except Exception:
                pass  # peer has no sm card (e.g. excluded via --mca btl)
        sm.set_peers(sm_peers)
        if sm_peers:
            from ompi_tpu_torch.runtime import smsc  # registers smsc_enable

            if get_var("smsc", "enable"):
                # scope the ptracer opt-in to the known same-node peer
                # pids (one-pid kernel grant when possible, ANY
                # otherwise — see smsc.enable_peer_access)
                pids = []
                for r in sm_peers:
                    try:
                        pids.append(int(modex.get(r, "smsc.pid",
                                                  timeout=0.0)))
                    except Exception:
                        pass
                if pids:
                    smsc.enable_peer_access(pids)

    # add_procs: bind the best endpoint per peer, ordered by component
    # priority + locality — the bml/r2 endpoint ordering (instance.c:730):
    # self (loopback) > sm (same node) > tcp.
    if self_btl is not None:
        pml.add_endpoint(urank, self_btl)
    for r in job_peers:
        if r == urank:
            continue
        if r in sm_peers:
            pml.add_endpoint(r, sm)
            if tcp is not None:
                # bml/r2 failover order: a dead sm channel rebinds to tcp
                pml.set_fallbacks(r, [sm, tcp])
        elif tcp is not None:
            pml.add_endpoint(r, tcp)

    # Cross-job endpoints (intercomm/spawn traffic) wire lazily: first
    # send/recv to an unknown universe rank resolves its card from the
    # modex and binds tcp (sm ring indices are job-scoped — dynamic
    # processes ride the DCN path, reference: dpm over OOB channels).
    def _resolve_endpoint(r: int):
        if tcp is None:
            return None
        addr = modex.get(r, "btl.tcp.addr", timeout=30.0)
        tcp.peers[r] = addr
        return tcp

    pml.endpoint_resolver = _resolve_endpoint

    # link-reliability upcall: a tcp link healed by reconnect-and-replay
    # tells the pml so its dead-letter stash for that peer re-drives
    # (getattr: monitoring/vprotocol wrappers forward it; a pml without
    # the seam simply leaves the btl callback unbound)
    if tcp is not None:
        _restored = getattr(pml, "link_restored", None)
        if _restored is not None:
            tcp.link_restored_cb = _restored

    for _, _, mod in modules:
        register_progress(mod.progress)

    # idle-blocking sources: fd-driven transports export their fds so
    # idle loops can park in select; a poll-only transport (sm rings)
    # registers as None, capping every park at the legacy poll
    # interval; self (inline delivery) registers nothing
    from ompi_tpu_torch.runtime.progress import set_idle_sources

    idle_srcs = []
    for _, _, mod in modules:
        exporter = getattr(mod, "idle_fds", None)
        if exporter is not None:
            idle_srcs.append(exporter)
        elif getattr(mod, "NEEDS_POLL", True):
            idle_srcs.append(None)
    set_idle_sources(idle_srcs)

    pthread = None
    if get_var("runtime", "progress_thread"):
        pthread = ProgressThread()
        pthread.start()

    # ULFM plane: revoke notices + heartbeat routing (reference: the PMIx
    # error handlers + detector registered during init, instance.c:452-530)
    from ompi_tpu_torch.ft.revoke import on_revoke_notice

    pml.register_system_handler(REVOKE_TAG, on_revoke_notice)

    # failure-notice flood (reference: comm_ft_propagator.c): a locally
    # detected death (ring heartbeat or tcp EOF) is re-forwarded to every
    # peer; mark_failed's dedup terminates the flood
    def _on_failure_prop(hdr, payload):
        import numpy as _np

        ft_detector.mark_failed(int(_np.frombuffer(payload,
                                                   dtype=_np.int64)[0]))

    def _propagate_failure(dead: int):
        import numpy as _np

        from ompi_tpu_torch.core.datatype import INT64

        notice = _np.array([dead], dtype=_np.int64)
        for peer in job_peers:
            if peer in (urank, dead) or \
                    peer in ft_detector.known_failed():
                continue
            try:
                pml.isend(notice, 1, INT64, peer,
                          ft_detector.FAILURE_PROP_TAG, 0)
            except Exception:
                pass

    pml.register_system_handler(ft_detector.FAILURE_PROP_TAG,
                                _on_failure_prop)
    ft_detector.set_propagator(_propagate_failure)

    # same fence discipline for the other diagnostic planes (mpiracer
    # handler-fence): the sanitizer/metrics init_bottom hooks read
    # world_pml(), which is None until init_process_mode RETURNS — so a
    # fast peer racing through init_bottom into its first collective
    # could ship a stamp/probe this rank's unbound tag would drop. The
    # hier retune plane has no init_bottom hook at all (its lazy ensure
    # ran only when this rank's own composed call finished).
    from ompi_tpu_torch.coll.hier import decide as hier_decide
    from ompi_tpu_torch.runtime import forensics as rt_forensics
    from ompi_tpu_torch.runtime import linkmodel as rt_linkmodel
    from ompi_tpu_torch.runtime import metrics as rt_metrics
    from ompi_tpu_torch.runtime import sanitizer as rt_sanitizer

    rt_sanitizer.bind_plane(pml)
    rt_metrics.bind_plane(pml)
    hier_decide.bind_plane(pml)
    # stall-forensics dump-request plane (-4800): a fast peer's stall
    # sentinel can latch and request this rank's dump the moment the
    # fence releases it — same pre-fence discipline as the planes above
    rt_forensics.bind_plane(pml)
    # fabric-telemetry probe echo plane (-4900): a fast peer's idle
    # prober can ping this rank right after the fence
    rt_linkmodel.bind_plane(pml)

    hb = None
    if get_var("ft", "enable") and job == 0:
        # the heartbeat ring runs over job-0 world ranks; spawned jobs
        # rely on their parent's detector (reference: per-job PMIx
        # event registration)
        hb = ft_detector.HeartbeatDetector(pml, rank, size)
        pml.register_system_handler(
            ft_detector.HEARTBEAT_TAG,
            lambda hdr, payload: hb.note_heartbeat(hdr.src))
        hb.start()

    # _ctx goes live BEFORE the world comm exists: ProcComm.__init__
    # runs coll selection, and locality-aware components (coll/sm,
    # coll/han) read the modex node map through _ctx — created after,
    # they would silently decline on MPI_COMM_WORLD
    _ctx = {
        "modex": modex,
        "btls": [mod for _, _, mod in modules],
        "progress_thread": pthread,
        "detector": hb,
        "world": None,
        "job": job,
        "base": base,
        "size": size,
    }
    world = ProcComm(Group(job_peers), cid=0, pml=pml,
                     name="MPI_COMM_WORLD")
    _ctx["world"] = world
    if hasattr(pml, "note_world"):  # pml/v live mode: record geometry
        pml.note_world(size, base)
    # the pre-activation barrier (ompi_mpi_init.c:451-505 modex barrier)
    modex.fence()
    return world


def shutdown() -> None:
    global _ctx
    if _ctx is None:
        return
    # No exit fence on the modex: the reference's never runs (its
    # shutdown reads ``ft_detector``, a name bound only inside
    # init_process_mode, and swallows the NameError), and the ranks of
    # both packages in one job must leave alike — a fence that only the
    # port's ranks entered would wait for ever.
    if _ctx.get("detector") is not None:
        _ctx["detector"].stop()
    if _ctx.get("progress_thread") is not None:
        _ctx["progress_thread"].stop()
    # stale fd exporters must not survive into the next epoch (their
    # btls are about to close)
    from ompi_tpu_torch.runtime.progress import set_idle_sources

    set_idle_sources([])
    for btl in _ctx.get("btls", []):
        try:
            btl.finalize()
        except Exception:
            pass
    try:
        _ctx["modex"].close()
    except Exception:
        pass
    _ctx = None
