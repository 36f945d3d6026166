"""QoS traffic classes: classification shared by the pml and the btls.

The port of ``ompi_tpu/qos.py``. The classes, the tag map and the
per-communicator override run now; the shaping that consumes them lives
in the tcp btl and the ob1 pml of process mode. Until a process-mode
communicator registers itself (``comm.communicator.lookup_comm``), every
communicator classifies NORMAL, as mesh-mode comms do in the reference.

Production serving means background planes — diskless
checkpoint replication (tag -4600), metrics shipping (-4500), respawn
state transfer — share wires with latency-critical collectives. This
module owns the class taxonomy and the classification policy; the tcp
btl (the shaped transport) owns the per-class send scheduler, and the
pml stamps the class into a spare bit-field of the frame header (bits
6-7 of the kind byte, NORMAL=0 so an unshaped job's wire format is
bit-identical to the pre-QoS framing).

Classes:

- ``LATENCY`` — control traffic that must never queue behind bulk:
  protocol handshakes (CTS/ACK/FIN are stamped LATENCY by the pml
  itself), heartbeats, era/revoke floods, and any communicator an
  operator promotes.
- ``NORMAL`` — the default: application pt2pt and collectives.
- ``BULK``  — background byte movers: diskless checkpoint blobs,
  metrics shipping, demoted communicators. Bulk frames above
  ``btl_tcp_shape_segment_bytes`` are segmented at the pml into
  resumable sub-frames (reassembled via the existing offset/msgid
  header fields) so a 64MB blob can be preempted between sendmsg
  calls instead of head-of-line-blocking a 4KB allreduce for its full
  serialization time.

Classification precedence (evaluated only when shaping is enabled —
the disabled path of every hook is one live-Var attribute load):

1. an explicit per-send override (``pml.isend(..., qos=...)`` — the
   coll round engine tags phase traffic this way);
2. the ``qos_tag_map`` cvar: system tags (<= -4000) always resolve
   through it (the default demotes the known background planes to BULK
   and promotes the ft control plane to LATENCY), and explicitly
   listed POSITIVE tags do too — the recovery state-movement planes
   (respawn state delivery 4242, diskless reconstruction exchange
   4243, reshard rounds 4300) default to BULK so a recovery storm
   cannot contend head-on with foreground step traffic;
3. a per-communicator override via comm attrs
   (:func:`set_comm_class` / ``comm.Set_qos_class``), looked up
   through the live-comm registry with a flat cid-keyed cache so the
   steady state is one dict hit (derived cid planes — NBC, partitioned,
   collective — inherit the base communicator's class);
4. NORMAL.

Ordering contract: the tcp shaper preserves FIFO *within* a class but
reorders *across* classes, so the pml runs one MATCH-plane sequence
space per (peer, class). MPI's non-overtaking guarantee holds because
a (cid, tag) plane maps to exactly one class: comm overrides apply to
the whole communicator (all its tags and derived planes), the tag map
keys matching-exempt system planes, and round-engine phase overrides
ride distinct tag sub-planes (``Round.plane``). Changing a comm's
class while its traffic is in flight is therefore the caller's
ordering hazard, same as any mid-stream retune of a trusted-symmetric
cvar.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ompi_tpu_torch.mca.var import register_var, register_pvar, watch_var

# wire encoding (header kind-byte bits 6-7): NORMAL must be 0 so the
# unshaped framing is bit-identical to the pre-QoS wire format
NORMAL = 0
LATENCY = 1
BULK = 2
NAMES = {NORMAL: "normal", LATENCY: "latency", BULK: "bulk"}
_BY_NAME = {v: k for k, v in NAMES.items()}

#: system tags (<= this) are framework planes (pml/base single source
#: of truth is -4000; duplicated here so this module imports nothing
#: above mca/var — the pml imports us, not the reverse)
_SYSTEM_TAG_BASE = -4000
#: user cids live below the plane bits (pml/base._PLANE_MASK inverse)
_PLANE_SHIFT = 25
_CID_MASK = (1 << _PLANE_SHIFT) - 1

_enable_var = register_var(
    "btl_tcp", "shape_enable", 0,
    help="1 = priority-aware traffic shaping: the pml stamps a QoS "
         "class (latency/normal/bulk) into each frame header, system "
         "blobs above btl_tcp_shape_segment_bytes are segmented into "
         "preemptible sub-frames, and the tcp btl drains per-class "
         "sub-queues with a weighted-deficit scheduler instead of one "
         "FIFO. 0 (default) = the legacy single-FIFO drain, verbatim. "
         "Trusted-symmetric: set it identically on every rank of a "
         "job (the receive side keys its per-class sequence planes off "
         "the stamped class, so mixed OLD/NEW builds must not shape)",
    level=4)
_segment_var = register_var(
    "btl_tcp", "shape_segment_bytes", 262144,
    help="With shaping on, system-plane frames above this size are "
         "segmented into sub-frames of at most this many payload "
         "bytes (reassembled via the header offset/msgid fields), and "
         "BULK rendezvous DATA fragments are clamped to it — the "
         "yield granularity at which a LATENCY frame can preempt a "
         "bulk blob mid-transfer", level=5)
_tag_map_var = register_var(
    "qos", "tag_map", "-4600:bulk,-4500:bulk,-4242:latency,"
                      "-4243:latency,-4244:latency,-4245:latency,"
                      "-4800:latency,-4900:latency,"
                      "4242:bulk,4243:bulk,4300:bulk",
    typ=str,
    help="Default QoS class per tag plane: 'tag:class' pairs, comma-"
         "separated. System tags (<= -4000) always resolve through "
         "this map; POSITIVE tags resolve through it only when listed "
         "AND only on the plane-free user cid — derived planes carry "
         "internal tag sequences that must not collide — (ahead of "
         "any per-comm override). The default demotes the "
         "known background planes (diskless ckpt replication -4600, "
         "metrics shipping -4500) to bulk, promotes the ft control "
         "plane (revoke -4242, heartbeat -4243, era -4244, failure "
         "flood -4245), the stall-forensics dump requests (-4800 — "
         "a dump request diagnosing a bulk backlog must not queue "
         "behind it) and the fabric-telemetry probe echoes (-4900 — "
         "an RTT probe queued behind bulk would measure the queue, "
         "not the wire) to latency, and demotes the RECOVERY state-"
         "movement planes to bulk: respawn state delivery (4242), the "
         "diskless XOR-reconstruction/buddy-blob exchange (4243), and "
         "reshard rounds (4300) — during a recovery storm these bytes "
         "must not contend head-on with foreground step traffic "
         "(tests/procmode/check_serving.py iso measures the A/B). An "
         "application whose own traffic uses one of the mapped "
         "positive tags can unlist it here; unlisted tags ride their "
         "comm's class or normal", level=5)

# classification counters (plain int bumps, the btl _ctr discipline) —
# stamped-by-class totals prove the demotion map engages
_ctr: Dict[str, int] = {"normal": 0, "latency": 0, "bulk": 0,  # mpiracer: relaxed-counter — classify() rides the per-send hot path; single-op GIL adds, a racing bump may lose a count
                        "seg_frames": 0, "reassembled": 0}

register_pvar("qos", "stamped_normal", lambda: _ctr["normal"],
              help="Frames classified NORMAL by the pml stamp "
                   "(shaping on)")
register_pvar("qos", "stamped_latency", lambda: _ctr["latency"],
              help="Frames classified LATENCY by the pml stamp")
register_pvar("qos", "stamped_bulk", lambda: _ctr["bulk"],
              help="Frames classified BULK by the pml stamp")
register_pvar("qos", "segments", lambda: _ctr["seg_frames"],
              help="Sub-frames produced by segmenting oversized "
                   "system-plane blobs for preemptible BULK shipping")
register_pvar("qos", "reassembled", lambda: _ctr["reassembled"],
              help="Segmented system-plane blobs reassembled at the "
                   "receive side (offset/msgid recombination)")


def enabled() -> bool:
    """One attribute load off the live Var (spc/trace discipline)."""
    return bool(_enable_var._value)


def segment_bytes() -> int:
    return int(_segment_var._value)


def resolve(cls) -> int:
    """Class name or int -> class int (raises on unknown)."""
    if isinstance(cls, str):
        try:
            return _BY_NAME[cls.lower()]
        except KeyError:
            raise ValueError(f"unknown QoS class {cls!r}: expected one "
                             f"of {sorted(_BY_NAME)}") from None
    c = int(cls)
    if c not in NAMES:
        raise ValueError(f"unknown QoS class {cls!r}")
    return c


# ------------------------------------------------------------ tag map
_lock = threading.Lock()
_tag_classes: Optional[Dict[int, int]] = None


def _parse_tag_map() -> Dict[int, int]:
    out: Dict[int, int] = {}
    raw = str(_tag_map_var._value or "")
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        tag_s, _, cls_s = part.partition(":")
        try:
            out[int(tag_s)] = resolve(cls_s.strip())
        except ValueError:
            from ompi_tpu_torch.utils.output import get_logger

            get_logger("qos").warning(
                "qos_tag_map: ignoring malformed entry %r", part)
    return out


def _invalidate_tag_map(_var=None) -> None:
    global _tag_classes
    with _lock:
        _tag_classes = None


watch_var("qos", "tag_map", _invalidate_tag_map)


def _tag_map() -> Dict[int, int]:
    global _tag_classes
    m = _tag_classes
    if m is None:
        with _lock:
            m = _tag_classes = _parse_tag_map()
    return m


def _tag_class(tag: int) -> int:
    return _tag_map().get(tag, NORMAL)


# ----------------------------------------------- per-communicator override
# kvid of the comm-attr keyval (created lazily — this module must stay
# importable below comm/), and a flat cid -> class cache so the pml's
# per-send lookup is one dict hit. The cache covers derived cid planes
# (cid | NBC_CID_BIT etc. resolve through the base-cid comm).
_keyval: Optional[int] = None
_cls_cache: Dict[int, int] = {}


def _clear_cache(*_a) -> None:
    # rebind, don't .clear(): the pml's classify() reads this dict from
    # both the app thread and the progress thread with no lock (one
    # dict hit per send is the whole point). clear() racing a concurrent
    # _comm_class insert could resurrect a stale class after a comm-attr
    # rewrite; swapping in a fresh dict is one atomic store, and an
    # in-flight reader of the old dict at worst finishes its current
    # lookup against the pre-invalidation view (found by mpiracer
    # cross-thread-race).
    global _cls_cache
    _cls_cache = {}


def comm_keyval() -> int:
    global _keyval
    if _keyval is None:
        from ompi_tpu_torch.comm.communicator import Communicator

        # copy_fn inherits the class at Dup; delete_fn (Delete_attr,
        # Set_attr replace, Free's attr sweep) invalidates the cache so
        # a dead comm's class can't leak onto a recycled cid
        _keyval = Communicator.Create_keyval(
            copy_fn=lambda comm, kv, val: (True, val),
            delete_fn=lambda comm, kv, val: _clear_cache())
    return _keyval


def set_comm_class(comm, cls) -> None:
    """Override every frame of ``comm`` (and its derived cid planes —
    NBC schedules, partitioned transfers) to QoS class ``cls``
    ('latency' / 'normal' / 'bulk' or the class int). Dups inherit the
    override through the comm-attr copy hook. Applies only while
    shaping (``btl_tcp_shape_enable``) is on; changing it with traffic
    in flight is the caller's ordering hazard."""
    comm.Set_attr(comm_keyval(), resolve(cls))
    _clear_cache()


def get_comm_class(comm) -> int:
    v = comm.Get_attr(comm_keyval())
    return NORMAL if v is None else int(v)


def _comm_class(cid: int) -> int:
    # bind the dict ONCE: a _clear_cache() rebind racing this lookup
    # must see our (possibly stale) insert land in the DISCARDED dict,
    # not the fresh one — re-reading the global at the store would let
    # a pre-invalidation class resurrect into the new cache (and stick
    # to a recycled cid)
    cache = _cls_cache
    cls = cache.get(cid)
    if cls is not None:
        return cls
    from ompi_tpu_torch.comm.communicator import lookup_comm

    comm = lookup_comm(cid & _CID_MASK)
    cls = NORMAL
    if comm is not None and _keyval is not None:
        v = comm.attributes.get(_keyval)
        if v is not None:
            cls = int(v)
    cache[cid] = cls
    return cls


def classify(tag: int, cid: int) -> int:
    """Class of one outbound message (called by the pml only when
    shaping is on): tag map for system planes AND explicitly-listed
    user tags (the recovery state-movement planes — respawn delivery
    4242, parity exchange 4243, reshard 4300 — ride user-plane tags on
    fresh/shrunk comms, so the map is the only boundary that can see
    them), comm override for everything else, NORMAL otherwise. The
    (cid, tag)->class mapping stays deterministic — tag-keyed entries
    apply on every comm — so the per-(peer, class) MATCH seq planes
    stay consistent. Bumps the stamped-by-class counters."""
    if tag <= _SYSTEM_TAG_BASE:
        cls = _tag_class(tag)
    else:
        # positive-tag map entries apply ONLY on the plane-free user
        # cid: derived planes carry internal tag sequences (the NBC
        # schedule allocator counts up from 0 per comm), so a
        # long-running comm's 4243rd nonblocking collective would
        # otherwise collide with the recovery entries and silently ride
        # BULK — the recovery planes themselves are plain comm.Send /
        # Recv traffic with no plane bits
        cls = _tag_map().get(tag) if (cid >> _PLANE_SHIFT) == 0 else None
        if cls is None:
            cls = _comm_class(cid)
    _ctr[NAMES[cls]] += 1
    return cls


def note_segments(n: int) -> None:
    """Charge ``n`` sub-frames produced by system-blob segmentation."""
    _ctr["seg_frames"] += n


def note_reassembled() -> None:
    """Count one segmented blob recombined at the receive side."""
    _ctr["reassembled"] += 1


def reset_for_testing() -> None:
    _invalidate_tag_map()
    _clear_cache()
    for k in _ctr:
        _ctr[k] = 0
