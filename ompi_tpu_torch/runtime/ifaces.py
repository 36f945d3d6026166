"""if/reachable — local interface inventory + peer reachability weights.

The port of ``ompi_tpu/runtime/ifaces.py``, whole.

Reference: opal/mca/if (interface discovery) and opal/mca/reachable
(reachable_weighted: score every (local interface, peer address) pair
so each connection uses the best source — same subnet beats same
address family beats loopback-only). The btl/tcp component consults
``pick_source`` when dialing a peer on a multi-homed host; the modex
card publishes the best-scored local address instead of a blind
hostname lookup.

Pure stdlib: interface addresses/netmasks come from SIOCGIFADDR /
SIOCGIFNETMASK ioctls over the names socket.if_nameindex() reports
(the opal/mca/if/posix_ipv4 approach).
"""

from __future__ import annotations

import socket
import struct
from typing import List, NamedTuple, Optional

_SIOCGIFADDR = 0x8915
_SIOCGIFNETMASK = 0x891B
_SIOCGIFFLAGS = 0x8913
_IFF_UP = 0x1
_IFF_LOOPBACK = 0x8


class Iface(NamedTuple):
    name: str
    addr: str
    netmask: str
    up: bool
    loopback: bool


def _ioctl_addr(sock, code: int, name: str) -> Optional[str]:
    import fcntl

    try:
        packed = struct.pack("256s", name.encode()[:15])
        out = fcntl.ioctl(sock.fileno(), code, packed)
        return socket.inet_ntoa(out[20:24])
    except OSError:
        return None


def _ioctl_flags(sock, name: str) -> int:
    import fcntl

    try:
        packed = struct.pack("256s", name.encode()[:15])
        out = fcntl.ioctl(sock.fileno(), _SIOCGIFFLAGS, packed)
        return struct.unpack_from("H", out, 16)[0]
    except OSError:
        return 0


def list_interfaces() -> List[Iface]:
    """IPv4 interfaces with address/netmask/flags (opal_if analog)."""
    out: List[Iface] = []
    try:
        names = [n for _, n in socket.if_nameindex()]
    except OSError:
        return out
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for name in names:
            addr = _ioctl_addr(s, _SIOCGIFADDR, name)
            if addr is None:
                continue
            mask = _ioctl_addr(s, _SIOCGIFNETMASK, name) or "255.255.255.255"
            flags = _ioctl_flags(s, name)
            out.append(Iface(name, addr, mask, bool(flags & _IFF_UP),
                             bool(flags & _IFF_LOOPBACK)))
    return out


def _ip(v: str) -> int:
    return struct.unpack("!I", socket.inet_aton(v))[0]


def weight(iface: Iface, peer_addr: str) -> int:
    """reachable_weighted scoring: higher is better.

    same subnet (400) > routable non-loopback (300) > loopback to a
    loopback peer (200) > mismatched loopback (0); a downed interface
    never wins."""
    if not iface.up:
        return -1
    try:
        p = _ip(peer_addr)
    except OSError:
        return 0
    a, m = _ip(iface.addr), _ip(iface.netmask)
    peer_loop = (p >> 24) == 127
    if iface.loopback:
        return 200 if peer_loop else 0
    if peer_loop:
        return 0
    if (a & m) == (p & m):
        return 400
    return 300


def pick_source(peer_addr: str) -> Optional[str]:
    """Local source address for dialing ``peer_addr``, or None to let
    the kernel route. Pins ONLY on a confident match — same subnet, or
    loopback-to-loopback: for an off-subnet peer every routable
    interface ties and an arbitrary pin (e.g. a container bridge) can
    blackhole the SYN where the kernel's route would work."""
    best = None
    best_w = 0
    for iface in list_interfaces():
        w = weight(iface, peer_addr)
        if w > best_w:
            best, best_w = iface.addr, w
    return best if best_w in (400, 200) else None


# interface-name prefixes that are almost never the fabric NIC
# (container bridges, virt taps, VPN tunnels) — deprioritized when no
# default route disambiguates (reference: btl_tcp_if_exclude defaults)
_VIRTUAL_PREFIXES = ("docker", "virbr", "veth", "br-", "tun", "tap",
                    "vnet", "wg")


def best_local_addr() -> Optional[str]:
    """The address to publish in the modex card.

    Primary signal: the source address the kernel's default route would
    use (a connected UDP socket sends no packets — this is a pure route
    lookup). Fallback when there is no default route: the first up
    non-loopback interface whose name doesn't look like a container
    bridge/VPN (if_nameindex order is NOT priority order — a dev box
    often enumerates docker0 before the fabric NIC)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("203.0.113.1", 9))  # TEST-NET-3: never sent to
            addr = s.getsockname()[0]
        if not addr.startswith("127."):
            return addr
    except OSError:
        pass
    ifaces = [i for i in list_interfaces() if i.up]
    physical = [i for i in ifaces if not i.loopback
                and not i.name.startswith(_VIRTUAL_PREFIXES)]
    virtual = [i for i in ifaces if not i.loopback
               and i.name.startswith(_VIRTUAL_PREFIXES)]
    for pool in (physical, virtual, ifaces):
        if pool:
            return pool[0].addr
    return None
