"""PLM — process lifecycle management: hostfile parsing + remote spawn.

The port of ``ompi_tpu/runtime/plm.py``, whole.

Reference: PRRTE's plm framework behind mpirun (ompi/tools/mpirun/main.c:32
hands off to prterun; prte's plm/ssh launches one prted per node which
then forks the ranks). Redesign for a launcher-hosted runtime: no daemon
tree — the launcher itself places ranks onto hosts and spawns each rank
directly through a pluggable *launch agent* (ssh by default, like
plm_ssh_agent). The remote side needs no resident runtime: the whole
launch contract (rank identity, modex address, MCA vars) is marshalled
into the remote command line, and the rank dials back to the launcher's
modex server over TCP.

Host specification matches the reference's hostfile shape
(docs: ompi/docs/running-apps/scheduling.rst):

    node1 slots=2        # 2 ranks
    node2                # 1 slot
    # comments + blank lines ignored

``--host a:2,b`` is the inline equivalent. Ranks fill hosts in slot
order; when np exceeds the total slot count the placement wraps
(oversubscription, the reference's --oversubscribe behavior).
"""

from __future__ import annotations

import os
import shlex
import socket
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from ompi_tpu_torch.utils.output import get_logger

log = get_logger("runtime.plm")

# env vars marshalled to remote ranks (everything else is host-local
# state that must not leak across machines); OMPI_TPU_* is matched as a
# prefix on top of these
_FORWARD_ENV = ("PYTHONPATH", "JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                "XLA_FLAGS", "TMPDIR")


class HostSpec(NamedTuple):
    name: str
    slots: int


def parse_hostfile(path: str) -> List[HostSpec]:
    """``node [slots=N]`` per line (reference hostfile format)."""
    out: List[HostSpec] = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            name, slots = parts[0], 1
            for tok in parts[1:]:
                k, _, v = tok.partition("=")
                if k in ("slots", "max_slots", "max-slots"):
                    try:
                        slots = max(1, int(v))
                    except ValueError:
                        raise ValueError(
                            f"{path}:{lineno}: bad slot count {tok!r}")
                else:
                    # a typo'd keyword must not silently become 1 slot
                    raise ValueError(
                        f"{path}:{lineno}: unrecognized token {tok!r} "
                        f"(expected slots=N)")
            out.append(HostSpec(name, slots))
    if not out:
        raise ValueError(f"hostfile {path} lists no hosts")
    return out


def parse_host_list(spec: str) -> List[HostSpec]:
    """``--host a:2,b`` inline form (reference: --host n1:2,n2)."""
    out: List[HostSpec] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, slots = item.partition(":")
        out.append(HostSpec(name, max(1, int(slots)) if slots else 1))
    if not out:
        raise ValueError(f"--host {spec!r} lists no hosts")
    return out


def assign_ranks(hosts: Sequence[HostSpec], np_: int) -> List[str]:
    """Host per rank: fill each host's slots in file order, wrapping when
    np exceeds total slots (oversubscription)."""
    order: List[str] = []
    for h in hosts:
        order.extend([h.name] * h.slots)
    if np_ > len(order):
        log.info("oversubscribing: %d ranks over %d slots", np_, len(order))
    return [order[i % len(order)] for i in range(np_)]


_LOCAL_NAMES = None


def is_local(host: str) -> bool:
    """Local ranks skip the launch agent (reference: prterun forks local
    ranks itself; only remote nodes get an ssh-launched prted)."""
    global _LOCAL_NAMES
    if _LOCAL_NAMES is None:
        names = {"localhost", "127.0.0.1", "::1"}
        try:
            hn = socket.gethostname()
            names.update({hn, hn.split(".", 1)[0]})
        except OSError:
            pass
        _LOCAL_NAMES = names
    return host in _LOCAL_NAMES


def agent_argv(agent: str) -> List[str]:
    """Resolve the launch-agent spec to argv. ``fake`` is the in-tree
    remote-exec shim: same argv contract as ssh (argv = agent + [host,
    command]) but executes on this box with a scrubbed environment, so CI
    without sshd still exercises the full remote marshalling path."""
    if agent == "fake":
        return [sys.executable, "-m", "ompi_tpu_torch.tools.fake_rsh"]
    return shlex.split(agent)


def _fwd_env(env: Dict[str, str]) -> List[Tuple[str, str]]:
    out = []
    for k, v in sorted(env.items()):
        if k.startswith("OMPI_TPU_") or k in _FORWARD_ENV:
            out.append((k, v))
    return out


def _rank_argv(program: str, args: Sequence[str]) -> List[str]:
    """Python scripts run under this interpreter; an EXECUTABLE program
    (e.g. a C binary built against the mpicc wrapper) execs directly —
    the embedded runtime reads the same OMPI_TPU_* launch contract.
    Anything else (extensionless python script, no exec bit) falls back
    to the interpreter. Bare names: exec resolves them via PATH, so a
    cwd-local executable must be qualified with ./ or it would miss."""
    import shutil

    if not program.endswith(".py"):
        if os.sep in program:
            if os.access(program, os.X_OK):
                return [program, *args]
        elif shutil.which(program):
            return [program, *args]
        elif os.access(program, os.X_OK):
            return [os.path.join(".", program), *args]
    return [sys.executable, program, *args]


def remote_command(env: Dict[str, str], program: str,
                   args: Sequence[str], cwd: str) -> str:
    """One shell line carrying the whole launch contract. Assumes the
    standard MPI homogeneity contract: same interpreter path and same
    filesystem layout on every node (reference docs make the same
    assumption for non-shared-FS launches)."""
    envs = " ".join(f"{k}={shlex.quote(v)}" for k, v in _fwd_env(env))
    argv = " ".join(shlex.quote(a) for a in _rank_argv(program, args))
    return f"cd {shlex.quote(cwd)} && exec env {envs} {argv}"


def spawn_rank(host: Optional[str], agent: str, env: Dict[str, str],
               program: str, args: Sequence[str],
               cwd: str) -> subprocess.Popen:
    """Spawn one rank: direct fork for local hosts, launch agent for
    remote ones. The agent sees argv [*agent, host, command]."""
    if host is None or is_local(host):
        env = dict(env)
        # only meaningful for direct children: a rank checks this pid
        # to detect a launcher that died before PR_SET_PDEATHSIG armed
        # (remote ranks live in another pid namespace — never set it)
        env["OMPI_TPU_LAUNCHER_PID"] = str(os.getpid())
        return subprocess.Popen(_rank_argv(program, args),
                                env=env, cwd=cwd)
    cmd = remote_command(env, program, args, cwd)
    return subprocess.Popen([*agent_argv(agent), host, cmd])
