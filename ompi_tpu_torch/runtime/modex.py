"""PMIx-lite modex: out-of-band key/value exchange + fences.

The port of ``ompi_tpu/runtime/modex.py``, whole; its wire format is
the reference's, so a client of either package talks to a server of
the other.

Reference: the PMIx layer (opal/mca/pmix, OPAL_MODEX_SEND/RECV macros
pmix-internal.h:266,577; PMIx_Fence_nb at ompi/runtime/ompi_mpi_init.c:489).
The reference treats the PMIx server (inside prted) as external
infrastructure; our launcher hosts the equivalent: a tiny TCP KV server
speaking JSON lines. Ranks publish "business cards" (transport endpoints),
fence, then read peers' cards to wire endpoints.

Protocol (one JSON object per line, one TCP connection per rank):
  {"op": "put",   "rank": r, "key": k, "val": v}   -> {"ok": true}
  {"op": "get",   "rank": r, "key": k}             -> {"val": v} | {"missing": true}
  {"op": "fence", "rank": r, "job": j}             -> {"ok": true}  (blocks
       the reply until all ranks of job j have entered the fence)
  {"op": "spawn", "nprocs": k}                     -> {"job": j, "base": b}
       (dynamic processes: allocates a new job of k universe ranks
       starting at b — reference: PMIx_Spawn inside MPI_Comm_spawn,
       dpm.c; ranks are "universe ranks" so one flat namespace covers
       every job's keys and transport endpoints)
  {"op": "abort", "rank": r, "msg": m}             -> {"ok": true}  (flags
       job abort; subsequent fences fail fast — reference: PMIx_Abort)
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ompi_tpu_torch.utils.output import get_logger


class ModexServer:
    """Runs inside the launcher (reference analog: prted's PMIx server)."""

    def __init__(self, size: int, host: str = "127.0.0.1",
                 advertise: Optional[str] = None):
        # `advertise` overrides the address ranks are told to dial —
        # needed when binding 0.0.0.0 for off-host ranks (reference: the
        # PMIx server URI prted publishes is a routable address)
        self.size = size
        self.advertise = advertise
        self.kv: Dict[Tuple[int, str], Any] = {}
        self.kv_cond = threading.Condition()
        # per-job fence domains; job 0 is the initial world
        self.jobs: Dict[int, Dict[str, int]] = {
            0: {"size": size, "gen": 0, "count": 0}
        }
        self.next_job = 1
        self.next_base = size
        self.fence_cond = threading.Condition()
        self.aborted: Optional[str] = None
        self.log = get_logger("runtime.modex")
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, 0))
        self.sock.listen(size + 8)
        self.host, self.port = self.sock.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="modex-server")
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.advertise or self.host}:{self.port}"

    def _accept_loop(self) -> None:
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        f = conn.makefile("rwb")
        try:
            for line in f:
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    break
                resp = self._handle(msg)
                f.write(json.dumps(resp).encode() + b"\n")
                f.flush()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        op = msg.get("op")
        if op == "put":
            with self.kv_cond:
                self.kv[(int(msg["rank"]), msg["key"])] = msg["val"]
                self.kv_cond.notify_all()
            return {"ok": True}
        if op == "get":
            with self.kv_cond:
                key = (int(msg["rank"]), msg["key"])
                if key in self.kv:
                    return {"val": self.kv[key]}
            return {"missing": True}
        if op == "fence":
            jid = int(msg.get("job", 0))
            with self.fence_cond:
                job = self.jobs.get(jid)
                if job is None:
                    return {"error": f"unknown job {jid}"}
                gen = job["gen"]
                job["count"] += 1
                if job["count"] >= job["size"]:
                    job["count"] = 0
                    job["gen"] += 1
                    self.fence_cond.notify_all()
                else:
                    while (job["gen"] == gen
                           and self.aborted is None
                           and not self._stop.is_set()):
                        self.fence_cond.wait(0.5)
            if self.aborted is not None:
                return {"error": f"job aborted: {self.aborted}"}
            return {"ok": True}
        if op == "spawn":
            k = int(msg["nprocs"])
            if k <= 0:
                return {"error": f"bad nprocs {k}"}
            with self.fence_cond:
                jid = self.next_job
                self.next_job += 1
                base = self.next_base
                self.next_base += k
                self.jobs[jid] = {"size": k, "gen": 0, "count": 0}
            return {"job": jid, "base": base}
        if op == "abort":
            self.aborted = str(msg.get("msg", "unknown"))
            with self.fence_cond:
                self.fence_cond.notify_all()
            return {"ok": True}
        return {"error": f"bad op {op!r}"}

    def close(self) -> None:
        self._stop.set()
        with self.fence_cond:
            self.fence_cond.notify_all()
        try:
            self.sock.close()
        except OSError:
            pass


class ModexClient:
    """Per-rank connection (reference analog: PMIx_Init's server link)."""

    def __init__(self, address: str, rank: int, size: int,
                 timeout: float = 60.0, job: int = 0):
        host, port = address.rsplit(":", 1)
        self.rank = rank  # universe rank
        self.size = size
        self.job = job
        self.timeout = timeout
        self._lock = threading.Lock()
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.sock = socket.create_connection((host, int(port)),
                                                     timeout=timeout)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self.f = self.sock.makefile("rwb")

    def _rpc(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self.f.write(json.dumps(msg).encode() + b"\n")
            self.f.flush()
            line = self.f.readline()
        if not line:
            raise RuntimeError("modex server closed connection")
        resp = json.loads(line)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp

    def put(self, key: str, val: Any, rank: Optional[int] = None) -> None:
        """Publish under this rank, or an explicit one (the reserved
        name-service channel uses rank -1)."""
        self._rpc({"op": "put",
                   "rank": self.rank if rank is None else rank,
                   "key": key, "val": val})

    def get(self, rank: int, key: str, timeout: float = 30.0) -> Any:
        deadline = time.monotonic() + timeout
        while True:
            resp = self._rpc({"op": "get", "rank": rank, "key": key})
            if "val" in resp:
                return resp["val"]
            if time.monotonic() > deadline:
                raise TimeoutError(f"modex key ({rank}, {key}) never appeared")
            time.sleep(0.01)

    def fence(self) -> None:
        """Block until every rank of MY JOB fences (reference:
        PMIx_Fence over the job's nspace)."""
        self._rpc({"op": "fence", "rank": self.rank, "job": self.job})

    def spawn(self, nprocs: int) -> Tuple[int, int]:
        """Allocate a new job of `nprocs` universe ranks; returns
        (job id, universe base rank) — reference: PMIx_Spawn."""
        resp = self._rpc({"op": "spawn", "nprocs": nprocs})
        return int(resp["job"]), int(resp["base"])

    def abort(self, msg: str) -> None:
        try:
            self._rpc({"op": "abort", "rank": self.rank, "msg": msg})
        except Exception:
            pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
