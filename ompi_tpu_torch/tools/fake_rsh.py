"""fake_rsh — in-tree remote-execution shim for the launch-agent path.

The port of ``ompi_tpu/tools/fake_rsh.py``, whole (``plm.agent_argv``
resolves the ``fake`` agent to it).

Reference analog: prte's plm tests stub the ssh agent the same way (the
agent contract is just argv = [agent..., host, command]). This shim obeys
that contract but runs the command on the local box with a SCRUBBED
environment — every OMPI_TPU_*/PYTHONPATH/JAX_* variable inherited from
the launcher is dropped, so the command line must carry the entire launch
contract exactly as it would have to over real ssh. CI on a single box
therefore proves the remote marshalling path end to end.

Usage (what mpirun execs): python -m ompi_tpu_torch.tools.fake_rsh HOST COMMAND
"""

from __future__ import annotations

import os
import sys

from ompi_tpu_torch.runtime.plm import _FORWARD_ENV


def main(argv=None) -> "int":
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("usage: fake_rsh HOST COMMAND", file=sys.stderr)
        return 2
    _host, command = argv[0], argv[1]
    # scrub exactly the complement of what plm.remote_command marshals,
    # so a marshalling regression can't be masked by inherited state
    env = {k: v for k, v in os.environ.items()
           if not (k.startswith("OMPI_TPU_") or k.startswith("JAX_")
                   or k in _FORWARD_ENV)}
    # exec, not fork: the job-teardown SIGTERM mpirun sends must land on
    # the rank itself (our command string exec-chains sh -> env ->
    # python), not die with a wrapper while the rank runs on orphaned
    os.execve("/bin/sh", ["/bin/sh", "-c", command], env)


if __name__ == "__main__":
    sys.exit(main())
