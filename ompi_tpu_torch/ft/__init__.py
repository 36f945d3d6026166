"""ULFM-style fault tolerance (reference: ompi/communicator/ft and
ompi/mpiext/ftmpi): the port of ``ompi_tpu/ft``. The heartbeat failure
detector lives in ``ft.detector``, revocation in ``ft.revoke`` and the
deterministic fault injection of the chaos harness in ``ft.inject``;
shrink, agreement, diskless checkpoints and recovery come with process
mode."""
