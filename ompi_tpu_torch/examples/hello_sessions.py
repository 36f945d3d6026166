"""MPI-4 Sessions (reference: examples/hello_sessions_c.c): bring the
runtime up through a session — no MPI_Init — and build a communicator
from the WORLD process set.

Run:  python -m ompi_tpu_torch.tools.mpirun -np 4 ompi_tpu_torch/examples/hello_sessions.py
"""

import sys

import numpy as np

from ompi_tpu_torch.runtime.session import Session


def main() -> int:
    session = Session.Init()
    group = session.Group_from_pset("mpi://WORLD")
    comm = session.Comm_create_from_group(group, tag="hello")
    rank, size = comm.Get_rank(), comm.Get_size()
    if rank == 0:
        for i in range(session.Get_num_psets()):
            name = session.Get_nth_pset(i)
            info = session.Get_pset_info(name)
            print(f"pset {i}: {name} (size {info.Get('size')})",
                  flush=True)
    total = np.zeros(1, np.int64)
    comm.Allreduce(np.array([rank + 1], np.int64), total)
    print(f"Hello from rank {rank} of {size} via sessions "
          f"(allreduce check: {int(total[0])})", flush=True)
    comm.Free()
    session.Finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
