"""coll/persist — the settings and counters of the mesh-mode persistent
collectives (``X_init`` then ``Start``).

The port of the two settings of ``ompi_tpu/coll/persist.py:97-127`` that
mesh mode reads, and of its replay counters. The JAX package registers the
settings as MCA variables (``coll_persist_enable``, ``coll_persist_donate``)
and the counters as MPI_T pvars; the port has no variable system yet, so
they are module attributes, read at ``X_init`` and bumped at ``Start``. The
process-mode persist machinery (frozen round schedules, pools) is not
ported: mesh mode does not use it.
"""

# 1 = X_init freezes the verb's resolved callable into the request, so
# Start skips the coll-table and cache lookups; 0 = every Start calls the
# verb (the same result, the A/B baseline)
enable = 1
# 1 = a Start with a fresh operand of the output's shape and dtype writes
# the result into that operand's storage (the operand is consumed); the
# init-time operand is never donated
donate = 0

plans = 0         # callables frozen into requests
starts = 0        # persistent Starts issued (frozen or not)
replay_us = 0.0   # host microseconds spent in those Starts
