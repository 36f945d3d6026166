"""coll/persist: the settings and counters of the mesh-mode persistent
collectives (``X_init`` then ``Start``).

The port of the two variables of ``ompi_tpu/coll/persist.py:97-127`` that
mesh mode reads (it reads no ``coll_persist_chunk_bytes``), and of the
replay counters with their pvars (``:130-141``). The process-mode persist
machinery (frozen round schedules, pools) is not ported: mesh mode does
not use it.
"""

from ompi_tpu_torch.mca.var import register_pvar, register_var

_enable_var = register_var(
    "coll_persist", "enable", 1,
    help="1 = X_init freezes the verb's resolved callable into the "
         "request, so Start skips the coll-table and cache lookups. "
         "0 = every Start calls the verb (the same result, the A/B "
         "baseline).", level=6)
_donate_var = register_var(
    "coll_persist", "donate", 0,
    help="Mesh mode: 1 = a Start with a fresh operand of the output's "
         "shape and dtype writes the result into that operand's storage "
         "(the operand is CONSUMED). The init-time operand is never "
         "donated.", level=7)

plans = 0         # callables frozen into requests
starts = 0        # persistent Starts issued (frozen or not)
replay_us = 0.0   # host microseconds spent in those Starts

register_pvar("persist", "plans", lambda: plans,
              help="Persistent plans compiled (mesh callable freezes)")
register_pvar("persist", "starts", lambda: starts,
              help="Persistent Start activations issued (frozen replay "
                   "AND coll_persist_enable=0 re-issue — the A/B "
                   "denominator)")
register_pvar("persist", "replay_us", lambda: replay_us,
              help="Accumulated Start-call latency in microseconds; "
                   "divide by persist_starts deltas per mode for the A/B")
