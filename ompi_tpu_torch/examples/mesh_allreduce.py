"""Mesh mode on torch: MPI ranks are the rows of one tensor on one device,
and collectives are tensor ops over the rank dim.

    python -m ompi_tpu_torch.examples.mesh_allreduce [--device cpu] [--quant]

The counterpart of the repo's ``examples/mesh_allreduce.py``: the same
lines in the same order, over ``mesh_world(8)`` on the card (or on the CPU
with ``--device cpu``). ``--quant`` builds the world with the block-scaled
quantized allreduce (``quant_enable``, ``quant_min_bytes`` 1024)
and prints its error against the codec's closed-form bound.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ompi_tpu_torch import quant  # noqa: F401 registers the quant_* vars
from ompi_tpu_torch.core import op as mpi_op
from ompi_tpu_torch.mca.var import get_var, set_var
from ompi_tpu_torch.parallel.mesh import mesh_world
from ompi_tpu_torch.quant.codec import make_codec
from ompi_tpu_torch.tools.bench import device_name

W = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--quant", action="store_true",
                    help="use the block-scaled int8 quantized allreduce")
    opts = ap.parse_args(argv)

    # a comm reads the quant settings when it is built
    saved = get_var("quant", "enable"), get_var("quant", "min_bytes")
    if opts.quant:
        set_var("quant", "enable", True)
        set_var("quant", "min_bytes", 1024)  # demo arrays are small
    try:
        world = mesh_world(W, opts.device)
    finally:
        if opts.quant:
            set_var("quant", "enable", saved[0])
            set_var("quant", "min_bytes", saved[1])
    print(f"mesh world over {W} rank(s) on one device: {world.device} "
          f"({device_name(world.device)})", flush=True)

    # every rank (a row) contributes its index
    x = world.shard(np.stack(
        [np.full(4, float(r), np.float32) for r in range(W)]))
    total = world.allreduce(x)
    print(f"allreduce(sum of 0..{W - 1}): {float(total[0][0]):.0f}",
          flush=True)

    if opts.quant:
        # big enough to clear min_bytes: the quantized schedule engages and
        # the result must respect the closed-form bound of the codec the
        # comm was built with
        mode, bits, block = (get_var("quant", k)
                             for k in ("mode", "bits", "block"))
        rng = np.random.RandomState(0)
        xs = (rng.randn(W, 1024) * 5).astype(np.float32)
        got = world.allreduce(world.shard(xs))[0].cpu().numpy()
        exact = xs.astype(np.float64).sum(axis=0)
        codec = make_codec(mode, bits, block)
        err = np.abs(got.astype(np.float64) - exact)
        bnd = codec.error_bound(xs)
        # per-element err/bound: the max error against another element's
        # bound would misreport a healthy run as a violation
        worst = float(np.max(err / np.maximum(bnd, 1e-300)))
        prov = world.coll.providers.get("allreduce")
        note = "" if prov == "quant" else \
            " [quant path NOT engaged — exact allreduce ran]"
        print(f"quantized allreduce ({mode}/{bits}b/blk{block}): "
              f"provider={prov}{note} "
              f"max_err={float(err.max()):.4f}, err/bound "
              f"{worst:.3f} (< 1 == closed-form bound holds), "
              f"wire ratio {codec.ratio(1024):.2f}x", flush=True)

    # sub-communicators are partitions of the rank dim: split even/odd
    sub = world.Split([r % 2 for r in range(W)])
    print(f"even-ranks sum: {float(sub.allreduce(x)[0][0]):.0f}", flush=True)

    # nonblocking + persistent variants
    req = world.iallreduce(x, mpi_op.MAX)
    req.Wait()
    print(f"iallreduce max: {float(req.result[0][0]):.0f}", flush=True)
    preq = world.allreduce_init(x)
    preq.Start()
    preq.Wait()
    print(f"persistent allreduce: {float(preq.result[0][0]):.0f}",
          flush=True)

    # ring shift: row r + 1 takes row r
    shifted = world.shift(x, steps=1)
    print(f"ring shift: row 0 now holds rank "
          f"{float(shifted[0][0]):.0f}'s data", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
