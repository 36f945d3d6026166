"""coll/quant — the block-scaled quantized allreduce of mesh mode.

The port of ``ompi_tpu/coll/xla.py:692-800`` (``quant_allreduce_body``) and
``ompi_tpu/coll/quant.py:252-331`` (``QuantXlaColl``). There the body is
one traced XLA program: quantize each rank's per-destination chunks,
``all_to_all`` the int8/fp8 codes and f32 block scales, dequantize and
reduce, requantize the reduced chunk, ``all_gather`` it and dequantize.
Here it is tensor ops over the rank dim, the way ``coll/mesh.py`` maps the
XLA collectives:

- the ``all_to_all`` of the codes and scales is the transpose of the
  rows of ``[W (source), W (chunk), per]``;
- the ``all_gather`` gives every rank the same reduced chunks, so the
  dequantized result is computed once and stacked on every row.

Codes are computed in f32 and cast to int8 or float8_e4m3fn once (both
round half to even), and read back through f32. Non-finite blocks travel
as the codec's sentinels: the block's scale is +inf and the codes are
{+inf, -inf, nan} code points (fp8: +-448 and nan; int8: 127, -127,
-128), so +-inf and nan arrive in place.

Eligibility is checked on every call, on the terms of the JAX body
(``:776-779``): a world comm of at least two ranks, the SUM op, a floating
dtype (bf16 included) and a payload of at least ``min_bytes`` a rank.
Anything else takes the plain allreduce body, uncounted. The callable is cached under
``cache_key("allreduce", op, extra=("quant",))``, never under the plain
allreduce's key: ``MeshColl.reduce`` shares the plain one, so a shared key
would make the result depend on the order of the calls.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch import quant as _quant
from ompi_tpu_torch.coll import mesh as _mesh
from ompi_tpu_torch.coll.base import CollModule, coll_framework
from ompi_tpu_torch.coll.mesh import _check_device_op, _stack, cache_key
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.runtime import trace as _trace
from ompi_tpu_torch.quant import negotiate as _negotiate
from ompi_tpu_torch.quant.codec import chunk_layout

_INF = float("inf")
_NAN = float("nan")


def _eligible(comm, op: _op.Op, b: torch.Tensor, min_bytes: int) -> bool:
    return (comm.world_size >= 2 and comm.groups is None
            and op.kind == "sum"
            and b.is_floating_point()
            and b[0].numel() * b.element_size() >= min_bytes)


def quant_allreduce_body(comm, mode: str, block: int):
    """body(b) -> [W, ...]: the quantized SUM allreduce of the float
    buffer ``b`` (the caller checks eligibility, ``_eligible``)."""
    W = comm.world_size
    if mode == "fp8":
        qdtype, target, qmax = torch.float8_e4m3fn, 224.0, 448.0
    else:
        qdtype, target, qmax = torch.int8, 127.0, 127.0
    recip = float(np.float32(1.0 / target))

    def _quantize(blocks):  # [..., nb, block] f32 -> (codes, scales)
        amax = blocks.abs().amax(-1)
        finite = torch.isfinite(amax)
        # XLA folds the division by the constant into a product with its
        # f32 reciprocal; the same product keeps the scales bit-equal
        scale = torch.where(finite & (amax > 0), amax * recip, 1.0)
        t = blocks / scale[..., None]
        t = torch.where(torch.isfinite(t), t, 0.0)
        if mode == "fp8":
            q = t.to(qdtype).to(torch.float32)  # round half to even
            nan_code = _NAN
        else:
            q = torch.clamp(torch.round(t), -127.0, 127.0)
            nan_code = -128.0
        code = torch.where(
            blocks == _INF, qmax,
            torch.where(blocks == -_INF, -qmax,
                        torch.where(torch.isnan(blocks), nan_code, 0.0)))
        q = torch.where(finite[..., None], q, code)
        return q.to(qdtype), torch.where(finite, scale, _INF)

    def _dequantize(q, scale):
        fin = torch.isfinite(scale)
        qf = q.to(torch.float32)
        v = qf * torch.where(fin, scale, 1.0)[..., None]
        if mode == "fp8":
            sent = torch.where(
                qf >= 448.0, _INF,
                torch.where(qf <= -448.0, -_INF,
                            torch.where(torch.isnan(qf), _NAN, 0.0)))
        else:
            sent = torch.where(
                qf == 127.0, _INF,
                torch.where(qf == -127.0, -_INF,
                            torch.where(qf == -128.0, _NAN, 0.0)))
        return torch.where(fin[..., None], v, sent)

    def body(b):
        flat = b.reshape(W, -1)
        n = flat.shape[1]
        per, padded = chunk_layout(n, W, block)
        nb = per // block
        f = flat.new_zeros((W, padded), dtype=torch.float32)
        f[:, :n] = flat
        q, s = _quantize(f.view(W, W, nb, block))
        # all_to_all: rank j receives chunk j of every source
        red = _dequantize(q.transpose(0, 1), s.transpose(0, 1)).sum(1)
        # requantize the reduced chunks; all_gather them and dequantize
        qr, sr = _quantize(red)
        out = _dequantize(qr.view(W * nb, block), sr.view(-1))
        out = out.view(-1)[:n].view(b.shape[1:]).to(b.dtype)
        return _stack(out, W)

    return body


class QuantMeshColl(CollModule):
    """The quantized allreduce of a quant-selected ``MeshComm``; the comm's
    other verbs stay with ``coll/mesh.py``."""

    def __init__(self, plain: _mesh.MeshColl):
        self._plain = plain

    @staticmethod
    def allreduce_key(op: _op.Op):
        return cache_key("allreduce", op, extra=("quant",))

    def allreduce(self, comm, x, op: _op.Op = _op.SUM):
        st = comm._quant_state

        def build():
            plain = self._plain._allreduce_body(comm, op)
            body = quant_allreduce_body(comm, st.mode, st.block)
            codec = st.codec
            W = comm.world_size

            def fn(b):
                _check_device_op(op, b)
                if not _eligible(comm, op, b, st.min_bytes):
                    return plain(b)
                # whole-mesh accounting: each of W ranks sends W - 1 chunks
                # twice (reduce-scatter, allgather); the raw baseline
                # counts unpadded chunks
                n, item = b[0].numel(), b.element_size()
                per, _ = chunk_layout(n, W, codec.block)
                _quant.note_coll("allreduce",
                                 2 * W * (W - 1) * (-(-n // W)) * item,
                                 2 * W * (W - 1) * codec.wire_nbytes(per))
                if _trace.enabled():
                    # reference: coll/quant.py:108-109
                    with _trace.span("coll.quant.allreduce", cat="coll",
                                     comm=comm.name):
                        return body(b)
                return body(b)

            return fn

        return self._plain._dispatch(comm, self.allreduce_key(op), build, x)


module = QuantMeshColl(_mesh.module)


class QuantCollComponent(Component):
    """The mesh branch of ``ompi_tpu/coll/quant.py:342-361``: the quantized
    allreduce where the comm's verdict is active. Priority 110, above
    ``mesh`` (100), so it owns the allreduce slot there and ``mesh``'s
    allreduce is its fallback. The verdict is kept on every ``MeshComm``
    it is asked about (``comm._quant_state``)."""

    NAME = "quant"
    PRIORITY = 110

    def query(self, comm=None, **ctx):
        from ompi_tpu_torch.parallel.mesh import MeshComm

        if not isinstance(comm, MeshComm):
            return None
        comm._quant_state = st = _negotiate.for_mesh_comm(comm)
        return module if st.active else None


coll_framework.register(QuantCollComponent())
