"""Flash attention on Hopper: the port of ompi_tpu/ops/flash_attention.py.

Contract (the JAX package's):

    flash_block(q, k, v, keep_full, keep_tri, sm_scale=None, layout="bthd")
        -> out in the input layout, float32 (normalized),
           lse [B, H, Tq] float32 with -1e30 on rows that see no key

- q/k/v may be float32 or bfloat16; they are rounded to bf16 before the
  matmuls and accumulation is f32. ``layout`` 'bthd' is [B, T, H, D],
  'bhtd' is [B, H, T, D] (the layout the model emits).
- ``keep_full``/``keep_tri`` select the ring block relation (full attend /
  causal triangle / neither); Python bools or 0-d tensors.
- Differentiable in q, k and v through one ``torch.autograd.Function``
  (``_Flash``, the JAX ``custom_vjp``): it saves q, k, v, the output rounded
  to bf16 and lse, and its backward re-scores the tiles from them. The lse
  cotangent is honoured: it folds into ``delta = rowsum(dO * O) - g_lse``.
- A CUDA tensor goes to the hand-written kernels, ``csrc/flash_fwd.cu``
  forward and ``csrc/flash_bwd.cu`` (``flash_dq``, ``flash_dkv``) backward;
  a CPU tensor to their plain versions ``flash_block_reference`` and
  ``flash_block_bwd_reference``. There is no other path: a CUDA call the
  kernels cannot take raises, in the forward.
- The kernels load their tiles by TMA, which cannot convert types, so the
  wrappers round f32 q, k and v (and dO) to bf16 before the launch (round
  to nearest even, as the kernels' operands are rounded anyway: the values
  the products see are the same). ``flash_block_bwd`` checks and rounds
  its arguments once for both backward kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from ompi_tpu_torch.ops import _build

NEG_BIG = -1e30
SEQ_MULTIPLE = 64  # both sequence lengths must be multiples of it

# Launches of each CUDA kernel (flash_fwd, flash_dq, flash_dkv); a run
# resets them and reads them to show that its path went through the kernels.
KERNEL_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0


def _dims(q_shape, k_shape, layout: str) -> Tuple[int, int, int, int, int]:
    """(B, H, Tq, Tk, D) of a block pair in ``layout``."""
    if layout == "bhtd":
        B, H, Tq, D = q_shape
        return B, H, Tq, k_shape[2], D
    if layout == "bthd":
        B, Tq, H, D = q_shape
        return B, H, Tq, k_shape[1], D
    raise ValueError(f"unknown layout {layout!r}")


def flash_supported(q_shape, k_shape, layout: str = "bthd") -> bool:
    """Static gate for the Hopper kernels, forward and backward alike:
    SEQ_MULTIPLE must divide both shards and the head dim must fit the
    kernels (a multiple of the tensor cores' 16-deep bf16 step, at most
    128). The kernels stream their tiles through shared memory, so no
    residency limit applies."""
    _, _, Tq, Tk, D = _dims(q_shape, k_shape, layout)
    return (D % 16 == 0 and 16 <= D <= 128 and Tq >= SEQ_MULTIPLE
            and Tk >= SEQ_MULTIPLE and Tq % SEQ_MULTIPLE == 0
            and Tk % SEQ_MULTIPLE == 0)


def _flag(x) -> bool:
    return bool(x.item() if isinstance(x, torch.Tensor) else x)


def _to3(x: torch.Tensor, layout: str) -> torch.Tensor:
    """'bthd' [B,T,H,D] or 'bhtd' [B,H,T,D] -> [B*H, T, D]."""
    if layout == "bthd":
        x = x.transpose(1, 2)
    B, H, T, D = x.shape
    return x.reshape(B * H, T, D)


def _from3(x: torch.Tensor, B: int, H: int, layout: str) -> torch.Tensor:
    BH, T, D = x.shape
    x = x.reshape(B, H, T, D)
    return x.transpose(1, 2) if layout == "bthd" else x


def _keep(keep_full, keep_tri, Tq: int, Tk: int, device) -> torch.Tensor:
    """[Tq, Tk] mask of the (q, k) pairs the block relation keeps."""
    if _flag(keep_full):
        return torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    if _flag(keep_tri):
        rows = torch.arange(Tq, device=device)[:, None]
        return torch.arange(Tk, device=device)[None, :] <= rows
    return torch.zeros(Tq, Tk, dtype=torch.bool, device=device)


def flash_block_reference(q, k, v, keep_full, keep_tri, sm_scale=None,
                          layout: str = "bthd"):
    """The kernel's function in plain PyTorch: bf16-rounded matmul operands
    (P included, as the kernel rounds it before P.V), f32 accumulation and
    softmax, the same -1e30 sentinel and 1e-30 denominator floor. Dense
    rather than tiled; the kernel's tile skipping changes no value."""
    B, H, Tq, Tk, D = _dims(q.shape, k.shape, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bf = lambda x: _to3(x, layout).to(torch.bfloat16).float()
    q3, k3, v3 = bf(q), bf(k), bf(v)
    s = torch.matmul(q3, k3.transpose(1, 2)) * sm_scale
    keep = _keep(keep_full, keep_tri, Tq, Tk, q.device)
    s = torch.where(keep, s, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    o3 = torch.matmul(p.to(torch.bfloat16).float(), v3) / den.clamp_min(1e-30)
    lse = torch.where(den > 0, m + torch.log(den), NEG_BIG)[..., 0]
    return _from3(o3, B, H, layout), lse.reshape(B, H, Tq)


def flash_block_bwd_reference(q, k, v, dout, lse, delta, keep_full,
                              keep_tri, sm_scale=None, layout: str = "bthd"):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) in the
    input layout, f32. ``dout`` is the output cotangent (like q), ``lse``
    the forward's [B, H, Tq] and ``delta`` = rowsum(dO * O) - g_lse
    [B, H, Tq]. q, k, v and dO are rounded to bf16, as are P and dS before
    their products; sums are f32. Dense rather than tiled; pairs the block
    relation drops give exact zeros, as the kernels' loop bounds do."""
    B, H, Tq, Tk, D = _dims(q.shape, k.shape, layout)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bf = lambda x: _to3(x, layout).to(torch.bfloat16).float()
    q3, k3, v3, do3 = bf(q), bf(k), bf(v), bf(dout)
    keep = _keep(keep_full, keep_tri, Tq, Tk, q.device)
    s = torch.matmul(q3, k3.transpose(1, 2)) * sm_scale
    lse3 = lse.reshape(B * H, Tq, 1).float()
    p = torch.where(keep, torch.exp(s - lse3), 0.0)
    dp = torch.matmul(do3, v3.transpose(1, 2))
    ds = p * (dp - delta.reshape(B * H, Tq, 1).float())
    ds_b, p_b = ds.to(torch.bfloat16).float(), p.to(torch.bfloat16).float()
    dq = torch.matmul(ds_b, k3) * sm_scale
    dk = torch.matmul(ds_b.transpose(1, 2), q3) * sm_scale
    dv = torch.matmul(p_b.transpose(1, 2), do3)
    return tuple(_from3(x, B, H, layout) for x in (dq, dk, dv))


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# C entry point -> (library, argument types): tensor pointers, nine ints,
# sm_scale, the stream
_ENTRIES = {
    "flash_fwd": ("flash_fwd", [_PTR] * 5 + [_I32] * 9 + [ctypes.c_float,
                                                          _PTR]),
    "flash_dq": ("flash_bwd", [_PTR] * 7 + [_I32] * 9 + [ctypes.c_float,
                                                         _PTR]),
    "flash_dkv": ("flash_bwd", [_PTR] * 8 + [_I32] * 9 + [ctypes.c_float,
                                                          _PTR]),
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The typed C entry point ``name``, its library built first if
    needed."""
    lib, argtypes = _ENTRIES[name]
    fn = getattr(_build.load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, layout):
    """(B, H, Tq, Tk, D) of a block pair the kernels take; raises on any
    other."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == q.dtype and v.dtype == q.dtype):
        raise TypeError("q, k and v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, H, Tq, Tk, D = _dims(q.shape, k.shape, layout)
    kB, kH, _, _, kD = _dims(k.shape, k.shape, layout)
    if (kB, kH, kD) != (B, H, D):
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree "
                         f"in batch, heads or head dim ({layout})")
    if not flash_supported(q.shape, k.shape, layout):
        raise ValueError(f"the flash kernels do not take q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} ({layout}); see flash_supported")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous in their layout "
                         "and 16-byte aligned")
    return B, H, Tq, Tk, D


def _bf16(*xs):
    """``xs`` in bf16, contiguous and 16-byte aligned, as TMA reads them
    (a bf16 tensor that already is comes back as it is)."""
    out = []
    for x in xs:
        if not (x.dtype == torch.bfloat16 and x.is_contiguous()
                and x.data_ptr() % 16 == 0):
            x = x.to(torch.bfloat16).contiguous()
            x = x if x.data_ptr() % 16 == 0 else x.clone()
        out.append(x)
    return out


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q, k, v, keep_full, keep_tri, sm_scale, layout):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors: (out, lse). f32 q, k
    and v are rounded to bf16 first (the kernel reads bf16 by TMA)."""
    global KERNEL_LAUNCHES
    B, H, Tq, Tk, D = _check(q, k, v, layout)
    q, k, v = _bf16(q, k, v)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _entry("flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Tq, Tk, D, int(layout == "bthd"), 1,
            int(_flag(keep_full)), int(_flag(keep_tri)), float(sm_scale),
            _stream(q))
    _raise_on(rc, "flash_fwd")
    KERNEL_LAUNCHES += 1
    return out, lse


def _bwd_args(q, k, v, dout, lse, delta, layout):
    """Checked shapes, and the bf16 q, k, v and dO and the f32 lse and delta
    that the backward kernels read (TMA and 16-byte aligned rows)."""
    dims = _check(q, k, v, layout)
    B, H, Tq = dims[0], dims[1], dims[2]
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"dout{tuple(dout.shape)} must be like "
                         f"q{tuple(q.shape)}")
    if lse.shape != (B, H, Tq) or delta.shape != (B, H, Tq):
        raise ValueError(f"lse{tuple(lse.shape)} and delta"
                         f"{tuple(delta.shape)} must be {(B, H, Tq)}")
    # dO is rounded to bf16 here, as the TPU kernels round it on load
    lse, delta = (x.to(torch.float32).contiguous() for x in (lse, delta))
    lse, delta = (x if x.data_ptr() % 16 == 0 else x.clone()
                  for x in (lse, delta))
    return dims, (*_bf16(q, k, v, dout), lse, delta)


def _launch_dq(dims, ins, keep_full, keep_tri, sm_scale, layout):
    """``flash_dq`` on what ``_bwd_args`` prepared: dq like q, f32."""
    global DQ_LAUNCHES
    B, H, Tq, Tk, D = dims
    q = ins[0]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _entry("flash_dq")(
            *(x.data_ptr() for x in ins), dq.data_ptr(), B, H, Tq, Tk, D,
            int(layout == "bthd"), 1, int(_flag(keep_full)),
            int(_flag(keep_tri)), float(sm_scale), _stream(q))
    _raise_on(rc, "flash_dq")
    DQ_LAUNCHES += 1
    return dq


def _launch_dkv(dims, ins, keep_full, keep_tri, sm_scale, layout):
    """``flash_dkv`` on what ``_bwd_args`` prepared: (dk, dv) like k, f32."""
    global DKV_LAUNCHES
    B, H, Tq, Tk, D = dims
    q, k = ins[0], ins[1]
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    with torch.cuda.device(q.device):
        rc = _entry("flash_dkv")(
            *(x.data_ptr() for x in ins), dk.data_ptr(), dv.data_ptr(),
            B, H, Tq, Tk, D, int(layout == "bthd"), 1,
            int(_flag(keep_full)), int(_flag(keep_tri)), float(sm_scale),
            _stream(q))
    _raise_on(rc, "flash_dkv")
    DKV_LAUNCHES += 1
    return dk, dv


def flash_dq(q, k, v, dout, lse, delta, keep_full, keep_tri, sm_scale,
             layout):
    """Launch ``flash_dq`` of ``csrc/flash_bwd.cu`` on CUDA tensors: dq
    like q, f32."""
    return _launch_dq(*_bwd_args(q, k, v, dout, lse, delta, layout),
                      keep_full, keep_tri, sm_scale, layout)


def flash_dkv(q, k, v, dout, lse, delta, keep_full, keep_tri, sm_scale,
              layout):
    """Launch ``flash_dkv`` of ``csrc/flash_bwd.cu`` on CUDA tensors:
    (dk, dv) like k, f32."""
    return _launch_dkv(*_bwd_args(q, k, v, dout, lse, delta, layout),
                       keep_full, keep_tri, sm_scale, layout)


def flash_delta(o, dout, g_lse, layout: str = "bthd") -> torch.Tensor:
    """delta [B, H, Tq] of the backward: rowsum(dO * O) over the head dim,
    in f32, minus the lse cotangent. It folds both cotangent sources: the
    output's, and the lse's (a ring merge differentiates through
    exp(lse - lse_new), so g_lse is not 0 mid-ring)."""
    return (_to3(dout, layout).float() * _to3(o, layout).float()).sum(
        -1).reshape(g_lse.shape) - g_lse.float()


def flash_block_bwd(q, k, v, dout, lse, delta, keep_full, keep_tri,
                    sm_scale=None, layout: str = "bthd"):
    """(dq, dk, dv) of one block pair, f32 in the input layout: the two
    backward kernels on CUDA tensors, their plain version on CPU tensors
    (arguments as ``flash_block_bwd_reference``)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_block_bwd_reference(q, k, v, dout, lse, delta,
                                         keep_full, keep_tri, sm_scale,
                                         layout)
    args = _bwd_args(q, k, v, dout, lse, delta, layout)
    dq = _launch_dq(*args, keep_full, keep_tri, sm_scale, layout)
    dk, dv = _launch_dkv(*args, keep_full, keep_tri, sm_scale, layout)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The JAX ``_flash`` custom_vjp: forward kernel (or its plain version),
    residuals (q, k, v, out in bf16, lse), and a backward through the dq and
    dk/dv kernels (or their plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, keep_full, keep_tri, sm_scale, layout):
        if q.device.type == "cpu":
            out, lse = flash_block_reference(q, k, v, keep_full, keep_tri,
                                             sm_scale, layout)
        else:
            out, lse = flash_fwd(q, k, v, keep_full, keep_tri, sm_scale,
                                 layout)
        if any(ctx.needs_input_grad[:3]):
            # the saved output rides in bf16, as in the JAX package: delta
            # tolerates the rounding and the f32 buffer would otherwise
            # live across the whole backward
            ctx.save_for_backward(q, k, v, out.to(torch.bfloat16), lse)
            ctx.args = (keep_full, keep_tri, sm_scale, layout)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        # an output the caller did not use arrives as zeros (autograd
        # materializes it), so a missing g_lse counts as zeros
        q, k, v, o, lse = ctx.saved_tensors
        keep_full, keep_tri, sm_scale, layout = ctx.args
        delta = flash_delta(o, g_out, g_lse, layout)
        dq, dk, dv = flash_block_bwd(q, k, v, g_out, lse, delta, keep_full,
                                     keep_tri, sm_scale, layout)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_block(q, k, v, keep_full, keep_tri, sm_scale=None,
                layout: str = "bthd"):
    """One Q-shard x KV-shard flash attention block pair (see the module
    docstring). Returns (out in the input layout, f32 normalized;
    lse [B, H, Tq] f32); differentiable in q, k and v."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, _flag(keep_full), _flag(keep_tri),
                        float(sm_scale), layout)
