"""Flash attention forward on Hopper: the port of ompi_tpu/ops/flash_attention.py.

Contract (the JAX package's, forward only):

    flash_block(q, k, v, keep_full, keep_tri, sm_scale=None, layout="bthd")
        -> out in the input layout, float32 (normalized),
           lse [B, H, Tq] float32 with -1e30 on rows that see no key

- q/k/v may be float32 or bfloat16; they are rounded to bf16 before the
  matmuls and accumulation is f32. ``layout`` 'bthd' is [B, T, H, D],
  'bhtd' is [B, H, T, D] (the layout the model emits).
- ``keep_full``/``keep_tri`` select the ring block relation (full attend /
  causal triangle / neither); Python bools or 0-d tensors.
- A CUDA tensor goes to the hand-written kernel ``csrc/flash_fwd.cu``; a CPU
  tensor to ``flash_block_reference``, the same function in plain PyTorch.
  There is no other path: a CUDA call the kernel cannot take raises.
- Forward only. The backward kernels (the TPU's ``_dq_kernel`` and
  ``_dkv_kernel``) come with the training slice, so a CUDA tensor that
  requires grad is refused.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from ompi_tpu_torch.ops import _build

NEG_BIG = -1e30
BLOCK_Q = 64
BLOCK_K = 64

# Launches of the CUDA kernel; a run resets it and reads it to show that its
# path went through the kernel.
KERNEL_LAUNCHES = 0


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
    """Static gate for the Hopper kernel: 64-row Q and KV tiles must divide
    the shards and the head dim must fit the kernel (a multiple of the
    tensor cores' 16-deep bf16 step, at most 128). The kernel streams K/V
    tiles through shared memory, so no residency limit applies."""
    _, _, Tq, Tk, D = _dims(q_shape, k_shape, layout)
    return (D % 16 == 0 and 16 <= D <= 128 and Tq >= BLOCK_Q
            and Tk >= BLOCK_K and Tq % BLOCK_Q == 0 and Tk % BLOCK_K == 0)


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
    if _flag(keep_full):
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    elif _flag(keep_tri):
        rows = torch.arange(Tq, device=q.device)[:, None]
        keep = torch.arange(Tk, device=q.device)[None, :] <= rows
    else:
        keep = torch.zeros(Tq, Tk, dtype=torch.bool, device=q.device)
    s = torch.where(keep, s, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    o3 = torch.matmul(p.to(torch.bfloat16).float(), v3) / den.clamp_min(1e-30)
    lse = torch.where(den > 0, m + torch.log(den), NEG_BIG)[..., 0]
    return _from3(o3, B, H, layout), lse.reshape(B, H, Tq)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("flash_fwd").flash_fwd
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i32] * 9 + [ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, keep_full, keep_tri, sm_scale, layout):
    global KERNEL_LAUNCHES
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_block on CUDA is forward only; its backward kernels "
            "arrive with the training slice of the port")
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
        raise ValueError(f"the flash_fwd kernel does not take q{tuple(q.shape)}"
                         f" k{tuple(k.shape)} ({layout}); see flash_supported")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous in their layout "
                         "and 16-byte aligned")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D,
                       int(layout == "bthd"), int(q.dtype == torch.bfloat16),
                       int(_flag(keep_full)), int(_flag(keep_tri)),
                       float(sm_scale), stream)
    if rc:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES += 1
    return out, lse


def flash_block(q, k, v, keep_full, keep_tri, sm_scale=None,
                layout: str = "bthd"):
    """One Q-shard x KV-shard flash attention block pair (see the module
    docstring). Returns (out in the input layout, f32 normalized;
    lse [B, H, Tq] f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_block_reference(q, k, v, keep_full, keep_tri, sm_scale,
                                     layout)
    return _launch(q, k, v, keep_full, keep_tri, sm_scale, layout)
