"""The yardstick: the card's peaks, and the operations and bytes of the
model's work, computed from shapes alone.

- Model FLOPs count the products a step needs, with causal attention over
  its visible pairs, T*(T+1)/2 a sequence and head, and nothing recomputed:
  a forward is 2*N_matmul a token plus 4*d_model a visible pair and layer,
  a training step three times that. N_matmul is the blocks' matrices and
  the tied embedding (read once as the logits' product); the position
  table is a gather and the gains are elementwise, so neither counts.
- A product's least time is the larger of its operations over the bf16
  peak and its bytes over the memory peak: bf16 operands read once, the
  f32 result written once (the port's products all write f32).
- The flash kernels' least times are ``chip_smoke.py``'s ``flash_bound_ms``
  and ``flash_bwd_bounds_ms`` as of this benchmark, frozen here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.lib.weights import Dims

# published dense peaks, by torch.cuda.get_device_name (NVIDIA's data sheet)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes": 3.35e12},
}

# flops of each flash kernel a visible (q, k) pair and head dim
FLASH_FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}


def peak(device_name: str) -> Optional[dict]:
    return PEAKS.get(device_name)


def pairs(T: int) -> int:
    """Visible (q, k) pairs of one causal sequence and head."""
    return T * (T + 1) // 2


def n_matmul(d: Dims) -> int:
    block = 4 * d.d_model * d.d_model + 2 * d.d_model * d.d_ff
    return d.n_layers * block + d.vocab * d.d_model


def forward_flops(d: Dims, batch: int, T: int) -> float:
    """A forward of ``batch`` prompts of length T, logits at every
    position."""
    return batch * (2.0 * n_matmul(d) * T
                    + 4.0 * d.n_layers * d.d_model * pairs(T))


def train_flops(d: Dims, batch: int, T: int) -> float:
    """A training step: forward, and a backward of twice its products."""
    return 3.0 * forward_flops(d, batch, T)


def _bound_s(flops: float, nbytes: float, pk: dict) -> float:
    return max(flops / pk["bf16_flops"], nbytes / pk["bytes"])


def _gemm_s(M: int, K: int, N: int, pk: dict) -> float:
    return _bound_s(2.0 * M * K * N, 2.0 * (M * K + K * N) + 4.0 * M * N, pk)


def forward_products(d: Dims, M: int) -> List[Tuple[int, int, int]]:
    """(M, K, N) of every product of a forward over M tokens: q, k, v, the
    output projection, the two MLP products a layer, then the logits."""
    D, F = d.d_model, d.d_ff
    layer = [(M, D, D)] * 4 + [(M, D, F), (M, F, D)]
    return layer * d.n_layers + [(M, D, d.vocab)]


def gemm_bound_s(d: Dims, M: int, train: bool, pk: dict) -> float:
    """Least time of the products of a forward (and, with ``train``, of
    each product's two backward products, dX and dW) over M tokens."""
    total = 0.0
    for m, k, n in forward_products(d, M):
        total += _gemm_s(m, k, n, pk)
        if train:
            total += _gemm_s(m, n, k, pk) + _gemm_s(k, m, n, pk)
    return total


def flash_flops(name: str, B: int, H: int, T: int, D: int) -> float:
    return FLASH_FLOPS_PER_PAIR[name] * D * B * H * pairs(T)


def flash_fwd_bound_s(B: int, H: int, T: int, D: int, in_bytes: int,
                      pk: dict) -> float:
    """q/k/v read once, f32 out and lse written once."""
    nbytes = 3 * B * H * T * D * in_bytes + B * H * T * (D + 1) * 4
    return _bound_s(flash_flops("flash_fwd", B, H, T, D), nbytes, pk)


def flash_bwd_bounds_s(B: int, H: int, T: int, D: int, in_bytes: int,
                       pk: dict) -> Tuple[float, float]:
    """flash_dq's and flash_dkv's: q, k, v and dO (bf16) read once, lse and
    delta read once, the f32 gradients written once."""
    reads = B * H * T * (3 * D * in_bytes + 2 * D + 2 * 4)
    grad = B * H * T * D * 4
    return (_bound_s(flash_flops("flash_dq", B, H, T, D), reads + grad, pk),
            _bound_s(flash_flops("flash_dkv", B, H, T, D),
                     reads + 2 * grad, pk))


def flash_bound_s(d: Dims, batch: int, T: int, train: bool,
                  pk: dict) -> float:
    """Least time of every flash launch of one call: a forward launch a
    layer, and with ``train`` one dq and one dkv launch a layer; q, k and v
    arrive in bf16."""
    args = (batch, d.n_heads, T, d.head_dim, 2, pk)
    one = flash_fwd_bound_s(*args)
    if train:
        one += sum(flash_bwd_bounds_s(*args))
    return d.n_layers * one
