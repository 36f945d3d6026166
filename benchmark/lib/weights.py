"""Model sizes, weights and tokens of a cell, made from the seed.

Weights follow the port's layout and scales (``embed`` [V, D], ``pos``
[S, D], ``ln_f`` [D]; a block's ``ln1``/``ln2`` [D], ``qkv`` [D, H, 3*hd],
``wo`` [D, D], ``w1`` [D, F], ``w2`` [F, D]; normal / sqrt(fan_in), unit
gains). Each group (the embeddings, then each block) is drawn by one
``torch.randn`` on the device from a generator seeded by the run's seed and
the group's name, so the same seed gives the same weights, and any one group
can be drawn again alone: the reference and the check of a training step
redraw the starting weights group by group instead of holding a copy.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

BLOCK_KEYS = ("ln1", "qkv", "wo", "ln2", "w1", "w2")


@dataclasses.dataclass(frozen=True)
class Dims:
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    seq_len: int
    lr: float

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def dims_of(config: dict) -> Dims:
    """The sizes of a configuration file (its published keys)."""
    c = config["config"]
    return Dims(vocab=c["vocab_size"], d_model=c["hidden_size"],
                n_heads=c["num_attention_heads"],
                n_layers=c["num_hidden_layers"], d_ff=c["ffn_dim"],
                seq_len=c["max_position_embeddings"],
                lr=float(config["assumed"]["lr"]))


def seed_for(seed: int, tag: str) -> int:
    """A 63-bit generator seed for one purpose of one run."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_for(seed, tag))


def _drawn(seed: int, tag: str, shapes: List[Tuple[int, ...]],
           fan_ins: List[int], device) -> List[torch.Tensor]:
    """Tensors of ``shapes``, views of one normal draw, each scaled by
    1/sqrt(its fan-in)."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, tag, device),
                       device=device, dtype=torch.float32)
    out = []
    for part, shape, fan_in in zip(flat.split(sizes), shapes, fan_ins):
        out.append(part.view(shape).mul_(1.0 / math.sqrt(fan_in)))
    return out


def make_top(d: Dims, seed: int, device) -> Dict[str, torch.Tensor]:
    """``embed``, ``pos`` and ``ln_f``."""
    embed, pos = _drawn(seed, "weights.top",
                        [(d.vocab, d.d_model), (d.seq_len, d.d_model)],
                        [d.d_model, d.d_model], device)
    return {"embed": embed, "pos": pos,
            "ln_f": torch.ones(d.d_model, device=device)}


def make_block(d: Dims, seed: int, layer: int, device
               ) -> Dict[str, torch.Tensor]:
    """Block ``layer``'s weights."""
    D, F = d.d_model, d.d_ff
    qkv, wo, w1, w2 = _drawn(
        seed, f"weights.block{layer}",
        [(D, d.n_heads, 3 * d.head_dim), (D, D), (D, F), (F, D)],
        [D, D, D, F], device)
    return {"ln1": torch.ones(D, device=device), "qkv": qkv, "wo": wo,
            "ln2": torch.ones(D, device=device), "w1": w1, "w2": w2}


def make_params(d: Dims, seed: int, device) -> dict:
    """The whole tree in the port's layout."""
    params = make_top(d, seed, device)
    params["blocks"] = [make_block(d, seed, i, device)
                        for i in range(d.n_layers)]
    return params


def leaves(params: dict) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, in one fixed order."""
    out = [(k, params[k]) for k in ("embed", "pos", "ln_f")]
    for i, blk in enumerate(params["blocks"]):
        out += [(f"blocks.{i}.{k}", blk[k]) for k in BLOCK_KEYS]
    return out


def redrawn(d: Dims, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """The starting leaves again, in ``leaves`` order, one group at a
    time (at most one block is held)."""
    top = make_top(d, seed, device)
    for k in ("embed", "pos", "ln_f"):
        yield k, top[k]
    del top
    for i in range(d.n_layers):
        blk = make_block(d, seed, i, device)
        for k in BLOCK_KEYS:
            yield f"blocks.{i}.{k}", blk[k]


def change_norms(d: Dims, seed: int, params: dict) -> Dict[str, float]:
    """Each leaf's L2 norm of (now - start), the start drawn again."""
    now = dict(leaves(params))
    out = {}
    for name, start in redrawn(d, seed, now["embed"].device):
        out[name] = float(torch.linalg.vector_norm(
            now[name] - start, dtype=torch.float64))
    return out


def clone_tree(params: dict) -> dict:
    """A copy of the tree, on its device."""
    out = {k: params[k].clone() for k in ("embed", "pos", "ln_f")}
    out["blocks"] = [{k: blk[k].clone() for k in BLOCK_KEYS}
                     for blk in params["blocks"]]
    return out


def step_norms(before: dict, after: dict, lr: float) -> torch.Tensor:
    """Each leaf's ||after - before|| / lr, in ``leaves`` order, as one
    float64 tensor on the device (no synchronisation)."""
    return torch.stack([torch.linalg.vector_norm(a - b, dtype=torch.float64)
                        for (_, a), (_, b) in zip(leaves(after),
                                                  leaves(before))]) / lr


def token_rows(seed: int, tag: str, rows: int, length: int, vocab: int,
               device) -> torch.Tensor:
    """[rows, length] int64 tokens uniform over the vocabulary."""
    return torch.randint(0, vocab, (rows, length),
                         generator=generator(seed, tag, device),
                         device=device)
