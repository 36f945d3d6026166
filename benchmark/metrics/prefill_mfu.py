"""prefill_mfu: model FLOPs of the requests of the untraced rest of the window over its seconds, as a share of the card's bf16 peak."""

from benchmark.lib import layers


def read(t):
    return layers.mfu(t)
