"""device_idle.<suffix>: share of the untraced rest of the window in which no operation ran on the card, from the traced calls' device time."""

from benchmark.lib import layers


def read(t):
    return layers.device_idle(t)
