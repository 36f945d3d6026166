"""flash_roofline.<suffix>: least time of the flash launches (frozen chip_smoke bounds at each launch's shape) over the flash kernels' time."""

from benchmark.lib import layers


def read(t):
    return layers.flash_roofline(t)
