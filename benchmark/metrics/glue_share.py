"""glue_share.<suffix>: device time outside the cuBLAS products and the flash kernels, as a share of all device time in the traced window."""

from benchmark.lib import layers


def read(t):
    return layers.glue_share(t)
