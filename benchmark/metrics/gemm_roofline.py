"""gemm_roofline.<suffix>: least time of the model's products (from their shapes) over the time of the product kernels."""

from benchmark.lib import layers


def read(t):
    return layers.gemm_roofline(t)
