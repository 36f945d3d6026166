"""The ``mca`` fixture of the port's tests (this file holds no test): set MCA
variables of the port and of the JAX package, and put each back (value and
source) after the test, so that a variable set in one test never leaks
into another in the same worker."""

import pytest


class VarSetter:
    def __init__(self):
        self._saved = []

    def _set(self, mod, fw, name, value):
        v = mod.all_vars()[f"{fw}_{name}"]
        self._saved.append((v, v._value, v._source))
        mod.set_var(fw, name, value)

    def port(self, fw, name, value):
        from ompi_tpu_torch.mca import var

        self._set(var, fw, name, value)

    def jax(self, fw, name, value):
        from ompi_tpu.mca import var

        self._set(var, fw, name, value)

    def both(self, fw, name, value):
        self.jax(fw, name, value)
        self.port(fw, name, value)

    def restore(self):
        for v, value, source in reversed(self._saved):
            v._value, v._source = value, source
        self._saved.clear()


@pytest.fixture
def mca():
    setter = VarSetter()
    try:
        yield setter
    finally:
        setter.restore()
