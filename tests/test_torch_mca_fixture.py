"""The ``mca`` fixture of the port's tests (this file holds no test): set MCA
variables of the port and of the JAX package, and put each back (value and
source) after the test, so that a variable set in one test never leaks
into another in the same worker."""

import pytest


class VarSetter:
    """``watched`` puts a value back through ``set_var``, so that the
    variable's watchers run (a plane that binds hooks or caches on a
    write, such as forensics or the QoS tag map, then unbinds)."""

    def __init__(self, watched: bool = False):
        self._saved = []
        self._watched = watched

    def _set(self, mod, fw, name, value):
        v = mod.all_vars()[f"{fw}_{name}"]
        self._saved.append((v, v._value, v._source, mod, fw, name))
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
        for v, value, source, mod, fw, name in reversed(self._saved):
            if self._watched:
                mod.set_var(fw, name, value)
            v._value, v._source = value, source
        self._saved.clear()


@pytest.fixture
def mca():
    setter = VarSetter()
    try:
        yield setter
    finally:
        setter.restore()


@pytest.fixture
def mca_watched():
    setter = VarSetter(watched=True)
    try:
        yield setter
    finally:
        setter.restore()
