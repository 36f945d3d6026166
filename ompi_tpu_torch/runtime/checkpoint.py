"""Training-state checkpoints of mesh mode, with retention.

The port of ``ompi_tpu/runtime/checkpoint.py:35-80`` (``MeshCheckpointer``).
The reference saves through orbax; the port saves the tree (dicts and
lists of tensors, as ``models/transformer.py`` holds parameters) with
``torch.save``, as CPU tensors, one file a step. The two formats are not
interchangeable. A save is atomic: the step's directory is written under a
temporary name and renamed into place (``os.replace``), so a crash leaves
the previous steps and no torn one. Restore with ``specs`` re-places the
tree on the current mesh through ``models/transformer.shard_params``: a
full tree (``gather_params``) saved from one mesh restores on any other.
The process-mode rank-partitioned checkpoints are not ported.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

from ompi_tpu_torch.core.errors import MPIError, ERR_FILE
from ompi_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["MeshCheckpointer"]

_STATE = "state.pt"


def _map(tree, fn, *rest):
    """``fn`` on every leaf of a tree of dicts and lists, with the matching
    leaves of ``rest``."""
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise MPIError(ERR_FILE, "checkpoint tree does not match the "
                                     "template")
        return {k: _map(v, fn, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        if any(len(r) != len(tree) for r in rest):
            raise MPIError(ERR_FILE, "checkpoint tree does not match the "
                                     "template")
        return [_map(v, fn, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _to_host(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else \
        torch.as_tensor(x)


def _like(x: torch.Tensor, t) -> torch.Tensor:
    if tuple(x.shape) != tuple(t.shape):
        raise MPIError(ERR_FILE, f"checkpoint leaf {tuple(x.shape)} vs "
                                 f"template {tuple(t.shape)}")
    return x.to(t.device, t.dtype)


class MeshCheckpointer:
    """Checkpoints of a parameter tree under ``directory``, one
    subdirectory a step, keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self._dir, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self._dir) if d.isdigit()
                      and os.path.isfile(os.path.join(self._dir, d, _STATE)))

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` (leaves on any device) as step ``step``, and
        drop the steps past ``max_to_keep``. The write is synchronous (the
        reference's ``wait=False`` has no counterpart)."""
        final = self._step_dir(step)
        if os.path.exists(final):
            raise MPIError(ERR_FILE, f"step {step} already saved in "
                                     f"{self._dir}")
        tmp = os.path.join(self._dir, f".{int(step)}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(_map(state, _to_host), os.path.join(tmp, _STATE))
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Any = None,
                specs: Any = None, device: DeviceLike = None) -> Any:
        """The tree of step ``step`` (the latest by default).

        - no ``template``, no ``specs``: CPU tensors, as saved;
        - ``template``: each leaf takes its template leaf's shape (checked),
          dtype and device;
        - ``specs`` (``param_specs``): this rank's slice on the current mesh
          (``shard_params``), on ``device`` (the current mesh's device, or
          ``cuda`` without a mesh)."""
        step = self.latest_step() if step is None else step
        path = os.path.join(self._step_dir(step), _STATE) \
            if step is not None else None
        if path is None or not os.path.isfile(path):
            raise MPIError(ERR_FILE, f"no checkpoint {step} in {self._dir}")
        state = torch.load(path, map_location="cpu", weights_only=True)
        if template is not None:
            state = _map(state, _like, template)
        if specs is not None:
            from ompi_tpu_torch.models.transformer import shard_params
            from ompi_tpu_torch.parallel import axes

            mesh = axes.current_mesh()
            if device is None and mesh is not None:
                device = mesh.device
            dev = resolve_device(device)
            state = _map(shard_params(state, specs), lambda t: t.to(dev))
        return state

    def close(self) -> None:
        """Nothing is held open between calls."""
