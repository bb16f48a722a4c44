"""The active device mesh, counterpart of ``pai_tpu/parallel/context.py``.

Three op layers of the port read it when they run:

* ``pai_tpu_torch.ops.attention`` — under an ``sp`` axis of more than one
  rank, ``multihead_attention`` runs ring attention over it;
* ``pai_tpu_torch.ops.layers`` — train-mode ``BatchNorm`` takes the
  statistics of the global batch over ``dp``, and the dropout layers draw
  their masks for the global batch and keep this rank's rows;
* ``pai_tpu_torch.utils.metrics`` and ``train.losses`` — a whole-batch mean
  (a loss, a train metric) is the global batch's.

The context is a ``contextvars.ContextVar``, as in the JAX package: each
thread sees its own value, and the Trainer installs its mesh for the length
of ``fit`` and clears it after. The autograd engine runs the backward of
CUDA ops on a thread of its own, where the context is not set: everything
that a backward needs of the mesh (a process group, a rank) is taken while
the forward runs and kept with the saved tensors.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import NamedTuple, Optional


class MeshContext(NamedTuple):
    mesh: object                      # torch.distributed DeviceMesh
    sp_axis: Optional[str] = None     # set iff sequence sharding requested


_CTX: ContextVar = ContextVar("pai_tpu_torch_mesh_context", default=None)


def set_mesh_context(mesh, sp_axis: Optional[str] = None) -> None:
    """Install (or clear, with ``mesh=None``) the active mesh."""
    _CTX.set(MeshContext(mesh, sp_axis) if mesh is not None else None)


def get_mesh_context() -> Optional[MeshContext]:
    return _CTX.get()


class mesh_context:
    """Scoped form of :func:`set_mesh_context` (tests, library callers)."""

    def __init__(self, mesh, sp_axis: Optional[str] = None):
        self.mesh, self.sp_axis = mesh, sp_axis

    def __enter__(self):
        self._token = _CTX.set(
            MeshContext(self.mesh, self.sp_axis)
            if self.mesh is not None else None)
        return self

    def __exit__(self, *exc):
        _CTX.reset(self._token)
