"""Device mesh and batch placement, counterpart of
``pai_tpu/parallel/mesh.py``.

One process per rank, one device per process. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every rank of the default
process group, its axes ``('dp', 'tp')`` or, with sequence parallelism,
``('dp', 'tp', 'sp')``, laid out row-major: rank ``(d * tp + t) * sp + s``.

* ``dp`` — data parallel: each dp index holds its rows of the global batch
  (``shard_batch``), the parameters are replicated, gradients are averaged
  over ``dp`` and train-mode BatchNorm takes the global batch's statistics;
* ``tp`` — tensor parallel: large convolution kernels are split on their
  output channels (``parallel.partitioning``); the ranks of one tp group see
  the same rows;
* ``sp`` — sequence parallel: attention runs as ring attention over the
  token axis (``parallel.ring_attention``); the ranks of one sp group see
  the same rows and hold the same parameters.

A run without a process group (one process, no launcher) has no mesh: the
helpers below read ``None`` as a mesh of one rank on every axis.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from pai_tpu_torch.parallel.context import get_mesh_context
from pai_tpu_torch.parallel.distributed import all_reduce_sum


def mesh_shape(world: int, tp: int = 1, sp: int = 1) -> tuple:
    """``(dp, tp[, sp])`` of a mesh over ``world`` ranks, with the JAX
    package's error when ``tp * sp`` does not divide it."""
    if world % (tp * sp):
        raise ValueError(f"{world} devices not divisible by tp*sp={tp * sp}")
    dp = world // (tp * sp)
    return (dp, tp, sp) if sp > 1 else (dp, tp)


def make_mesh(world: Optional[int] = None, tp: int = 1, sp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """The ``('dp', 'tp'[, 'sp'])`` mesh over the ranks of the default
    process group (which must exist). ``'sp'`` is only added when asked for,
    as in the JAX package."""
    if world is None:
        world = dist.get_world_size()
    shape = mesh_shape(world, tp, sp)
    names = ("dp", "tp", "sp")[:len(shape)]
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def shard_batch(mesh: Optional[DeviceMesh], batch: torch.Tensor
                ) -> torch.Tensor:
    """This rank's rows of a global batch: the dp index's contiguous share
    (``local_batch_rows``); the whole batch on a mesh without 'dp'."""
    dp = axis_size(mesh, "dp")
    if dp == 1:
        return batch
    if batch.shape[0] % dp:
        raise ValueError(f"batch of {batch.shape[0]} rows does not split "
                         f"over dp={dp}")
    per = batch.shape[0] // dp
    return batch.narrow(0, axis_rank(mesh, "dp") * per, per)


def place_replicated(mesh: Optional[DeviceMesh],
                     tree: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """The same tensors on every rank: rank 0's, broadcast in place over the
    whole mesh."""
    if mesh is not None and mesh.size() > 1:
        for t in tree:
            dist.broadcast(t, src=0)
    return tree


def dp_of_context():
    """``(dp size, dp rank, dp group)`` of the installed mesh; ``(1, 0,
    None)`` without one."""
    ctx = get_mesh_context()
    mesh = ctx.mesh if ctx is not None else None
    dp = axis_size(mesh, "dp")
    if dp == 1:
        return 1, 0, None
    return dp, axis_rank(mesh, "dp"), axis_group(mesh, "dp")


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]
              ) -> torch.Tensor:
    """A random draw of ``shape`` (this rank's rows) made for the global
    batch: under a mesh with ``dp`` ranks, ``draw`` is called for ``dp``
    times the rows and this rank's rows are kept, so every rank draws what a
    one-process run draws for the whole batch, as JAX draws over the global
    array. Without one, ``draw(shape)``."""
    dp, rank, _ = dp_of_context()
    shape = tuple(shape)
    if dp == 1:
        return draw(shape)
    rows = shape[0]
    return draw((rows * dp,) + shape[1:]).narrow(0, rank * rows, rows)


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of a mean over this rank's rows (equal
    row counts): the mean of ``x`` over the installed mesh's dp group,
    differentiable. A whole-batch reduction of a loss or a metric is then
    what XLA computes over the dp-sharded global array."""
    dp, _, group = dp_of_context()
    if dp == 1:
        return x
    return all_reduce_sum(x, group) / dp
