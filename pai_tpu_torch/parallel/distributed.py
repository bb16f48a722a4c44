"""Process-group start-up and the collectives of the parallel layer,
counterpart of ``pai_tpu/parallel/distributed.py``.

One process per rank, as ``torchrun --nproc-per-node N`` starts them:

* ``maybe_initialize_distributed`` reads the launcher's environment
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``)
  and starts the default process group: NCCL for CUDA ranks, gloo for CPU
  ranks, or the ``backend`` the caller names. A group the caller already
  made is taken as it is. Without a launcher it is a no-op: one process, a
  world of one.
* ``local_batch_rows`` — the contiguous rows of a global batch one dp index
  loads, unchanged from the JAX package.

Collectives. NCCL refuses two ranks of one communicator on one card, so a
machine with one GPU runs its ranks over gloo with CUDA tensors. gloo
carries all-reduce, broadcast, all-gather and reduce-scatter on CUDA tensors,
but not point-to-point send and receive (``tools/torch_gloo_cuda_probe.py``;
PERF.md §7): ``ring_pass`` stages those through host memory when the group's
backend is gloo, a fact it reads from the group. Nothing here wraps a
collective in ``try``.

The differentiable collectives are the conjugate pairs the parallel layer
needs under autograd (the backward never reads the mesh context: the group
is kept with the saved tensors):

* ``all_reduce_sum`` — sum forward, sum of the gradients backward (global
  BatchNorm statistics, global means of losses and metrics);
* ``slice_dim`` — this rank's slice forward, all-gather backward (the token
  shard entering the ring, the heads a tp rank computes);
* ``gather_dim`` — all-gather forward, this rank's slice backward (the
  ring's output, a tp convolution's output channels); right where the
  gradient arriving there is the same on every rank of the group;
* ``copy_to_group`` — identity forward, all-reduce backward (the input of a
  channel-sharded convolution);
* ``ring_shift`` — the ring's neighbour exchange, its gradient sent back the
  other way.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def launcher_world(env: Optional[Mapping] = None) -> Tuple[int, int, int]:
    """``(rank, world, local_rank)`` the launcher's environment names;
    ``(0, 1, 0)`` without one."""
    env = os.environ if env is None else env
    world = int(env.get("WORLD_SIZE", "1") or 1)
    rank = int(env.get("RANK", "0") or 0)
    local = int(env.get("LOCAL_RANK", str(rank)) or rank)
    return rank, world, local


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def maybe_initialize_distributed(device: torch.device = torch.device("cpu"),
                                 backend: Optional[str] = None,
                                 env: Optional[Mapping] = None
                                 ) -> Tuple[int, int]:
    """Start the default process group when the launcher's environment names
    a world of more than one rank (or ``WORLD_SIZE=1`` with an address, as
    ``torchrun --nproc-per-node 1`` gives); a no-op without one, or when a
    group already exists. Returns ``(rank, world)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ if env is None else env
    rank, world, _ = launcher_world(env)
    if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
        return 0, 1
    backend = backend or default_backend(device)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(minutes=30), **kwargs)
    return rank, world


def local_batch_rows(batch_size: int, process_index: int,
                     process_count: int) -> range:
    """The contiguous rows of a global batch this process must load.

    Batch rows are laid out over the mesh's 'dp' axis in rank order, so dp
    index p owns rows [p*B/P, (p+1)*B/P)."""
    if batch_size % process_count:
        raise ValueError(
            f"batch_size {batch_size} not divisible by process_count "
            f"{process_count}")
    per = batch_size // process_count
    return range(process_index * per, (process_index + 1) * per)


# --------------------------------------------------------------------------
# plain collectives
# --------------------------------------------------------------------------
def stages_point_to_point(group, tensor: torch.Tensor) -> bool:
    """Whether a send or receive of ``tensor`` over ``group`` goes through
    host memory: gloo does not carry point-to-point on CUDA tensors."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def ring_pass(tensors: Sequence[torch.Tensor], group, step: int = 1
              ) -> List[torch.Tensor]:
    """Each tensor sent to the rank ``step`` places on around ``group``'s
    ring and replaced by the one from ``step`` places before, as
    ``jax.lax.ppermute`` with the ring permutation."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    staged = stages_point_to_point(group, tensors[0])
    send = [t.detach().contiguous() for t in tensors]
    if staged:
        send = [t.cpu() for t in send]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, dst, group, tag=i)
           for i, t in enumerate(send)]
    ops += [dist.P2POp(dist.irecv, t, src, group, tag=i)
            for i, t in enumerate(recv)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        return [t.to(like.device) for t, like in zip(recv, tensors)]
    return recv


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """In place, the mean over ``group`` of each tensor, as one all-reduce
    of their flattened concatenation (one per dtype)."""
    n = dist.get_world_size(group)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


# --------------------------------------------------------------------------
# collectives under autograd
# --------------------------------------------------------------------------
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    per = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * per, per).contiguous()


class _SliceDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.group, ctx.dim), None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own_slice(grad, ctx.group, ctx.dim), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(ring_pass(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ring_pass(grads, ctx.group, -1))


def slice_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal share of ``x`` along ``dim``."""
    return _SliceDim.apply(x, group, dim)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``."""
    return _GatherDim.apply(x, group, dim)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def ring_shift(tensors: Sequence[torch.Tensor], group) -> Tuple:
    """``ring_pass`` one place on, differentiable (the gradient travels one
    place back)."""
    return _RingShift.apply(group, *tensors)
