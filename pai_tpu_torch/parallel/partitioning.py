"""Parameter partitioning for tensor parallelism and FSDP, counterpart of
``pai_tpu/parallel/partitioning.py``.

The rules are the JAX package's, read on torch's layouts: a JAX convolution
kernel is HWIO, output channels last; torch's ``Conv2d`` weight is OIHW
(output channels at dim 0) and ``ConvTranspose2d``'s is IOHW (dim 1).

* tp (``tp_spec_for_leaf``): a 4-D kernel whose output channels are at least
  ``tp * 8`` and divisible by ``tp`` is split on them over 'tp'; everything
  else (biases, norms, dense layers) is replicated. ``shard_modules`` makes
  the split real: such a layer keeps its ``1/tp`` share of the kernel as its
  parameter and computes its share of the output channels, which the ranks
  of the tp group then gather (``ops.layers.Conv``, ``ConvTranspose``). A
  grouped convolution (ResNeXt's) is left whole: its output-channel share
  would need other ranks' input groups. That is a layout difference, not a
  result difference.
* fsdp (``fsdp_spec_for_leaf``): the JAX rule shards the largest axis of a
  leaf that is at least ``dp * 8`` and divisible over 'dp' and replicates
  small leaves. The port shards with ``torch.distributed.fsdp.fully_shard``
  (FSDP2), which splits every parameter on dim 0 over the dp group and
  gathers it for each forward and backward. A layout difference again: the
  results are those of the replicated state, and the checkpoint slot holds
  full tensors either way. On one dp rank (a world of one) both rules
  replicate everything, and so does the port.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from pai_tpu_torch.parallel.distributed import all_gather_cat
from pai_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size


class TpShard(NamedTuple):
    """A layer's share of a kernel split over a tp group: ``dim`` is the
    output-channel axis of its weight, ``full`` its output channels."""
    group: object
    rank: int
    size: int
    dim: int
    full: int


def _out_dim(module: nn.Module) -> int:
    return 1 if isinstance(module, nn.ConvTranspose2d) else 0


def tp_spec_for_leaf(leaf: torch.Tensor, tp: int, out_dim: int = 0
                     ) -> Tuple[Optional[str], ...]:
    """Per-dimension mesh axes of a weight under tp: ``'tp'`` on the output
    channels of an eligible 4-D kernel, else all replicated (None); as in
    the JAX package, also at tp = 1, where the axis has one rank."""
    spec = [None] * leaf.dim()
    if (leaf.dim() == 4 and leaf.shape[out_dim] % tp == 0
            and leaf.shape[out_dim] >= tp * 8):
        spec[out_dim] = "tp"
    return tuple(spec)


def _jax_axis_order(leaf: torch.Tensor, out_dim: int) -> Tuple[int, ...]:
    """This tensor's axes in the order of the JAX package's layout of the
    same leaf: HWIO for a convolution kernel, (in, out) for a dense one."""
    if leaf.dim() == 4:
        return (2, 3, 1 - out_dim, out_dim)
    if leaf.dim() == 2:
        return (1, 0)
    return tuple(range(leaf.dim()))


def fsdp_spec_for_leaf(leaf: torch.Tensor, dp: int, tp: int = 1,
                       out_dim: int = 0) -> Tuple[Optional[str], ...]:
    """The JAX package's ZeRO-3 rule on a torch tensor: the largest axis not
    already on 'tp' that is at least ``dp * 8`` and divisible by ``dp`` goes
    on 'dp' (ties: the first such axis in the JAX layout's order)."""
    if dp <= 1:
        return tp_spec_for_leaf(leaf, tp, out_dim) if tp > 1 \
            else (None,) * leaf.dim()
    spec = list(tp_spec_for_leaf(leaf, tp, out_dim)) \
        if tp > 1 and leaf.dim() == 4 else [None] * leaf.dim()
    best_axis, best_dim = None, 0
    for axis in _jax_axis_order(leaf, out_dim):
        if spec[axis] is not None:
            continue
        size = leaf.shape[axis]
        if size % dp == 0 and size >= dp * 8 and size > best_dim:
            best_axis, best_dim = axis, size
    if best_axis is not None:
        spec[best_axis] = "dp"
    return tuple(spec)


def _tp_candidates(model: nn.Module, tp: int):
    from pai_tpu_torch.ops.layers import Conv, ConvTranspose

    for name, mod in model.named_modules():
        if isinstance(mod, (Conv, ConvTranspose)) and mod.groups == 1 \
                and "tp" in tp_spec_for_leaf(mod.weight, tp, _out_dim(mod)):
            yield name, mod


def shard_tree_for_tp(model: nn.Module, mesh, tp: int) -> int:
    """Split every eligible convolution of ``model`` on its output channels
    over the mesh's tp group, in place; returns how many were split."""
    if tp <= 1:
        return 0
    group = axis_group(mesh, "tp")
    rank = axis_rank(mesh, "tp")
    count = 0
    for _, mod in list(_tp_candidates(model, tp)):
        dim = _out_dim(mod)
        full = mod.weight.shape[dim]
        per = full // tp
        with torch.no_grad():
            share = mod.weight.narrow(dim, rank * per, per).clone()
        mod.weight = nn.Parameter(share)
        mod.tp_shard = TpShard(group, rank, tp, dim, full)
        count += 1
    return count


def tp_layouts(model: nn.Module, prefix: str = "") -> Dict[str, TpShard]:
    """``{parameter name: TpShard}`` of the split kernels of ``model``."""
    return {f"{prefix}{name}.weight": mod.tp_shard
            for name, mod in model.named_modules()
            if getattr(mod, "tp_shard", None) is not None}


def shard_modules(model: nn.Module, mesh, tp: int = 1,
                  fsdp: bool = False) -> nn.Module:
    """Place a network for a parallelism mix, before its optimizer is made:
    tp splits the eligible kernels, fsdp shards every parameter over the dp
    group with FSDP2 (a dp group of one replicates, as the JAX rule does)."""
    shard_tree_for_tp(model, mesh, tp)
    if fsdp and axis_size(mesh, "dp") > 1:
        from torch.distributed.fsdp import fully_shard

        # FSDP2 shards contiguous parameters only (the models keep their
        # convolution kernels channels_last)
        with torch.no_grad():
            for param in model.parameters():
                if not param.is_contiguous():
                    param.data = param.data.contiguous()
        fully_shard(model, mesh=mesh["dp"])
    return model


def shard_state(networks, mesh, tp: int = 1, fsdp: bool = False):
    """``shard_modules`` over each network of a train state (the generator
    and, for ``gan``, the discriminator)."""
    for model in networks:
        if model is not None:
            shard_modules(model, mesh, tp, fsdp)
    return networks


# --------------------------------------------------------------------------
# full tensors <-> a rank's share (checkpoints)
# --------------------------------------------------------------------------
def full_tensor(live: torch.Tensor, shard: Optional[TpShard] = None
                ) -> torch.Tensor:
    """The whole of a tensor that may be an FSDP share (a DTensor) and a tp
    share: collective over the groups it is split over."""
    from torch.distributed.tensor import DTensor

    if isinstance(live, DTensor):
        live = live.full_tensor()
    if shard is not None and live.dim() == 4:
        live = all_gather_cat(live.detach(), shard.group, shard.dim)
    return live.detach()


def local_share(full: torch.Tensor, live: torch.Tensor,
                shard: Optional[TpShard] = None) -> torch.Tensor:
    """This rank's share of ``full`` in the layout of ``live`` (a tp share,
    an FSDP DTensor share or a whole tensor); no communication. A share that
    is not a DTensor stays where ``full`` lies: the caller's copy moves it."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if shard is not None and full.dim() == 4:
        per = shard.full // shard.size
        full = full.narrow(shard.dim, shard.rank * per, per)
    if isinstance(live, DTensor):
        return distribute_tensor(
            full.to(device=live.device, dtype=live.dtype).contiguous(),
            live.device_mesh, live.placements, src_data_rank=None)
    return full


def is_sharded(model: nn.Module) -> bool:
    """Whether ``model`` was sharded with FSDP2."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def reshard(model: Optional[nn.Module]) -> None:
    """Put an FSDP2 module's parameters back to their shares. After a
    forward without backward (evaluation) the root module keeps the gathered
    parameters registered, where a state dict or a swap would find plain
    tensors."""
    if model is not None and is_sharded(model):
        model.reshard()
