"""Spatial self-attention for the diffusion UNet, counterpart of
``pai_tpu/ops/attention.py``.

Scaling is QKVAttentionLegacy's: q and k are each scaled by ``D**-0.25``
before the product (== logits / sqrt(D)); logits and softmax are float32.

``multihead_attention`` keeps the JAX dispatcher's rule: sequences shorter
than 4,096 tokens, or not a multiple of 1,024, materialise the full softmax
(``_full_attention``, plain matrix products — the JAX package computes this
outside any Pallas kernel too); longer ones go to
``kernels.flash_attention.flash_attention``, which on CUDA tensors launches
the hand-written kernel (or raises) and on CPU tensors takes the plain
blockwise version. The mesh branches follow the JAX dispatcher's
(``pai_tpu/ops/attention.py:52-68,132-191``), reading the mesh installed in
``pai_tpu_torch.parallel.context``:

* under an 'sp' axis of more than one rank that divides the tokens,
  attention is ring attention over it (``parallel.ring_attention``), at any
  length, as in the JAX package;
* on the flash path with a 'tp' axis that divides the heads, each tp rank
  runs the kernel on its share of the heads and the shares are gathered (the
  JAX package's ``shard_map`` over heads); the batch rows are already this
  rank's on a 'dp' axis, so dp needs nothing here.

``AttentionBlock`` passes the context it read to ``multihead_attention``
explicitly: its recomputation in the backward pass runs on the autograd
engine's thread, where the context variable is not set.
"""

from __future__ import annotations

from typing import Optional

import torch

from pai_tpu_torch.kernels.flash_attention import flash_attention
from pai_tpu_torch.ops.layers import weak_scalar
from pai_tpu_torch.parallel.context import (MeshContext, get_mesh_context,
                                            mesh_context, set_mesh_context)
from pai_tpu_torch.parallel.distributed import gather_dim, slice_dim
from pai_tpu_torch.parallel.mesh import axis_group, axis_size
from pai_tpu_torch.parallel.ring_attention import sequence_sharded_attention

# Sequences at or above this length take the flash path.
FLASH_THRESHOLD = 4096
FLASH_MULTIPLE = 1024


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Full-softmax attention. q, k, v: (B, H, T, D). As the JAX function:
    q and k are scaled in their own dtype (by the scale rounded to it, as
    JAX's weakly typed scalar is), their product accumulates in float32, the
    softmax is float32, the weights are rounded to v's dtype, and the second
    product accumulates in float32 and is rounded once to v's dtype. The
    products of 16-bit values are exact in float32 (and in TF32), so they run
    as float32 matrix products."""
    scale = weak_scalar(q.shape[-1] ** -0.25, q.dtype)
    with torch.autocast(device_type=q.device.type, enabled=False):
        logits = torch.matmul((q * scale).float(),
                              (k * scale).float().transpose(-1, -2))
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.matmul(weights.float(), v.float()).to(v.dtype)


def set_sequence_mesh(mesh, axis: str = "sp") -> None:
    """Install (or clear, with ``mesh=None``) the mesh whose ``axis`` the
    tokens are sharded over (a thin wrapper over ``parallel.context``)."""
    set_mesh_context(mesh, sp_axis=axis if mesh is not None else None)


class sequence_parallel(mesh_context):
    """Scoped form of :func:`set_sequence_mesh` (tests)."""

    def __init__(self, mesh, axis: str = "sp"):
        super().__init__(mesh, sp_axis=axis)


def _head_sharded_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        group) -> torch.Tensor:
    """The flash kernel on this tp rank's share of the heads; the shares
    gathered (gradient: each rank's heads, then gathered back)."""
    qs, ks, vs = (slice_dim(x, group, 1) for x in (q, k, v))
    return gather_dim(flash_attention(qs, ks, vs), group, 1)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        context: Optional[MeshContext] = None
                        ) -> torch.Tensor:
    """Self-attention over (B, H, T, D) with the automatic long-sequence
    path and the mesh branches (module docstring); ``context`` is the mesh
    context to dispatch on (default: the installed one). The one-rank flash
    path's result is token-major in memory (a view of a contiguous (B, T, H,
    D) buffer)."""
    ctx = get_mesh_context() if context is None else context
    mesh = ctx.mesh if ctx is not None else None
    t = q.shape[2]
    if ctx is not None and ctx.sp_axis is not None:
        sp = axis_size(mesh, ctx.sp_axis)
        if sp > 1 and t % sp == 0:
            return sequence_sharded_attention(mesh, q, k, v, ctx.sp_axis)
    if t < FLASH_THRESHOLD or t % FLASH_MULTIPLE:
        return _full_attention(q, k, v)
    tp = axis_size(mesh, "tp")
    if tp > 1 and q.shape[1] % tp == 0:
        return _head_sharded_flash(q, k, v, axis_group(mesh, "tp"))
    return flash_attention(q, k, v)
