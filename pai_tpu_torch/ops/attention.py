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
blockwise version. The JAX dispatcher's mesh branches (ring attention over a
sequence-parallel axis, ``shard_map`` over batch and heads) belong to the
multi-device layer (ROADMAP.md Queue A item 7) and are not here.
"""

from __future__ import annotations

import torch

from pai_tpu_torch.kernels.flash_attention import flash_attention
from pai_tpu_torch.ops.layers import weak_scalar

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


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    """Self-attention over (B, H, T, D) with the automatic long-sequence
    path. The flash path's result is token-major in memory (a view of a
    contiguous (B, T, H, D) buffer)."""
    t = q.shape[2]
    if t < FLASH_THRESHOLD or t % FLASH_MULTIPLE:
        return _full_attention(q, k, v)
    return flash_attention(q, k, v)
