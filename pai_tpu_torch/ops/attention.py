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

# Sequences at or above this length take the flash path.
FLASH_THRESHOLD = 4096
FLASH_MULTIPLE = 1024


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Full-softmax attention. q, k, v: (B, H, T, D); float32 logits and
    softmax, the result in v's dtype."""
    scale = q.shape[-1] ** -0.25
    with torch.autocast(device_type=q.device.type, enabled=False):
        logits = torch.matmul(q.float() * scale,
                              (k.float() * scale).transpose(-1, -2))
        weights = torch.softmax(logits, dim=-1)
        return torch.matmul(weights, v.float()).to(v.dtype)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    """Self-attention over (B, H, T, D) with the automatic long-sequence
    path. The flash path's result is token-major in memory (a view of a
    contiguous (B, T, H, D) buffer)."""
    t = q.shape[2]
    if t < FLASH_THRESHOLD or t % FLASH_MULTIPLE:
        return _full_attention(q, k, v)
    return flash_attention(q, k, v)
