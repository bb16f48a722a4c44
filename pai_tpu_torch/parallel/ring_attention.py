"""Ring (sequence-parallel) attention over a process group, counterpart of
``pai_tpu/parallel/ring_attention.py``.

Tokens are sharded over the group ``sp``; each rank holds its query shard
and streams the key/value shards around the ring, each to rank ``(r + 1) %
n`` (``distributed.ring_pass``, the JAX package's ``ppermute`` with
``_ring_perm``), folding every visiting shard into the running softmax
state. Exact, not an approximation. Two hop implementations, chosen by the
shard's length as the JAX package chooses them:

* **flash hop** (``t_local >= FLASH_RING_THRESHOLD``, ``t_local`` a multiple
  of 128, a head dimension the kernels take): each hop is
  ``kernels.flash_attention(q, ks, vs, emit_lse=True)`` — kernel
  ``flash_fwd`` on CUDA tensors, its plain version on CPU tensors — and the
  hops merge by ``lse_new = logaddexp(lse_prev, lse_hop)``, ``o = o_prev *
  exp(lse_prev - lse_new) + o_hop * exp(lse_hop - lse_new)``. The backward
  (``_RingFlash.backward``) is a second ring: at each hop
  ``kernels.flash_attention_backward(q, ks, vs, o, lse, do)`` — kernels
  ``flash_bwd_dq`` and ``flash_bwd_dkv`` — with the *global* ``lse``, which
  makes each hop's softmax block the globally normalised one, so its dq, dk
  and dv are exact contributions. dq is summed where it is; the dk and dv
  accumulators travel with their key/value shard and arrive home after n
  hops with every rank's contribution. Per ring and rank: ``flash_fwd`` n
  launches forward, ``flash_bwd_dq`` and ``flash_bwd_dkv`` n each backward.
* **einsum hop** (shorter shards): the materialised-logits online-softmax
  fold in float32 with plain ``torch.matmul``, differentiable through
  ``distributed.ring_shift``; the JAX package computes it outside Pallas too.

The merge (``logaddexp``, two ``exp`` rescales) and the key/value transport
are plain PyTorch, as they are XLA in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pai_tpu_torch.kernels.flash_attention import (BLOCK_Q, HEAD_DIMS,
                                                   _takes_layout,
                                                   flash_attention,
                                                   flash_attention_backward)
from pai_tpu_torch.parallel.distributed import (gather_dim, ring_pass,
                                                ring_shift, slice_dim)
from pai_tpu_torch.parallel.mesh import axis_group, axis_size

# Shards at or above this token count take the flash hop (they must also
# tile: t_local % 128 == 0). Below it the einsum hop's logits tile is small.
FLASH_RING_THRESHOLD = 2048


def _ring_attention_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           group) -> torch.Tensor:
    """Einsum-hop ring over ``group``: q, k, v are this rank's (B, H,
    T_local, D) shards. Scaling is QKVAttentionLegacy's (``D**-0.25`` on each
    operand), logits and softmax in float32."""
    n = dist.get_world_size(group)
    b, h, t, d = q.shape
    scale = d ** -0.25
    with torch.autocast(device_type=q.device.type, enabled=False):
        qs = q.float() * scale
        m = torch.full((b, h, t, 1), float("-inf"), dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
        ks, vs = k, v
        for hop in range(n):
            logits = torch.matmul(qs, (ks.float() * scale).transpose(-1, -2))
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vs.float())
            m = m_new
            if hop + 1 < n:
                ks, vs = ring_shift((ks, vs), group)
        return (acc / l).to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash-hop ring and its backward ring (the JAX package's
    ``custom_vjp`` rules ``_ring_flash_fwd_rule`` / ``_ring_flash_bwd_rule``)."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        n = dist.get_world_size(group)
        b, h, t, d = q.shape
        o = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, t, 1), float("-inf"), dtype=torch.float32,
                         device=q.device)
        ks, vs = k, v
        for hop in range(n):
            o_hop, lse_hop = flash_attention(q, ks, vs, emit_lse=True)
            lse_hop = lse_hop.reshape(b, h, t, 1)
            lse_new = torch.logaddexp(lse, lse_hop)
            o = (o * torch.exp(lse - lse_new)
                 + o_hop.float() * torch.exp(lse_hop - lse_new))
            lse = lse_new
            if hop + 1 < n:
                ks, vs = ring_pass((ks, vs), group)
        out = o.to(v.dtype)
        ctx.group = group
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        n = dist.get_world_size(group)
        b, h, t, d = q.shape
        lse_flat = lse.reshape(b * h, t)
        if not _takes_layout(grad):
            grad = grad.contiguous()
        dq = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
        dk = torch.zeros_like(dq)
        dv = torch.zeros_like(dq)
        ks, vs = k, v
        for hop in range(n):
            dq_hop, dk_hop, dv_hop = flash_attention_backward(
                q, ks, vs, o, lse_flat, grad)
            dq += dq_hop.float()
            dk += dk_hop.float()
            dv += dv_hop.float()
            # the accumulators travel with their shard and are home after
            # n passes; the shard itself is not needed after the last hop
            if hop + 1 < n:
                ks, vs, dk, dv = ring_pass((ks, vs, dk, dv), group)
            else:
                dk, dv = ring_pass((dk, dv), group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_hop_eligible(t_local: int, head_dim: int) -> bool:
    return (t_local >= FLASH_RING_THRESHOLD and t_local % BLOCK_Q == 0
            and head_dim in HEAD_DIMS)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group) -> torch.Tensor:
    """Exact attention of this rank's (B, H, T_local, D) query shard over
    the key/value shards of every rank of ``group``: the flash hop where
    the shard is long enough, the einsum hop otherwise."""
    if flash_hop_eligible(q.shape[2], q.shape[3]):
        return _RingFlash.apply(q, k, v, group)
    return _ring_attention_einsum(q, k, v, group)


def sequence_sharded_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, axis_name: str = "sp"
                               ) -> torch.Tensor:
    """Attention of replicated (B, H, T, D) inputs with the tokens sharded
    over the mesh axis ``axis_name``: each rank takes its token shard
    (gradient: all-gather), runs the ring, and the shards of the output are
    gathered (gradient: this rank's shard). The result is replicated."""
    if axis_size(mesh, axis_name) == 1:
        raise ValueError(f"mesh axis '{axis_name}' has one rank")
    group = axis_group(mesh, axis_name)
    qs, ks, vs = (slice_dim(x, group, 2) for x in (q, k, v))
    return gather_dim(ring_attention(qs, ks, vs, group), group, 2)
