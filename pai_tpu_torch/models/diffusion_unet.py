"""Embedding-conditioned UNet backbone for Palette diffusion, counterpart of
``pai_tpu/models/diffusion_unet.py`` (the reference's guided_diffusion UNet
with its BatchNorm deviation).

* ``cond_embed`` MLP (inner -> 4*inner -> 4*inner, SiLU) over the sinusoidal
  gamma embedding.
* Input / middle / output block lists of FiLM (scale-shift norm) ResBlocks,
  attention at the configured downsample rates, ResBlock up/downsampling,
  skip concatenation from every input block, zero-initialised output
  convolution.
* Norms are BatchNorm in float32 (2d in the ResBlocks, over tokens in the
  attention blocks).
* ``AttentionBlock``: BatchNorm over tokens -> ``qkv`` -> heads ->
  ``ops.attention.multihead_attention`` -> zero-initialised ``proj_out`` ->
  residual. The ``3C`` channels of ``qkv`` are ordered ``(head, {q,k,v}, D)``
  — the legacy split — not ``({q,k,v}, head, D)``. q, k and v are views of the
  one ``(N, T, heads, 3, D)`` tensor; the flash kernel reads them in place
  and writes token-major, so nothing is transposed in memory on the long
  path.

The public interface is NHWC like the JAX module; inside, tensors are NCHW in
``torch.channels_last`` memory, the same bytes. Parameters carry the
reference's torch names (``input_blocks.N.0.in_layers.0.weight``,
``...emb_layers.1.weight``, ``...out_layers.3.weight``,
``...skip_connection.weight``, ``input_blocks.N.1.qkv.weight`` of shape
``(3C, C, 1)``, ``middle_block.1.proj_out.weight``, ``output_blocks...``,
``out.0`` / ``out.2``, ``cond_embed.0`` / ``cond_embed.2``), so a reference
``state_dict`` (minus its ``unet.`` prefix) loads as it is.

Training: ``AttentionBlock`` recomputes its attention in the backward pass
(``torch.utils.checkpoint``, non-reentrant) and wraps nothing else, as the JAX
module wraps only ``multihead_attention`` in ``jax.checkpoint``. The norm
stays outside, so its running statistics move once per step, at momentum
0.19 = 1 - 0.9**2: the reference's checkpointing re-ran the whole block in
train mode and moved them twice at 0.1, which one step at 0.19 reproduces.
On the flash path each attention call then launches the forward kernel twice
(the step's forward and the recomputation) and each backward kernel once. The
ResBlocks' elementwise dropout draws from the generator the model was built
with; eval mode reads the running statistics only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pai_tpu_torch.ops import (BatchNorm, Conv, Dense, Dropout, SiLU,
                               avg_pool_2x, gamma_embedding, round_to_compute,
                               upsample_nearest_2x)
from pai_tpu_torch.ops.attention import multihead_attention
from pai_tpu_torch.parallel.context import get_mesh_context
from pai_tpu_torch.ops.layers import _bias_after_rounding, bf16_autocast


class ZeroConv(Conv):
    """Conv with zero-initialised kernel and bias (guided_diffusion
    ``zero_module``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1, device=None, float32_sum: bool = False):
        super().__init__(in_channels, features, kernel_size, 1, padding,
                         init_mode="zeros", device=device,
                         float32_sum=float32_sum)


class TokenConv1d(nn.Conv1d):
    """The reference's ``conv_nd(1, in, out, 1)`` — weight ``(out, in, 1)`` —
    applied to token-major ``(N, T, in)`` tensors as the linear map it is."""

    def __init__(self, in_channels: int, features: int, zero: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(in_channels, features, 1, device=device)
        if self.weight.is_meta:
            return
        with torch.no_grad():
            if zero:
                self.weight.zero_()
                self.bias.zero_()
            else:  # torch's default: U(+-1/sqrt(fan_in)) for both
                bound = in_channels ** -0.5
                self.weight.uniform_(-bound, bound, generator=generator)
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return _bias_after_rounding(nn.functional.linear, tokens,
                                    self.weight[:, :, 0], self.bias, (-1,))


class ResBlock(nn.Module):
    """FiLM-conditioned residual block with optional up/down sampling
    (``use_scale_shift_norm=True``). Its dropout draws from ``generator``.
    Under bfloat16 autocast ``conv_in`` hands ``norm_out`` its float32 sum,
    and the block returns the float32 residual sum: XLA keeps both in float32
    for the BatchNorm that reads them (``pai_tpu/models/diffusion_unet.py:
    83,99,109``, see ``ops/layers._bias_after_rounding``); every bfloat16
    reader rounds the returned sum first (``round_to_compute``)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 dropout: float = 0.0, up: bool = False, down: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.out_channels = out_channels
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            BatchNorm(in_channels, device=device), SiLU(),
            Conv(in_channels, out_channels, 3, padding=1, init_mode="torch",
                 generator=generator, device=device, float32_sum=True))
        self.emb_layers = nn.Sequential(
            SiLU(),
            Dense(emb_channels, 2 * out_channels, init_mode="torch",
                  generator=generator, device=device))
        self.out_layers = nn.Sequential(
            BatchNorm(out_channels, device=device), SiLU(),
            Dropout(dropout, generator=generator),
            ZeroConv(out_channels, out_channels, 3, 1, device=device))
        if in_channels != out_channels:
            self.skip_connection = Conv(in_channels, out_channels, 1,
                                        init_mode="torch",
                                        generator=generator, device=device)
        else:
            self.skip_connection = nn.Identity()

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[1](self.in_layers[0](x))
        x = round_to_compute(x)
        if self.up:
            h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
        elif self.down:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.out_layers[0](self.in_layers[2](h))
        emb_out = self.emb_layers(emb).to(h.dtype)[:, :, None, None]
        scale, shift = emb_out.chunk(2, dim=1)
        h = h * (1 + scale) + shift
        h = self.out_layers[3](self.out_layers[2](self.out_layers[1](h)))
        skip = self.skip_connection(x)
        if bf16_autocast(h):
            return skip.float() + h.float()
        return skip + h


class AttentionBlock(nn.Module):
    """Spatial self-attention with a BatchNorm pre-norm over tokens and a
    zero-initialised output projection."""

    def __init__(self, channels: int, num_heads: int = 4,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        # torch momentum 0.19 is flax momentum 0.81 = 0.9**2 (see the module
        # docstring)
        self.norm = BatchNorm(channels, momentum=0.19, device=device)
        self.qkv = TokenConv1d(channels, 3 * channels, generator=generator,
                               device=device)
        self.proj_out = TokenConv1d(channels, channels, zero=True,
                                    device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, hh, ww = x.shape
        t = hh * ww
        x = round_to_compute(x)
        tokens = x.permute(0, 2, 3, 1).reshape(n, t, c)
        qkv = self.qkv(self.norm(tokens))
        qkv = qkv.reshape(n, t, self.num_heads, 3, c // self.num_heads)
        q, k, v = (qkv[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
        # under a mesh, the context of this forward goes along: the
        # recomputation runs on autograd's thread, where it is not set
        context = get_mesh_context()
        args = (q, k, v) if context is None else (q, k, v, context)
        if torch.is_grad_enabled() and qkv.requires_grad:
            # recomputed in the backward pass (the reference's always-on
            # checkpointing, the JAX module's jax.checkpoint); it draws no
            # random numbers, so no RNG state is stashed (a CUDA graph's
            # capture could not read it)
            a = checkpoint(multihead_attention, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            a = multihead_attention(*args)            # (N, heads, T, D)
        a = a.permute(0, 2, 1, 3).reshape(n, t, c)
        out = tokens + self.proj_out(a).to(tokens.dtype)
        return out.reshape(n, hh, ww, c).permute(0, 3, 1, 2)


class EmbedSequential(nn.Sequential):
    """A block of the UNet: its ResBlocks take the embedding, its other
    members (the stem conv, attention) do not."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class DiffusionUNet(nn.Module):
    """``generator`` seeds the init; it must live on ``device``. ``dtype`` is
    the compute dtype: ``torch.bfloat16`` runs convolutions, linear maps and
    attention operands under autocast with float32 parameters, norms and
    softmax."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 inner_channel: int = 128, res_blocks: int = 2,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8, 8, 8, 8),
                 attn_res: Sequence[int] = (8, 4, 2), num_heads: int = 4,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        mults = tuple(channel_mults)
        attn = set(attn_res)
        inner = inner_channel
        emb_ch = 4 * inner
        self.inner_channel = inner
        self.compute_dtype = dtype
        kw = dict(generator=generator, device=device)

        def res(cin, cout, **updown):
            return ResBlock(cin, cout, emb_ch, dropout, **updown, **kw)

        self.cond_embed = nn.Sequential(
            Dense(inner, emb_ch, init_mode="torch", **kw), SiLU(),
            Dense(emb_ch, emb_ch, init_mode="torch", **kw))

        ch = mults[0] * inner
        blocks = [EmbedSequential(Conv(in_channels, ch, 3, padding=1,
                                       init_mode="torch", float32_sum=True,
                                       **kw))]
        skip_chans = [ch]
        ds = 1
        for level, mult in enumerate(mults):
            for _ in range(res_blocks):
                layers = [res(ch, mult * inner)]
                ch = mult * inner
                if ds in attn:
                    layers.append(AttentionBlock(ch, num_heads, **kw))
                blocks.append(EmbedSequential(*layers))
                skip_chans.append(ch)
            if level != len(mults) - 1:
                blocks.append(EmbedSequential(res(ch, ch, down=True)))
                skip_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)

        self.middle_block = EmbedSequential(
            res(ch, ch), AttentionBlock(ch, num_heads, **kw), res(ch, ch))

        blocks = []
        for level, mult in reversed(list(enumerate(mults))):
            for i in range(res_blocks + 1):
                layers = [res(ch + skip_chans.pop(), mult * inner)]
                ch = mult * inner
                if ds in attn:
                    layers.append(AttentionBlock(ch, num_heads, **kw))
                if level and i == res_blocks:
                    layers.append(res(ch, ch, up=True))
                    ds //= 2
                blocks.append(EmbedSequential(*layers))
        self.output_blocks = nn.ModuleList(blocks)

        self.out = nn.Sequential(BatchNorm(ch, device=device), SiLU(),
                                 ZeroConv(ch, out_channels, 3, 1,
                                          device=device, float32_sum=True))
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                gammas: torch.Tensor) -> torch.Tensor:
        """x: condition (N,H,W,C); y: noisy image (N,H,W,C); gammas: (N,).
        Returns (N, H, W, C_out) float32."""
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            emb = self.cond_embed(gamma_embedding(gammas, self.inner_channel))
            # NHWC bytes seen as channels_last NCHW
            h = torch.cat([x, y], dim=-1).permute(0, 3, 1, 2)
            hs = []
            for block in self.input_blocks:
                h = block(h, emb)
                hs.append(round_to_compute(h))
            h = self.middle_block(h, emb)
            for block in self.output_blocks:
                h = block(torch.cat([round_to_compute(h), hs.pop()], dim=1),
                          emb)
            h = self.out(h)
        return h.float().permute(0, 2, 3, 1)
