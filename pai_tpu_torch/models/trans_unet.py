"""TransUNet, counterpart of ``pai_tpu/models/trans_unet.py``: a strided
bottleneck-convolution encoder, a ViT over the innermost feature map's
patches, a convolutional decoder.

* Stem 3x3 convolution to 64 channels. An encoder block (``BottleneckDown``)
  is 1x1 -> 3x3 stride 2 -> 1x1 at a quarter of its input's width, every
  convolution bias-free and followed by a BatchNorm, plus a 1x1 stride-2
  projection skip, and the ReLU of the sum.
* The ViT (``VisionTransformer``): the innermost map cut into p x p patches,
  ``n (h p1) (w p2) c -> n (h w) (p1 p2 c)``, then LayerNorm -> Linear ->
  LayerNorm, a learned positional embedding drawn from N(0, 1),
  ``vit_layers`` post-LN transformer layers (torch
  ``nn.TransformerEncoderLayer``: 8 heads, exact GELU, FFN 2048, dropout on
  the attention weights, after the attention, inside and after the FFN),
  and the patches put back.
* A decoder block is two 3x3 convolution + BatchNorm + ReLU, then a nearest
  2x upsample; skips are concatenated as in Pix2Pix; a last decoder to 64
  channels, a 3x3 head and tanh in float32.

The JAX package's documented deviation is kept: the reference feeds
``(N, patches, dim)`` to a transformer built without ``batch_first`` and so
attends across the batch; here attention runs over the patches of each
sample. Its logits are a float32 product, as ``preferred_element_type``
gives them in the JAX package, and so is the weighted sum of the values
(``torch.matmul``; the 4-token attention of the published configuration is
no kernel of the JAX package either). ``validate`` raises where the
innermost map cannot be cut into patches, as the JAX package does (the
8-level CLI default collapses it to 1x1).

Parameters carry the reference's torch names: ``in_conv``,
``encoders.L.{decode,skip}.k``, ``vit_bottleneck.{to_patch_embedding.{1,2,3},
pos_embedding, transformer.layers.i.{self_attn.{in_proj_weight,
in_proj_bias, out_proj}, linear1, linear2, norm1, norm2}}``,
``decoders.i.decode.k``, ``out.0``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from pai_tpu_torch.models.res_unet import UpsampleNearest2x
from pai_tpu_torch.ops import (BatchNorm, Conv, Dense, Dropout, LayerNorm,
                               gelu)
from pai_tpu_torch.ops.layers import _bias_after_rounding

VIT_LAYERS = 12


def validate(image_size: int, channel_mults: Sequence[int],
             patch_size: int) -> None:
    """Raise ``ValueError`` where the innermost feature map cannot be cut
    into ``patch_size`` patches (``pai_tpu/models/trans_unet.py:170-178``)."""
    bott = image_size // (2 ** len(channel_mults))
    if bott < patch_size or bott % patch_size:
        raise ValueError(
            f"TransUnet bottleneck size {bott} (image {image_size}, "
            f"{len(channel_mults)} levels) is incompatible with "
            f"patch_size={patch_size}; use e.g. --channel-mults "
            f"1,2,2,4,4 (the reference crashes on this too, "
            f"trans_unet.py:77)")


class BottleneckDown(nn.Module):
    def __init__(self, in_channels: int, features: int, generator=None,
                 device=None):
        super().__init__()
        width = in_channels // 4
        # every convolution is read by a BatchNorm: the float32 product
        args = dict(bias=False, generator=generator, device=device,
                    float32_sum=True)
        self.decode = nn.Sequential(
            Conv(in_channels, width, 1, **args),
            BatchNorm(width, device=device), nn.ReLU(),
            Conv(width, width, 3, stride=2, padding=1, **args),
            BatchNorm(width, device=device), nn.ReLU(),
            Conv(width, features, 1, **args),
            BatchNorm(features, device=device))
        self.skip = nn.Sequential(
            Conv(in_channels, features, 1, stride=2, **args),
            BatchNorm(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.decode(x)
        return torch.relu(h + self.skip(x))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              dropout: nn.Module) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(D)) v`` over ``(N, H, T, D)`` heads, as
    ``pai_tpu/models/trans_unet.py:89-97`` computes it: both products summed
    in float32 from the operands' values (``preferred_element_type``), the
    softmax in float32, its weights and the result rounded to the operands'
    dtype; ``dropout`` on the rounded weights."""
    with torch.autocast(device_type=q.device.type, enabled=False):
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        weights = torch.softmax(logits / math.sqrt(q.shape[-1]), dim=-1)
        weights = dropout(weights.to(q.dtype))
        return torch.matmul(weights.float(), v.float()).to(q.dtype)


class SelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``) over ``(N, T, D)`` tokens of one
    sample each."""

    def __init__(self, dim: int, num_heads: int, dropout: float,
                 generator=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim, device=device))
        if not self.in_proj_weight.is_meta:  # N(0, 0.02), zero bias
            with torch.no_grad():
                self.in_proj_weight.normal_(0.0, 0.02, generator=generator)
                self.in_proj_bias.zero_()
        self.out_proj = Dense(dim, dim, generator=generator, device=device)
        self.dropout = Dropout(dropout, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        qkv = _bias_after_rounding(nn.functional.linear, x,
                                   self.in_proj_weight, self.in_proj_bias,
                                   (-1,))
        q, k, v = (a.reshape(n, t, self.num_heads, -1).transpose(1, 2)
                   for a in qkv.split(d, dim=-1))
        attn = attention(q, k, v, self.dropout)
        return self.out_proj(attn.transpose(1, 2).reshape(n, t, d))


class TransformerLayer(nn.Module):
    """Post-LN torch ``nn.TransformerEncoderLayer`` (exact GELU, FFN
    ``ffn_dim``)."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_dim: int = 2048,
                 dropout: float = 0.0, generator=None, device=None):
        super().__init__()
        args = dict(generator=generator, device=device)
        self.self_attn = SelfAttention(dim, num_heads, dropout, **args)
        self.linear1 = Dense(dim, ffn_dim, **args)
        self.linear2 = Dense(ffn_dim, dim, **args)
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.dropout = Dropout(dropout, generator=generator)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under bf16 each branch ends rounded to bfloat16, and its residual
        # sum is taken in float32 for the LayerNorm that reads it, as XLA
        # compiles pai_tpu's layer (tests/test_torch_port_bf16.py)
        x = self.norm1(x.float() + self.dropout1(self.self_attn(x)).float())
        h = self.dropout(gelu(self.linear1(x)))
        return self.norm2(x.float() + self.dropout2(self.linear2(h)).float())


class Patchify(nn.Module):
    """``(N, C, H, W)`` -> ``(N, (H/p)(W/p), p p C)``: row-major patches,
    each flattened row-major with the channels last."""

    def __init__(self, patch_size: int):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, hh, ww = x.shape
        p = self.patch_size
        h = x.permute(0, 2, 3, 1).reshape(n, hh // p, p, ww // p, p, c)
        return h.transpose(2, 3).reshape(n, (hh // p) * (ww // p), p * p * c)


class Transformer(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class VisionTransformer(nn.Module):
    """Over a ``(N, C, size, size)`` map; ``size`` fixes the number of
    patches, and so the positional embedding's shape."""

    def __init__(self, channels: int, size: int, patch_size: int = 4,
                 num_heads: int = 8, dropout: float = 0.0,
                 num_layers: int = VIT_LAYERS, generator=None, device=None):
        super().__init__()
        args = dict(generator=generator, device=device)
        dim = channels * patch_size * patch_size
        self.patch_size = patch_size
        self.to_patch_embedding = nn.Sequential(
            Patchify(patch_size), LayerNorm(dim, device=device),
            Dense(dim, dim, float32_sum=True, **args),
            LayerNorm(dim, device=device))
        self.pos_embedding = nn.Parameter(torch.empty(
            1, (size // patch_size) ** 2, dim, device=device))
        if not self.pos_embedding.is_meta:
            with torch.no_grad():
                self.pos_embedding.normal_(0.0, 1.0, generator=generator)
        self.transformer = Transformer(
            TransformerLayer(dim, num_heads, 2048, dropout, **args)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, hh, ww = x.shape
        p = self.patch_size
        h = self.to_patch_embedding(x)
        h = self.transformer(h + self.pos_embedding.to(h.dtype))
        h = h.reshape(n, hh // p, ww // p, p, p, c).transpose(2, 3)
        return h.reshape(n, hh, ww, c).permute(0, 3, 1, 2)


class ConvDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, generator=None,
                 device=None):
        super().__init__()
        args = dict(generator=generator, device=device, float32_sum=True)
        self.decode = nn.Sequential(
            Conv(in_channels, features, 3, padding=1, **args),
            BatchNorm(features, device=device), nn.ReLU(),
            Conv(features, features, 3, padding=1, **args),
            BatchNorm(features, device=device), nn.ReLU(),
            UpsampleNearest2x())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(x)


class TransUnet(nn.Module):
    """``image_size`` fixes the ViT's number of patches; ``vit_layers`` its
    depth (12 in the published configuration); the other arguments as
    ``Pix2PixUnet``'s."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 image_size: int = 256,
                 channel_mults: Sequence[int] = (1, 2, 2, 4, 4),
                 patch_size: int = 4, num_heads: int = 8,
                 dropout: float = 0.0, vit_layers: int = VIT_LAYERS,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        mults = tuple(channel_mults)
        validate(image_size, mults, patch_size)
        args = dict(generator=generator, device=device)
        self.channel_mults = mults
        self.compute_dtype = dtype
        n = len(mults)
        self.in_conv = Conv(in_channels, 64, 3, padding=1, **args)
        widths = [64] + [m * 64 for m in mults]
        self.encoders = nn.ModuleList(
            BottleneckDown(widths[level], widths[level + 1], **args)
            for level in range(n))
        self.vit_bottleneck = VisionTransformer(
            widths[-1], image_size // 2 ** n, patch_size, num_heads, dropout,
            vit_layers, **args)
        rev = mults[-2::-1]
        decoders = [ConvDecoderBlock(
            rev[i - 1] * 64 * 2 if i else widths[-1], rev[i] * 64, **args)
            for i in range(n - 1)]
        decoders.append(ConvDecoderBlock(
            mults[0] * 64 * 2 if n > 1 else widths[-1], 64, **args))
        self.decoders = nn.ModuleList(decoders)
        self.out = nn.Sequential(Conv(64, out_channels, 3, padding=1,
                                      float32_sum=True, **args))
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C_in) -> (N, H, W, C_out) float32 in [-1, 1]."""
        h = x.permute(0, 3, 1, 2)
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            h = self.in_conv(h)
            skips = []
            for encoder in self.encoders:
                h = encoder(h)
                skips.append(h)
            skips.pop()  # the innermost feature map goes through the ViT
            h = self.vit_bottleneck(h)
            for i, decoder in enumerate(self.decoders):
                if i != 0:
                    h = torch.cat([h, skips.pop()], dim=1)
                h = decoder(h)
            h = self.out(h)
        return torch.tanh(h.float()).permute(0, 2, 3, 1)
