"""Residual U-Net with four residual-block types, counterpart of
``pai_tpu/models/res_unet.py``.

* Blocks (``RES_BLOCKS``): "18", two 3x3 convolutions and a 1x1 projection
  skip; "50", the bottleneck 1x1 -> 3x3 -> 1x1 at a quarter of the input's
  width; "v2", pre-activation; "next", ResNeXt's bottleneck of width 4 x
  cardinality 32 with a grouped 3x3. The skip is projected where the width
  changes, else it is the input.
* The reference's quirks, kept: "v2" and "next" have no ReLU after the sum,
  and "next" keeps a trailing ReLU inside its branch.
* Stem 3x3 convolution to 64 channels; an encoder is a block then a 2x2 max
  pool (its output is the skip); a decoder a block, whole-channel dropout
  (only the three deepest widest) and a nearest 2x upsample; one more
  decoder without dropout after the last skip; a 3x3 head and tanh in
  float32.

Parameters carry the reference's torch names: ``in_conv``,
``encoders.L.encode.0.{conv_block,conv_skip}.k``,
``decoders.i.decode.0.{conv_block,conv_skip}.k``, ``out.0``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pai_tpu_torch.models.pix2pix import dropout_for_level
from pai_tpu_torch.ops import (BatchNorm, Conv, Dropout2d, max_pool_2x,
                               upsample_nearest_2x)
from pai_tpu_torch.ops.layers import round_to_compute


def _conv_bn(in_channels, features, kernel_size, generator, device,
             groups=1):
    """A convolution its BatchNorm reads (so the float32 sum under bf16)."""
    return [Conv(in_channels, features, kernel_size,
                 padding=kernel_size // 2, groups=groups, generator=generator,
                 device=device, float32_sum=True),
            BatchNorm(features, device=device)]


class _ResidualBlock(nn.Module):
    """``conv_block`` and, where the width changes, ``conv_skip``;
    ``post_relu``: a ReLU after the sum."""

    post_relu = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_block(x)
        h = h + (self.conv_skip(x) if self.conv_skip is not None
                 else round_to_compute(x))
        return torch.relu(h) if self.post_relu else h


class ResidualBlock18(_ResidualBlock):
    def __init__(self, in_channels: int, features: int, generator=None,
                 device=None):
        super().__init__()
        args = (generator, device)
        self.conv_block = nn.Sequential(
            *_conv_bn(in_channels, features, 3, *args), nn.ReLU(),
            *_conv_bn(features, features, 3, *args))
        self.conv_skip = nn.Sequential(*_conv_bn(
            in_channels, features, 1, *args)) \
            if in_channels != features else None


class ResidualBlock50(_ResidualBlock):
    def __init__(self, in_channels: int, features: int, generator=None,
                 device=None):
        super().__init__()
        args, width = (generator, device), in_channels // 4
        self.conv_block = nn.Sequential(
            *_conv_bn(in_channels, width, 1, *args), nn.ReLU(),
            *_conv_bn(width, width, 3, *args), nn.ReLU(),
            *_conv_bn(width, features, 1, *args))
        self.conv_skip = nn.Sequential(*_conv_bn(
            in_channels, features, 1, *args)) \
            if in_channels != features else None


class ResidualBlockV2(_ResidualBlock):
    post_relu = False

    def __init__(self, in_channels: int, features: int, generator=None,
                 device=None):
        super().__init__()
        args = (generator, device)
        self.conv_block = nn.Sequential(
            BatchNorm(in_channels, device=device), nn.ReLU(),
            *_conv_bn(in_channels, features, 3, *args), nn.ReLU(),
            Conv(features, features, 3, padding=1, generator=generator,
                 device=device))
        self.conv_skip = nn.Sequential(
            BatchNorm(in_channels, device=device), nn.ReLU(),
            Conv(in_channels, features, 1, generator=generator,
                 device=device)) if in_channels != features else None


class ResidualBlockNeXt(_ResidualBlock):
    post_relu = False

    def __init__(self, in_channels: int, features: int, generator=None,
                 device=None, cardinality: int = 32, bottleneck: int = 4):
        super().__init__()
        args, inner = (generator, device), bottleneck * cardinality
        self.conv_block = nn.Sequential(
            *_conv_bn(in_channels, inner, 1, *args), nn.ReLU(),
            *_conv_bn(inner, inner, 3, *args, groups=cardinality), nn.ReLU(),
            *_conv_bn(inner, features, 1, *args), nn.ReLU())
        self.conv_skip = nn.Sequential(*_conv_bn(
            in_channels, features, 1, *args)) \
            if in_channels != features else None


RES_BLOCKS = {
    "18": ResidualBlock18,
    "50": ResidualBlock50,
    "v2": ResidualBlockV2,
    "next": ResidualBlockNeXt,
}


class MaxPool2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2x(x)


class UpsampleNearest2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest_2x(x)


class ResUnet(nn.Module):
    """``res_type`` selects the block (``RES_BLOCKS``); the other arguments
    as ``Pix2PixUnet``'s."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 res_type: str = "18",
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8, 8, 8, 8),
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        mults = tuple(channel_mults)
        block = RES_BLOCKS[res_type]
        args = dict(generator=generator, device=device)
        self.channel_mults = mults
        self.compute_dtype = dtype
        n = len(mults)
        # "v2" opens with a BatchNorm, which reads the stem's float32 sum
        # under bf16; the identity skip rounds it (_ResidualBlock)
        self.in_conv = Conv(in_channels, 64, 3, padding=1,
                            float32_sum=res_type == "v2", **args)
        widths = [64] + [m * 64 for m in mults]
        self.encoders = nn.ModuleList(
            nn.ModuleDict({"encode": nn.Sequential(
                block(widths[level], widths[level + 1], **args),
                MaxPool2x())}) for level in range(n))
        decoders = []
        for i, level in enumerate(range(n - 2, -1, -1)):
            in_ch = mults[level + 1] * 64 * (1 if i == 0 else 2)
            rate = dropout_for_level(level, mults[level], mults, dropout)
            decoders.append(nn.ModuleDict({"decode": nn.Sequential(
                block(in_ch, mults[level] * 64, **args),
                Dropout2d(rate, generator=generator),
                UpsampleNearest2x())}))
        decoders.append(nn.ModuleDict({"decode": nn.Sequential(
            block(mults[0] * 64 * 2, mults[0] * 64, **args),
            UpsampleNearest2x())}))
        self.decoders = nn.ModuleList(decoders)
        self.out = nn.Sequential(Conv(mults[0] * 64, out_channels, 3,
                                      padding=1, float32_sum=True, **args))
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
                h = encoder["encode"](h)
                skips.append(h)
            skips.pop()  # the innermost feature map is not used as a skip
            for i, decoder in enumerate(self.decoders):
                if i != 0:
                    h = torch.cat([h, skips.pop()], dim=1)
                h = decoder["decode"](h)
            h = self.out(h)
        return torch.tanh(h.float()).permute(0, 2, 3, 1)
