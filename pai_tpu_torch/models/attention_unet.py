"""Attention U-Net (Oktay et al. 2018), counterpart of
``pai_tpu/models/attention_unet.py``: the Pix2Pix topology with an additive
attention gate on every skip connection.

* Encoders and decoders are Pix2Pix's (``models/pix2pix.py``), dropout in the
  same three deepest widest decoders.
* A gate projects the skip and the decoder signal with a 1x1 convolution and
  a BatchNorm each, takes the ReLU of their sum, and makes a one-channel
  mask through another 1x1 convolution, a BatchNorm and a sigmoid; the skip
  times the mask is what the decoder concatenates. A gate has half the
  skip's channels.

Parameters carry the reference's torch names: Pix2Pix's, plus
``attention_blocks.j.{input_gate,signal_gate,attention}.{0,1}`` (convolution,
BatchNorm); gate ``j`` serves decoder ``j + 1``, the last one the head.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pai_tpu_torch.models.pix2pix import Pix2PixUnet
from pai_tpu_torch.ops import BatchNorm, Conv, sigmoid


def _projection(in_channels: int, features: int, generator, device
                ) -> nn.Sequential:
    return nn.Sequential(
        Conv(in_channels, features, kernel_size=1, generator=generator,
             device=device, float32_sum=True),
        BatchNorm(features, device=device))


class AttentionGate(nn.Module):
    def __init__(self, channels: int, attention_channels: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.input_gate = _projection(channels, attention_channels,
                                      generator, device)
        self.signal_gate = _projection(channels, attention_channels,
                                       generator, device)
        self.attention = _projection(attention_channels, 1, generator,
                                     device)

    def forward(self, x: torch.Tensor, signal: torch.Tensor) -> torch.Tensor:
        h_input = self.input_gate(x)
        h = torch.relu(self.signal_gate(signal) + h_input)
        return x * sigmoid(self.attention(h))


class AttentionUnet(Pix2PixUnet):
    """Arguments as ``Pix2PixUnet``'s."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8, 8, 8, 8),
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(in_channels, out_channels, channel_mults, dropout,
                         dtype, generator, device)
        # decoder j + 1 gates the skip of level n - 2 - j, as wide as the
        # decoder's input h; the head gates the stem's
        widths = [m * 64 for m in self.channel_mults[-2::-1]]
        self.attention_blocks = nn.ModuleList(
            AttentionGate(c, c // 2, generator=generator, device=device)
            for c in widths)
        self.to(memory_format=torch.channels_last)

    def skip(self, i: int, feature: torch.Tensor, h: torch.Tensor
             ) -> torch.Tensor:
        return self.attention_blocks[i - 1](feature, h)
