"""Pix2Pix U-Net generator (Isola et al. 2018), counterpart of
``pai_tpu/models/pix2pix.py``.

* Levels with channels ``64 * mult`` (default mults (1,2,4,8,8,8,8,8)).
* The stem is a bare Conv(k4,s2,p1); an encoder block is LeakyReLU(0.2) ->
  Conv(k4,s2,p1) -> BatchNorm, with no norm on the innermost level.
* A decoder block is ReLU -> ConvTranspose(k4,s2,p1) -> BatchNorm ->
  Dropout2d, dropout only in the three deepest widest decoders.
* Skips concatenate ``[h, skip]``; the innermost feature is not a skip; the
  head is a bare ConvTranspose to ``out_channels`` followed by tanh in
  float32.

The public interface is NHWC like the JAX module. Inside, tensors are NCHW in
``torch.channels_last`` memory format, which is the same bytes: the permute at
either end moves nothing. Parameters carry the reference's torch names
(``encoders.0.weight``, ``encoders.L.encode.1.weight``,
``encoders.L.encode.2.running_mean``, ``decoders.i.decode.1.weight``, ...), so
a reference ``state_dict`` (minus its ``unet.`` prefix) loads as it is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pai_tpu_torch.ops import (BatchNorm, Conv, ConvTranspose, Dropout2d,
                               LeakyReLU)


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, norm: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        layers = [LeakyReLU(0.2),
                  Conv(in_channels, features, kernel_size=4, stride=2,
                       padding=1, generator=generator, device=device,
                       float32_sum=norm)]
        if norm:
            layers.append(BatchNorm(features, device=device))
        self.encode = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x)


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.decode = nn.Sequential(
            nn.ReLU(),
            ConvTranspose(in_channels, features, kernel_size=4, stride=2,
                          padding=1, generator=generator, device=device,
                          float32_sum=True),
            BatchNorm(features, device=device),
            Dropout2d(dropout, generator=generator),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(x)


def dropout_for_level(level: int, mult: int, channel_mults: Sequence[int],
                      dropout: float) -> float:
    """Dropout only in the three deepest widest decoders: mult == max(mults)
    and level > len(mults) - 5."""
    if mult == max(channel_mults) and level > len(channel_mults) - 5:
        return dropout
    return 0.0


class Pix2PixUnet(nn.Module):
    """``generator`` seeds the N(0, 0.02) init and the dropout masks; it must
    live on ``device``. ``dtype`` is the compute dtype: ``torch.bfloat16``
    runs the convolutions under autocast with float32 parameters, rounded
    where the JAX module rounds under ``jit`` (``ops/layers.py``): a
    convolution read by a BatchNorm or by the float32 tanh hands it the
    float32 sum of its rounded product and bias."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8, 8, 8, 8),
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        mults = tuple(channel_mults)
        if len(mults) < 2:
            raise ValueError("Pix2PixUnet needs at least two levels")
        self.channel_mults = mults
        self.compute_dtype = dtype
        n = len(mults)

        encoders = [Conv(in_channels, mults[0] * 64, kernel_size=4, stride=2,
                         padding=1, generator=generator, device=device)]
        for level in range(1, n):
            encoders.append(EncoderBlock(
                mults[level - 1] * 64, mults[level] * 64,
                norm=level != n - 1, generator=generator, device=device))
        self.encoders = nn.ModuleList(encoders)

        decoders = []
        for i, level in enumerate(range(n - 2, -1, -1)):
            # decoder 0 takes the innermost feature alone; every later one
            # takes [previous decoder, skip], both mults[level + 1] * 64 wide
            in_ch = mults[level + 1] * 64 * (1 if i == 0 else 2)
            decoders.append(DecoderBlock(
                in_ch, mults[level] * 64,
                dropout=dropout_for_level(level, mults[level], mults,
                                          dropout),
                generator=generator, device=device))
        decoders.append(ConvTranspose(mults[0] * 64 * 2, out_channels,
                                      kernel_size=4, stride=2, padding=1,
                                      generator=generator, device=device,
                                      float32_sum=True))
        self.decoders = nn.ModuleList(decoders)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C_in) -> (N, H, W, C_out) float32 in [-1, 1]."""
        h = x.permute(0, 3, 1, 2)  # NHWC bytes seen as channels_last NCHW
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            feats = []
            for encoder in self.encoders:
                h = encoder(h)
                feats.append(h)
            feats.pop()  # the innermost feature map is not used as a skip
            for i, decoder in enumerate(self.decoders):
                if i != 0:
                    h = torch.cat([h, self.skip(i, feats.pop(), h)], dim=1)
                h = decoder(h)
        return torch.tanh(h.float()).permute(0, 2, 3, 1)

    def skip(self, i: int, feature: torch.Tensor, h: torch.Tensor
             ) -> torch.Tensor:
        """What decoder ``i`` (> 0) reads beside ``h``: here the encoder
        ``feature`` as it is; the attention U-Net gates it."""
        return feature
