"""PatchGAN discriminator, counterpart of ``pai_tpu/models/discriminator.py``.

Four stride-2 blocks (64 -> 128 -> 256 -> 512 channels, Conv k4 s2 p1, an
optional InstanceNorm, LeakyReLU 0.2), then a 1-channel k4 s1 p1 head conv
without bias that gives the patch logits, in float32. The input is the
channel concatenation of the condition and the (real or generated) image, so
``in_channels`` is their channel count together (2 for the grayscale CLIs).

As in the JAX package (and the reference it follows), no block has a norm by
default: ``use_norm=True`` puts InstanceNorm in blocks 2-4, never the first.
Parameter names are the reference's: ``discriminator.{0..3}.block.0.*`` and
the head ``discriminator.4.weight``. The public interface is NHWC like the
JAX module's; inside, NCHW in ``channels_last`` memory.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pai_tpu_torch.ops import Conv, InstanceNorm, LeakyReLU

FEATURES = (64, 128, 256, 512)


class DiscriminatorBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, norm: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        layers = [Conv(in_channels, features, kernel_size=4, stride=2,
                       padding=1, generator=generator, device=device,
                       float32_sum=norm)]
        if norm:
            layers.append(InstanceNorm())
        layers.append(LeakyReLU(0.2))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Discriminator(nn.Module):
    """``generator`` seeds the N(0, 0.02) init and must live on ``device``.
    ``dtype`` is the compute dtype: ``torch.bfloat16`` runs the convolutions
    under autocast with float32 parameters, as the generators do."""

    def __init__(self, in_channels: int = 2, use_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.compute_dtype = dtype
        layers, width = [], in_channels
        for i, features in enumerate(FEATURES):
            layers.append(DiscriminatorBlock(
                width, features, norm=use_norm and i > 0,
                generator=generator, device=device))
            width = features
        layers.append(Conv(width, 1, kernel_size=4, stride=1, padding=1,
                           generator=generator, device=device, bias=False))
        self.discriminator = nn.Sequential(*layers)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (N, H, W, C) -> patch logits (N, H/16 - 1, W/16 - 1, 1),
        float32."""
        h = torch.cat([x, y], dim=-1).permute(0, 3, 1, 2)
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(device_type=h.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            h = self.discriminator(h)
        return h.float().permute(0, 2, 3, 1)
