"""Layers of the Pix2Pix family, counterparts of ``pai_tpu/ops/layers.py``.

* ``Conv`` — ``nn.Conv2d`` (the generator uses k4 s2 p1), OIHW weight.
* ``ConvTranspose`` — ``nn.ConvTranspose2d`` k4 s2 p1, weight
  ``(in, out, kh, kw)``. The JAX package stores the same kernel un-flipped as
  ``(kh, kw, in, out)`` and flips it when it applies it, so the torch weight
  is a transpose of the JAX one with no flip.
* ``BatchNorm`` — torch defaults (eps 1e-5, momentum 0.1), always computed in
  float32 whatever the compute dtype, and cast back.
* ``Dropout2d`` — whole-channel dropout; rate 0 is the identity.
* ``leaky_relu`` — slope 0.2.

Weights are drawn N(0, 0.02) with zero biases from an explicit
``torch.Generator`` (the reference's ``init_weights``; zero bias is the JAX
package's documented deviation, kept). The remaining layers of the JAX module
(InstanceNorm, Dense, LayerNorm, pools, upsample, gamma embedding) arrive with
the slices that use them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def _init_normal(module: nn.Module, generator: Optional[torch.Generator]
                 ) -> None:
    """N(0, 0.02) weight, zero bias. A module on the ``meta`` device has no
    storage and is left alone."""
    if module.weight.is_meta:
        return
    with torch.no_grad():
        module.weight.normal_(0.0, 0.02, generator=generator)
        module.bias.zero_()


class Conv(nn.Conv2d):
    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(in_channels, features, kernel_size, stride, padding,
                         device=device)
        _init_normal(self, generator)


class ConvTranspose(nn.ConvTranspose2d):
    """``out = (in - 1) * s - 2p + k``: exactly 2x for k4 s2 p1."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(in_channels, features, kernel_size, stride, padding,
                         device=device)
        _init_normal(self, generator)


class BatchNorm(nn.BatchNorm2d):
    """Running variance follows torch (unbiased update); the JAX package
    keeps the biased one, a deviation it documents. Eval-mode outputs and
    train-mode outputs are the same function in both."""

    def __init__(self, features: int, device=None):
        super().__init__(features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(device_type=x.device.type, enabled=False):
            return super().forward(x.float()).to(x.dtype)


class Dropout2d(nn.Module):
    """One Bernoulli draw per (sample, channel), broadcast over H and W, from
    the module's own generator (the global one when none was given)."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0], x.shape[1], 1, 1), dtype=x.dtype,
                           device=x.device)
        mask.bernoulli_(keep, generator=self.generator)
        return x * (mask / keep)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
