"""Layers of the Pix2Pix family and of the diffusion UNet, counterparts of
``pai_tpu/ops/layers.py``. Inside a model tensors are NCHW in
``channels_last`` memory, so the layers and the pooling functions here take
NCHW.

* ``Conv`` — ``nn.Conv2d`` (the generator uses k4 s2 p1), OIHW weight.
* ``ConvTranspose`` — ``nn.ConvTranspose2d`` k4 s2 p1, weight
  ``(in, out, kh, kw)``. The JAX package stores the same kernel un-flipped as
  ``(kh, kw, in, out)`` and flips it when it applies it, so the torch weight
  is a transpose of the JAX one with no flip.
* ``Dense`` — ``nn.Linear``, weight ``(out, in)``.
* ``BatchNorm`` — torch defaults (eps 1e-5, momentum 0.1), always computed in
  float32 whatever the compute dtype, and cast back. Takes NCHW, or token
  tensors ``(N, L, C)`` (the reference's ``BatchNorm1d``), normalising every
  axis but the channels.
* ``Dropout2d`` — whole-channel dropout; rate 0 is the identity.
* ``leaky_relu`` — slope 0.2; ``silu`` — ``x * sigmoid(x)``.
* ``avg_pool_2x`` / ``upsample_nearest_2x`` — ``nn.AvgPool2d(2)`` and nearest
  ``nn.Upsample(scale_factor=2)`` on NCHW.
* ``gamma_embedding`` — sinusoidal embedding of noise levels, [cos | sin].

Two init modes, both drawing from an explicit ``torch.Generator``:
``"normal002"`` (the GAN families: the reference's ``init_weights``, weights
N(0, 0.02), zero biases — zero bias is the JAX package's documented deviation,
kept) and ``"torch"`` (the diffusion UNet, which the reference never
re-initialises: weight and bias both U(+-1/sqrt(fan_in))). The remaining
layers of the JAX module (InstanceNorm, LayerNorm, max_pool_2x) arrive with
the slices that use them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _init_normal(module: nn.Module, generator: Optional[torch.Generator]
                 ) -> None:
    """N(0, 0.02) weight, zero bias. A module on the ``meta`` device has no
    storage and is left alone."""
    if module.weight.is_meta:
        return
    with torch.no_grad():
        module.weight.normal_(0.0, 0.02, generator=generator)
        module.bias.zero_()


def _init_torch(module: nn.Module, generator: Optional[torch.Generator]
                ) -> None:
    """torch's own default for ``nn.Conv2d``/``nn.Linear``: weight and bias
    both U(+-1/sqrt(fan_in)), fan_in = in_features x kernel area."""
    if module.weight.is_meta:
        return
    bound = 1.0 / math.sqrt(module.weight[0].numel())
    with torch.no_grad():
        module.weight.uniform_(-bound, bound, generator=generator)
        module.bias.uniform_(-bound, bound, generator=generator)


def _init(module: nn.Module, init_mode: str,
          generator: Optional[torch.Generator]) -> None:
    if init_mode == "torch":
        _init_torch(module, generator)
    elif init_mode == "normal002":
        _init_normal(module, generator)
    else:
        raise ValueError(f"unknown init_mode '{init_mode}'")


class Conv(nn.Conv2d):
    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0,
                 init_mode: str = "normal002",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(in_channels, features, kernel_size, stride, padding,
                         device=device)
        _init(self, init_mode, generator)


class Dense(nn.Linear):
    def __init__(self, in_features: int, features: int,
                 init_mode: str = "normal002",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(in_features, features, device=device)
        _init(self, init_mode, generator)


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
    train-mode outputs are the same function in both. ``momentum`` is torch's
    (the weight of the new batch): flax's 0.9 is 0.1 here."""

    def __init__(self, features: int, momentum: float = 0.1, device=None):
        super().__init__(features, eps=1e-5, momentum=momentum, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x.dim() == 3
        if tokens:  # (N, L, C) seen as channels_last (N, C, L, 1): no copy
            x = x.transpose(1, 2).unsqueeze(-1)
        with torch.autocast(device_type=x.device.type, enabled=False):
            y = super().forward(x.float()).to(x.dtype)
        return y.squeeze(-1).transpose(1, 2) if tokens else y


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


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.AvgPool2d(2)`` on NCHW."""
    return nn.functional.avg_pool2d(x, 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2)`` (nearest) on NCHW."""
    return nn.functional.interpolate(x, scale_factor=2, mode="nearest")


def gamma_embedding(gammas: torch.Tensor, dim: int,
                    max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding ``(N, dim)`` of fractional noise levels, [cos |
    sin] order, zero-padded if ``dim`` is odd."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=gammas.device) / half)
    args = gammas.reshape(-1).float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
