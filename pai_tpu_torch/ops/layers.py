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
  axis but the channels. The running variance follows the JAX package (the
  biased batch variance), not torch's unbiased update.
* ``InstanceNorm`` — ``nn.InstanceNorm2d`` with torch's defaults (no affine,
  no running statistics, eps 1e-5), in float32 and cast back; the PatchGAN's
  optional norm.
* ``Dropout`` — elementwise dropout (the diffusion ResBlock's); ``Dropout2d``
  — whole-channel dropout. Both draw from an explicit ``torch.Generator``;
  rate 0 is the identity.
* ``LayerNorm`` — ``nn.LayerNorm`` (eps 1e-5, affine) over the last axis,
  computed in float32 whatever the compute dtype, and cast back.
* ``leaky_relu`` / ``LeakyReLU`` — slope 0.2; ``sigmoid``; ``silu`` /
  ``SiLU`` — ``x * sigmoid(x)``; ``gelu`` — the exact (erf) GELU.
* ``max_pool_2x`` / ``avg_pool_2x`` / ``upsample_nearest_2x`` —
  ``nn.MaxPool2d(2)``, ``nn.AvgPool2d(2)`` and nearest
  ``nn.Upsample(scale_factor=2)`` on NCHW.
* ``gamma_embedding`` — sinusoidal embedding of noise levels, [cos | sin].

bfloat16 (``--precision bf16-mixed``: autocast, float32 parameters) rounds
where the JAX package rounds when XLA runs it at ``dtype=bfloat16``: a
convolution or dense product is rounded to bfloat16 before its bfloat16 bias
is added (``_bias_after_rounding``); ``sigmoid``, ``silu``, ``gelu``,
``leaky_relu`` and ``avg_pool_2x`` of a bfloat16 tensor round after every op
XLA emits for them. Float32 takes one library call per layer, bias inside,
as before.

Two init modes, both drawing from an explicit ``torch.Generator``:
``"normal002"`` (the GAN families: the reference's ``init_weights``, weights
N(0, 0.02), zero biases — zero bias is the JAX package's documented deviation,
kept) and ``"torch"`` (the diffusion UNet, which the reference never
re-initialises: weight and bias both U(+-1/sqrt(fan_in)); a grouped
convolution's fan-in is that of one group).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pai_tpu_torch.parallel.mesh import draw_rows


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar (weakly
    typed) before an op with an array of that dtype; made on the host."""
    return torch.tensor(value, dtype=dtype).item()


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """The slope is rounded to ``x``'s dtype first (0.2001953125 in bfloat16,
    ``pai_tpu/ops/layers.py:67-68``); the product is rounded once."""
    return nn.functional.leaky_relu(x, weak_scalar(negative_slope, x.dtype))


class LeakyReLU(nn.LeakyReLU):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """In bfloat16 as XLA computes ``jax.nn.sigmoid``: expanded to ``1 / (1 +
    exp(-x))``, rounded after the exp, the add and the division; outside
    autocast, which on CUDA would run the exp and the division in
    float32."""
    if x.dtype == torch.bfloat16:
        with torch.autocast(x.device.type, enabled=False):
            return torch.reciprocal(1 + torch.exp(-x))
    return torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` (``pai_tpu/ops/layers.py:71-73``); in bfloat16 the
    product is rounded once more, outside autocast."""
    if x.dtype == torch.bfloat16:
        with torch.autocast(x.device.type, enabled=False):
            return x * sigmoid(x)
    return nn.functional.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU. In bfloat16 as XLA computes
    ``jax.nn.gelu(approximate=False)``, ``0.5 * x * erfc(-x * sqrt(0.5))``
    with ``sqrt(0.5)`` rounded to bfloat16: the erfc's argument is kept in
    float32 (its only reader is float32), the erfc and the final product
    are rounded; outside autocast."""
    if x.dtype == torch.bfloat16:
        with torch.autocast(x.device.type, enabled=False):
            half = weak_scalar(math.sqrt(0.5), x.dtype)
            erfc = torch.special.erfc(-x.float() * half)
            return (0.5 * x) * erfc.to(torch.bfloat16)
    return nn.functional.gelu(x)


class SiLU(nn.SiLU):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(x)


def _init_normal(module: nn.Module, generator: Optional[torch.Generator]
                 ) -> None:
    """N(0, 0.02) weight, zero bias (where there is one). A module on the
    ``meta`` device has no storage and is left alone."""
    if module.weight.is_meta:
        return
    with torch.no_grad():
        module.weight.normal_(0.0, 0.02, generator=generator)
        if module.bias is not None:
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


def _init_zeros(module: nn.Module) -> None:
    """Zero weight and bias (guided_diffusion ``zero_module``)."""
    if module.weight.is_meta:
        return
    with torch.no_grad():
        module.weight.zero_()
        module.bias.zero_()


def _init(module: nn.Module, init_mode: str,
          generator: Optional[torch.Generator]) -> None:
    if init_mode == "torch":
        _init_torch(module, generator)
    elif init_mode == "normal002":
        _init_normal(module, generator)
    elif init_mode == "zeros":
        _init_zeros(module)
    else:
        raise ValueError(f"unknown init_mode '{init_mode}'")


def bf16_autocast(x: torch.Tensor) -> bool:
    """Whether bfloat16 autocast is on for ``x``'s device."""
    device = x.device.type
    return (torch.is_autocast_enabled(device)
            and torch.get_autocast_dtype(device) == torch.bfloat16)


def round_to_compute(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 under bfloat16 autocast, else as it is: the
    rounding of a sum that XLA held in float32 for a float32 reader, made
    where a bfloat16 op reads it (see ``_bias_after_rounding``)."""
    return x.to(torch.bfloat16) if bf16_autocast(x) else x


def _bias_after_rounding(op, x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, bias_shape,
                         float32_sum: bool = False) -> torch.Tensor:
    """``op(x, weight, bias)``, a convolution or linear map. Under bfloat16
    autocast it rounds as the JAX layers do (``pai_tpu/ops/layers.py:111-113,
    150-154``, flax ``nn.Dense``, ``pai_tpu/models/diffusion_unet.py:66``):
    the product without bias is rounded to bfloat16, then the bias, rounded
    to bfloat16, is added by a separate add. That add rounds to bfloat16
    again, unless ``float32_sum``: where a reader casts the sum to float32
    (a BatchNorm, a model's float32 output), XLA drops that rounding for it,
    so the float32 sum is returned, and a bfloat16 reader rounds it
    (``round_to_compute``). Without a bias and with ``float32_sum``, that
    reader gets the product itself unrounded: the float32 sum of the
    bfloat16 operands' products, taken here in float32 (TF32 on the card,
    which holds a bfloat16 value exactly). Otherwise one call with the bias
    inside."""
    if not bf16_autocast(x):
        return op(x, weight, bias)
    if bias is None:
        if not float32_sum:
            return op(x, weight, None)
        with torch.autocast(x.device.type, enabled=False):
            return op(x.to(torch.bfloat16).float(),
                      weight.to(torch.bfloat16).float(), None)
    y = op(x, weight, None)
    b = bias.to(y.dtype).view(bias_shape)
    return y.float() + b.float() if float32_sum else y + b


def _tp_split(layer: nn.Module, x: torch.Tensor, op) -> torch.Tensor:
    """``op(x, weight, bias)`` of a convolution, bias rounded as
    ``_bias_after_rounding`` rounds it. Where tensor parallelism split the
    kernel on its output channels (``layer.tp_shard``), this rank computes
    its share of them from the whole input (whose gradient is summed over
    the tp group) and the ranks' shares are gathered (whose gradient is this
    rank's share)."""
    shard = layer.tp_shard
    if shard is None:
        return _bias_after_rounding(op, x, layer.weight, layer.bias,
                                    (-1, 1, 1), layer.float32_sum)
    from pai_tpu_torch.parallel.distributed import copy_to_group, gather_dim

    per = shard.full // shard.size
    bias = None if layer.bias is None \
        else copy_to_group(layer.bias, shard.group).narrow(
            0, shard.rank * per, per)
    y = _bias_after_rounding(op, copy_to_group(x, shard.group), layer.weight,
                             bias, (-1, 1, 1), layer.float32_sum)
    y = gather_dim(y, shard.group, 1)
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y


class Conv(nn.Conv2d):
    """``float32_sum``: a BatchNorm or a float32 output reads the output, so
    under bfloat16 autocast it is the float32 sum of the rounded product and
    bias (``_bias_after_rounding``). ``bias=False``: no bias (the PatchGAN's
    head, TransUNet's encoder). ``groups``: a grouped convolution
    (ResNeXt's 3x3, cardinality 32)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0,
                 init_mode: str = "normal002",
                 generator: Optional[torch.Generator] = None, device=None,
                 float32_sum: bool = False, bias: bool = True,
                 groups: int = 1):
        super().__init__(in_channels, features, kernel_size, stride, padding,
                         groups=groups, bias=bias, device=device)
        self.float32_sum = float32_sum
        _init(self, init_mode, generator)

    tp_shard = None  # set by parallel.partitioning when the kernel is split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _tp_split(self, x, self._conv_forward)


class Dense(nn.Linear):
    """``float32_sum`` as for ``Conv``."""

    def __init__(self, in_features: int, features: int,
                 init_mode: str = "normal002",
                 generator: Optional[torch.Generator] = None, device=None,
                 float32_sum: bool = False):
        super().__init__(in_features, features, device=device)
        self.float32_sum = float32_sum
        _init(self, init_mode, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bias_after_rounding(nn.functional.linear, x, self.weight,
                                    self.bias, (-1,), self.float32_sum)


class ConvTranspose(nn.ConvTranspose2d):
    """``out = (in - 1) * s - 2p + k``: exactly 2x for k4 s2 p1.
    ``float32_sum`` as for ``Conv``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1,
                 generator: Optional[torch.Generator] = None, device=None,
                 float32_sum: bool = False):
        super().__init__(in_channels, features, kernel_size, stride, padding,
                         device=device)
        self.float32_sum = float32_sum
        _init_normal(self, generator)

    tp_shard = None  # set by parallel.partitioning when the kernel is split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def op(x, weight, bias):
            return nn.functional.conv_transpose2d(
                x, weight, bias, self.stride, self.padding,
                self.output_padding, self.groups, self.dilation)

        return _tp_split(self, x, op)


class BatchNorm(nn.BatchNorm2d):
    """Train mode normalises with the batch mean and the biased batch
    variance, as torch and the JAX package both do, and moves the running
    statistics toward the batch mean and the *biased* batch variance, as the
    JAX package does (flax's ``BatchNorm``; torch's own module would take the
    unbiased one, n/(n-1) larger). ``momentum`` is torch's (the weight of the
    new batch): flax's 0.9 is 0.1 here. Eval mode reads the running
    statistics only."""

    def __init__(self, features: int, momentum: float = 0.1, device=None):
        super().__init__(features, eps=1e-5, momentum=momentum, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x.dim() == 3
        if tokens:  # (N, L, C) seen as channels_last (N, C, L, 1): no copy
            x = x.transpose(1, 2).unsqueeze(-1)
        bf16 = x.dtype == torch.bfloat16 or bf16_autocast(x)
        if self.training:
            from pai_tpu_torch.parallel.mesh import dp_of_context

            dp, _, group = dp_of_context()
            if dp > 1:
                y = self._global_batch_norm(x, bf16, group)
                return y.squeeze(-1).transpose(1, 2) if tokens else y
        if self.training and x.numel() == x.shape[1]:
            y = self._one_value_per_channel(x, bf16)
            return y.squeeze(-1).transpose(1, 2) if tokens else y
        if bf16 and not self.training:
            y = self._flax_normalize(x)
            return y.squeeze(-1).transpose(1, 2) if tokens else y
        update = self.training and self.track_running_stats
        if update:
            old_var = self.running_var.clone()
        with torch.autocast(device_type=x.device.type, enabled=False):
            y = super().forward(x.float()).to(
                torch.bfloat16 if bf16 else x.dtype)
        if update:
            # torch moved running_var toward v*n/(n-1) with weight m; the
            # same step toward v is (n-1)/n of that plus (1-m)/n of the old.
            # Through .data: autograd holds the buffer as an input of the
            # op above (its backward never reads it), and an in-place change
            # of the tensor itself would fail its version check.
            n = x.numel() // x.shape[1]
            m = self.momentum if self.momentum is not None \
                else 1.0 / float(self.num_batches_tracked)
            self.running_var.data.mul_((n - 1) / n).add_(old_var,
                                                         alpha=(1 - m) / n)
        return y.squeeze(-1).transpose(1, 2) if tokens else y

    def _global_batch_norm(self, x: torch.Tensor, bf16: bool, group
                           ) -> torch.Tensor:
        """Train mode on a dp group: the statistics of the global batch, as
        XLA computes flax's ``BatchNorm`` on a batch sharded over 'dp'
        (``pai_tpu/ops/layers.py:166-169``). Count, sum and sum of squares
        per channel are summed over the group in float32, differentiably
        (the gradient of each rank's sums is the sum of every rank's), and
        flax's fast variance ``E[x^2] - E[x]^2``, clipped at 0, normalises;
        the running statistics move toward the global mean and biased
        variance. Over one value per channel in all it gives flax's
        answer (the output is the bias)."""
        from pai_tpu_torch.parallel.distributed import all_reduce_sum

        shape = (1, -1, 1, 1)
        c = x.shape[1]
        with torch.autocast(device_type=x.device.type, enabled=False):
            x32 = x.float()
            count = torch.full((1,), float(x32.numel() // c),
                               dtype=torch.float32, device=x.device)
            sums = all_reduce_sum(torch.cat(
                [x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3)),
                 count]), group)
            n = sums[2 * c]
            mean = sums[:c] / n
            var = torch.maximum(sums[c:2 * c] / n - mean * mean,
                                torch.zeros_like(mean))
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = (x32 - mean.view(shape)) * mul.view(shape) \
                + self.bias.view(shape)
        if self.track_running_stats:
            m = self.momentum if self.momentum is not None \
                else 1.0 / float(self.num_batches_tracked + 1)
            with torch.no_grad():
                self.running_mean.data.lerp_(mean.detach(), m)
                self.running_var.data.lerp_(var.detach(), m)
                self.num_batches_tracked.data.add_(1)
        return y.to(torch.bfloat16 if bf16 else x.dtype)

    def _one_value_per_channel(self, x: torch.Tensor, bf16: bool
                               ) -> torch.Tensor:
        """Train mode over one value per channel (N x H x W == 1), where
        torch's batch norm raises and flax's normalises: the batch variance
        is 0, so the output is the bias (``x`` minus its own mean, times
        ``scale / sqrt(eps)``, plus the bias: no gradient reaches ``x`` or
        the scale, as in flax), the running mean moves toward ``x`` and the
        running variance toward 0."""
        shape = (1, -1, 1, 1)
        with torch.autocast(device_type=x.device.type, enabled=False):
            x32 = x.float()
            mul = self.weight * (1.0 / math.sqrt(self.eps))
            y = torch.addcmul(self.bias.view(shape), x32 - x32,
                              mul.view(shape))
        if self.track_running_stats:
            m = self.momentum if self.momentum is not None \
                else 1.0 / float(self.num_batches_tracked + 1)
            with torch.no_grad():
                self.running_mean.data.lerp_(x32.detach().sum(dim=(0, 2, 3)),
                                             m)
                self.running_var.data.mul_(1.0 - m)
                self.num_batches_tracked.data.add_(1)
        return y.to(torch.bfloat16 if bf16 else x.dtype)

    def _flax_normalize(self, x: torch.Tensor) -> torch.Tensor:
        """Eval mode at a bfloat16 compute dtype: flax's ``BatchNorm`` in
        float32 (``pai_tpu/ops/layers.py:178-188``), ``(x - mean) *
        (rsqrt(var + eps) * scale) + bias`` from the running statistics,
        rounded to bfloat16 once; ``x`` is bfloat16 or the float32 sum of
        ``_bias_after_rounding``. The library's batch norm takes the
        product in another order, and its bfloat16 output then differs from
        the JAX package's in one value in 10^4, which the eval forward
        spreads (PERF.md). Train mode takes the library's float32 batch
        norm and rounds once: its cost in a training step is what an op-by-
        op formula would add there (PERF.md)."""
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return torch.addcmul(self.bias.view(shape),
                             x - self.running_mean.view(shape),
                             mul.view(shape)).to(torch.bfloat16)


class InstanceNorm(nn.Module):
    """torch ``nn.InstanceNorm2d`` with its defaults (no affine, no running
    statistics, eps 1e-5) on NCHW: each (sample, channel) normalised over H
    and W with its biased variance, in float32, cast back to the compute
    dtype (``pai_tpu/ops/layers.py:191-205``)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf16 = x.dtype == torch.bfloat16 or bf16_autocast(x)
        with torch.autocast(device_type=x.device.type, enabled=False):
            y = nn.functional.instance_norm(x.float(), eps=self.eps)
        return y.to(torch.bfloat16 if bf16 else x.dtype)

    def extra_repr(self) -> str:
        return f"eps={self.eps}"


class LayerNorm(nn.LayerNorm):
    """torch ``nn.LayerNorm`` over the last axis (eps 1e-5, scale and bias),
    computed in float32 whatever the compute dtype and cast back to it
    (``pai_tpu/ops/layers.py:252-263``): bfloat16 under bf16 autocast or
    for a bfloat16 input, else the input's dtype."""

    def __init__(self, features: int, device=None):
        super().__init__(features, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf16 = x.dtype == torch.bfloat16 or bf16_autocast(x)
        with torch.autocast(device_type=x.device.type, enabled=False):
            y = nn.functional.layer_norm(x.float(), self.normalized_shape,
                                         self.weight, self.bias, self.eps)
        return y.to(torch.bfloat16 if bf16 else x.dtype)


class Dropout(nn.Module):
    """Elementwise dropout: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, the mask drawn from the module's
    ``generator`` (the global one when none was given)."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        # a global draw keeps x's strides (rows outermost), so each rank's
        # rows hold what a one-process run draws for them
        mask = draw_rows(lambda shape: torch.empty_strided(
            shape, x.stride(), dtype=x.dtype, device=x.device).bernoulli_(
                keep, generator=self.generator)
            if shape != x.shape else torch.empty_like(x).bernoulli_(
                keep, generator=self.generator), x.shape)
        return x * (mask / keep)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


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
        mask = draw_rows(lambda shape: torch.empty(
            shape, dtype=x.dtype, device=x.device).bernoulli_(
                keep, generator=self.generator),
            (x.shape[0], x.shape[1], 1, 1))
        return x * (mask / keep)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.MaxPool2d(2)`` on NCHW (``pai_tpu/ops/layers.py:266-280``):
    exact in any dtype. Its gradient goes to the first largest value of a
    window in row-major order, as XLA's ``reduce_window`` max does, also
    where the window holds ties (the zeros of a ReLU)."""
    return nn.functional.max_pool2d(x, 2)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.AvgPool2d(2)`` on NCHW. In bfloat16 as XLA's ``reduce_window``
    sum in ``x.dtype`` (``pai_tpu/ops/layers.py:283-294``): the four values
    of a window added in row-major order, rounded after each add, then
    times 0.25 (exact)."""
    if x.dtype != torch.bfloat16:
        return nn.functional.avg_pool2d(x, 2)
    h, w = x.shape[2] // 2 * 2, x.shape[3] // 2 * 2
    s = x[:, :, 0:h:2, 0:w:2] + x[:, :, 0:h:2, 1:w:2]
    s = s + x[:, :, 1:h:2, 0:w:2]
    return (s + x[:, :, 1:h:2, 1:w:2]) * 0.25


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
