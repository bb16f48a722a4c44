"""Losses of the GAN families, counterpart of ``pai_tpu/train/losses.py``.

* ``gan``:   BCE-with-logits(D(x, pred), 1) + 50 * L1(pred, target) (the
  reference's weight 50, not the paper's 100);
* ``ssim``:  -SSIM(denorm(pred), denorm(target));
* ``psnr``:  -PSNR(denorm(pred), denorm(target));
* ``ssim+psnr``: -(30 * SSIM + PSNR) on denormalised images;
* ``mse``:   mean squared error on the raw [-1, 1] tensors;
* discriminator: BCE(fake -> 0) + BCE(real -> 1).

Every reduction is a mean in float32, over the global batch under a dp mesh
(``parallel.mesh.dp_mean``). At a kink the gradient is JAX's, as
the JAX package's losses take it at a tie: ``|d|`` has slope 1 at 0 (torch's
``abs`` has 0: an L1 term where a prediction equals its target, as a
saturated tanh on a saturated pixel does), ``max(l, 0)`` slope 0.5, and the
denormalisation's clip to [0, 1] half its slope at either end (``jnp.clip``
is a max and a min, whose ties split the gradient; ``torch.clamp`` passes all
of it). SSIM goes through ``utils.metrics.ssim``: on a CUDA tensor its
forward is the ``ssim_scalar`` kernel and its gradient recomputes through the
plain version (``kernels/ssim.py::_SsimFused``), as the JAX package's
``custom_vjp`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from pai_tpu_torch.parallel.mesh import dp_mean
from pai_tpu_torch.utils import metrics

LOSS_TYPES = ("gan", "ssim", "psnr", "ssim+psnr", "mse")


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's slope of 1 at 0."""
    return torch.where(x >= 0, x, -x)


def _denormalize(x: torch.Tensor) -> torch.Tensor:
    """``utils.images.denormalize`` (``clamp(x * 0.5 + 0.5, 0, 1)``) with
    JAX's gradient at the ends of the clip."""
    y = x * 0.5 + 0.5
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    return torch.minimum(torch.maximum(y, zero), zero + 1.0)


def bce_with_logits(logits: torch.Tensor, targets: float) -> torch.Tensor:
    """Mean binary cross-entropy of ``logits`` against a constant target, in
    the stable form ``max(l, 0) - l * t + log1p(exp(-|l|))``."""
    logits = logits.float()
    loss = (torch.maximum(logits, torch.zeros_like(logits))
            - logits * targets + torch.log1p(torch.exp(-_abs(logits))))
    return dp_mean(loss.mean())


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return dp_mean(torch.mean(_abs(pred.float() - target.float())))


def generator_loss(loss_type: str, pred: torch.Tensor, target: torch.Tensor,
                   pred_logits: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The generator's objective; for ``gan``, ``pred_logits`` are the
    discriminator's logits on (condition, pred)."""
    if loss_type == "gan":
        return bce_with_logits(pred_logits, 1.0) + 50.0 * l1_loss(pred,
                                                                   target)
    if loss_type == "mse":
        return metrics.mse(pred, target)
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown loss_type {loss_type}")
    dp, dt = _denormalize(pred), _denormalize(target)
    if loss_type == "ssim":
        return -metrics.ssim(dp, dt)
    if loss_type == "psnr":
        return -metrics.psnr(dp, dt)
    return -(30.0 * metrics.ssim(dp, dt) + metrics.psnr(dp, dt))


def discriminator_loss(pred_logits: torch.Tensor,
                       target_logits: torch.Tensor) -> torch.Tensor:
    """The discriminator's objective: fakes -> 0, reals -> 1."""
    return (bce_with_logits(pred_logits, 0.0)
            + bce_with_logits(target_logits, 1.0))
