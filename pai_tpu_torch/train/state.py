"""Optimizers and train states, counterpart of ``pai_tpu/train/state.py``.

GAN families: two independent Adam chains, one for the generator and one for
the discriminator, each with lr 2e-4, betas (0.5, 0.999) and eps 1e-7 (the
reference's ``models/wrapper.py:97-115``).

Palette: Adam with lr 1e-4, betas (0.9, 0.999), eps 1e-8. Both are
``torch.optim.Adam``: the optimizer is plain PyTorch, not one of the TPU
kernels; its fused CUDA implementation on the card, which keeps no
parameter-sized temporaries, in its capturable form (a CUDA graph may
record its step), with Palette's learning rate a device scalar that every
step writes (``set_lr``): a graph reads it from there, and the ordinary
step takes the same path, so the two do not round apart. Palette's
learning rate follows torch ``LinearLR``'s warmup as the JAX package
reproduces it, ``1e-4 * (1/3 + 2/3 * min(unit, 10000) / 10000)``, where
``unit`` is the optimizer step or, by default, the epoch (``step //
steps_per_epoch``: Lightning steps the reference's scheduler once per
epoch). It is read at the count before the step, as optax reads its
schedule, and computed in float32 as the JAX package computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Union

import numpy as np
import torch
from torch import nn

from pai_tpu_torch.train.ema import EmaState
from pai_tpu_torch.utils.checkpoint import DISCRIMINATOR_PREFIX

BASE_LR = 1e-4
GAN_LR = 2e-4
WARMUP_ITERS = 10000


def palette_lr(step: int, steps_per_epoch: Optional[int] = None,
               warmup_iters: int = WARMUP_ITERS,
               base_lr: float = BASE_LR) -> float:
    """The learning rate of the optimizer step that starts at count
    ``step``."""
    unit = step if steps_per_epoch is None else step // steps_per_epoch
    frac = np.float32(min(unit, warmup_iters)) / np.float32(warmup_iters)
    factor = np.float32(1.0 / 3.0) + np.float32(1.0 - 1.0 / 3.0) * frac
    return float(np.float32(base_lr) * factor)


def gan_optimizer(params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    params = list(params)
    cuda = bool(params) and params[0].is_cuda
    return torch.optim.Adam(params, lr=GAN_LR, betas=(0.5, 0.999), eps=1e-7,
                            fused=cuda, capturable=cuda)


def palette_optimizer(params: Iterable[torch.nn.Parameter],
                      base_lr: float = BASE_LR) -> torch.optim.Adam:
    params = list(params)
    cuda = bool(params) and params[0].is_cuda
    lr = torch.tensor(base_lr, dtype=torch.float32,
                      device=params[0].device) if cuda else base_lr
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            fused=cuda, capturable=cuda)


def set_lr(opt: torch.optim.Optimizer,
           lr: Union[float, torch.Tensor]) -> None:
    """The learning rate of ``opt``'s next step: written into the device
    scalar of a CUDA optimizer (a float, or a device scalar where a CUDA
    graph records the step), set as it is on the CPU."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor) and group["lr"].is_cuda:
            if isinstance(lr, torch.Tensor):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        else:
            group["lr"] = lr


@dataclasses.dataclass
class PaletteTrainState:
    """``model`` holds the parameters and the BatchNorm running statistics
    (the JAX state's ``params`` and ``stats``); ``step`` counts optimizer
    steps."""

    step: int
    model: nn.Module
    opt: torch.optim.Adam
    ema: Optional[EmaState] = None


@dataclasses.dataclass
class GanTrainState:
    """``generator`` holds the generator's parameters and BatchNorm running
    statistics (the JAX state's ``g_params`` and ``g_stats``);
    ``discriminator`` and ``d_opt`` exist only for ``loss_type == "gan"``.
    The EMA, where kept, spans both networks' parameters under the names of
    a training slot: the generator's own names and the discriminator's
    prefixed ``discriminator.`` (``gan_parameters``)."""

    step: int
    generator: nn.Module
    g_opt: torch.optim.Adam
    discriminator: Optional[nn.Module] = None
    d_opt: Optional[torch.optim.Adam] = None
    ema: Optional[EmaState] = None



def gan_parameters(state: GanTrainState) -> Dict[str, torch.nn.Parameter]:
    """Both networks' parameters by slot name: the generator's names, then
    the discriminator's under ``discriminator.``."""
    params = dict(state.generator.named_parameters())
    if state.discriminator is not None:
        params.update({DISCRIMINATOR_PREFIX + k: v for k, v in
                       state.discriminator.named_parameters()})
    return params
