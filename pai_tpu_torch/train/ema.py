"""Exponential moving average of the parameters, counterpart of
``pai_tpu/train/ema.py``.

``torch_ema.ExponentialMovingAverage`` as the reference's EMA callback uses it
(decay 0.9999): the effective decay ramps as ``min(decay, (1 + n) / (10 + n))``
over the update count ``n``, and after every train batch
``ema = ema - (1 - decay_eff) * (ema - param)``. The average spans the
parameters only, not the BatchNorm running statistics. The update is made in
place, one multi-tensor ``lerp_`` over all shadow tensors (no copy of the
1-billion-parameter model), where the JAX function returns a new tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]  # name -> shadow tensor
    num_updates: int = 0
    decay: float = 0.9999


def init_ema(params: Mapping[str, torch.Tensor],
             decay: float = 0.9999) -> EmaState:
    """Fresh shadow copies of ``params`` (name -> tensor): the average must
    not alias the live weights."""
    return EmaState(params={k: v.detach().clone() for k, v in params.items()},
                    num_updates=0, decay=decay)


def decay_for(num_updates: int, decay: float) -> np.float32:
    """The effective decay of update number ``num_updates`` (from 1), in
    float32 as the JAX package computes it."""
    n = np.float32(num_updates)
    return min(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))


def update_weight(ema: EmaState, ahead: int = 0) -> float:
    """``1 - decay`` of the update ``ahead`` updates after the next one, in
    float32 as the JAX package computes it."""
    return float(np.float32(1.0) - decay_for(ema.num_updates + 1 + ahead,
                                             ema.decay))


def lerp_ema(ema: EmaState, params: Mapping[str, torch.Tensor],
             weight: Union[float, torch.Tensor]) -> None:
    """``ema <- ema + weight (params - ema)`` in place, ``torch.lerp``'s
    arithmetic, the update count left as it is. ``weight`` is a float, or a
    device scalar where a CUDA graph records the update (one ``lerp_`` per
    tensor, the same arithmetic)."""
    names = list(ema.params)
    shadows = [ema.params[k] for k in names]
    with torch.no_grad():
        targets = [params[k].detach() for k in names]
        if isinstance(weight, torch.Tensor):
            torch._foreach_lerp_(shadows, targets, [weight] * len(names))
        else:
            torch._foreach_lerp_(shadows, targets, weight)


def update_ema(ema: EmaState, params: Mapping[str, torch.Tensor]) -> EmaState:
    """One update toward ``params`` (name -> tensor), in place; returns
    ``ema``."""
    weight = update_weight(ema)
    ema.num_updates += 1
    lerp_ema(ema, params, weight)
    return ema
