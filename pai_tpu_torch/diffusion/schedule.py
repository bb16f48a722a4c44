"""Noise schedules as precomputed tensors, counterpart of
``pai_tpu/diffusion/schedule.py``.

The training schedule is a 2000-step linear(1e-6, 0.01) beta ramp and the
sampling schedule an independent 100-step cosine one; the model is
conditioned on the continuous noise level gamma, not the integer step, which
is what lets the two differ. The cosine schedule uses cos(...) **without**
squaring, as the reference does. Betas, alphas and their cumulative product
are computed in float64 numpy and stored as float32 tensors on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np
import torch


def linear_beta_schedule(timesteps: int, start: float = 1e-6,
                         end: float = 0.01) -> np.ndarray:
    return np.linspace(start, end, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    gammas = np.cos((math.pi / 2) * ((x / timesteps) + s) / (1 + s))
    gammas = gammas / gammas[0]
    betas = 1 - (gammas[1:] / gammas[:-1])
    return np.clip(betas, 0.0001, 0.9999)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule buffers, float32 tensors of length
    ``timesteps`` on one device."""

    timesteps: int
    alphas: torch.Tensor       # 1 - betas
    gammas: torch.Tensor       # cumprod(alphas)
    gammas_prev: torch.Tensor  # [1, gammas[:-1]]


def make_schedule(schedule_type: str, timesteps: int, start: float = 1e-6,
                  end: float = 0.01,
                  device: Union[str, torch.device] = "cpu"
                  ) -> DiffusionSchedule:
    if schedule_type == "linear":
        betas = linear_beta_schedule(timesteps, start, end)
    elif schedule_type == "cosine":
        betas = cosine_beta_schedule(timesteps)
    else:
        raise ValueError(f"{schedule_type} is not supported.")
    alphas = 1.0 - betas
    gammas = np.cumprod(alphas)
    gammas_prev = np.concatenate([[1.0], gammas[:-1]])

    def tensor(values):
        return torch.from_numpy(values.astype(np.float32)).to(device)

    return DiffusionSchedule(timesteps=timesteps, alphas=tensor(alphas),
                             gammas=tensor(gammas),
                             gammas_prev=tensor(gammas_prev))
