"""Gaussian diffusion distributions of the sampling path, counterpart of
``pai_tpu/diffusion/gaussian.py``.

Functions over NHWC image batches with a step ``t`` that is a Python int (one
step for the whole batch, as the sampler uses it: indexing a device tensor
with it costs no host synchronisation) or an integer tensor ``[N]``.

* ``q_mean_variance`` — the posterior q(y_{t-1} | y_t, y_0).
* ``p_mean_variance`` — the model's reverse distribution: x0 is predicted from
  the noise estimate and clamped to [-1, 1]; with ``learn_var`` the output's
  last C channels, mapped from [-1, 1] to [0, 1], interpolate the
  log-variance between the posterior lower bound and log(1 - alpha_t).

``q_sample``, ``normal_kl``, ``discretized_gaussian_log_likelihood`` and
``vlb_term`` are training-side and arrive with the Palette training slice.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from pai_tpu_torch.diffusion.schedule import DiffusionSchedule

Step = Union[int, torch.Tensor]


def _bcast(values: torch.Tensor, t: Step) -> torch.Tensor:
    """``values[t]`` broadcast over image dims: [N] (or a scalar) ->
    [N or 1, 1, 1, 1]."""
    return values[t].reshape(-1, 1, 1, 1)


def q_mean_variance(sched: DiffusionSchedule, y_0: torch.Tensor,
                    y_t: torch.Tensor, t: Step
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    alpha = _bcast(sched.alphas, t)
    gamma = _bcast(sched.gammas, t)
    gamma_prev = _bcast(sched.gammas_prev, t)
    mean = ((torch.sqrt(gamma_prev) * (1 - alpha) / (1 - gamma)) * y_0
            + (torch.sqrt(alpha) * (1 - gamma_prev) / (1 - gamma)) * y_t)
    var_lb = (1 - alpha) * (1 - gamma_prev) / (1 - gamma)
    return mean, torch.log(torch.clamp(var_lb, min=1e-20))


def p_mean_variance(sched: DiffusionSchedule, model_output: torch.Tensor,
                    y_t: torch.Tensor, t: Step, learn_var: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    alpha = _bcast(sched.alphas, t)
    gamma = _bcast(sched.gammas, t)
    gamma_prev = _bcast(sched.gammas_prev, t)

    if learn_var:
        c = y_t.shape[-1]
        noise_pred = model_output[..., :c]
        var_interp = (model_output[..., c:] + 1.0) / 2.0
    else:
        noise_pred = model_output
        var_interp = 0.0

    var_lb = torch.clamp((1 - alpha) * (1 - gamma_prev) / (1 - gamma),
                         min=1e-20)
    var_ub = 1 - alpha
    log_variance = (var_interp * torch.log(var_ub)
                    + (1 - var_interp) * torch.log(var_lb))

    y_0_hat = (y_t - torch.sqrt(1 - gamma) * noise_pred) / torch.sqrt(gamma)
    y_0_hat = torch.clamp(y_0_hat, -1.0, 1.0)

    mean = ((torch.sqrt(gamma_prev) * (1 - alpha) / (1 - gamma)) * y_0_hat
            + (torch.sqrt(alpha) * (1 - gamma_prev) / (1 - gamma)) * y_t)
    return mean, log_variance
