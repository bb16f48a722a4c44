"""Gaussian diffusion distributions, counterpart of
``pai_tpu/diffusion/gaussian.py``.

Functions over NHWC image batches with a step ``t`` that is a Python int (one
step for the whole batch, as the sampler uses it: indexing a device tensor
with it costs no host synchronisation) or an integer tensor ``[N]``.

* ``q_mean_variance`` — the posterior q(y_{t-1} | y_t, y_0).
* ``p_mean_variance`` — the model's reverse distribution: x0 is predicted from
  the noise estimate and clamped to [-1, 1]; with ``learn_var`` the output's
  last C channels, mapped from [-1, 1] to [0, 1], interpolate the
  log-variance between the posterior lower bound and log(1 - alpha_t).

* ``q_sample`` — the noising forward process: gamma drawn uniformly in
  [gamma_{t-1}, gamma_t] per sample, the noise zeroed where t == 0.
* ``vlb_term`` — the per-sample variational bound in bits: a KL for t > 0,
  the discretised Gaussian NLL at t == 0, the mean prediction detached under
  ``learn_var`` so that only the variance channels receive its gradient.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from pai_tpu_torch.diffusion.schedule import DiffusionSchedule
from pai_tpu_torch.parallel.mesh import draw_rows

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


def q_sample(sched: DiffusionSchedule, y_0: torch.Tensor, t: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             u: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y_t, noise, gamma[N])`` for integer steps ``t`` [N]. ``noise``
    (raw, before the t == 0 mask) and ``u`` (the uniform draw placing gamma
    between gamma_{t-1} and gamma_t) are drawn from ``generator`` unless
    given, so that two implementations can be fed the same draws."""
    if noise is None:
        noise = draw_rows(lambda shape: torch.randn(
            shape, generator=generator, device=y_0.device,
            dtype=torch.float32), y_0.shape)
    noise = noise * (t > 0).reshape(-1, 1, 1, 1)
    gamma_prev = _bcast(sched.gammas_prev, t)
    gamma_cur = _bcast(sched.gammas, t)
    if u is None:
        u = draw_rows(lambda shape: torch.rand(
            shape, generator=generator, device=y_0.device,
            dtype=torch.float32), gamma_cur.shape)
    else:
        u = u.reshape(gamma_cur.shape)
    gamma = (gamma_cur - gamma_prev) * u + gamma_prev
    y_t = torch.sqrt(gamma) * y_0 + torch.sqrt(1.0 - gamma) * noise
    return y_t, noise, gamma.reshape(-1)


def normal_kl(mean1, log_var1, mean2, log_var2):
    """KL between diagonal Gaussians."""
    return 0.5 * (-1.0 + (log_var2 - log_var1)
                  + torch.exp(log_var1 - log_var2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-log_var2))


def approx_standard_normal_cdf(x):
    """tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretised to +-1/255 image bins."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def vlb_term(sched: DiffusionSchedule, model_output: torch.Tensor,
             y_0: torch.Tensor, y_t: torch.Tensor, t: torch.Tensor,
             learn_var: bool) -> torch.Tensor:
    """Per-sample VLB term [N] in bits."""
    if learn_var:
        c = y_t.shape[-1]
        model_output = torch.cat([model_output[..., :c].detach(),
                                  model_output[..., c:]], dim=-1)
    true_mean, true_log_var = q_mean_variance(sched, y_0, y_t, t)
    pred_mean, pred_log_var = p_mean_variance(sched, model_output, y_t, t,
                                              learn_var)
    kl = normal_kl(true_mean, true_log_var, pred_mean, pred_log_var)
    kl = kl.reshape(kl.shape[0], -1).mean(dim=-1) / math.log(2.0)
    nll = -discretized_gaussian_log_likelihood(
        y_0, means=pred_mean, log_scales=0.5 * pred_log_var)
    nll = nll.reshape(nll.shape[0], -1).mean(dim=-1) / math.log(2.0)
    return torch.where(t == 0, nll, kl)
