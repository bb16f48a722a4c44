"""DDPM reverse sampler, counterpart of ``pai_tpu/diffusion/sampler.py``.

The JAX package compiles the whole chain into one ``lax.scan``; here it is a
Python loop over ``t = T-1 .. 0`` under ``torch.inference_mode()`` that never
waits for the device: ``t`` is a Python int, the schedule lives on the device
and is indexed there, noise is drawn on the device from the generator, and
kept frames go into a buffer allocated before the loop. The host only
enqueues; the first synchronisation is the caller's. Noise is zeroed for
``t <= 1``, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from pai_tpu_torch.diffusion.gaussian import p_mean_variance
from pai_tpu_torch.diffusion.schedule import DiffusionSchedule


def capture_steps(timesteps: int, capture_every: int) -> list:
    """The steps ``t`` whose ``y_{t-1}`` is kept, in the order the chain
    visits them; the frame count is one more (``y_T`` comes first)."""
    return [t for t in range(timesteps - 1, -1, -1) if t % capture_every == 0]


def ddpm_sample(
    sched: DiffusionSchedule,
    denoise_fn: Callable,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    learn_var: bool = False,
    capture_every: Optional[int] = None,
    y_T: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the full reverse chain conditioned on ``x`` [N,H,W,C].

    ``denoise_fn(x, y_t, gamma[N]) -> model_output`` is the eval-mode UNet.
    Returns ``y_0`` — and, if ``capture_every`` is set, the kept frames
    ``[N, F, H, W, C]``: ``y_T`` first, then ``y_{t-1}`` at every
    ``t % capture_every == 0`` (F = 9 for 100 steps and ``100 // 7``).

    ``generator`` (on ``x``'s device) draws ``y_T`` and the per-step noise;
    ``y_T`` and ``step_noise`` ([T, N, H, W, C], raw, ordered t = T-1 .. 0)
    may be supplied instead so that two implementations can be fed the same
    draws.
    """
    n = x.shape[0]
    with torch.inference_mode():
        if y_T is None:
            y_T = torch.randn(x.shape, generator=generator, device=x.device,
                              dtype=torch.float32)
        y_t = y_T.to(device=x.device, dtype=torch.float32)
        frames = None
        if capture_every:
            n_frames = 1 + len(capture_steps(sched.timesteps, capture_every))
            frames = torch.empty((n, n_frames) + tuple(y_t.shape[1:]),
                                 dtype=torch.float32, device=x.device)
            frames[:, 0] = y_t
            slot = 1
        for i, t in enumerate(range(sched.timesteps - 1, -1, -1)):
            gamma = sched.gammas[t].expand(n)
            model_output = denoise_fn(x, y_t, gamma)
            mean, log_variance = p_mean_variance(sched, model_output, y_t, t,
                                                 learn_var)
            # one draw per step, used or not, so the stream does not depend
            # on where the masking starts
            noise = step_noise[i].to(x.device) if step_noise is not None \
                else torch.randn(y_t.shape, generator=generator,
                                 device=x.device, dtype=torch.float32)
            y_t = mean + torch.exp(0.5 * log_variance) * noise if t > 1 \
                else mean
            if capture_every and t % capture_every == 0:
                frames[:, slot] = y_t
                slot += 1
    if capture_every:
        return y_t, frames
    return y_t
