"""Palette train and sample steps, counterpart of the Palette half of
``pai_tpu/train/steps.py``.

Train step (the reference's ``models/palette.py:110-140``): a step ``t``
uniform over the 2,000 training steps, the continuous-gamma ``q_sample``, the
UNet in train mode, the MSE between predicted and true noise, and the VLB
term, added with weight 1e-3 only when the variance is learned and logged
always; one Adam step at the scheduled learning rate, then the EMA update.
The step mutates the train state in place (module, optimizer, EMA, count) and
returns it with the step's metrics as device tensors: nothing in it waits for
the device.

The draws (``t``, the noise, ``u``, the ResBlocks' dropout masks) come from
one ``torch.Generator`` re-seeded from ``(seed, step)`` at every step, as the
JAX step folds the step count into its key: a run resumed at step k draws
what an uninterrupted run draws at step k. Torch's generator does not give
JAX's numbers; ``external_rand=True`` builds the variant that takes
``{"t", "noise", "u"}`` instead, so that tests can feed both packages the
same draws.

The sample step runs the 100-step DDPM chain (``diffusion.ddpm_sample``)
under ``torch.inference_mode()`` with the evaluation weights swapped in by
``torch.func.functional_call``, and scores it with the per-image metrics (SSIM
through the ``ssim_scalar`` kernel on the card).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from pai_tpu_torch.diffusion import (DiffusionSchedule, ddpm_sample, q_sample,
                                     vlb_term)
from pai_tpu_torch.train.ema import init_ema, update_ema
from pai_tpu_torch.train.state import (PaletteTrainState, palette_lr,
                                       palette_optimizer)
from pai_tpu_torch.utils import metrics
from pai_tpu_torch.utils.images import denormalize


def init_palette_state(unet: nn.Module, use_ema: bool) -> PaletteTrainState:
    """The train state of an initialised UNet (the JAX function also
    initialises the weights; here the module's constructor does, from its
    generator)."""
    opt = palette_optimizer(unet.parameters())
    ema = init_ema(dict(unet.named_parameters())) if use_ema else None
    return PaletteTrainState(step=0, model=unet, opt=opt, ema=ema)


def step_seed(seed: int, step: int) -> int:
    """The generator's seed at optimizer step ``step`` of a run seeded
    ``seed``."""
    return (seed * 1_000_003 + step + 1) % (2 ** 63)


def make_palette_train_step(unet: nn.Module, sched: DiffusionSchedule,
                            learn_var: bool,
                            warmup_steps_per_epoch: Optional[int] = None,
                            external_rand: bool = False,
                            generator: Optional[torch.Generator] = None,
                            seed: int = 0) -> Callable:
    """``train_step(state, x, y_0, rand=None) -> (state, metrics)``.
    ``warmup_steps_per_epoch`` set => the warmup advances once per epoch
    (the default of the CLI); None => once per step. ``generator`` (on the
    batch's device; the one the UNet's dropout draws from) is re-seeded from
    ``(seed, step)`` every step; with ``external_rand`` the draws are
    ``rand = {"t", "noise", "u"}`` and dropout must be off."""

    def train_step(state: PaletteTrainState, x: torch.Tensor,
                   y_0: torch.Tensor, rand: Optional[Mapping] = None):
        n, c = y_0.shape[0], y_0.shape[-1]
        model = state.model.train()
        if external_rand:
            t = torch.as_tensor(rand["t"], device=y_0.device).long()
            y_t, noise, gamma = q_sample(
                sched, y_0, t,
                noise=torch.as_tensor(rand["noise"], device=y_0.device),
                u=torch.as_tensor(rand["u"], device=y_0.device))
        else:
            generator.manual_seed(step_seed(seed, state.step))
            t = torch.randint(0, sched.timesteps, (n,), generator=generator,
                              device=y_0.device)
            y_t, noise, gamma = q_sample(sched, y_0, t, generator)

        model_output = model(x, y_t, gamma)
        noise_pred = model_output[..., :c] if learn_var else model_output
        mse_loss = torch.mean((noise_pred - noise) ** 2)
        with torch.set_grad_enabled(learn_var):
            vlb = torch.mean(vlb_term(sched, model_output, y_0, y_t, t,
                                      learn_var))
        loss = mse_loss + 0.001 * vlb if learn_var else mse_loss

        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        lr = palette_lr(state.step, warmup_steps_per_epoch)
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.step()
        if state.ema is not None:
            update_ema(state.ema, dict(model.named_parameters()))
        state.step += 1
        return state, {"loss": loss.detach(), "mse_loss": mse_loss.detach(),
                       "vlb_loss": vlb.detach()}

    return train_step


def palette_eval_params(state: PaletteTrainState) -> Dict[str, torch.Tensor]:
    """The parameters validation runs under: the EMA shadow weights when the
    run keeps them, the raw ones otherwise (the running statistics are always
    the module's own)."""
    if state.ema is not None:
        return state.ema.params
    return dict(state.model.named_parameters())


def make_palette_sample_step(unet: nn.Module, sched_inf: DiffusionSchedule,
                             learn_var: bool) -> Callable:
    """``sample(params, x, y_0, generator) -> (y_pred, per_image)``: the full
    reverse chain conditioned on ``x`` with ``params`` (name -> tensor)
    swapped into ``unet``, and per-image ``ssim``/``psnr``/``mse`` of the
    result against ``y_0``."""

    def sample(params: Mapping[str, torch.Tensor], x: torch.Tensor,
               y_0: torch.Tensor, generator: torch.Generator):
        unet.eval()

        def denoise_fn(cond, y_t, gamma):
            return torch.func.functional_call(unet, dict(params),
                                              (cond, y_t, gamma))

        with torch.inference_mode():
            y_pred = ddpm_sample(sched_inf, denoise_fn, x, generator,
                                 learn_var)
            dp, dt = denormalize(y_pred), denormalize(y_0)
            per_image = {"ssim": metrics.ssim_per_image(dp, dt),
                         "psnr": metrics.psnr_per_image(dp, dt),
                         "mse": metrics.mse_per_image(dp, dt)}
        return y_pred, per_image

    return sample
