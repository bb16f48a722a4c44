"""Train, evaluation and sample steps, counterpart of
``pai_tpu/train/steps.py``. Every train step mutates the train state in place
(modules, optimizers, EMA, count) and returns it with the step's metrics as
device tensors: nothing in it waits for the device.

GAN step (the reference's ``models/wrapper.py:117-162``, D-then-G):

1. one generator forward in train mode, its graph kept for the generator's
   backward (BatchNorm running statistics s0 -> s1);
2. the discriminator on the concatenation [real | fake] against the detached
   prediction, BCE(fake -> 0) + BCE(real -> 1), and its Adam step;
3. the generator loss against the *updated* discriminator (for ``gan``; the
   other four losses need no discriminator), backward through the forward of
   step 1, and its Adam step; then the EMA update.

The reference runs the generator forward twice per step, so every BatchNorm
running statistic takes two updates toward the same batch statistics. With
one forward the second is made in closed form, ``s2 = (1 + d) s1 - d s0``
with ``d = 1 - momentum``, on every running mean and (biased) variance; only
for ``gan`` (the reference's other losses run one forward) and only while no
dropout layer fires. When one fires (``generator_dropout_active``) the two
forwards see different masks and the step runs them literally: a first
forward without gradient (its own masks, s0 -> s1) feeds the discriminator,
a second one (fresh masks, s1 -> s2) the generator's loss.

Palette step (the reference's ``models/palette.py:110-140``): a step ``t``
uniform over the 2,000 training steps, the continuous-gamma ``q_sample``, the
UNet in train mode, the MSE between predicted and true noise, and the VLB
term, added with weight 1e-3 only when the variance is learned and logged
always; one Adam step at the scheduled learning rate, then the EMA update.

The draws (Palette's ``t``, noise and ``u``, and every dropout mask) come
from one ``torch.Generator`` re-seeded from ``(seed, step)`` at every step,
as the JAX step folds the step count into its key: a run resumed at step k
draws what an uninterrupted run draws at step k. Torch's generator does not
give JAX's numbers; Palette's ``external_rand=True`` builds the variant that
takes ``{"t", "noise", "u"}`` instead, so that tests can feed both packages
the same draws.

The GAN evaluation step and the Palette sample step run under
``torch.inference_mode()`` (``torch.no_grad()`` for FSDP shares) with the
evaluation weights swapped in by ``call_with_params`` and score their output with the per-image
metrics (SSIM through the ``ssim_scalar`` kernel on the card); Palette's runs
the 100-step DDPM chain (``diffusion.ddpm_sample``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from pai_tpu_torch.diffusion import (DiffusionSchedule, ddpm_sample, q_sample,
                                     vlb_term)
from pai_tpu_torch.ops import Dropout, Dropout2d
from pai_tpu_torch.parallel.distributed import all_reduce_mean_
from pai_tpu_torch.parallel.mesh import dp_mean, dp_of_context, draw_rows
from pai_tpu_torch.parallel.partitioning import is_sharded, reshard
from pai_tpu_torch.train import losses
from pai_tpu_torch.train.ema import init_ema, update_ema
from pai_tpu_torch.train.state import (GanTrainState, PaletteTrainState,
                                       gan_optimizer, gan_parameters,
                                       palette_lr, palette_optimizer)
from pai_tpu_torch.utils import metrics
from pai_tpu_torch.utils.images import denormalize


def init_gan_state(generator: nn.Module,
                   discriminator: Optional[nn.Module], loss_type: str,
                   use_ema: bool) -> GanTrainState:
    """The train state of an initialised generator (and, for ``gan``, its
    discriminator; for the other losses the discriminator is dropped): two
    Adam chains and, where asked, the EMA over both networks."""
    gan = loss_type == "gan"
    state = GanTrainState(
        step=0, generator=generator, g_opt=gan_optimizer(
            generator.parameters()),
        discriminator=discriminator if gan else None,
        d_opt=gan_optimizer(discriminator.parameters()) if gan else None)
    if use_ema:
        state.ema = init_ema(gan_parameters(state))
    return state


def init_palette_state(unet: nn.Module, use_ema: bool) -> PaletteTrainState:
    """The train state of an initialised UNet (the JAX functions also
    initialise the weights; here the modules' constructors do, from their
    generator)."""
    opt = palette_optimizer(unet.parameters())
    ema = init_ema(dict(unet.named_parameters())) if use_ema else None
    return PaletteTrainState(step=0, model=unet, opt=opt, ema=ema)


def step_seed(seed: int, step: int) -> int:
    """The generator's seed at optimizer step ``step`` of a run seeded
    ``seed``."""
    return (seed * 1_000_003 + step + 1) % (2 ** 63)


def generator_dropout_active(generator: nn.Module) -> bool:
    """Whether any dropout layer of ``generator`` fires in a training
    forward (``pai_tpu/train/steps.py:113-137``). A nonzero ``--dropout`` is
    not enough for the convolutional U-Nets: Pix2Pix, the attention and the
    residual U-Nets drop only in the deepest widest decoders
    (``models/pix2pix.dropout_for_level``), so mults (1, 2, 4, 8) never drop
    at any rate. TransUNet's ViT drops at any nonzero rate."""
    return any(isinstance(m, (Dropout, Dropout2d)) and m.rate > 0.0
               for m in generator.modules())


def _running_stats(model: nn.Module) -> Dict[float, List[torch.Tensor]]:
    """Every BatchNorm running mean and variance of ``model`` (their
    ``.data``: autograd holds the buffers as inputs of the forward), grouped
    by the layer's momentum."""
    groups: Dict[float, List[torch.Tensor]] = {}
    for mod in model.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm) \
                and mod.track_running_stats and mod.momentum is not None:
            groups.setdefault(mod.momentum, []).extend(
                [mod.running_mean.data, mod.running_var.data])
    return groups


def _second_stats_update(model: nn.Module, before: Dict[float, List]
                         ) -> None:
    """The running statistics' second update toward the same batch
    statistics, in closed form: ``s2 = (1 + d) s1 - d s0``."""
    for momentum, stats in _running_stats(model).items():
        d = 1.0 - momentum
        torch._foreach_mul_(stats, 1.0 + d)
        torch._foreach_add_(stats, before[momentum], alpha=-d)
    counters = [mod.num_batches_tracked.data for mod in model.modules()
                if isinstance(mod, nn.modules.batchnorm._BatchNorm)
                and mod.track_running_stats]
    if counters:
        torch._foreach_add_(counters, 1)


def sync_gradients(params) -> None:
    """Under a mesh with a dp axis, every gradient becomes the mean of the dp
    ranks' (XLA's psum of a dp-sharded batch's gradients): one all-reduce of
    the flattened gradients of a chain before its optimizer step. Each
    rank's gradient already holds what the global statistics and means gave
    it (``parallel.distributed.all_reduce_sum``), so the mean is the global
    batch's gradient. FSDP shares (DTensors) are left alone: FSDP2 averaged
    them over dp in its reduce-scatter."""
    from torch.distributed.tensor import DTensor

    dp, _, group = dp_of_context()
    if dp == 1:
        return
    grads = [p.grad for p in params
             if p.grad is not None and not isinstance(p.grad, DTensor)]
    if grads:
        all_reduce_mean_(grads, group)


def make_gan_train_step(generator: nn.Module,
                        discriminator: Optional[nn.Module], loss_type: str,
                        compute_metrics: bool = True,
                        with_grads: bool = False,
                        rng: Optional[torch.Generator] = None,
                        seed: int = 0) -> Callable:
    """``train_step(state, x, y) -> (state, metrics)`` of a GAN family.
    ``metrics``: ``loss`` (the generator's), ``d_loss`` for ``gan``, and with
    ``compute_metrics`` ``train_ssim``/``train_psnr``/``train_rmse`` of the
    prediction (the lean variant, for the steps that are not logged, skips
    them); ``with_grads=True`` adds the raw gradients ``g_grads`` and
    ``d_grads`` (name -> tensor). ``rng`` (on the batch's device; the one
    the dropout layers draw from) is re-seeded from ``(seed, step)`` every
    step."""
    gan = loss_type == "gan"
    exact_double = gan and generator_dropout_active(generator)

    def train_step(state: GanTrainState, x: torch.Tensor, y: torch.Tensor):
        model = state.generator.train()
        if rng is not None:
            rng.manual_seed(step_seed(seed, state.step))
        out: Dict[str, torch.Tensor] = {}
        if exact_double:
            with torch.no_grad():
                pred_d = model(x)
            pred = model(x)
        else:
            before = {m: torch._foreach_mul(stats, 1.0) for m, stats in
                      _running_stats(model).items()} if gan else {}
            pred = model(x)
            pred_d = pred.detach()
            if before:
                _second_stats_update(model, before)

        disc = state.discriminator
        if gan:
            disc.train()
            n = x.shape[0]
            both = disc(torch.cat([x, x]), torch.cat([y, pred_d]))
            d_loss = losses.discriminator_loss(both[n:], both[:n])
            state.d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            sync_gradients(disc.parameters())
            if with_grads:
                out["d_grads"] = {k: p.grad.detach().clone()
                                  for k, p in disc.named_parameters()}
            state.d_opt.step()
            out["d_loss"] = d_loss.detach()

        logits = disc(x, pred) if gan else None
        g_loss = losses.generator_loss(loss_type, pred, y, logits)
        params = list(model.parameters())
        state.g_opt.zero_grad(set_to_none=True)
        g_loss.backward(inputs=params)
        sync_gradients(params)
        if with_grads:
            out["g_grads"] = {k: p.grad.detach().clone()
                              for k, p in model.named_parameters()}
        state.g_opt.step()
        if state.ema is not None:
            update_ema(state.ema, gan_parameters(state))
        state.step += 1

        step_metrics = {"loss": g_loss.detach(), **out}
        if compute_metrics:
            with torch.no_grad():
                dp, dt = denormalize(pred.detach()), denormalize(y)
                step_metrics.update(train_ssim=metrics.ssim(dp, dt),
                                    train_psnr=metrics.psnr(dp, dt),
                                    train_rmse=metrics.rmse(dp, dt))
        return state, step_metrics

    return train_step


def _no_grad_for(model: nn.Module):
    """``torch.inference_mode()``, or ``torch.no_grad()`` for a model whose
    parameters are FSDP shares: FSDP2 gathers into buffers it reuses, which
    must not become inference tensors."""
    return torch.no_grad() if is_sharded(model) else torch.inference_mode()


def call_with_params(model: nn.Module, params: Mapping[str, torch.Tensor],
                     args: tuple):
    """``model(*args)`` with ``params`` (name -> tensor) in place of its own:
    ``torch.func.functional_call``; for FSDP shares, whose forward gathers
    the module's own parameters, the values are copied into them for the
    call and back after it (no gradient is taken)."""
    if not is_sharded(model):
        return torch.func.functional_call(model, dict(params), args)
    reshard(model)
    live = dict(model.named_parameters())
    swap = [k for k in params if params[k] is not live[k]]
    with torch.no_grad():
        kept = [live[k].detach().clone() for k in swap]
        for k in swap:
            live[k].copy_(params[k])
        out = model(*args)
        reshard(model)
        for k, value in zip(swap, kept):
            live[k].copy_(value)
    return out


def make_gan_eval_step(generator: nn.Module) -> Callable:
    """``eval_step(params, x, y) -> (pred, per_image)``: the eval-mode
    forward with ``params`` (name -> tensor) swapped into ``generator``, and
    per-image ``ssim``/``psnr``/``mse`` against ``y``; the caller drops the
    rows past a batch's ``n_valid``."""

    def eval_step(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  y: torch.Tensor):
        generator.eval()
        with _no_grad_for(generator):
            pred = call_with_params(generator, params, (x,))
            dp, dt = denormalize(pred), denormalize(y)
            per_image = {"ssim": metrics.ssim_per_image(dp, dt),
                         "psnr": metrics.psnr_per_image(dp, dt),
                         "mse": metrics.mse_per_image(dp, dt)}
        return pred, per_image

    return eval_step


def gan_eval_params(state: GanTrainState) -> Dict[str, torch.Tensor]:
    """The generator's parameters validation runs under: the EMA shadow
    weights when the run keeps them, the raw ones otherwise."""
    params = dict(state.generator.named_parameters())
    if state.ema is not None:
        return {k: state.ema.params[k] for k in params}
    return params


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
            t = draw_rows(lambda shape: torch.randint(
                0, sched.timesteps, shape, generator=generator,
                device=y_0.device), (n,))
            y_t, noise, gamma = q_sample(sched, y_0, t, generator)

        model_output = model(x, y_t, gamma)
        noise_pred = model_output[..., :c] if learn_var else model_output
        mse_loss = dp_mean(torch.mean((noise_pred - noise) ** 2))
        with torch.set_grad_enabled(learn_var):
            vlb = dp_mean(torch.mean(vlb_term(sched, model_output, y_0, y_t,
                                              t, learn_var)))
        loss = mse_loss + 0.001 * vlb if learn_var else mse_loss

        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        sync_gradients(model.parameters())
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
            return call_with_params(unet, params, (cond, y_t, gamma))

        with _no_grad_for(unet):
            y_pred = ddpm_sample(sched_inf, denoise_fn, x, generator,
                                 learn_var)
            dp, dt = denormalize(y_pred), denormalize(y_0)
            per_image = {"ssim": metrics.ssim_per_image(dp, dt),
                         "psnr": metrics.psnr_per_image(dp, dt),
                         "mse": metrics.mse_per_image(dp, dt)}
        return y_pred, per_image

    return sample
