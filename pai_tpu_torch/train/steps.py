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

Each train step is a ``TrainStep``: the host's part (the re-seed, the
learning rate and EMA weight read from the counts, the counts' advance)
around a device body that reads no host value, so that ``TrainScan``
(``--scan-steps K``, ``make_gan_train_scan``/``make_palette_train_scan``,
the JAX package's ``lax.scan`` of K steps) can record K of them in one CUDA
graph on the card.

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
from pai_tpu_torch.parallel.context import get_mesh_context
from pai_tpu_torch.parallel.distributed import all_reduce_mean_
from pai_tpu_torch.parallel.mesh import dp_mean, dp_of_context, draw_rows
from pai_tpu_torch.parallel.partitioning import is_sharded, reshard
from pai_tpu_torch.train import losses
from pai_tpu_torch.train.ema import init_ema, lerp_ema, update_weight
from pai_tpu_torch.train.state import (GAN_LR, GanTrainState,
                                       PaletteTrainState, gan_optimizer,
                                       gan_parameters, palette_lr,
                                       palette_optimizer, set_lr)
from pai_tpu_torch.utils import metrics
from pai_tpu_torch.utils.graphs import CapturedGraph, GraphStream
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


class TrainStep:
    """``step(state, x, y, rand=None) -> (state, metrics)``: one optimizer
    step. The host's part of it is here: the re-seed of ``rng`` from
    ``(seed, step)``, the step's learning rate and EMA weight (``values``,
    read from the counts before the step) and the counts' advance. The
    device work is ``body(state, x, y, lr, ema_weight, rand)``, which reads
    no host state: ``TrainScan`` records it in a CUDA graph, with ``lr``
    and ``ema_weight`` as device scalars, where here they are floats."""

    def __init__(self, body: Callable, values: Callable,
                 rng: Optional[torch.Generator] = None, seed: int = 0):
        self.body, self.values, self.rng, self.seed = body, values, rng, seed

    def __call__(self, state, x: torch.Tensor, y: torch.Tensor,
                 rand: Optional[Mapping] = None):
        if self.rng is not None:
            self.rng.manual_seed(step_seed(self.seed, state.step))
        metrics = self.body(state, x, y, *self.values(state, 0), rand)
        advance(state, 1)
        return state, metrics


def advance(state, steps: int) -> None:
    """The counts after ``steps`` optimizer steps: the step's and the
    EMA's."""
    state.step += steps
    if state.ema is not None:
        state.ema.num_updates += steps


def _ema_weight(state, ahead: int) -> float:
    return update_weight(state.ema, ahead) if state.ema is not None else 0.0


def make_gan_train_step(generator: nn.Module,
                        discriminator: Optional[nn.Module], loss_type: str,
                        compute_metrics: bool = True,
                        with_grads: bool = False,
                        rng: Optional[torch.Generator] = None,
                        seed: int = 0) -> TrainStep:
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

    def body(state: GanTrainState, x: torch.Tensor, y: torch.Tensor, lr,
             ema_weight, rand=None):
        model = state.generator.train()
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
            lerp_ema(state.ema, gan_parameters(state), ema_weight)

        step_metrics = {"loss": g_loss.detach(), **out}
        if compute_metrics:
            with torch.no_grad():
                dp, dt = denormalize(pred.detach()), denormalize(y)
                step_metrics.update(train_ssim=metrics.ssim(dp, dt),
                                    train_psnr=metrics.psnr(dp, dt),
                                    train_rmse=metrics.rmse(dp, dt))
        return step_metrics

    def values(state: GanTrainState, ahead: int):
        return GAN_LR, _ema_weight(state, ahead)

    return TrainStep(body, values, rng, seed)


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
                            seed: int = 0) -> TrainStep:
    """``train_step(state, x, y_0, rand=None) -> (state, metrics)``.
    ``warmup_steps_per_epoch`` set => the warmup advances once per epoch
    (the default of the CLI); None => once per step. ``generator`` (on the
    batch's device; the one the UNet's dropout draws from) is re-seeded from
    ``(seed, step)`` every step; with ``external_rand`` the draws are
    ``rand = {"t", "noise", "u"}`` and dropout must be off."""

    def body(state: PaletteTrainState, x: torch.Tensor, y_0: torch.Tensor,
             lr, ema_weight, rand: Optional[Mapping] = None):
        n, c = y_0.shape[0], y_0.shape[-1]
        model = state.model.train()
        if external_rand:
            t = torch.as_tensor(rand["t"], device=y_0.device).long()
            y_t, noise, gamma = q_sample(
                sched, y_0, t,
                noise=torch.as_tensor(rand["noise"], device=y_0.device),
                u=torch.as_tensor(rand["u"], device=y_0.device))
        else:
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
        set_lr(state.opt, lr)
        state.opt.step()
        if state.ema is not None:
            lerp_ema(state.ema, dict(model.named_parameters()), ema_weight)
        return {"loss": loss.detach(), "mse_loss": mse_loss.detach(),
                "vlb_loss": vlb.detach()}

    def values(state: PaletteTrainState, ahead: int):
        return (palette_lr(state.step + ahead, warmup_steps_per_epoch),
                _ema_weight(state, ahead))

    return TrainStep(body, values, None if external_rand else generator,
                     seed)


class TrainScan:
    """``scan(state, xs, ys, rands=None) -> (state, metrics)``: ``len(xs)``
    lean steps (``step``: a ``TrainStep``) in one dispatch, counterpart of
    ``pai_tpu``'s ``make_gan_train_scan`` and ``make_palette_train_scan``
    (``pai_tpu/train/steps.py:288-325``, one ``lax.scan``); ``metrics`` are
    the last step's.

    On the card, with no mesh installed, the steps' device work is one CUDA
    graph (``utils.graphs``), replayed once per call: ``fold`` as the graph
    records it. The first call, and a call with other shapes, warms the
    graph up: its steps run as ordinary steps on the graph's stream, then
    the graph is recorded (which runs nothing). Before each replay the host
    writes what the steps read of it: the batches into the graph's input
    buffers, each step's learning rate and EMA weight into a device tensor,
    and each step's seed ``step_seed(seed, step)`` into a generator state of
    its own, registered with the graph, which the step's draws come from
    (``rng`` is switched to it while the graph records that step). So a
    replay draws, and computes, what the ordinary steps do, and the counts
    advance on the host after it.

    On the CPU, and under a mesh (the collectives of a gloo group stage
    through host memory, which a graph cannot record), the steps are
    ordinary steps. ``rands`` (external draws) are taken on those paths
    only."""

    def __init__(self, step: TrainStep):
        self.step = step
        self.graph = None
        self._key = None
        self._side = None

    def __call__(self, state, xs: List[torch.Tensor],
                 ys: List[torch.Tensor], rands: Optional[List] = None):
        if not xs[0].is_cuda or get_mesh_context() is not None:
            for i in range(len(xs)):
                state, out = self.step(state, xs[i], ys[i],
                                       rands[i] if rands else None)
            return state, out
        if rands is not None:
            raise ValueError("a CUDA graph of train steps makes its own "
                             "draws; external draws run ordinary steps")
        key = (len(xs), xs[0].shape, xs[0].dtype, ys[0].shape, ys[0].dtype)
        if key != self._key:
            self._side = self._side or GraphStream()
            with self._side:
                for x, y in zip(xs, ys):
                    state, out = self.step(state, x, y)
            self._record(state, xs, ys)
            self._key = key
            return state, out
        for i in range(len(xs)):
            self._xs[i].copy_(xs[i])
            self._ys[i].copy_(ys[i])
        self._values.copy_(self.host_values(state, len(xs)).pin_memory(),
                           non_blocking=True)
        for i, rng_state in enumerate(self._rng_states):
            rng_state.manual_seed(step_seed(self.step.seed, state.step + i))
        self.graph.replay()
        advance(state, len(xs))
        return state, self.graph.output

    def host_values(self, state, n: int) -> torch.Tensor:
        """(n, 2) float32 on the host: each step's learning rate and EMA
        weight."""
        return torch.tensor([self.step.values(state, i) for i in range(n)],
                            dtype=torch.float32)

    def fold(self, state, xs, ys, values: torch.Tensor, rng_states=(),
             rands: Optional[List] = None) -> Dict[str, torch.Tensor]:
        """The device work of ``len(xs)`` steps as a graph records it: step
        i takes its learning rate and EMA weight from ``values[i]`` (device
        scalars) and draws from ``rng_states[i]`` where given; the counts
        are left as they are. Returns the last step's metrics."""
        rng = self.step.rng
        live = rng.graphsafe_get_state() if rng_states else None
        for i in range(len(xs)):
            if rng_states:
                rng.graphsafe_set_state(rng_states[i])
            out = self.step.body(state, xs[i], ys[i], values[i, 0],
                                 values[i, 1], rands[i] if rands else None)
        if rng_states:
            rng.graphsafe_set_state(live)
        return out

    def _record(self, state, xs, ys) -> None:
        self._xs, self._ys = torch.stack(xs), torch.stack(ys)
        self._values = torch.zeros((len(xs), 2), dtype=torch.float32,
                                   device=xs[0].device)
        rng = self.step.rng
        self._rng_states = [rng.clone_state() for _ in xs] \
            if rng is not None else []
        self.graph = None  # the old graph's pool is freed first
        self.graph = CapturedGraph(
            lambda: self.fold(state, self._xs, self._ys, self._values,
                              self._rng_states),
            self._side.stream, self._rng_states)


def make_gan_train_scan(generator: nn.Module,
                        discriminator: Optional[nn.Module], loss_type: str,
                        rng: Optional[torch.Generator] = None,
                        seed: int = 0) -> TrainScan:
    """K lean GAN steps per dispatch (``TrainScan``)."""
    return TrainScan(make_gan_train_step(generator, discriminator, loss_type,
                                         compute_metrics=False, rng=rng,
                                         seed=seed))


def make_palette_train_scan(unet: nn.Module, sched: DiffusionSchedule,
                            learn_var: bool,
                            warmup_steps_per_epoch: Optional[int] = None,
                            external_rand: bool = False,
                            generator: Optional[torch.Generator] = None,
                            seed: int = 0) -> TrainScan:
    """K Palette steps per dispatch (``TrainScan``)."""
    return TrainScan(make_palette_train_step(
        unet, sched, learn_var, warmup_steps_per_epoch, external_rand,
        generator, seed))


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

    bound: Dict[str, object] = {}  # the denoiser of the last weights

    def sample(params: Mapping[str, torch.Tensor], x: torch.Tensor,
               y_0: torch.Tensor, generator: torch.Generator):
        unet.eval()
        # one denoiser per set of weights (by address), so that the chain's
        # CUDA graph, which reads them where they are, is recorded once
        weights = tuple(v.data_ptr() for v in params.values())
        if bound.get("weights") != weights:
            bound.clear()
            bound.update(weights=weights, fn=lambda cond, y_t, gamma:
                         call_with_params(unet, params, (cond, y_t, gamma)))

        with _no_grad_for(unet):
            y_pred = ddpm_sample(sched_inf, bound["fn"], x, generator,
                                 learn_var)
            dp, dt = denormalize(y_pred), denormalize(y_0)
            per_image = {"ssim": metrics.ssim_per_image(dp, dt),
                         "psnr": metrics.psnr_per_image(dp, dt),
                         "mse": metrics.mse_per_image(dp, dt)}
        return y_pred, per_image

    return sample
