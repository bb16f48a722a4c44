"""Palette training of pai_tpu_torch vs pai_tpu on the CPU: the training
half of ``diffusion.gaussian``, the EMA, the learning-rate schedule, the
BatchNorm running statistics of a train-mode forward, and three whole train
steps from the same numpy-made weights, batches and injected draws
``{"t", "noise", "u"}`` (``make_palette_train_step(..., external_rand=True)``
on both sides).

With ``learn_var`` off (the CLI default) the steps run one UNet of 16x16
images, channel mults (1, 2), inner width 32, one head, attention at
downsample rates 1 and 2. Both packages take their long-sequence attention
from 256 tokens here (the test lowers the 4,096-token threshold on both
sides), so rate 1 (256 tokens of D = 32) goes through ``FlashAttention`` on
this side — the plain flash version and its plain backward, recomputed under
the checkpoint — and through the JAX package's blockwise formulation (128-row
blocks, under ``jax.checkpoint``) differentiated by XLA on the other; rate 2
and the middle block (64 tokens) take the full softmax on both sides. (At
64x64, where 4,096 tokens take that path unpatched, the JAX step costs three
times as long on the CPU.) With ``learn_var`` on (and the EMA) a one-level
UNet of 8x8 images, whose JAX step compiles in half the time.

Tolerances: elementwise functions 1e-6 relative; losses 1e-5 relative;
gradients and parameters 1e-4 relative to each tensor's largest magnitude, or,
for the parameters, to the distance the three Adam steps moved them (float32
reductions over 4,096-token softmaxes and 64x64 convolutions, summed in other
orders). One class of parameters is held to a bound instead: a bias that
only shifts what a BatchNorm then takes away (every bias that lands on the
residual stream, the k and v parts of qkv) has a gradient of zero up to float
noise, which each side sums in its own order (it changes with the number of
threads), and Adam scales that noise to a step of up to the learning rate, of
either sign, in either framework. Such gradients are held below a thousandth
of the largest gradient. The running means that follow such shifts are
compared at the size of the shifts; the running variances, which no shift
moves, closely."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu.diffusion import gaussian as jg
from pai_tpu.diffusion import make_schedule as jax_schedule
from pai_tpu_torch.diffusion import gaussian as tg
from pai_tpu_torch.diffusion import make_schedule as port_schedule
from pai_tpu_torch.interop import state_dict_from_jax
from pai_tpu_torch.train import ema as tema
from pai_tpu_torch.train import steps as tsteps
from pai_tpu_torch.train.state import palette_lr
from torch_port_util import (adam_initial_state, ema_initial_state,
                             palette_hparams, palette_numpy_variables,
                             port_palette_model)

RTOL = 1e-6


def _close(got, want, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def schedules():
    return (jax_schedule("linear", 2000, 1e-6, 0.01),
            port_schedule("linear", 2000, 1e-6, 0.01))


def _noisy(seed, n=3, size=6, c=1):
    rng = np.random.default_rng(seed)
    y_0 = rng.uniform(-1, 1, (n, size, size, c)).astype(np.float32)
    noise = rng.normal(size=(n, size, size, c)).astype(np.float32)
    u = rng.uniform(size=(n,)).astype(np.float32)
    return y_0, noise, u


# ---------------------------------------------------------------- gaussian
def test_q_sample_matches_jax_and_masks_the_noise_at_t_zero(schedules):
    jsched, tsched = schedules
    y_0, noise, u = _noisy(0)
    t = np.array([0, 1, 1999], np.int32)
    want = jax.jit(lambda *a: jg.q_sample(jsched, *a[:2], None, *a[2:]))(
        jnp.asarray(y_0), jnp.asarray(t), jnp.asarray(noise), jnp.asarray(u))
    got = tg.q_sample(tsched, torch.from_numpy(y_0),
                      torch.from_numpy(t).long(),
                      noise=torch.from_numpy(noise), u=torch.from_numpy(u))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert float(got[1][0].abs().max()) == 0.0  # no noise at t == 0
    # drawn from a generator when not given: the same seed, the same draws
    gen = [torch.Generator().manual_seed(1) for _ in range(2)]
    a, b = (tg.q_sample(tsched, torch.from_numpy(y_0),
                        torch.from_numpy(t).long(), g) for g in gen)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(a[1][1:].std()) > 0.5


def test_kl_cdf_and_discretized_likelihood_match_jax():
    rng = np.random.default_rng(1)
    m1, v1, m2, v2 = (rng.normal(size=(2, 5, 5, 1)).astype(np.float32)
                      for _ in range(4))
    _close(tg.normal_kl(*map(torch.from_numpy, (m1, v1, m2, v2))).numpy(),
           jg.normal_kl(*map(jnp.asarray, (m1, v1, m2, v2))), atol=1e-6)
    x = np.concatenate([[-1.0, 1.0, -0.9995, 0.9995],
                        rng.uniform(-1, 1, 21)]).astype(np.float32)
    x = x.reshape(1, 5, 5, 1)
    _close(tg.approx_standard_normal_cdf(torch.from_numpy(m1)).numpy(),
           jg.approx_standard_normal_cdf(jnp.asarray(m1)))
    # means near x (within two standard deviations): far out in the tails
    # the likelihood is a difference of two CDFs within float rounding of
    # one, and the two frameworks' tanh round differently
    scales = rng.uniform(-3.0, -2.0, x.shape).astype(np.float32)
    means = (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)
    _close(tg.discretized_gaussian_log_likelihood(
               torch.from_numpy(x), means=torch.from_numpy(means),
               log_scales=torch.from_numpy(scales)).numpy(),
           jg.discretized_gaussian_log_likelihood(
               jnp.asarray(x), means=jnp.asarray(means),
               log_scales=jnp.asarray(scales)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("learn_var", [False, True])
def test_vlb_term_matches_jax(schedules, learn_var):
    """KL for t > 0, discretised NLL at t == 0; under ``learn_var`` the mean
    channels are detached, so only the variance channels get its gradient."""
    jsched, tsched = schedules
    y_0, noise, u = _noisy(2)
    t = np.array([0, 5, 1500], np.int32)
    y_t = np.array(jax.jit(lambda *a: jg.q_sample(jsched, *a[:2], None,
                                                  *a[2:]))(
        jnp.asarray(y_0), jnp.asarray(t), jnp.asarray(noise),
        jnp.asarray(u))[0])
    rng = np.random.default_rng(3)
    out = rng.normal(0, 0.5, y_0.shape[:-1] + (2 if learn_var else 1,)
                     ).astype(np.float32)
    def jax_vlb(o):
        return jg.vlb_term(jsched, o, jnp.asarray(y_0), jnp.asarray(y_t),
                           jnp.asarray(t), learn_var)

    want = jax.jit(jax_vlb)(jnp.asarray(out))
    leaf = torch.from_numpy(out).requires_grad_(True)
    got = tg.vlb_term(tsched, leaf, torch.from_numpy(y_0),
                      torch.from_numpy(y_t), torch.from_numpy(t).long(),
                      learn_var)
    _close(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    want_grad = jax.jit(jax.grad(lambda o: jnp.sum(jax_vlb(o))))(
        jnp.asarray(out))
    got.sum().backward()
    # the NLL's gradient goes through a difference of two tanh CDFs: 1e-5
    # of the largest element, as XLA's fused float32 arithmetic rounds it
    _close(leaf.grad.numpy(), want_grad, rtol=1e-4,
           atol=1e-5 * float(np.abs(want_grad).max()))
    if learn_var:
        assert float(leaf.grad[..., 0].abs().max()) == 0.0
        assert float(leaf.grad[..., 1].abs().max()) > 0.0


# ----------------------------------------------------------- EMA and the lr
def test_ema_matches_jax():
    from pai_tpu.train.ema import init_ema, update_ema

    rng = np.random.default_rng(4)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jema = init_ema(params)
    live = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = tema.init_ema(live)
    assert tstate.params["a"].data_ptr() != live["a"].data_ptr()
    for step in range(3):
        new = {k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in params.items()}
        jema = update_ema(jema, new)
        for k in live:
            live[k].copy_(torch.from_numpy(new[k]))
        tema.update_ema(tstate, live)
        assert tstate.num_updates == int(jema.num_updates) == step + 1
        for k in params:
            _close(tstate.params[k].numpy(), jema.params[k], atol=1e-7)
    # the effective decay ramps as min(0.9999, (1 + n) / (10 + n))
    assert tema.decay_for(1, 0.9999) == np.float32(2.0 / 11.0)
    assert tema.decay_for(10 ** 6, 0.9999) == np.float32(0.9999)


@pytest.mark.parametrize("steps_per_epoch", [None, 3])
def test_learning_rate_schedule_matches_optax(steps_per_epoch):
    """The JAX optimizer's step at count c, with Adam's moments zeroed and a
    gradient of one, is -lr(c) * m_hat / (sqrt(v_hat) + eps): the learning
    rate it reads at the count before the step, recovered here and compared
    with ``palette_lr``. Counts cross the epoch boundaries and the end of the
    10,000-unit warmup."""
    import optax
    from pai_tpu.train.state import palette_optimizer

    tx = palette_optimizer(steps_per_epoch=steps_per_epoch)
    params = jnp.zeros(())
    state = tx.init(params)
    for count in (0, 1, 2, 3, 7, 9999, 10000, 30001, 40000):
        adam, sched = state
        c = jnp.asarray(count, jnp.int32)
        probe = (adam._replace(count=c), sched._replace(count=c))
        updates, _ = tx.update(jnp.ones(()), probe, params)
        m_hat = 0.1 / (1 - 0.9 ** (count + 1))
        v_hat = 0.001 / (1 - 0.999 ** (count + 1))
        lr = -float(updates) / (m_hat / (np.sqrt(v_hat) + 1e-8))
        # the probe is good to float32's rounding of b2 (1e-5); the warmup
        # moves the rate by 2e-4 per unit
        assert palette_lr(count, steps_per_epoch) == pytest.approx(
            lr, rel=2e-5), count
    assert isinstance(tx, optax.GradientTransformation)
    assert palette_lr(0) == pytest.approx(1e-4 / 3)
    assert palette_lr(10 ** 6) == pytest.approx(1e-4)
    assert palette_lr(29999, 3) == palette_lr(9999)


# ------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("tokens", [False, True])
def test_batchnorm_running_stats_match_jax_after_a_train_forward(tokens):
    """Both packages normalise with the biased batch variance; the running
    variance must move toward it too (torch's own module takes the unbiased
    one, n/(n-1) larger)."""
    from pai_tpu.ops import layers as jl
    from pai_tpu_torch.ops import layers as tl

    rng = np.random.default_rng(5)
    shape = (3, 10, 6) if tokens else (2, 3, 4, 6)
    flax_momentum, momentum = (0.81, 0.19) if tokens else (0.9, 0.1)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
          "bias": rng.normal(0, 0.1, 6).astype(np.float32)}
    st = {"mean": rng.normal(0, 0.2, 6).astype(np.float32),
          "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    want, updated = jl.BatchNorm(use_running_average=False,
                                 momentum=flax_momentum).apply(
        {"params": {"BatchNorm_0": bn}, "batch_stats": {"BatchNorm_0": st}},
        jnp.asarray(x), mutable=["batch_stats"])
    norm = tl.BatchNorm(6, momentum=momentum).train()
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(bn["scale"]))
        norm.bias.copy_(torch.from_numpy(bn["bias"]))
        norm.running_mean.copy_(torch.from_numpy(st["mean"]))
        norm.running_var.copy_(torch.from_numpy(st["var"]))
    xt = torch.from_numpy(x)
    got = norm(xt if tokens else xt.permute(0, 3, 1, 2))
    got = got if tokens else got.permute(0, 2, 3, 1)
    _close(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    stats = updated["batch_stats"]["BatchNorm_0"]
    _close(norm.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-6)
    _close(norm.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ three train steps
MULTS, INNER = (1, 2), 32
STEPS_PER_EPOCH = 2  # the warmup's unit changes between steps 2 and 3


def _degenerate(name, tensor):
    """Biases whose gradient is zero up to float noise: every bias added to
    the residual stream (a per-channel constant there only ever reaches
    BatchNorms, skip convolutions, pooling and concatenation, and every
    BatchNorm removes it), and the k and v parts of qkv (k's adds the same
    amount to every logit of a query row; v's, through softmax weights that
    sum to one, a constant to the residual stream)."""
    if name.endswith(("out_layers.3.bias", "skip_connection.bias",
                      "proj_out.bias", "input_blocks.0.0.bias",
                      "in_layers.2.bias")):
        return torch.ones_like(tensor, dtype=torch.bool)
    if name.endswith("qkv.bias"):
        d = tensor.shape[0] // 3  # one head: (q, k, v) x D
        mask = torch.ones_like(tensor, dtype=torch.bool)
        mask[:d] = False
        return mask
    return torch.zeros_like(tensor, dtype=torch.bool)


# learn_var off (the CLI default, the path the card runs) on two levels that
# take both attention branches; learn_var on (the VLB's gradient, the
# detached mean, two output channels, the EMA) on one level of 8x8 with
# attention in the middle block only. Each case compiles one JAX train step,
# which is most of its time, and a one-level UNet compiles in half the time.
@pytest.mark.parametrize("learn_var,mults,size,attn", [
    (False, MULTS, 16, (1, 2)), (True, (1,), 8, (2,))])
def test_three_train_steps_match_jax(learn_var, mults, size, attn, schedules,
                                     monkeypatch):
    from pai_tpu.train import steps as jsteps
    from pai_tpu.train.state import PaletteTrainState, palette_optimizer
    from pai_tpu.ops import attention as jax_attention
    from pai_tpu_torch.ops import attention as port_attention

    flash_calls = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a: flash_calls.append(a[0].shape) or real(*a))
    # the long-sequence path from 256 tokens instead of 4,096 on both sides
    # (the port's flash version, the JAX package's blockwise formulation in
    # 128-row blocks): the same functions, at a size the CPU trains quickly
    monkeypatch.setattr(port_attention, "FLASH_THRESHOLD", 256)
    monkeypatch.setattr(port_attention, "FLASH_MULTIPLE", 128)
    for name, value in (("_BLOCKWISE_THRESHOLD", 256), ("_Q_BLOCK", 128),
                        ("_KV_BLOCK", 128)):
        monkeypatch.setattr(jax_attention, name, value)
    jsched, tsched = schedules
    module, params, stats = palette_numpy_variables(
        mults, attn, size, seed=3, learn_var=learn_var, inner=INNER,
        num_heads=1)
    model = port_palette_model(mults, attn, params, stats, learn_var,
                               inner=INNER, num_heads=1)
    initial = {k: v.detach().clone() for k, v in model.named_parameters()}
    jstate = PaletteTrainState(
        step=np.zeros((), np.int32), params=params, stats=stats,
        opt=adam_initial_state(
            palette_optimizer(steps_per_epoch=STEPS_PER_EPOCH), params),
        ema=ema_initial_state({"unet": params}) if learn_var else None)
    jstep = jax.jit(jsteps.make_palette_train_step(
        module, jsched, learn_var, warmup_steps_per_epoch=STEPS_PER_EPOCH,
        external_rand=True))
    tstate = tsteps.init_palette_state(model, use_ema=learn_var)
    tstep = tsteps.make_palette_train_step(
        model, tsched, learn_var, warmup_steps_per_epoch=STEPS_PER_EPOCH,
        external_rand=True)
    hp = palette_hparams(mults, attn)

    def adam_moments(moment, jax_moment):
        """(port, JAX) Adam moments by port parameter name."""
        want = state_dict_from_jax("palette", jax_moment, {}, hp)
        return {name: (tstate.opt.state[p][moment], want[name])
                for name, p in model.named_parameters()}

    rng = np.random.default_rng(6)
    for step, t in enumerate((0, 1234, 77)):  # t == 0: the noise masked,
        x, y = (rng.uniform(-1, 1, (1, size, size, 1)).astype(np.float32)
                for _ in range(2))           # the VLB's NLL branch
        rand = {"t": np.array([t], np.int32),
                "noise": rng.normal(size=(1, size, size, 1)).astype(
                    np.float32),
                "u": rng.uniform(size=(1,)).astype(np.float32)}
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                           {k: jnp.asarray(v) for k, v in rand.items()})
        tstate, tm = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y),
                           {k: torch.from_numpy(v) for k, v in rand.items()})
        for key in ("loss", "mse_loss", "vlb_loss"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                                   abs=1e-7), (step, key)
        # Adam's first moment is a running sum of the gradients (0.1 g after
        # the first step): the gradients, compared without Adam's scaling
        moments = adam_moments("exp_avg", jstate.opt[0].mu)
        top = max(float(w.abs().max()) for _, w in moments.values())
        for name, (got, want) in moments.items():
            mask = _degenerate(name, got)
            if mask.any():  # float noise on both sides: a bound, not a match
                for side in (got, want):
                    assert float(side[mask].abs().max()) <= 1e-3 * top, \
                        (step, name)
            if (~mask).any():
                scale = max(float(want[~mask].abs().max()), 1e-3 * top)
                assert float((got - want)[~mask].abs().max()) <= \
                    1e-4 * scale, (step, name)
    assert tstate.step == int(jstate.step) == 3
    if size == 16:  # 5 flash calls per forward, again under the recompute
        assert flash_calls == [(1, 1, 256, 32)] * 30
    else:
        assert not flash_calls

    want_sd = state_dict_from_jax("palette", jstate.params, jstate.stats, hp)
    lr_sum = 3 * 1e-4  # three steps at a rate below 1e-4
    for name, p in model.named_parameters():
        got, want = p.detach(), want_sd[name]
        mask = _degenerate(name, got)
        if mask.any():  # the degenerate biases: a bound, not a match
            for side in (got, want):
                assert float((side - initial[name])[mask].abs().max()) \
                    <= 3.5 * lr_sum, name
        if (~mask).any():
            # an Adam step is about one learning rate long; elements whose
            # gradient is near eps (1e-8) step by a gradient-sensitive
            # fraction of it: agreement to a fifth of the distance moved
            assert float((got - want)[~mask].abs().max()) <= 0.2 * lr_sum, \
                name
            assert float((want - initial[name])[~mask].abs().max()) > \
                0.5 * lr_sum / 3, name  # the comparison is not vacuous
    if learn_var:
        for name, shadow in tstate.ema.params.items():
            assert shadow.shape == want_sd[name].shape
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):
            _close(buf.numpy(), want_sd[name].numpy(), rtol=1e-4, atol=1e-6)
        elif name.endswith("running_mean"):  # follows the degenerate shifts
            _close(buf.numpy(), want_sd[name].numpy(), rtol=0,
                   atol=3.5 * lr_sum)
