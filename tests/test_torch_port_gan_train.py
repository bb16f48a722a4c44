"""GAN training of pai_tpu_torch vs pai_tpu on the CPU: the InstanceNorm, the
PatchGAN, the five losses, and whole optimizer steps of a tiny Pix2Pix with
its PatchGAN from the same numpy-made weights and batches; then the port's
``Trainer``, train CLI, checkpoints and ``api.Pix2Pix.fit`` at 32x32; and the
first ten losses of ``tests/fixtures/train_parity_gan.npz`` (the reference's
own training run) as a second witness.

Sizes: Pix2Pix channel mults (1, 2, 4) at 32x32, batch 2, dropout 0; the
PatchGAN at its published widths (64-512), which takes no image smaller than
32x32. One JAX train step is compiled per loss type (a module-scoped cache).

Steps are compared from a shared state: before each of the three steps the
port's whole train state (both networks, running statistics, both Adam
chains, the EMA and their counts) is loaded from the JAX state through
``train.loop.load_train_state``, so float noise cannot grow from step to
step. Across steps the GAN's runs part quickly: Adam's first step moves an
element whose gradient is near its eps (1e-7) by a noise-sensitive fraction
of the learning rate, and the next forward then meets LeakyReLU inputs near
0 whose slope (1 or 0.2) the two runs take differently; the port's own
state over many steps is held by the trainer tests and by the second
witness below.

Tolerances, each with its reason:

* layers, the discriminator, the losses and their input gradients: 1e-5
  relative to each output's largest magnitude (float32 sums in other
  orders); the losses' kinks take JAX's gradients, so inputs at the kinks
  are included;
* each step: losses, ``d_loss`` and train metrics 1e-5 relative; Adam's
  first and second moments 1e-4 and 2e-4 relative to each tensor's largest
  magnitude (the square of a gradient doubles its relative error); the
  parameters and EMA weights within 1e-2 of a learning rate where the
  gradient is at least 1e-3 of the tensor's largest, and within two
  learning rates everywhere (where a gradient sits near Adam's eps its step
  is a noise-sensitive fraction of the learning rate); the BatchNorm running
  statistics 1e-4 relative (the batch statistics of the forwards, twice per
  step for ``gan``);
* the convolution biases that a BatchNorm follows get a gradient of zero up
  to float noise, which each framework sums in its own order: their
  gradients are held below a thousandth of the largest gradient instead;
* the PatchGAN's last block sums only 16 positions per channel at 32x32, so
  a LeakyReLU input there within float noise of 0 moves its gradients by
  several percent: the test asserts that none lies within 1e-6 of 0.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu.models import Discriminator as JaxDiscriminator
from pai_tpu.train import losses as jlosses
from pai_tpu.train import steps as jsteps
from pai_tpu.train.state import GanTrainState as JaxGanTrainState
from pai_tpu.train.state import gan_optimizer as jax_gan_optimizer
from pai_tpu_torch.interop import jax_from_state_dict, state_dict_from_jax
from pai_tpu_torch.models import Discriminator, build_generator
from pai_tpu_torch.ops import layers as tl
from pai_tpu_torch.train import losses as tlosses
from pai_tpu_torch.train import steps as tsteps
from torch_port_util import adam_initial_state
from torch_port_util import discriminator_numpy_params, gan_batches
from torch_port_util import jax_gan_state, pix2pix_numpy_variables
from torch_port_util import port_gan_models
from torch_port_util import rel as _rel
from torch_port_util import reference_state_dict, run_gan_steps

MULTS, SIZE, BATCH = (1, 2, 4), 32, 2  # gan_batches' defaults
HP = {"channel_mults": "1,2,4"}
LOSS_TYPES = ("gan", "ssim", "psnr", "ssim+psnr", "mse")
N_STEPS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def nets():
    module, params, stats = pix2pix_numpy_variables(MULTS, SIZE, seed=11)
    return module, params, stats, discriminator_numpy_params(12)


# ------------------------------------------------------------ the modules
def test_instance_norm_matches_jax():
    from pai_tpu.ops import InstanceNorm

    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (2, 5, 6, 3)).astype(np.float32)
    want = InstanceNorm().apply({}, jnp.asarray(x))
    got = tl.InstanceNorm()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel(got.permute(0, 2, 3, 1), want) <= 1e-5
    assert not list(tl.InstanceNorm().parameters())


@pytest.mark.parametrize("use_norm", [False, True])
def test_discriminator_matches_jax(use_norm):
    dparams = discriminator_numpy_params(3)
    rng = np.random.default_rng(4)
    x, y = (rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(lambda p, a, b: JaxDiscriminator(use_norm=use_norm).apply(
        {"params": p}, a, b))(dparams, x, y)
    disc = Discriminator(use_norm=use_norm)
    disc.load_state_dict(state_dict_from_jax("discriminator", dparams, {},
                                             {}), strict=True)
    got = disc(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 1, 1)
    assert _rel(got, want) <= 1e-5
    # the name map both ways
    back, stats = jax_from_state_dict("discriminator", disc.state_dict(), {})
    assert stats == {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(dparams)[0]:
        keys = [p.key for p in path]
        node = back
        for key in keys:
            node = node[key]
        np.testing.assert_array_equal(node, leaf)


def test_discriminator_width_and_names_are_the_references():
    disc = Discriminator(in_channels=2, device="meta")
    names = [k for k, _ in disc.named_parameters()]
    assert names == [f"discriminator.{i}.block.0.{leaf}" for i in range(4)
                     for leaf in ("weight", "bias")] + \
        ["discriminator.4.weight"]
    assert sum(p.numel() for p in disc.parameters()) == 2_763_712
    normed = Discriminator(use_norm=True, device="meta")
    kinds = [type(m).__name__ for m in normed.modules()]
    assert kinds.count("InstanceNorm") == 3  # blocks 2-4, never the first
    assert "InstanceNorm" not in [type(m).__name__ for m in disc.modules()]


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_generator_loss_and_its_gradient_match_jax(loss_type):
    """Values and input gradients; the inputs are clipped to [-1, 1], so
    some predictions equal their targets (the L1 term's kink) and one logit
    is 0 (the BCE's kinks)."""
    rng = np.random.default_rng(5)
    pred, target = (np.clip(rng.normal(0, 0.6, (2, 16, 16, 1)), -1, 1)
                    .astype(np.float32) for _ in range(2))
    assert np.sum(pred == target) > 0
    logits = rng.normal(0, 2, (2, 1, 1, 1)).astype(np.float32)
    logits[0] = 0.0

    def jax_loss(p, lg):
        return jlosses.generator_loss(loss_type, p, jnp.asarray(target),
                                      lg if loss_type == "gan" else None)

    want, (want_gp, want_gl) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1)))(jnp.asarray(pred), jnp.asarray(logits))
    p = torch.from_numpy(pred).requires_grad_(True)
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.generator_loss(loss_type, p, torch.from_numpy(target),
                                 lg if loss_type == "gan" else None)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    assert _rel(p.grad, want_gp) <= 1e-5
    if loss_type == "gan":
        assert _rel(lg.grad, want_gl) <= 1e-5
    assert tlosses.LOSS_TYPES == jlosses.LOSS_TYPES


def test_discriminator_loss_and_bce_match_jax():
    rng = np.random.default_rng(6)
    fake, real = (rng.normal(0, 3, (3, 2, 2, 1)).astype(np.float32)
                  for _ in range(2))
    fake[0, 0, 0, 0] = 40.0  # the stable form far out in both tails
    real[0, 0, 0, 0] = -40.0
    want, grads = jax.jit(jax.value_and_grad(jlosses.discriminator_loss,
                                             argnums=(0, 1)))(fake, real)
    f, r = (torch.from_numpy(a).requires_grad_(True) for a in (fake, real))
    got = tlosses.discriminator_loss(f, r)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    assert np.isfinite(float(got.detach()))
    assert _rel(f.grad, grads[0]) <= 1e-6 and _rel(r.grad, grads[1]) <= 1e-6
    a, b = (rng.uniform(-1, 1, (4, 3)).astype(np.float32) for _ in range(2))
    assert float(tlosses.l1_loss(torch.from_numpy(a), torch.from_numpy(b))) \
        == pytest.approx(float(jlosses.l1_loss(a, b)), rel=1e-6)


# ------------------------------------------------------------- the steps
_JAX_STEPS = {}


def _jax_step(module, disc, loss_type, key=None):
    """One compiled JAX train step per (loss type, case), kept for the
    module."""
    key = key or loss_type
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(jsteps.make_gan_train_step(
            module, disc if loss_type == "gan" else None, loss_type))
    return _JAX_STEPS[key]


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_three_train_steps_match_jax(loss_type, nets):
    """Three steps of each loss type from the same weights and batches: D
    then G against the updated D, one generator forward with the closed-form
    second BatchNorm update for ``gan``, the discriminator only for ``gan``,
    EMA over both networks."""
    module, params, stats, dparams = nets
    jstep = _jax_step(module, JaxDiscriminator(), loss_type)
    tstate = run_gan_steps(params, stats, dparams, loss_type,
                           gan_batches(21, N_STEPS), jstep, MULTS)
    assert (tstate.discriminator is None) == (loss_type != "gan")


def test_active_dropout_takes_the_exact_double_forward(nets, monkeypatch):
    """Mults (1, 2, 2) with dropout 0.5: the deepest decoder drops, so the
    GAN step runs two generator forwards with independent masks (the first
    without gradient, for the discriminator). The same masks are injected
    into both packages: the JAX package's ``Dropout2d`` is replaced, in its
    Pix2Pix module only and for this test only, by a layer that reads them
    in call order, as is the port's."""
    import pai_tpu.models.pix2pix as jpix

    mults = (1, 2, 2)
    module, params, stats = pix2pix_numpy_variables(mults, SIZE, seed=13)
    module = type(module)(channel_mults=mults, dropout=0.5)
    rng = np.random.default_rng(14)
    masks = [(rng.uniform(size=(BATCH, 1, 1, 128)) < 0.5).astype(np.float32)
             for _ in range(2)]
    calls = {"jax": 0, "port": 0}

    class JaxMask:
        def __init__(self, rate):
            self.rate = rate

        def __call__(self, x, deterministic):
            if self.rate == 0.0 or deterministic:
                return x
            mask = masks[calls["jax"] % 2]
            calls["jax"] += 1
            return x * jnp.asarray(mask / (1.0 - self.rate), x.dtype)

    def port_mask(layer, x):
        if layer.rate == 0.0 or not layer.training:
            return x
        mask = masks[calls["port"] % 2]
        calls["port"] += 1
        keep = torch.from_numpy(mask / (1.0 - layer.rate)).permute(0, 3, 1, 2)
        return x * keep

    monkeypatch.setattr(jpix, "Dropout2d", JaxMask)
    monkeypatch.setattr(tl.Dropout2d, "forward", port_mask)
    jstep = jax.jit(jsteps.make_gan_train_step(module, JaxDiscriminator(),
                                               "gan"))
    dparams = nets[3]
    tstate = run_gan_steps(params, stats, dparams, "gan",
                           gan_batches(24, N_STEPS), jstep, mults,
                           dropout=0.5,
                           before_step=lambda: calls.update(port=0))
    assert calls["jax"] == 2  # one trace: fwd#1 and fwd#2, one mask each
    assert calls["port"] == 2  # per step: the literal double forward
    assert tsteps.generator_dropout_active(tstate.generator)
    assert not tsteps.generator_dropout_active(
        build_generator("pix2pix", channel_mults=(1, 2, 4), dropout=0.5,
                        device="meta"))


def test_lean_step_leaves_the_state_of_the_logging_step(nets):
    """``compute_metrics=False`` skips the train metrics only: the states
    after two lean and two logging steps are equal bit for bit."""
    _, params, stats, dparams = nets
    states = []
    for full in (True, False):
        gen, disc = port_gan_models(params, stats, dparams, MULTS)
        state = tsteps.init_gan_state(gen, disc, "gan", use_ema=True)
        step = tsteps.make_gan_train_step(gen, disc, "gan",
                                          compute_metrics=full)
        for x, y in gan_batches(22, 2):
            state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert set(m) == ({"loss", "d_loss", "train_ssim", "train_psnr",
                           "train_rmse"} if full else {"loss", "d_loss"})
        states.append(state)
    from pai_tpu_torch.train.loop import train_state_dict

    a, b = (train_state_dict(s) for s in states)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_with_grads_and_the_eval_step_under_ema_match_jax(nets):
    """One ``gan`` step with the raw gradients returned (G and D), then the
    evaluation step under ``gan_eval_params``: the EMA's weights."""
    module, params, stats, dparams = nets
    x, y = gan_batches(23, 1)[0]
    jstep = jax.jit(jsteps.make_gan_train_step(
        module, JaxDiscriminator(), "gan", compute_metrics=False,
        with_grads=True))
    jstate, jm = jstep(jax_gan_state(params, stats, dparams, "gan"),
                       jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    gen, disc = port_gan_models(params, stats, dparams, MULTS)
    tstate = tsteps.init_gan_state(gen, disc, "gan", use_ema=True)
    tstate, tm = tsteps.make_gan_train_step(
        gen, disc, "gan", compute_metrics=False, with_grads=True)(
        tstate, torch.from_numpy(x), torch.from_numpy(y))
    for key, family in (("g_grads", "pix2pix"), ("d_grads", "discriminator")):
        want = state_dict_from_jax(family, jm[key], {}, HP)
        top = max(float(v.abs().max()) for v in want.values())
        for name, grad in tm[key].items():
            # the biases a BatchNorm reads: float noise
            if float(want[name].abs().max()) < 1e-3 * top:
                assert float(grad.abs().max()) <= 1e-3 * top, name
            else:
                assert _rel(grad, want[name]) <= 1e-4, (key, name)
    eval_params = tsteps.gan_eval_params(tstate)
    assert eval_params.keys() == dict(gen.named_parameters()).keys()
    assert all(eval_params[k] is tstate.ema.params[k] for k in eval_params)
    jparams = jsteps.gan_eval_params(jstate)
    want_pred, want_metrics = jax.jit(jsteps.make_gan_eval_step(module))(
        jparams, jstate.g_stats, jnp.asarray(x), jnp.asarray(y))
    pred, per_image = tsteps.make_gan_eval_step(gen)(
        eval_params, torch.from_numpy(x), torch.from_numpy(y))
    assert _rel(pred, want_pred) <= 1e-4
    for key in ("ssim", "psnr", "mse"):
        assert _rel(per_image[key], want_metrics[key]) <= 1e-4, key
    raw = tsteps.gan_eval_params(
        tsteps.init_gan_state(gen, None, "mse", use_ema=False))
    assert all(raw[k] is p for k, p in gen.named_parameters())


# ---------------------------- ROADMAP.md Queue C item 3: one value per channel
@pytest.mark.parametrize("tokens", [False, True])
def test_batchnorm_over_one_value_per_channel_matches_flax(tokens):
    """Train mode over N x H x W == 1: torch's own batch norm raises, flax
    normalises to the bias (the batch variance is 0) and moves the running
    variance toward 0. The port matches flax: the output, the gradients
    (none reaches the input or the scale) and the running statistics."""
    from pai_tpu.ops import layers as jl

    rng = np.random.default_rng(7)
    c = 5
    shape = (1, 1, c) if tokens else (1, 1, 1, c)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    bn = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
          "bias": rng.normal(0, 0.1, c).astype(np.float32)}
    st = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
          "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    g = rng.normal(size=shape).astype(np.float32)

    def flax_apply(xx, params):
        return jl.BatchNorm(use_running_average=False).apply(
            {"params": {"BatchNorm_0": params},
             "batch_stats": {"BatchNorm_0": st}}, xx, mutable=["batch_stats"])

    out, updated = flax_apply(jnp.asarray(x), bn)
    grads = jax.grad(lambda xx, p: jnp.sum(flax_apply(xx, p)[0] * g),
                     argnums=(0, 1))(jnp.asarray(x), bn)
    norm = tl.BatchNorm(c).train()
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(bn["scale"]))
        norm.bias.copy_(torch.from_numpy(bn["bias"]))
        norm.running_mean.copy_(torch.from_numpy(st["mean"]))
        norm.running_var.copy_(torch.from_numpy(st["var"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = norm(xt if tokens else xt.permute(0, 3, 1, 2))
    got = got if tokens else got.permute(0, 2, 3, 1)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), out, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy().reshape(c), bn["bias"],
                               atol=1e-6)
    assert float(xt.grad.abs().max()) == 0.0
    assert float(np.abs(grads[0]).max()) == 0.0
    np.testing.assert_allclose(norm.weight.grad.numpy(), grads[1]["scale"],
                               atol=1e-6)
    np.testing.assert_allclose(norm.bias.grad.numpy(), grads[1]["bias"],
                               atol=1e-6)
    stats = updated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(norm.running_mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(norm.running_var.numpy(), stats["var"],
                               rtol=1e-6)
    np.testing.assert_allclose(norm.running_var.numpy(), 0.9 * st["var"],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        torch.nn.BatchNorm2d(c).train()(torch.ones(1, c, 1, 1))


# ------------------------------------------------------- second witness
WITNESS_STEPS = 10
WITNESS_REL = 2e-3  # what pai_tpu meets on the same steps (1.4e-3)


def test_first_ten_losses_match_the_reference_fixture(monkeypatch):
    """``tests/fixtures/train_parity_gan.npz`` holds the losses of the
    reference's own GAN training (Pix2Pix mults (1, 2) and the PatchGAN,
    32x32, batch 8, ``tools/train_parity.py``), its weights as a seeded
    stream under the reference's names (``tools/make_parity_fixture.py``) and
    its batches as a seeded function (``train_parity.make_data``). The port
    loads those names as they are ("unet." and "disc." stripped) and trains
    ten steps on the same batches; so does ``pai_tpu`` from the same weights
    (``parity_port``, as ``tools/pai_train_parity.py`` does). Both must stay
    within ``WITNESS_REL`` of the reference's losses, the bound the JAX
    package meets (its float32 convolutions sum in XLA's order and part
    from torch's by 1.4e-3 at step 10; the port, torch on the CPU like the
    reference, by about 5e-7)."""
    import json

    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    from make_parity_fixture import deterministic_weights
    from parity_port import port_discriminator, port_pix2pix
    from train_parity import BATCH as FIX_BATCH
    from train_parity import N_TRAIN, make_data

    z = np.load(os.path.join(REPO, "tests", "fixtures",
                             "train_parity_gan.npz"))
    weights = deterministic_weights(json.loads(str(z["manifest"])))
    (tx, ty), _ = make_data()
    tx, ty = (np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))
              for a in (tx, ty))
    batches = [(tx[b * FIX_BATCH:(b + 1) * FIX_BATCH],
                ty[b * FIX_BATCH:(b + 1) * FIX_BATCH])
               for b in (s % (N_TRAIN // FIX_BATCH)
                         for s in range(WITNESS_STEPS))]
    ref = np.asarray(z["losses"][:WITNESS_STEPS], np.float64)

    gen = build_generator("pix2pix", channel_mults=(1, 2), device="cpu")
    gen.load_state_dict(reference_state_dict(weights, "unet."), strict=True)
    disc = Discriminator()
    disc.load_state_dict(reference_state_dict(weights, "disc."),
                         strict=True)
    state = tsteps.init_gan_state(gen, disc, "gan", use_ema=False)
    step = tsteps.make_gan_train_step(gen, disc, "gan",
                                      compute_metrics=False)
    port = []
    for x, y in batches:
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        port.append(float(m["loss"]))

    g_params, g_stats = port_pix2pix(weights)
    d_params = port_discriminator(weights)
    jstate = JaxGanTrainState(
        step=np.zeros((), np.int32), g_params=g_params, g_stats=g_stats,
        g_opt=adam_initial_state(jax_gan_optimizer(), g_params),
        d_params=d_params,
        d_opt=adam_initial_state(jax_gan_optimizer(), d_params), ema=None)
    from pai_tpu.models import build_generator as jax_build_generator

    jstep = jax.jit(jsteps.make_gan_train_step(
        jax_build_generator("pix2pix", channel_mults=(1, 2)),
        JaxDiscriminator(), "gan", compute_metrics=False))
    theirs = []
    for x, y in batches:
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                          jax.random.key(0))
        theirs.append(float(m["loss"]))
    port_rel = np.abs(np.asarray(port) - ref) / np.abs(ref)
    jax_rel = np.abs(np.asarray(theirs) - ref) / np.abs(ref)
    assert port_rel.max() <= WITNESS_REL, port_rel
    assert jax_rel.max() <= WITNESS_REL, jax_rel
