"""Shared helpers of the tests/test_torch_port_*.py files: numpy-made weights
and data handed to both the JAX package and the PyTorch port, and one fresh
interpreter that imports the whole port.

Importing this module caps PyTorch at one intra-op thread for the process.
The port's CPU tests run thousands of tiny ops, which threads do not speed
up; and where several test processes share the cores (pytest-xdist), OpenMP
threads that spin at every op's barrier while their siblings wait for a core
slow such a test by ten times or more. Every xdist worker collects every test
file, so the cap holds in each worker before its first test."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def fresh_interpreter_imports():
    """Import every module of ``pai_tpu_torch`` in one fresh interpreter (run
    once per test process, whichever test asks first) and return
    ``{"modules": [...], "loaded": [top-level names in sys.modules]}``."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import pai_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "pai_tpu_torch.__path__, 'pai_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "loaded = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'modules': names, 'loaded': loaded}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def numpy_tree_like(abstract, rng, kind):
    """A nested dict of float32 numpy arrays with the shapes of a flax
    abstract tree. ``kind`` "params": kernels N(0, 1/fan_in) so activations
    stay of order one at any width, biases N(0, 0.1), BatchNorm scales around
    1; "stats": means N(0, 0.2), variances in
    [0.5, 1.5] — non-trivial running statistics."""
    out = {}
    for key, value in abstract.items():
        if hasattr(value, "items"):
            out[key] = numpy_tree_like(value, rng, kind)
        elif kind == "stats":
            out[key] = (rng.uniform(0.5, 1.5, value.shape) if key == "var"
                        else rng.normal(0.0, 0.2, value.shape)
                        ).astype(np.float32)
        elif key == "scale":
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key == "kernel":
            std = 1.0 / np.sqrt(np.prod(value.shape[:-1]))
            out[key] = rng.normal(0.0, std, value.shape).astype(np.float32)
        else:
            out[key] = rng.normal(0.0, 0.1, value.shape).astype(np.float32)
    return out


TRANS_VIT_LAYERS = 2  # the tests' ViT depth (the published one is 12)


def jax_generator(name, mults, size=32, dropout=0.0):
    """The JAX package's generator ``name`` at ``mults``; TransUNet for
    ``size``-pixel images with ``TRANS_VIT_LAYERS`` ViT layers."""
    if name == "trans_unet":
        from pai_tpu.models.trans_unet import TransUnet

        return TransUnet(out_channels=1, image_size=size,
                         channel_mults=tuple(mults), patch_size=4,
                         num_heads=8, dropout=dropout,
                         vit_layers=TRANS_VIT_LAYERS)
    from pai_tpu.models import build_generator

    return build_generator(name, channel_mults=mults, dropout=dropout)


def port_generator(name, mults, size=32, dropout=0.0, **kwargs):
    """The port's counterpart of ``jax_generator``; ``kwargs`` go to the
    constructor (``generator``, ``device``, ``dtype``)."""
    if name == "trans_unet":
        from pai_tpu_torch.models.trans_unet import TransUnet

        return TransUnet(image_size=size, channel_mults=tuple(mults),
                         dropout=dropout, vit_layers=TRANS_VIT_LAYERS,
                         **kwargs)
    from pai_tpu_torch.models import build_generator

    return build_generator(name, channel_mults=mults, dropout=dropout,
                           **kwargs)


@functools.lru_cache(maxsize=None)
def _generator_shapes(name, mults, size):
    """(flax module, its abstract variables): ``init`` traced once per
    configuration and process (tracing a model's ``init`` takes seconds;
    the weights are drawn anew for every caller)."""
    import jax
    import jax.numpy as jnp

    module = jax_generator(name, mults, size)
    return module, jax.eval_shape(
        lambda: module.init(jax.random.key(0),
                            jnp.zeros((1, size, size, 1)), train=False))


def generator_numpy_variables(name, mults, size, seed):
    """(flax module, params, batch_stats) for the JAX package's generator
    ``name`` (``jax_generator``) with numpy-made weights; nothing is
    computed in JAX beyond shapes."""
    module, abstract = _generator_shapes(name, tuple(mults), size)
    rng = np.random.default_rng(seed)
    params = numpy_tree_like(abstract["params"], rng, "params")
    stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
    return module, params, stats


def pix2pix_numpy_variables(mults, size, seed):
    return generator_numpy_variables("pix2pix", mults, size, seed)


@functools.lru_cache(maxsize=None)
def _palette_shapes(mults, attn_res, size, learn_var, inner, num_heads):
    """``_generator_shapes`` of a Palette DiffusionUNet."""
    import jax
    import jax.numpy as jnp
    from pai_tpu.models.diffusion_unet import DiffusionUNet

    module = DiffusionUNet(in_channels=2, out_channels=2 if learn_var else 1,
                           inner_channel=inner, res_blocks=2,
                           channel_mults=mults, attn_res=attn_res,
                           num_heads=num_heads)
    zeros = jnp.zeros((1, size, size, 1))
    return module, jax.eval_shape(
        lambda: module.init(jax.random.key(0), zeros, zeros,
                            jnp.zeros((1,)), train=False))


def palette_numpy_variables(mults, attn_res, size, seed, learn_var=False,
                            inner=32, num_heads=4):
    """(flax module, params, batch_stats) for a Palette DiffusionUNet (2
    input channels, 2 res blocks, ``num_heads`` heads, ``inner`` base width) with
    numpy-made weights. The layers flax zero-initialises (every ResBlock's
    ``conv_out``, every attention ``proj``, ``out_conv``) get non-zero values
    like any other layer — at half the scale, so the residual stream grows
    slowly — or attention and the second half of each ResBlock would not
    reach the output."""
    module, abstract = _palette_shapes(tuple(mults), tuple(attn_res), size,
                                       learn_var, inner, num_heads)
    rng = np.random.default_rng(seed)
    params = numpy_tree_like(abstract["params"], rng, "params")
    stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
    for block in params.values():
        for member in ("conv_out", "proj"):
            if member in block:
                block[member]["kernel"] *= 0.5
    return module, params, stats


def port_palette_model(mults, attn_res, params, stats, learn_var=False,
                       inner=32, num_heads=4):
    """The port's DiffusionUNet of the same shape, in eval mode, carrying
    ``params``/``batch_stats`` through ``state_dict_from_jax``."""
    import torch
    from pai_tpu_torch.interop import state_dict_from_jax
    from pai_tpu_torch.models.diffusion_unet import DiffusionUNet

    model = DiffusionUNet(in_channels=2, out_channels=2 if learn_var else 1,
                          inner_channel=inner, res_blocks=2,
                          channel_mults=tuple(mults),
                          attn_res=tuple(attn_res), num_heads=num_heads,
                          generator=torch.Generator().manual_seed(0))
    model.load_state_dict(
        state_dict_from_jax("palette", params, stats,
                            palette_hparams(mults, attn_res)), strict=True)
    return model.eval()


def palette_hparams(mults, attn_res):
    return {"channel_mults": ",".join(str(m) for m in mults),
            "attention_res": ",".join(str(a) for a in attn_res)}


def blob_image(rng, size):
    """Smooth blobs plus a little texture, uint8 (examples/make_dataset.py
    style)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size), np.float32)
    for _ in range(6):
        cx, cy = rng.uniform(0.1, 0.9, 2)
        s = rng.uniform(0.03, 0.15)
        a = rng.uniform(0.3, 1.0)
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    img = img / img.max()
    img = np.clip(img * 0.9 + rng.uniform(0.0, 0.1, img.shape), 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def write_blob_dataset(directory, n, size, seed, write_png):
    """n (input, ground-truth) PNG pairs + ``data.yaml``; returns the
    manifest path."""
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        x = blob_image(rng, size)
        y = (255 - x.astype(np.int32)).astype(np.uint8)
        write_png(x, str(directory / f"in_{i}.png"))
        write_png(y, str(directory / f"gt_{i}.png"))
        entries.append(f"- input: in_{i}.png\n  ground_truth: gt_{i}.png\n")
    manifest = directory / "data.yaml"
    manifest.write_text("".join(entries))
    return str(manifest)


def bn_map(torch_mod, flax_mod):
    """(torch member, flax path, kind) triples of a BatchNorm, for
    ``load_flax_block``."""
    return [(f"{torch_mod}.weight", (flax_mod, "BatchNorm_0", "scale"), "1d"),
            (f"{torch_mod}.bias", (flax_mod, "BatchNorm_0", "bias"), "1d"),
            (f"{torch_mod}.running_mean",
             (flax_mod, "BatchNorm_0", "mean"), "1d"),
            (f"{torch_mod}.running_var",
             (flax_mod, "BatchNorm_0", "var"), "1d")]


def conv_map(torch_mod, flax_mod, kind="conv", inner=()):
    """The same for a convolution or dense layer (``kind`` as
    ``jax_params._to_torch`` takes it)."""
    return [(f"{torch_mod}.weight", (flax_mod, *inner, "kernel"), kind),
            (f"{torch_mod}.bias", (flax_mod, *inner, "bias"), "1d")]


def load_flax_block(module, name_map, params, stats=None):
    """Copy a flax block's numpy leaves into a port block by (torch member,
    flax path, kind) triples; a path whose last key is "" names the flax
    module's leaves directly under ``params``."""
    from pai_tpu_torch.interop import jax_params

    with torch.no_grad():
        for target, path, kind in name_map:
            tree = stats if path[-1] in ("mean", "var") else params
            for key in path:
                tree = tree[key]
            value = torch.from_numpy(jax_params._to_torch(
                np.asarray(tree, np.float32), kind).copy())
            if path[-1] in ("mean", "var"):
                module.get_buffer(target).copy_(value)
            else:
                module.get_parameter(target).copy_(value)


# ------------------------------------------------------------ GAN training
def gan_batches(seed, n, size=32, batch=2):
    """``n`` (x, y) pairs: y is the sign of a noisy inversion of x, every
    pixel saturated at -1 or 1 (0 or 255 in the PNG). The L1 term's gradient
    flips sign where a prediction crosses its target, so with targets inside
    (-1, 1) float noise in a prediction flips some pixels' gradients; a tanh
    output never reaches a saturated target."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.uniform(-1, 1, (batch, size, size, 1)).astype(np.float32)
        y = np.where(-0.8 * x + rng.normal(0, 0.2, x.shape) > 0, 1.0, -1.0)
        out.append((x, y.astype(np.float32)))
    return out


@functools.lru_cache(maxsize=None)
def _discriminator_shapes(size):
    import jax
    import jax.numpy as jnp
    from pai_tpu.models import Discriminator

    zeros = jnp.zeros((1, size, size, 1))
    return jax.eval_shape(
        lambda: Discriminator().init(jax.random.key(0), zeros, zeros))


def discriminator_numpy_params(seed, size=32):
    """numpy-made ``params`` of the JAX package's PatchGAN over a pair of
    one-channel images (its shapes traced once per size and process)."""
    return numpy_tree_like(_discriminator_shapes(size)["params"],
                           np.random.default_rng(seed), "params")


def reference_state_dict(weights, prefix):
    """The reference's tensors named ``prefix...`` (``tools/
    make_parity_fixture.deterministic_weights``) as a port ``state_dict``,
    the prefix stripped; each BatchNorm gains the zero
    ``num_batches_tracked`` that torch's modules own."""
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in weights.items()
          if k.startswith(prefix)}
    sd.update({k.replace("running_mean", "num_batches_tracked"):
               torch.zeros((), dtype=torch.int64)
               for k in list(sd) if k.endswith("running_mean")})
    return sd


def mults_hparams(mults):
    return {"channel_mults": ",".join(str(m) for m in mults)}


def port_gan_models(params, stats, dparams, mults, dropout=0.0,
                    family="pix2pix", size=32):
    """The port's generator ``family`` (in train mode) and PatchGAN carrying
    the JAX package's numpy trees."""
    from pai_tpu_torch.interop import state_dict_from_jax
    from pai_tpu_torch.models import Discriminator

    gen = port_generator(family, mults, size, dropout,
                         generator=torch.Generator().manual_seed(0))
    gen.load_state_dict(state_dict_from_jax(family, params, stats,
                                            mults_hparams(mults)),
                        strict=True)
    disc = Discriminator(generator=torch.Generator().manual_seed(0))
    disc.load_state_dict(state_dict_from_jax("discriminator", dparams, {},
                                             {}), strict=True)
    return gen, disc


def adam_initial_state(tx, tree):
    """``tx.init(tree)`` of an optax Adam chain (``gan_optimizer``,
    ``palette_optimizer``): zero moments and counts, made in numpy from the
    state's abstract shapes. An eager ``init`` runs one JAX op per leaf,
    and each op compiles on its own: seconds per model."""
    import jax

    return jax.tree.map(lambda leaf: np.zeros(leaf.shape, leaf.dtype),
                        jax.eval_shape(tx.init, tree))


def ema_initial_state(tree):
    """``pai_tpu.train.ema.init_ema(tree)`` in numpy: copies of the weights,
    no update counted yet."""
    import jax
    from pai_tpu.train.ema import EmaState

    return EmaState(params=jax.tree.map(np.array, tree),
                    num_updates=np.zeros((), np.int32))


def jax_gan_state(params, stats, dparams, loss_type):
    """The JAX package's GAN train state over those trees, EMA on (the
    discriminator and its Adam chain only for ``gan``)."""
    from pai_tpu.train.state import GanTrainState, gan_optimizer

    gan = loss_type == "gan"
    d = dparams if gan else None
    return GanTrainState(
        step=np.zeros((), np.int32), g_params=params, g_stats=stats,
        g_opt=adam_initial_state(gan_optimizer(), params), d_params=d,
        d_opt=adam_initial_state(gan_optimizer(), d) if gan else None,
        ema=ema_initial_state({"generator": params,
                               "discriminator": d if gan else {}}))


# ------------------------------------------------- GAN steps, port vs JAX
def rel(got, want):
    """Largest difference over the largest magnitude of ``want``."""
    got, want = (np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor)
                            else a, np.float64) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def slot_from_jax(jstate, loss_type, hp, family="pix2pix"):
    """The port's training slot (``train.loop.train_state_dict``'s names)
    of a JAX train state: both networks, both Adam chains, the EMA."""
    import jax

    from pai_tpu_torch.interop import state_dict_from_jax

    # one transfer of the whole state: leaf by leaf, each numpy conversion
    # of a JAX array waits for it alone
    jstate = jax.device_get(jstate)
    flat = dict(state_dict_from_jax(family, jstate.g_params,
                                    jstate.g_stats, hp))
    nets = [("", family, jstate.g_opt[0], jstate.ema.params["generator"])]
    if loss_type == "gan":
        flat.update({"discriminator." + k: v for k, v in state_dict_from_jax(
            "discriminator", jstate.d_params, {}, {}).items()})
        nets.append(("discriminator.", "discriminator", jstate.d_opt[0],
                     jstate.ema.params["discriminator"]))
    for prefix, name, adam, ema in nets:
        count = torch.tensor(float(adam.count))
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            for k, v in state_dict_from_jax(name, tree, {}, hp).items():
                flat[f"opt.{prefix}{k}.{key}"] = v.clone()
                flat[f"opt.{prefix}{k}.step"] = count.clone()
        for k, v in state_dict_from_jax(name, ema, {}, hp).items():
            flat[f"ema.{prefix}{k}"] = v.clone()
    return flat


def compare_step(tstate, jstate, loss_type, before, hp, family="pix2pix",
                 moment_tol=1e-4, steps=1):
    """One step's result from a shared state (the tolerances are those of
    ``tests/test_torch_port_gan_train.py``'s docstring); ``before`` is the
    shared state as a slot. ``moment_tol`` bounds the generator's Adam first
    moments (the second: twice that) relative to each tensor's largest.
    ``steps`` > 1: the result of that many steps from ``before``, the
    parameters and EMA weights held to the sum of the steps' bounds."""
    from pai_tpu_torch.train.loop import train_state_dict
    from pai_tpu_torch.train.state import GAN_LR

    after = slot_from_jax(jstate, loss_type, hp, family)
    got = train_state_dict(tstate)
    assert got.keys() == after.keys()
    for prefix, module in (("", tstate.generator),
                           ("discriminator.", tstate.discriminator)):
        if module is None:
            continue
        mus = {n: after[f"opt.{prefix}{n}.exp_avg"]
               for n, _ in module.named_parameters()}
        top = max(float(v.abs().max()) for v in mus.values())
        # float noise: the biases a BatchNorm reads, directly or through
        # linear layers and max pools, have a gradient of zero
        degenerate = {n for n, v in mus.items()
                      if float(v.abs().max()) < 1e-3 * top}
        for name, _ in module.named_parameters():
            key, mu = prefix + name, mus[name]
            assert float(got[f"opt.{key}.step"]) == float(jstate.step)
            for what in (key, "ema." + key):
                diff = (got[what] - after[what]).abs()
                assert float(diff.max()) <= 2.0 * GAN_LR * steps, what
            if name in degenerate:
                for side in (got[f"opt.{key}.exp_avg"], mu):
                    assert float(side.abs().max()) <= 1e-3 * top, key
                continue
            tol = moment_tol if prefix == "" else 1e-4
            assert rel(got[f"opt.{key}.exp_avg"], mu) <= tol, key
            assert rel(got[f"opt.{key}.exp_avg_sq"],
                       after[f"opt.{key}.exp_avg_sq"]) <= 2 * tol, key
            moved = (after[key] - before[key]).abs().max()
            assert float(moved) > 0.5 * GAN_LR, key  # not vacuous
            # where Adam's first step cannot change sign within the bound
            large = mu.abs() >= max(1e-3, tol) * mu.abs().max()
            for what in (key, "ema." + key):
                diff = (got[what] - after[what]).abs()
                assert float(diff[large].max()) <= 1e-2 * GAN_LR * steps, \
                    what
    for name, buf in tstate.generator.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert rel(buf, after[name]) <= 1e-4, name
    assert tstate.ema.num_updates == int(jstate.ema.num_updates)


def deepest_leaky_inputs(disc, margins):
    """Record the smallest |input| of the PatchGAN's last LeakyReLU: its
    block sums 16 positions per channel at 32x32, so an input within float
    noise of 0, whose slope (1 or 0.2) the two frameworks may then take
    differently, moves that block's gradients by several percent."""
    def record(module, args):
        margins.append(float(args[0].detach().abs().min()))

    disc.discriminator[3].block[-1].register_forward_pre_hook(record)


def run_gan_steps(params, stats, dparams, loss_type, batches, jstep, mults,
                  dropout=0.0, before_step=None, family="pix2pix",
                  moment_tol=1e-4):
    """``len(batches)`` steps of both packages. Before each, the port's whole
    train state is loaded from the JAX state (``train.loop.
    load_train_state``), so each step is compared from a shared state."""
    import jax
    import jax.numpy as jnp
    import pytest

    from pai_tpu_torch.train import steps as tsteps
    from pai_tpu_torch.train.loop import load_train_state

    hp = mults_hparams(mults)
    size = batches[0][0].shape[1]
    gen, disc = port_gan_models(params, stats, dparams, mults, dropout,
                                family, size)
    tstate = tsteps.init_gan_state(gen, disc, loss_type, use_ema=True)
    margins = []
    if loss_type == "gan":
        deepest_leaky_inputs(disc, margins)
    tstep = tsteps.make_gan_train_step(gen, disc, loss_type)
    jstate = jax_gan_state(params, stats, dparams, loss_type)
    keys = {"loss", "train_ssim", "train_psnr", "train_rmse"} | (
        {"d_loss"} if loss_type == "gan" else set())
    for step, (x, y) in enumerate(batches):
        before = slot_from_jax(jstate, loss_type, hp, family)
        if step:  # step 0: the fresh state (Adam's moments not yet made)
            load_train_state(tstate, before, {
                "step": step, "ema_num_updates": step})
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                           jax.random.key(0))
        if before_step is not None:
            before_step()
        tstate, tm = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        assert set(tm) == set(jm) == keys
        for key in keys:
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                                   abs=1e-6), (step, key)
        assert tstate.step == int(jstate.step) == step + 1
        compare_step(tstate, jstate, loss_type, before, hp, family,
                     moment_tol)
    assert all(m >= 1e-6 for m in margins), margins
    return tstate
