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


def pix2pix_numpy_variables(mults, size, seed):
    """(flax module, params, batch_stats) for a Pix2PixUnet with numpy-made
    weights; nothing is computed in JAX beyond shapes."""
    import jax
    import jax.numpy as jnp
    from pai_tpu.models import build_generator

    module = build_generator("pix2pix", channel_mults=mults)
    abstract = jax.eval_shape(
        lambda: module.init(jax.random.key(0),
                            jnp.zeros((1, size, size, 1)), train=False))
    rng = np.random.default_rng(seed)
    params = numpy_tree_like(abstract["params"], rng, "params")
    stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
    return module, params, stats


def palette_numpy_variables(mults, attn_res, size, seed, learn_var=False,
                            inner=32, num_heads=4):
    """(flax module, params, batch_stats) for a Palette DiffusionUNet (2
    input channels, 2 res blocks, ``num_heads`` heads, ``inner`` base width) with
    numpy-made weights. The layers flax zero-initialises (every ResBlock's
    ``conv_out``, every attention ``proj``, ``out_conv``) get non-zero values
    like any other layer — at half the scale, so the residual stream grows
    slowly — or attention and the second half of each ResBlock would not
    reach the output."""
    import jax
    import jax.numpy as jnp
    from pai_tpu.models.diffusion_unet import DiffusionUNet

    module = DiffusionUNet(in_channels=2, out_channels=2 if learn_var else 1,
                           inner_channel=inner, res_blocks=2,
                           channel_mults=tuple(mults),
                           attn_res=tuple(attn_res), num_heads=num_heads)
    zeros = jnp.zeros((1, size, size, 1))
    abstract = jax.eval_shape(
        lambda: module.init(jax.random.key(0), zeros, zeros,
                            jnp.zeros((1,)), train=False))
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


def discriminator_numpy_params(seed, size=32):
    """numpy-made ``params`` of the JAX package's PatchGAN over a pair of
    one-channel images."""
    import jax
    import jax.numpy as jnp
    from pai_tpu.models import Discriminator

    zeros = jnp.zeros((1, size, size, 1))
    abstract = jax.eval_shape(
        lambda: Discriminator().init(jax.random.key(0), zeros, zeros))
    return numpy_tree_like(abstract["params"], np.random.default_rng(seed),
                           "params")


def port_gan_models(params, stats, dparams, mults, dropout=0.0):
    """The port's Pix2Pix (in train mode) and PatchGAN carrying the JAX
    package's numpy trees."""
    from pai_tpu_torch.interop import state_dict_from_jax
    from pai_tpu_torch.models import Discriminator, build_generator

    gen = build_generator("pix2pix", channel_mults=mults, dropout=dropout,
                          generator=torch.Generator().manual_seed(0))
    hp = {"channel_mults": ",".join(str(m) for m in mults)}
    gen.load_state_dict(state_dict_from_jax("pix2pix", params, stats, hp),
                        strict=True)
    disc = Discriminator(generator=torch.Generator().manual_seed(0))
    disc.load_state_dict(state_dict_from_jax("discriminator", dparams, {},
                                             {}), strict=True)
    return gen, disc


def jax_gan_state(params, stats, dparams, loss_type):
    """The JAX package's GAN train state over those trees, EMA on (the
    discriminator and its Adam chain only for ``gan``)."""
    import jax.numpy as jnp
    from pai_tpu.train.ema import init_ema
    from pai_tpu.train.state import GanTrainState, gan_optimizer

    gan = loss_type == "gan"
    d = dparams if gan else None
    return GanTrainState(
        step=jnp.zeros((), jnp.int32), g_params=params, g_stats=stats,
        g_opt=gan_optimizer().init(params), d_params=d,
        d_opt=gan_optimizer().init(d) if gan else None,
        ema=init_ema({"generator": params,
                      "discriminator": d if gan else {}}))
