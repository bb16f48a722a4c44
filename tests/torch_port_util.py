"""Shared helpers of the tests/test_torch_port_*.py files: numpy-made weights
and data handed to both the JAX package and the PyTorch port."""

import numpy as np


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
                            inner=32):
    """(flax module, params, batch_stats) for a Palette DiffusionUNet (2
    input channels, 2 res blocks, 4 heads, ``inner`` base width) with
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
                           attn_res=tuple(attn_res), num_heads=4)
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
                       inner=32):
    """The port's DiffusionUNet of the same shape, in eval mode, carrying
    ``params``/``batch_stats`` through ``state_dict_from_jax``."""
    import torch
    from pai_tpu_torch.interop import state_dict_from_jax
    from pai_tpu_torch.models.diffusion_unet import DiffusionUNet

    model = DiffusionUNet(in_channels=2, out_channels=2 if learn_var else 1,
                          inner_channel=inner, res_blocks=2,
                          channel_mults=tuple(mults),
                          attn_res=tuple(attn_res), num_heads=4,
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
