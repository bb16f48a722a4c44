"""What each bfloat16 rounding point of ``--precision bf16-mixed`` buys and
costs: the port with one rounding point at a time put back to the library's
single op, against the port as it is.

    python3 tools/bf16_rounding_ablation.py --cpu   # agreement with pai_tpu
    python3 tools/bf16_rounding_ablation.py         # time on one NVIDIA GPU

The rounding points (``pai_tpu_torch/ops/layers.py``): ``bias`` (the bias
added after the product is rounded, and the float32 sum a BatchNorm or the
float32 output reads; put back: the bias inside the product), ``silu`` (put
back: ``F.silu``), ``avg_pool`` (put back: ``F.avg_pool2d``), ``batchnorm``
(eval mode: flax's formula in float32, rounded once; put back: the library's
float32 batch norm, rounded once, as train mode runs), ``residual`` (the ResBlock's float32 residual sum and its
rounding where a bfloat16 op reads it; put back: the bfloat16 sum) and
``all`` of them at once.

``--cpu`` runs the small diffusion UNet of ``tests/test_torch_port_bf16.py``
(two levels at 16x16, seeds 5-7) and its one-level training step (seed 5) on
the CPU against the JAX package at ``dtype=bfloat16``, and prints per variant
the readings that test bounds: ``gap`` (largest difference over the JAX
package's own largest bf16-vs-float32 difference), ``equal`` (share of values
bit-equal) and ``corr`` (cosine of the two bf16-minus-float32 errors). It
needs JAX and ``pai_tpu``; the port itself imports neither.

Without ``--cpu`` it times, per variant, the bf16-mixed forward (batch 2)
and training step (batch 4) of the CLI-default UNet with ``chip_smoke.py``'s
``bf16_path`` (CUDA events and the profiler's device busy time), and prints
one JSON line per variant, then the card's name and power limit."""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pai_tpu_torch.models import diffusion_unet as du  # noqa: E402
from pai_tpu_torch.ops import layers  # noqa: E402

VARIANTS = ("none", "bias", "silu", "avg_pool", "batchnorm", "residual",
            "all")


def _library_batchnorm(self, x):
    return nn.BatchNorm2d.forward(self, x.float()).to(torch.bfloat16)


def _patches(name):
    """(object, attribute, replacement) for the rounding point ``name``."""
    points = {
        "bias": [(mod, "_bias_after_rounding",
                  lambda op, x, w, b, shape, float32_sum=False: op(x, w, b))
                 for mod in (layers, du)],
        "silu": [(layers, "silu", nn.functional.silu)],
        "avg_pool": [(du, "avg_pool_2x",
                      lambda x: nn.functional.avg_pool2d(x, 2))],
        "batchnorm": [(layers.BatchNorm, "_flax_normalize",
                       _library_batchnorm)],
        "residual": [(du, "bf16_autocast", lambda x: False),
                     (du, "round_to_compute", lambda x: x)],
    }
    if name == "all":
        return [p for ps in points.values() for p in ps]
    return points.get(name, [])


@contextlib.contextmanager
def without(name):
    """The port with rounding point ``name`` put back to the library op."""
    saved = []
    try:
        for obj, attr, new in _patches(name):
            saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)


def cpu_readings():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax
    import jax.numpy as jnp
    from pai_tpu.models import diffusion_unet as jdu
    from test_torch_port_bf16 import (_agreement, _step_agreement,
                                      _unet_inputs)
    from torch_port_util import palette_numpy_variables, port_palette_model

    def jax_unet(mults, attn, dtype):
        return jdu.DiffusionUNet(in_channels=2, out_channels=1,
                                 inner_channel=32, res_blocks=2,
                                 channel_mults=mults, attn_res=attn,
                                 num_heads=4, dtype=dtype)

    cases = []
    for seed in (5, 6, 7):
        _, params, stats = palette_numpy_variables((1, 2), (2,), 16, seed)
        x, y, g = _unet_inputs(seed)
        outs = [np.asarray(jax.jit(lambda v, a, b, c, m=jax_unet(
            (1, 2), (2,), dtype): m.apply(v, a, b, c, train=False))(
            {"params": params, "batch_stats": stats}, x, y, g))
            for dtype in (jnp.bfloat16, jnp.float32)]
        cases.append((seed, params, stats, x, y, g, outs))
    _, sparams, sstats = palette_numpy_variables((1,), (1,), 8, seed=5)
    sx, sy, sg = _unet_inputs(5, 8)
    noise = np.random.default_rng(6).normal(size=(2, 8, 8, 1)).astype(
        np.float32)
    step = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        def loss_fn(p, m=jax_unet((1,), (1,), dtype)):
            out, _ = m.apply({"params": p, "batch_stats": sstats}, sx, sy,
                             sg, train=True, mutable=["batch_stats"])
            return jnp.mean((out - noise) ** 2), out
        (_, out), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                     has_aux=True))(sparams)
        step[dtype] = (out, grads)

    for variant in VARIANTS:
        with without(variant):
            row = {"variant": variant}
            for seed, params, stats, x, y, g, outs in cases:
                model = port_palette_model((1, 2), (2,), params, stats)
                model.compute_dtype = torch.bfloat16
                with torch.inference_mode():
                    got = model(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(g))
                row[f"forward_seed{seed}"] = _agreement(got, *outs)
            model = port_palette_model((1,), (1,), sparams, sstats).train()
            model.compute_dtype = torch.bfloat16
            corr, found, loss = _step_agreement(
                model, sx, sy, sg, noise, step[jnp.bfloat16],
                step[jnp.float32])
            row["step_mean_corr"] = corr
            row["step_output"] = found["output"]
        print(json.dumps(row), flush=True)


def card_timings():
    import chip_smoke

    keep = ("unet_forward_ms_batch_2", "forward_device_ms", "step_ms_batch_4",
            "step_device_ms", "step_enqueue_ms")
    for variant in VARIANTS:
        with without(variant), tempfile.TemporaryDirectory(
                prefix="pai_bf16_ablation_") as workdir:
            found = chip_smoke.bf16_path(torch.device("cuda", 0), workdir)
        print(json.dumps({"variant": variant,
                          **{k: found[k] for k in keep}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    if parser.parse_args().cpu:
        cpu_readings()
    else:
        card_timings()
