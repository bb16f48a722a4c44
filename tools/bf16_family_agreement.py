"""How close each generator family of ``pai_tpu_torch`` comes to ``pai_tpu``
under ``--precision bf16-mixed`` as a whole model, on the CPU: the eval
forward at ``dtype=bfloat16`` in both packages from the same numpy-made
weights and input (the JAX side jitted with the weights as arguments), and
the port at float32 on the same input as the control.

Printed per family and seed, for the port's bf16 output and for its float32
control, the readings of ``tests/test_torch_port_bf16.py``: ``gap`` (the
largest difference over the JAX package's own largest bf16-vs-float32
difference), ``equal`` (share of outputs bit-equal) and ``corr`` (cosine of
the two bf16-minus-float32 errors).

    JAX_PLATFORMS=cpu python3 tools/bf16_family_agreement.py [--tree DIR]
        [--seeds 21 22] [--families trans_unet resv2_unet]

``--tree`` is another checkout of the port (an unpacked ``git archive`` of
an earlier commit): its ``pai_tpu_torch`` is the one read, against this
checkout's ``pai_tpu`` and test helpers. Sizes: 32x32, batch 2, mults
(1, 2, 4) for the convolutional U-Nets, (1, 1) with a 2-layer ViT for
TransUNet (a 2x2 grid of 1,024-wide tokens).

For TransUNet and the residual U-Nets it also prints the share of the
first encoder block's bf16 outputs bit-equal to ``pai_tpu``'s (read with
flax's ``capture_intermediates``): TransUNet's block fed ``pai_tpu``'s own
stem output, a residual U-Net's block fed the port's stem (ResUNet-v2's
first BatchNorm reads the stem's sum)."""

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
MULTS = {"attention_unet": (1, 2, 4), "res18_unet": (1, 2, 4),
         "res50_unet": (1, 2, 4), "resv2_unet": (1, 2, 4),
         "resnext_unet": (1, 2, 4), "trans_unet": (1, 1)}


def readings(port16, jax16, jax32):
    import numpy as np

    port16, jax16, jax32 = (np.asarray(a, np.float64)
                            for a in (port16, jax16, jax32))
    mine, theirs = port16 - jax32, jax16 - jax32
    norm = np.linalg.norm(mine) * np.linalg.norm(theirs)
    return {"gap": float(np.abs(port16 - jax16).max()
                         / np.abs(theirs).max()),
            "equal": float(np.mean(port16 == jax16)),
            "corr": float((mine * theirs).sum() / norm) if norm else 0.0}


def first_block(name, module, variables, x, model):
    """The share of the first encoder block's bf16 outputs bit-equal to
    ``pai_tpu``'s at ``dtype=bfloat16``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jmod = module.clone(dtype=jnp.bfloat16)
    _, inter = jax.jit(lambda v, a: jmod.apply(
        v, a, train=False, capture_intermediates=True))(variables, x)
    inter = inter["intermediates"]
    stem, want = (np.asarray(inter[k]["__call__"][0].astype(jnp.float32))
                  for k in ("stem", "enc_0"))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        if name == "trans_unet":
            out = model.encoders[0](torch.from_numpy(stem).permute(
                0, 3, 1, 2).bfloat16().contiguous(
                memory_format=torch.channels_last))
        else:
            out = model.encoders[0]["encode"][0](
                model.in_conv(torch.from_numpy(x).permute(0, 3, 1, 2)))
    return float(np.mean(out.float().permute(0, 2, 3, 1).numpy() == want))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--seeds", type=int, nargs="+", default=[21])
    parser.add_argument("--families", nargs="+", default=list(MULTS))
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    sys.path.insert(1, os.path.abspath(ROOT))
    sys.path.insert(2, os.path.join(ROOT, "tests"))

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import pai_tpu_torch
    from pai_tpu_torch.interop import state_dict_from_jax
    from torch_port_util import (generator_numpy_variables, mults_hparams,
                                 port_generator)

    print(f"port from {os.path.dirname(pai_tpu_torch.__file__)}")
    for name in args.families:
        mults = MULTS[name]
        for seed in args.seeds:
            module, params, stats = generator_numpy_variables(name, mults,
                                                              32, seed)
            x = np.random.default_rng(seed).uniform(
                -1, 1, (2, 32, 32, 1)).astype(np.float32)
            variables = {"params": params, "batch_stats": stats}
            outs = {dtype: np.asarray(jax.jit(
                lambda v, a, m=module.clone(dtype=dtype): m.apply(
                    v, a, train=False))(variables, x), np.float32)
                for dtype in (jnp.bfloat16, jnp.float32)}
            model = port_generator(name, mults,
                                   generator=torch.Generator().manual_seed(0))
            model.load_state_dict(state_dict_from_jax(
                name, params, stats, mults_hparams(mults)), strict=True)
            model.eval()
            if name == "trans_unet" or name.startswith("res"):
                equal = first_block(name, module, variables, x, model)
                print(f"{name:15s} mults {mults} seed {seed} first block "
                      f"equal {equal:.4f}", flush=True)
            for dtype in (torch.bfloat16, torch.float32):
                model.compute_dtype = dtype
                with torch.inference_mode():
                    out = model(torch.from_numpy(x)).numpy()
                r = readings(out, outs[jnp.bfloat16], outs[jnp.float32])
                print(f"{name:15s} mults {mults} seed {seed} port "
                      f"{str(dtype)[6:]:8s} gap {r['gap']:.4f} equal "
                      f"{r['equal']:.4f} corr {r['corr']:.4f}", flush=True)


if __name__ == "__main__":
    main()
