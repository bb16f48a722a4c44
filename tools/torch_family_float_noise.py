"""How far each package's float32 result lies from the same network in
float64, for the generator families of ``pai_tpu_torch`` against
``pai_tpu``, on the CPU: the numbers behind the train-mode and step bounds
of ``tests/test_torch_port_families.py`` and
``tests/test_torch_port_families_train.py``.

For each family, at the tests' sizes, seeds and batch, one train-mode
forward and the generator's gradient of an ``mse`` loss are computed three
ways: the port in float32, the port in float64 (its BatchNorm and LayerNorm,
which compute in float32 by design, swapped here for the library's
float64 ones) and the JAX package in float32 (``jax.grad``). Printed per
family: the largest difference of the output from the float64 one for each
package, and the tensors whose gradients lie furthest from float64 (largest
difference over the tensor's largest magnitude), leaving out the tensors
whose float64 gradient is float noise (its largest below 1e-3 of the
network's: the biases a BatchNorm reads).

    JAX_PLATFORMS=cpu python tools/torch_family_float_noise.py [--top 4]
"""

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pai_tpu_torch.interop import state_dict_from_jax  # noqa: E402
from pai_tpu_torch.ops import layers as tl  # noqa: E402
from torch_port_util import (gan_batches, generator_numpy_variables,  # noqa
                             mults_hparams, port_generator, rel)

FAMILIES = {"attention_unet": (1, 2), "res18_unet": (1, 2),
            "res50_unet": (1, 2), "resv2_unet": (1, 2),
            "resnext_unet": (1, 2), "trans_unet": (1, 1)}


def float64_norms(on):
    """Swap the port's float32-inside norms for the library's (any dtype)
    while ``on``; give them back after."""
    if on:
        tl.BatchNorm.forward = lambda self, x: torch.nn.functional.batch_norm(
            x, None, None, self.weight, self.bias, True, 0.1, self.eps)
        tl.LayerNorm.forward = lambda self, x: torch.nn.functional.layer_norm(
            x, self.normalized_shape, self.weight, self.bias, self.eps)
    else:
        tl.BatchNorm.forward = REAL[0]
        tl.LayerNorm.forward = REAL[1]


REAL = (tl.BatchNorm.forward, tl.LayerNorm.forward)


def port_run(name, mults, params, stats, x, y, dtype):
    model = port_generator(name, mults, 32)
    model.load_state_dict(state_dict_from_jax(name, params, stats,
                                              mults_hparams(mults)))
    model = model.to(dtype).train()
    float64_norms(dtype == torch.float64)
    try:
        out = model(torch.from_numpy(x).to(dtype))
        torch.mean((out - torch.from_numpy(y).to(dtype)) ** 2).backward()
    finally:
        float64_norms(False)
    return out.detach().double(), {k: p.grad.double()
                                   for k, p in model.named_parameters()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--top", type=int, default=4)
    args = parser.parse_args(argv)
    for index, (name, mults) in enumerate(FAMILIES.items()):
        module, params, stats = generator_numpy_variables(
            name, mults, 32, seed=50 + index)  # the step tests' seeds
        x, y = gan_batches(60, 1)[0]

        def loss(p):
            pred, _ = module.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"])
            return jnp.mean((pred - y) ** 2), pred

        (_, jax_out), jax_grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
        jax_grads = state_dict_from_jax(name, jax_grads, {},
                                        mults_hparams(mults))
        out32, g32 = port_run(name, mults, params, stats, x, y, torch.float32)
        out64, g64 = port_run(name, mults, params, stats, x, y, torch.float64)
        top = max(float(g.abs().max()) for g in g64.values())
        rows = sorted(((rel(g32[k], g64[k]), rel(jax_grads[k].double(),
                                                 g64[k]), k)
                       for k in g64 if float(g64[k].abs().max()) >= 1e-3 * top),
                      reverse=True, key=lambda r: max(r[0], r[1]))
        jax_out = torch.from_numpy(np.asarray(jax_out, np.float64))
        print(f"{name}: train-mode output from float64: port "
              f"{float((out32 - out64).abs().max()):.2e}, JAX "
              f"{float((jax_out - out64).abs().max()):.2e}")
        for port_err, jax_err, key in rows[:args.top]:
            print(f"  gradient {key}: port {port_err:.2e}, JAX {jax_err:.2e}")


if __name__ == "__main__":
    main()
