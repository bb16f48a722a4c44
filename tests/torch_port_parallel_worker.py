"""One rank of the port's 4-rank gloo world on the CPU, for
``tests/test_torch_port_parallel.py``.

    python tests/torch_port_parallel_worker.py RANK WORLD PORT DIR

Reads ``DIR/inputs.pt`` (numpy-made inputs and weights, written by the test
process), joins a gloo process group of ``WORLD`` ranks on
``localhost:PORT``, runs every case below on its own mesh over the same
world, and writes ``DIR/rank<RANK>.pt``: per case, what this rank computed.
The world runs beside the test process's JAX references, at a lower CPU
priority than the test processes; it imports the port and torch only.
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)
# below the test processes beside it: the suite's longest file shares the
# machine's cores with this world
os.nice(10)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pai_tpu_torch.models import Discriminator, build_generator  # noqa: E402
from pai_tpu_torch.parallel import ring_attention as R  # noqa: E402
from pai_tpu_torch.parallel.context import mesh_context  # noqa: E402
from pai_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: E402
from pai_tpu_torch.parallel.partitioning import shard_state  # noqa: E402
from pai_tpu_torch.train import steps as tsteps  # noqa: E402
from pai_tpu_torch.train.loop import (Trainer,  # noqa: E402
                                      full_train_state_dict)


def _grads_of_ring(mesh, q, k, v):
    """Forward and d(sum(sin(out)))/d(q, k, v) of ring attention."""
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = R.sequence_sharded_attention(mesh, q, k, v)
    torch.sin(out).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def case_ring(inputs, world):
    mesh = make_mesh(world, sp=world, device_type="cpu")
    q, k, v = inputs["attn"]
    res = {"einsum": _grads_of_ring(mesh, q, k, v)}
    prev = R.FLASH_RING_THRESHOLD
    R.FLASH_RING_THRESHOLD = 128  # t_local = 512 / 4: the flash hop
    try:
        res["flash"] = _grads_of_ring(mesh, q, k, v)
    finally:
        R.FLASH_RING_THRESHOLD = prev
    from pai_tpu_torch.ops import attention as A

    qd, kd, vd = inputs["attn_dispatch"]
    dmesh = make_mesh(world, sp=2, device_type="cpu")  # dp=2 x sp=2
    with A.sequence_parallel(dmesh):
        res["dispatch"] = A.multihead_attention(qd, kd, vd)
    return res


def _gan_models(inputs):
    gen = build_generator("pix2pix", channel_mults=(1, 2),
                          generator=torch.Generator().manual_seed(0))
    gen.load_state_dict(inputs["gen"])
    disc = Discriminator(generator=torch.Generator().manual_seed(0))
    disc.load_state_dict(inputs["disc"])
    return gen, disc


def _gan_step(inputs, mesh, loss_type, tp=1, fsdp=False):
    gen, disc = _gan_models(inputs)
    disc = disc if loss_type == "gan" else None
    shard_state([gen, disc], mesh, tp, fsdp)
    state = tsteps.init_gan_state(gen, disc, loss_type, use_ema=True)
    step = tsteps.make_gan_train_step(gen, disc, loss_type)
    x, y = inputs["gan_batch"]
    with mesh_context(mesh):
        state, metrics = step(state, shard_batch(mesh, x),
                              shard_batch(mesh, y))
        flat = full_train_state_dict(state)
    return {"state": flat, "metrics": {k: float(v)
                                       for k, v in metrics.items()}}


def case_gan(inputs, world):
    return {
        "dp": _gan_step(inputs, make_mesh(world, device_type="cpu"), "gan"),
        "tp": _gan_step(inputs, make_mesh(world, tp=2, device_type="cpu"),
                        "mse", tp=2),
        "fsdp": _gan_step(inputs, make_mesh(world, device_type="cpu"),
                          "mse", fsdp=True)}


def case_palette(inputs, world):
    from pai_tpu_torch.diffusion import make_schedule
    from pai_tpu_torch.models.diffusion_unet import DiffusionUNet

    mesh = make_mesh(world, sp=2, device_type="cpu")  # dp=2 x sp=2
    unet = DiffusionUNet(in_channels=2, out_channels=1, inner_channel=32,
                         res_blocks=2, channel_mults=(1,), attn_res=(2,),
                         num_heads=4,
                         generator=torch.Generator().manual_seed(0))
    unet.load_state_dict(inputs["unet"])
    state = tsteps.init_palette_state(unet, use_ema=False)
    sched = make_schedule("linear", 2000, 1e-6, 0.01)
    step = tsteps.make_palette_train_step(unet, sched, False,
                                          external_rand=True)
    x, y, rand = inputs["palette_batch"]
    rand = {k: shard_batch(mesh, v) for k, v in rand.items()}
    with mesh_context(mesh, "sp"):
        state, metrics = step(state, shard_batch(mesh, x),
                              shard_batch(mesh, y), rand)
    return {"state": {k: v.detach().clone()
                      for k, v in full_train_state_dict(state).items()},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def case_trainer(inputs, world, directory):
    """``--fsdp`` through the Trainer on 4 dp ranks: one epoch, a
    validation, best/last slots."""
    h = dict(inputs["trainer_hparams"], fsdp=True,
             log_dir=os.path.join(directory, "logs"),
             ckpt_dir=os.path.join(directory, "ckpt"))
    return {"summary": Trainer(h).fit()}


def main(rank, world, port, directory):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    inputs = torch.load(os.path.join(directory, "inputs.pt"),
                        weights_only=False)
    out = {"ring": case_ring(inputs, world), "gan": case_gan(inputs, world),
           "palette": case_palette(inputs, world),
           "trainer": case_trainer(inputs, world, directory)}
    torch.save(out, os.path.join(directory, f"rank{rank}.pt.tmp"))
    os.replace(os.path.join(directory, f"rank{rank}.pt.tmp"),
               os.path.join(directory, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
