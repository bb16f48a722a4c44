"""Training the other generator families with the port, on the CPU: one GAN
step of each family against ``pai_tpu`` from the same numpy-made weights and
batch, for ``gan`` (with the PatchGAN) and one other loss each; a step at
batch 1 whose max pools meet tied windows and whose innermost BatchNorm sees
one value per channel; the train CLI (``-m res18_unet`` with the report CLI
on its slot, ``-m trans_unet``), the API classes; and the first losses of the
reference's own training runs (``tests/fixtures/train_parity_*.npz``) as a
second witness.

Sizes as in ``tests/test_torch_port_families.py``: mults (1, 2) on 32x32 for
the convolutional U-Nets, TransUNet at (1, 1) with a 2-layer ViT (the CLI
test patches the port's registry to build it so); batch 2; the PatchGAN at
its published widths. Each step is compared from a shared state, with the
tolerances of ``tests/test_torch_port_gan_train.py`` (``torch_port_util.
compare_step``): losses and train metrics 1e-5 relative, Adam's moments
1e-4 and 2e-4, parameters and EMA within 1e-2 of a learning rate where the
gradient is at least 1e-3 of its tensor's largest and within two learning
rates everywhere, running statistics 1e-4; the convolution biases a
BatchNorm reads (directly, or through linear layers and max pools) have a
gradient of float noise and are held below 1e-3 of the network's largest
instead.

The residual U-Nets' first moments are held to ``RES_MOMENT_TOL`` (5e-2)
relative to each tensor's largest, and their parameters within 1e-2 of a
learning rate where the gradient is at least that share of the tensor's
largest (where Adam's first step cannot change sign). Their full-resolution
layers hold 131,072 values each at 32x32, so a few ReLU inputs and max-pool
windows lie within float noise of a tie, where the two packages may take
the slope or the window's winner differently, and nearly cancelling float32
sums of gradients carry the rest: on these seeds either package's float32
gradient lies up to 3.0e-2 from the same network's in float64, the port's
on ResUNet-18 and ResNeXt, the JAX package's on ResUNet-v2, and both
within 2e-5 on the attention U-Net, ResUNet-50 and TransUNet
(``tools/torch_family_float_noise.py``); between the two
packages the largest reading is 4.3e-2 (ResNeXt, a BatchNorm bias at 2e-2
of the network's largest gradient).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from pai_tpu.models import Discriminator as JaxDiscriminator
from pai_tpu.train import steps as jsteps
from pai_tpu_torch import main as port_main
from pai_tpu_torch import report as port_report
from pai_tpu_torch.api import AttentionUnetGAN, ResUnetGAN, TransUnetGAN
from pai_tpu_torch.models import build_generator, registry
from pai_tpu_torch.models.trans_unet import TransUnet
from pai_tpu_torch.ops import BatchNorm
from pai_tpu_torch.train import loop
from pai_tpu_torch.train import steps as tsteps
from pai_tpu_torch.utils import images as ti
from pai_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_util import (TRANS_VIT_LAYERS, discriminator_numpy_params,
                             gan_batches, generator_numpy_variables,
                             reference_state_dict, run_gan_steps,
                             write_blob_dataset)

SIZE = 32
SMALL = {"attention_unet": (1, 2), "res18_unet": (1, 2),
         "res50_unet": (1, 2), "resv2_unet": (1, 2), "resnext_unet": (1, 2),
         "trans_unet": (1, 1)}
# one loss besides gan per family, the five spread over the six
OTHER_LOSS = {"attention_unet": "ssim+psnr", "res18_unet": "mse",
              "res50_unet": "ssim", "resv2_unet": "psnr",
              "resnext_unet": "ssim+psnr", "trans_unet": "mse"}
CASES = [(name, loss) for name in SMALL for loss in ("gan", OTHER_LOSS[name])]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the residual U-Nets' first moments (see the module docstring)
RES_MOMENT_TOL = 5e-2


def _moment_tol(name):
    return RES_MOMENT_TOL if name.startswith("res") else 1e-4


@pytest.fixture(scope="module")
def dparams():
    return discriminator_numpy_params(12)


@pytest.mark.parametrize("name,loss_type", CASES)
def test_gan_step_matches_jax(name, loss_type, dparams):
    """D then G against the updated D for ``gan`` (one generator forward
    with the closed-form second BatchNorm update), the generator alone for
    the other losses; EMA over both networks."""
    module, params, stats = generator_numpy_variables(
        name, SMALL[name], SIZE, seed=50 + list(SMALL).index(name))
    jstep = jax.jit(jsteps.make_gan_train_step(
        module, JaxDiscriminator() if loss_type == "gan" else None,
        loss_type))
    tstate = run_gan_steps(params, stats, dparams, loss_type,
                           gan_batches(60, 1), jstep, SMALL[name],
                           family=name, moment_tol=_moment_tol(name))
    assert (tstate.discriminator is None) == (loss_type != "gan")


def test_step_over_max_pool_ties_and_one_value_per_channel_matches_jax(
        dparams, monkeypatch):
    """ResUNet-18 at four levels on 16x16, batch 1, ``mse``: the innermost
    map is 1x1, so the first decoder's three BatchNorms normalise one value
    per channel (flax's output: the bias; ``ops/layers.BatchNorm``), and the
    ReLU that ends every block leaves 2x2 windows of tied values (zeros),
    whose gradient goes to the first element of the window in both
    packages."""
    mults, size = (1, 2, 4, 8), 16
    module, params, stats = generator_numpy_variables("res18_unet", mults,
                                                      size, seed=57)
    jstep = jax.jit(jsteps.make_gan_train_step(module, None, "mse"))
    seen = {"one_value": 0, "tied_windows": 0}
    real_norm = BatchNorm.forward
    real_pool = torch.nn.functional.max_pool2d

    def watch_norm(norm, x):
        seen["one_value"] += int(norm.training and x.numel() == x.shape[1])
        return real_norm(norm, x)

    def watch_pool(x, *args, **kwargs):
        n, c, h, w = x.shape
        windows = x.detach().reshape(n, c, h // 2, 2, w // 2, 2)
        windows = windows.transpose(3, 4).reshape(n, c, h // 2, w // 2, 4)
        top = windows.max(dim=-1, keepdim=True).values
        seen["tied_windows"] += int(((windows == top).sum(-1) > 1).sum())
        return real_pool(x, *args, **kwargs)

    monkeypatch.setattr(BatchNorm, "forward", watch_norm)
    monkeypatch.setattr(torch.nn.functional, "max_pool2d", watch_pool)
    x, y = gan_batches(61, 1, size=size, batch=1)[0]
    run_gan_steps(params, stats, dparams, "mse", [(x, y)], jstep, mults,
                  family="res18_unet", moment_tol=RES_MOMENT_TOL)
    assert seen["one_value"] == 3  # dec_0 at 1x1: two in its branch, one skip
    assert seen["tied_windows"] > 10


# ------------------------------------------------------- CLIs and the API
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    train_dir, val_dir = root / "train", root / "val"
    train_dir.mkdir()
    val_dir.mkdir()
    return {"root": root,
            "train": write_blob_dataset(train_dir, 5, 176, seed=71,
                                        write_png=ti.write_png),
            "val": write_blob_dataset(val_dir, 3, 176, seed=72,
                                      write_png=ti.write_png)}


def _argv(world, out, model, *extra):
    return ["run", "-d", world["train"], "-vd", world["val"], "-m", model,
            "--batch-size", "2", "--device", "cpu", "--log-dir",
            str(out / "logs"), "--ckpt-dir", str(out / "ckpt"), *extra]


def test_res18_cli_trains_and_its_slot_is_reported(world, tmp_path,
                                                  monkeypatch):
    """``python -m pai_tpu_torch.main run -m res18_unet --loss-type mse``,
    one epoch of 3 steps at 176x176 (the report's 16 depth bands need more
    than 10 rows each), then ``python -m pai_tpu_torch.report -m
    res18_unet`` on the best slot."""
    monkeypatch.setattr(loop, "IMAGE_SIZE", 176)
    summary = port_main.main(_argv(world, tmp_path, "res18_unet",
                                   "--channel-mults", "1,2", "--loss-type",
                                   "mse", "-e", "1", "--val-epochs", "1"))
    assert summary["steps"] == 3 and np.isfinite(summary["val_ssim"])
    best = tmp_path / "ckpt" / "run" / "best"
    state, meta = load_checkpoint(str(best))
    assert meta["hparams"]["model"] == "res18_unet"
    assert "encoders.1.encode.0.conv_skip.0.weight" in state
    stats = port_report.main(["rep", "-c", str(best), "-d", world["val"],
                              "-m", "res18_unet", "-bs", "2", "--device",
                              "cpu", "--reports-dir",
                              str(tmp_path / "reports")])
    out = tmp_path / "reports" / "rep"
    assert len(os.listdir(out / "outputs")) == 3
    assert stats["params"] == sum(
        p.numel() for p in build_generator(
            "res18_unet", channel_mults=(1, 2), device="meta").parameters())
    assert (out / "depth_ssim.csv").exists()


def _small_trans(**kwargs):
    kwargs["vit_layers"] = TRANS_VIT_LAYERS
    return TransUnet(**kwargs)


def test_trans_unet_cli_trains_with_the_patchgan(world, tmp_path,
                                                 monkeypatch):
    """``-m trans_unet --channel-mults 1,1`` under the CLI's default ``gan``
    loss at 32x32, with the ViT cut to two layers by patching the port's
    registry (the CLI builds the published twelve): 3 steps, a validation,
    best and last slots holding the ViT under the reference's names and the
    PatchGAN."""
    monkeypatch.setattr(loop, "IMAGE_SIZE", SIZE)
    monkeypatch.setattr(registry, "TransUnet", _small_trans)
    summary = port_main.main(_argv(world, tmp_path, "trans_unet",
                                   "--channel-mults", "1,1", "-e", "1",
                                   "--val-epochs", "1", "--ema"))
    assert summary["steps"] == 3 and np.isfinite(summary["val_ssim"])
    ckpt = tmp_path / "ckpt" / "run"
    assert sorted(os.listdir(ckpt)) == ["best", "last"]
    state, meta = load_checkpoint(str(ckpt / "last"))
    assert meta["hparams"]["model"] == "trans_unet"
    vit = "vit_bottleneck.transformer.layers.1.self_attn.in_proj_weight"
    assert {vit, f"ema.{vit}", f"opt.{vit}.exp_avg",
            "discriminator.discriminator.4.weight"} <= set(state)
    assert not any(".layers.2." in k for k in state)
    model = TransUnetGAN.load_from_checkpoint(str(ckpt / "best"),
                                              device="cpu")
    assert model.predict(np.zeros((1, SIZE, SIZE, 1), np.float32)).shape \
        == (1, SIZE, SIZE, 1)


@pytest.mark.parametrize("cls,kwargs,name", [
    (AttentionUnetGAN, {}, "attention_unet"),
    (ResUnetGAN, {"res_type": "next"}, "resnext_unet")])
def test_api_fit_load_and_predict(cls, kwargs, name, world, tmp_path):
    """``fit`` adopts the run's last weights; ``load_from_checkpoint``,
    called on any class, rebuilds the slot's own family."""
    model = cls(channel_mults=(1, 2), loss_type="psnr", image_size=SIZE,
                device="cpu", **kwargs)
    summary = model.fit("api", world["train"], world["val"], epochs=1,
                        val_epochs=1, batch_size=2,
                        log_dir=str(tmp_path / "logs"),
                        ckpt_dir=str(tmp_path / "ckpt"))
    assert summary["steps"] == 3
    x = np.random.default_rng(0).uniform(-1, 1, (1, SIZE, SIZE, 1)).astype(
        np.float32)
    pred = model.predict(x)
    loaded = TransUnetGAN.load_from_checkpoint(
        str(tmp_path / "ckpt" / "api" / "last"), device="cpu")
    assert loaded.model_name == name
    assert type(loaded._module).__name__ == type(model._module).__name__
    assert torch.equal(loaded.predict(x), pred)


# ------------------------------------------------------- second witness
WITNESS_STEPS = 10
FIRST_LOSS_REL = 1e-5  # the forward and the loss before any update
WITNESS_REL = 5e-3     # after Adam's first updates (see the docstring)


@pytest.mark.parametrize("fixture,name,mults,loss_type", [
    ("train_parity_attention_ssim_psnr.npz", "attention_unet", (1, 2),
     "ssim+psnr"),
    ("train_parity_res18_mse.npz", "res18_unet", (1, 2), "mse"),
    ("train_parity_trans_mse.npz", "trans_unet", (1, 1), "mse")])
def test_first_losses_match_the_reference_fixture(fixture, name, mults,
                                                  loss_type, monkeypatch):
    """The reference's own training runs (``tools/train_parity.py``: 32x32,
    batch 8, its weights as a seeded stream under its names, TransUNet with
    a 2-layer ViT): the port loads those names as they are ("unet."
    stripped) and trains ten steps on the same batches. The first loss
    reads the forward before any update and is held to ``FIRST_LOSS_REL``;
    the later ones part as two runs of one program part after Adam's first
    steps (an element whose gradient is near Adam's eps moves by a
    noise-sensitive fraction of the learning rate; measured up to 2.9e-3 at
    step 8, the JAX package 1.4e-3 on the GAN fixture,
    ``tests/test_torch_port_gan_train.py``)."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    from make_parity_fixture import deterministic_weights
    from train_parity import BATCH, N_TRAIN, make_data

    z = np.load(os.path.join(REPO, "tests", "fixtures", fixture))
    weights = deterministic_weights(json.loads(str(z["manifest"])))
    sd = reference_state_dict(weights, "unet.")
    if name == "trans_unet":
        gen = TransUnet(image_size=SIZE, channel_mults=mults,
                        vit_layers=TRANS_VIT_LAYERS, device="meta")
    else:
        gen = build_generator(name, channel_mults=mults, device="meta")
    gen.load_state_dict(sd, strict=True, assign=True)
    gen.to(memory_format=torch.channels_last)
    (tx, ty), _ = make_data()
    tx, ty = (np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))
              for a in (tx, ty))
    state = tsteps.init_gan_state(gen, None, loss_type, use_ema=False)
    step = tsteps.make_gan_train_step(gen, None, loss_type,
                                      compute_metrics=False)
    losses = []
    for s in range(WITNESS_STEPS):
        b = s % (N_TRAIN // BATCH)
        state, m = step(state, torch.from_numpy(tx[b * BATCH:(b + 1) * BATCH]),
                        torch.from_numpy(ty[b * BATCH:(b + 1) * BATCH]))
        losses.append(float(m["loss"]))
    ref = np.asarray(z["losses"][:WITNESS_STEPS], np.float64)
    err = np.abs(np.asarray(losses) - ref) / np.abs(ref)
    assert err[0] <= FIRST_LOSS_REL, err
    assert err.max() <= WITNESS_REL, err
