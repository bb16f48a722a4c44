"""Lightning ``.ckpt`` interop of the port (``pai_tpu_torch.interop.
lightning``, ``api.*.from_lightning_checkpoint`` and ``python -m
pai_tpu_torch.interop.lightning import|export``) against the JAX package's
(``pai_tpu.interop``), on the CPU.

Each of the eight generator families at a small width, with numpy-made
weights (and, for the GAN families, the PatchGAN's): the JAX package writes
the ``.ckpt`` (``export_lightning_checkpoint``), the port reads it, writes
its own, and the JAX package reads that back. Sizes: mults (1, 2) on 32x32
for the convolutional U-Nets, TransUNet at (1, 1) on 32x32 with a 2-layer
ViT (both packages' registries patched to build it so), Palette at (1, 2),
attention at 2, on 16x16.

Tolerances: tensor names, trees and round trips exact (bit-equal); the
prediction (Palette: one denoising forward) within 1e-5 of the JAX
package's, relative to the output's largest magnitude (float32 sums in
other orders). The EMA checkpoints store their state dict in another order
than the port's ``named_parameters()`` and their shadow weights differ from
the raw ones, so a shadow list read in the wrong order cannot pass.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pai_tpu_torch import api, main as port_main, report as port_report
from pai_tpu_torch.data.pipeline import normalize_u8
from pai_tpu_torch.interop import (export_lightning_state_dict,
                                   import_lightning_checkpoint,
                                   jax_from_state_dict, lightning,
                                   state_dict_from_jax)
from pai_tpu_torch.models import registry
from pai_tpu_torch.models.trans_unet import TransUnet
from pai_tpu_torch.train import loop
from pai_tpu_torch.utils import images as ti
from pai_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_util import (TRANS_VIT_LAYERS, discriminator_numpy_params,
                             numpy_tree_like, write_blob_dataset)

FAMILIES = ("pix2pix", "attention_unet", "res18_unet", "res50_unet",
            "resv2_unet", "resnext_unet", "trans_unet", "palette")
MULTS = {name: (1, 2) for name in FAMILIES}
MULTS["trans_unet"] = (1, 1)
SIZES = {name: 32 for name in FAMILIES}
SIZES["palette"] = 16
API_CLASS = {"pix2pix": api.Pix2Pix, "attention_unet": api.AttentionUnetGAN,
             "trans_unet": api.TransUnetGAN, "palette": api.Palette}
TOL = 1e-5


def _hparams(family, loss_type="gan"):
    return {"model": family, "in_channels": 1, "out_channels": 1,
            "channel_mults": ",".join(str(m) for m in MULTS[family]),
            "attention_res": "2", "dropout": 0.0, "loss_type": loss_type,
            "schedule_type": "linear", "learn_variance": False,
            "precision": "32", "image_size": SIZES[family]}


@pytest.fixture(scope="module", autouse=True)
def small_trans_unet():
    """Both packages build TransUNet with a 2-layer ViT in this module."""
    from pai_tpu.models import registry as jax_registry
    from pai_tpu.models.trans_unet import TransUnet as JaxTransUnet

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_registry, "TransUnet", functools.partial(
            JaxTransUnet, vit_layers=TRANS_VIT_LAYERS))
        patch.setattr(registry, "TransUnet", functools.partial(
            TransUnet, vit_layers=TRANS_VIT_LAYERS))
        yield


def _inputs(family):
    """The JAX module's example inputs for one prediction."""
    size = SIZES[family]
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, size, size, 1)).astype(np.float32)
    if family != "palette":
        return (x,)
    y_t = rng.normal(0, 1, x.shape).astype(np.float32)
    return x, y_t, np.array([0.3, 0.8], np.float32)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Per family (made once): the JAX package's generator with numpy-made
    trees, the PatchGAN's, and the ``.ckpt`` the JAX package exports."""
    from pai_tpu.interop import export_lightning_checkpoint as jax_export
    from pai_tpu.restore import build_generator_from_hparams

    root = tmp_path_factory.mktemp("interop")
    cache = {}

    def get(family):
        if family not in cache:
            h = _hparams(family)
            module = build_generator_from_hparams(h, SIZES[family])
            args = [jnp.asarray(a) for a in _inputs(family)]
            abstract = jax.eval_shape(lambda: module.init(
                jax.random.key(0), *args, train=False))
            rng = np.random.default_rng(FAMILIES.index(family) + 60)
            params = numpy_tree_like(abstract["params"], rng, "params")
            stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
            dparams = None if family == "palette" else \
                discriminator_numpy_params(FAMILIES.index(family) + 70)
            path = str(root / f"{family}.ckpt")
            jax_export(path, family, params, stats, h, d_params=dparams,
                       epoch=3, step=123)
            predict = jax.jit(lambda p, s, *a: module.apply(
                {"params": p, "batch_stats": s}, *a, train=False))
            cache[family] = {"predict": predict, "params": params,
                             "stats": stats, "dparams": dparams,
                             "hparams": h, "ckpt": path}
        return cache[family]

    return get


def _jax_predict(src, params, stats):
    """The JAX package's eval-mode prediction (jitted, the weights passed as
    arguments) and its inputs."""
    args = _inputs(src["hparams"]["model"])
    return np.asarray(src["predict"](params, stats, *args)), args


def _port_predict(obj, args):
    with torch.inference_mode():
        return obj._module(*(torch.from_numpy(a) for a in args)).numpy()


def _assert_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale


def _assert_trees_equal(got, want):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for key, value in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[key]), value,
                                      err_msg=str(key))


@pytest.mark.parametrize("family", FAMILIES)
def test_state_dict_names_match_the_jax_exporter(sources, family):
    """The port's prefixed names (generator; the schedules for Palette; the
    PatchGAN for a GAN) are the names, values and shapes the JAX package
    exports, and every one of the port's module's tensors is among them."""
    src = sources(family)
    h = src["hparams"]
    gen = state_dict_from_jax(family, src["params"], src["stats"], h)
    disc = None if src["dparams"] is None else state_dict_from_jax(
        "discriminator", src["dparams"], {}, {})
    ours = export_lightning_state_dict(family, gen, h, disc)
    theirs = torch.load(src["ckpt"], weights_only=False)["state_dict"]
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        if key.endswith("num_batches_tracked"):  # the JAX exporter's (1,)
            value = value.reshape(())
        assert torch.equal(ours[key], value), key
    module, _ = lightning._modules(family, h)
    assert {"unet." + k for k in module.state_dict()} == {
        k for k in ours if k.startswith("unet.")}
    assert any(k.startswith("diffusion") for k in ours) == (
        family == "palette")
    assert any(k.startswith("discriminator.") for k in ours) == (
        family != "palette")


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_checkpoint_predicts_as_jax_does(sources, family):
    src = sources(family)
    cls = API_CLASS.get(family, api.ResUnetGAN)
    obj = cls.from_lightning_checkpoint(src["ckpt"], device="cpu",
                                        model=family,
                                        image_size=SIZES[family])
    assert obj.model_name == family and obj.hparams["ema"] is False
    assert obj.hparams["channel_mults"] == src["hparams"]["channel_mults"]
    want, args = _jax_predict(src, src["params"], src["stats"])
    got = _port_predict(obj, args)
    assert got.shape == want.shape
    _assert_close(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_port_export_reads_back_bit_equal_in_jax(sources, family, tmp_path):
    """JAX .ckpt -> ``import`` (a port slot) -> ``export`` -> the JAX
    package's importer: every tree bit-equal to the source, the step and
    epoch carried."""
    from pai_tpu.interop import import_lightning_checkpoint as jax_import

    src = sources(family)
    slot = lightning.main(["import", src["ckpt"], "-m", family, "-o",
                           str(tmp_path), "--name", "run", "--slot", "best",
                           "--image-size", str(SIZES[family])])
    out = str(tmp_path / "back.ckpt")
    lightning.main(["export", slot, "-o", out])
    (params, stats, dparams, ema), h, meta = jax_import(
        out, family, {"image_size": SIZES[family]})
    _assert_trees_equal(params, src["params"])
    _assert_trees_equal(stats, src["stats"])
    if src["dparams"] is None:
        assert dparams is None
    else:
        _assert_trees_equal(dparams, src["dparams"])
    assert ema is None and meta == {"step": 123, "epoch": 3}
    keys = ["channel_mults", "dropout"] + (
        ["attention_res", "schedule_type", "learn_variance"]
        if family == "palette" else ["loss_type"])
    for key in keys:
        assert h[key] == src["hparams"][key], key


def _with_ema(src, path, num_updates, seed):
    """The source ``.ckpt`` rewritten with its state dict in reverse order
    and a torch_ema payload (shadow = raw weights, each moved at random by
    2 % of itself, as an average trails its weights) in that order. Returns
    the shadow weights by name."""
    ckpt = torch.load(src["ckpt"], weights_only=False)
    sd = dict(reversed(list(ckpt["state_dict"].items())))
    gen = torch.Generator().manual_seed(seed)
    shadow = {k: v * (1 + 0.02 * torch.randn(v.shape, generator=gen))
              for k, v in sd.items() if not lightning._is_buffer(k)}
    ckpt["state_dict"] = sd
    ckpt["callbacks"] = {"EMA": {"shadow_params": list(shadow.values()),
                                 "num_updates": num_updates,
                                 "decay": 0.9999, "collected_params": None}}
    torch.save(ckpt, path)
    return shadow


@pytest.mark.parametrize("family", ["pix2pix", "palette"])
def test_ema_shadow_is_read_in_the_checkpoints_order(sources, family,
                                                     tmp_path):
    from pai_tpu.interop import import_lightning_checkpoint as jax_import

    src = sources(family)
    path = str(tmp_path / "ema.ckpt")
    shadow = _with_ema(src, path, num_updates=57, seed=5)
    override = {"image_size": SIZES[family]}
    (gen_sd, disc_sd, ema), h, meta = import_lightning_checkpoint(
        path, family, override)
    assert h["ema"] is True and meta["ema_num_updates"] == 57
    # the file's order is not the port's: the test can tell them apart
    module, _ = lightning._modules(family, h)
    file_order = [k[len("unet."):] for k in shadow if k.startswith("unet.")]
    assert file_order != [n for n, _ in module.named_parameters()]
    for name, value in ema.items():
        key = name if name.startswith("discriminator.") else "unet." + name
        assert torch.equal(value, shadow[key]), name
    assert (disc_sd is None) == (family == "palette")

    # the same trees as the JAX package's importer
    (_, _, _, jax_ema), jax_h, jax_meta = jax_import(path, family, override)
    assert jax_h["ema"] is True and jax_meta["ema_num_updates"] == 57
    hp = src["hparams"]
    gen_ema = {k: v for k, v in ema.items()
               if not k.startswith("discriminator.")}
    want = jax_ema["unet"] if family == "palette" else jax_ema["generator"]
    _assert_trees_equal(jax_from_state_dict(family, gen_ema, hp)[0], want)
    if family != "palette":
        disc_ema = {k[len("discriminator."):]: v for k, v in ema.items()
                    if k.startswith("discriminator.")}
        _assert_trees_equal(
            jax_from_state_dict("discriminator", disc_ema, {})[0],
            jax_ema["discriminator"])

    # the API evaluates with the average; the slot keeps its update count
    obj = API_CLASS[family].from_lightning_checkpoint(path, device="cpu",
                                                      **override)
    want_pred, args = _jax_predict(src, want, src["stats"])
    _assert_close(_port_predict(obj, args), want_pred)
    slot = lightning.main(["import", path, "-m", family, "-o",
                           str(tmp_path), "--name", "run",
                           "--image-size", str(SIZES[family])])
    _, slot_meta = load_checkpoint(slot)
    assert slot_meta["ema_num_updates"] == 57 and slot_meta["step"] == 123
    assert slot_meta["hparams"]["ema"] is True


def test_gan_checkpoint_without_the_patchgan_becomes_mse(sources, tmp_path):
    from pai_tpu.interop import export_lightning_checkpoint as jax_export

    src = sources("pix2pix")
    path = str(tmp_path / "g_only.ckpt")
    jax_export(path, "pix2pix", src["params"], src["stats"], src["hparams"],
               epoch=1, step=9)
    assert torch.load(path, weights_only=False)["hyper_parameters"][
        "loss_type"] == "gan"
    slot = lightning.main(["import", path, "-m", "pix2pix", "-o",
                           str(tmp_path), "--name", "g",
                           "--image-size", "32"])
    state, meta = load_checkpoint(slot)
    assert meta["hparams"]["loss_type"] == "mse"
    assert not any(k.startswith("discriminator.") for k in state)
    # export writes no PatchGAN for it, and the reference's names
    lightning.main(["export", slot, "-o", str(tmp_path / "g.ckpt")])
    back = torch.load(str(tmp_path / "g.ckpt"), weights_only=False)
    assert all(k.startswith("unet.") for k in back["state_dict"])
    assert back["hyper_parameters"]["loss_type"] == "mse"
    with pytest.raises(KeyError, match="missing"):
        import_lightning_checkpoint(path, "attention_unet",
                                    {"image_size": 32})


def test_import_report_and_resume_end_to_end(tmp_path, monkeypatch):
    """A reference-layout GAN ``.ckpt`` with an EMA payload -> ``import
    --slot best`` -> the report CLI at 176x176 -> ``import --slot last`` ->
    the train CLI ``--resume``: it starts at the checkpoint's step and
    carries on the EMA's update count."""
    from pai_tpu.interop import export_lightning_checkpoint as jax_export
    from pai_tpu.restore import build_generator_from_hparams

    size, n_updates = 176, 40
    h = dict(_hparams("pix2pix"), image_size=size)
    module = build_generator_from_hparams(h, size)
    abstract = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros((1, size, size, 1)), train=False))
    rng = np.random.default_rng(80)
    params = numpy_tree_like(abstract["params"], rng, "params")
    stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
    src = {"ckpt": str(tmp_path / "src.ckpt")}
    jax_export(src["ckpt"], "pix2pix", params, stats, h,
               d_params=discriminator_numpy_params(81), epoch=2, step=6)
    path = str(tmp_path / "ema.ckpt")
    _with_ema(src, path, num_updates=n_updates, seed=6)
    data = tmp_path / "data"
    data.mkdir()
    manifest = write_blob_dataset(data, 2, size, seed=82,
                                  write_png=ti.write_png)

    best = lightning.main(["import", path, "-m", "pix2pix", "-o",
                           str(tmp_path / "ck"), "--name", "run", "--slot",
                           "best", "--image-size", str(size)])
    port_report.main(["rep", "-c", best, "-d", manifest, "-m", "pix2pix",
                      "-bs", "2", "--device", "cpu", "--reports-dir",
                      str(tmp_path / "reports")])
    model = api.Pix2Pix.from_lightning_checkpoint(path, device="cpu",
                                                  image_size=size)
    x = np.stack([ti.read_png_gray(str(data / f"in_{i}.png"))
                  for i in range(2)])[..., None]
    pred = model.predict(normalize_u8(torch.from_numpy(x)))
    want = ti.to_int(ti.afmhot_rgb(
        ti.denormalize(pred)[1, ..., 0].numpy()))
    got = ti.read_png(str(tmp_path / "reports" / "rep" / "outputs"
                          / "00001.png"))
    np.testing.assert_array_equal(got, want)  # the EMA model's output

    lightning.main(["import", path, "-m", "pix2pix", "-o",
                    str(tmp_path / "ck"), "--name", "run", "--image-size",
                    str(size)])
    monkeypatch.setattr(loop, "IMAGE_SIZE", size)
    summary = port_main.main([
        "run", "-d", manifest, "-m", "pix2pix", "--channel-mults", "1,2",
        "--loss-type", "gan", "--ema", "--resume", "--batch-size", "2",
        "-e", "6", "-s", "8", "--device", "cpu",
        "--ckpt-dir", str(tmp_path / "ck"), "--log-dir",
        str(tmp_path / "logs")])
    assert summary["steps"] == 8
    _, meta = load_checkpoint(str(tmp_path / "ck" / "run" / "last"))
    assert meta["step"] == 8 and meta["epoch"] == 4
    assert meta["ema_num_updates"] == n_updates + 2
