"""The Palette slice as a whole on the CPU: ``run_report(-m palette,
output_process=True)`` and ``api.Palette`` from one small checkpoint.

Sizes: 2 images of 176x176 (the smallest size whose depth bands hold an
11-tap window), channel mults (1,1,1,1) with attention at downsample rate 8
(22x22 = 484 tokens, the full-softmax path) and in the middle block. The
registry fixes Palette's base width at 128; the test narrows it to 16 by
wrapping the class the registry builds, and shortens the inference schedule
from 100 steps to 8 by patching ``pai_tpu_torch.reporting.make_schedule`` (the
way the JAX package's report test shortens its own), so that the file stays a
few seconds long. 8 steps captured every 8 // 7 = 1 give the same 9 frames
the 100-step chain keeps."""

import os

import numpy as np
import pytest
import torch

from pai_tpu_torch import reporting as port_reporting
from pai_tpu_torch.api import Palette
from pai_tpu_torch.config import TRAIN_DEFAULTS
from pai_tpu_torch.data import BatchLoader, ImageDataset
from pai_tpu_torch.models import diffusion_unet, registry
from pai_tpu_torch.utils import images as ti
from pai_tpu_torch.utils import metrics
from pai_tpu_torch.utils.checkpoint import save_eval_checkpoint
from torch_port_util import fresh_interpreter_imports, write_blob_dataset

SIZE, N_IMAGES, STEPS, INNER = 176, 2, 8, 16
HPARAMS = dict(TRAIN_DEFAULTS, model="palette", channel_mults="1,1,1,1",
               attention_res="8", dropout=0.0, precision="32",
               image_size=SIZE, ema=True, loss_type="mse",
               learn_variance=False)


def _narrow_unet(**kwargs):
    kwargs["inner_channel"] = INNER
    return diffusion_unet.DiffusionUNet(**kwargs)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    patch = pytest.MonkeyPatch()
    patch.setattr(registry, "DiffusionUNet", _narrow_unet)
    real_schedule = port_reporting.make_schedule
    patch.setattr(port_reporting, "make_schedule",
                  lambda kind, n, **kw: real_schedule(kind, STEPS, **kw))
    root = tmp_path_factory.mktemp("palette_slice")
    manifest = write_blob_dataset(root, N_IMAGES, SIZE, seed=21,
                                  write_png=ti.write_png)
    gen = torch.Generator().manual_seed(22)
    model = registry.build_generator("palette", channel_mults=(1, 1, 1, 1),
                                     attention_res=(8,), generator=gen)
    with torch.no_grad():  # the zero-initialised layers, or the output is 0
        for module in model.modules():
            if isinstance(module, (diffusion_unet.ZeroConv,
                                   diffusion_unet.TokenConv1d)):
                module.weight.normal_(0.0, 0.05, generator=gen)
    # the raw weights are junk; evaluation must run the EMA shadow weights
    ema = {k: v for k, v in model.state_dict().items()
           if k in dict(model.named_parameters())}
    raw = {k: torch.zeros_like(v) if k in ema else v
           for k, v in model.state_dict().items()}
    slot = save_eval_checkpoint(str(root / "checkpoints"), "run", raw,
                                HPARAMS, ema_state_dict=ema)
    try:
        stats = port_reporting.run_report(
            "pal", slot, manifest, "palette", batch_size=N_IMAGES,
            reports_dir=str(root / "reports"), output_process=True,
            device="cpu")
        api_model = Palette.load_from_checkpoint(slot, device="cpu")
        loader = BatchLoader(ImageDataset(manifest, SIZE), N_IMAGES,
                             pad_mode="zero", device="cpu")
        batch = next(iter(loader))
        pred, frames = api_model.predict(
            batch.x, generator=torch.Generator().manual_seed(0),
            output_process=True)
        default_seed = api_model(batch.x)
        yield {"dir": root / "reports" / "pal", "stats": stats, "ema": ema,
               "model": api_model, "batch": batch, "pred": pred,
               "frames": frames, "default_seed": default_seed}
    finally:
        patch.undo()


def test_report_files_and_process_frames(slice_run):
    rdir = slice_run["dir"]
    assert sorted(os.listdir(rdir)) == [
        "depth_ssim.csv", "mse_per_image.csv", "outputs", "process",
        "psnr_per_image.csv", "ssim_images", "ssim_per_image.csv",
        "stats.txt"]
    names = [f"{str(i).zfill(5)}.png" for i in range(N_IMAGES)]
    assert sorted(os.listdir(rdir / "outputs")) == names
    assert sorted(os.listdir(rdir / "ssim_images")) == names
    assert sorted(os.listdir(rdir / "process")) == sorted(
        f"{str(i).zfill(5)}_{k}.png" for i in range(N_IMAGES)
        for k in range(9))
    assert ti.read_png(str(rdir / "process" / "00001_0.png")).shape == \
        (SIZE, SIZE, 3)


def test_stats_equal_metrics_of_the_apis_prediction_with_the_same_seed(
        slice_run):
    """The report seeds one generator with 0 for all its batches; the API
    given the same seed predicts the same bits, so the report's statistics
    are the metrics of the API's prediction."""
    pred, batch = slice_run["pred"], slice_run["batch"]
    assert pred.shape == (N_IMAGES, SIZE, SIZE, 1)
    assert pred.dtype == torch.float32
    assert float(pred.min()) >= -1.0 and float(pred.max()) <= 1.0
    assert float(pred.std()) > 0.01
    assert torch.equal(slice_run["default_seed"], pred)  # seed 0 by default
    p, t = ti.denormalize(pred), ti.denormalize(batch.y)
    stats = slice_run["stats"]
    assert stats["ssim"] == pytest.approx(
        float(metrics.ssim_per_image(p, t).mean()), abs=1e-6)
    assert stats["psnr"] == pytest.approx(
        float(metrics.psnr_per_image(p, t).mean()), abs=1e-4)
    assert stats["rmse"] == pytest.approx(
        float(metrics.mse_per_image(p, t).mean().sqrt()), abs=1e-6)
    text = dict(line.split(": ") for line in
                (slice_run["dir"] / "stats.txt").read_text().splitlines())
    assert float(text["SSIM"]) == stats["ssim"]
    assert int(text["Parameter count"]) == stats["params"] == sum(
        v.numel() for v in slice_run["ema"].values())
    # the report's output PNG is this prediction, colormapped
    want = ti.to_int(ti.afmhot_rgb(p[0, ..., 0].numpy()))
    got = ti.read_png(str(slice_run["dir"] / "outputs" / "00000.png"))
    np.testing.assert_array_equal(got, want)


def test_api_output_process_frames(slice_run):
    frames, pred = slice_run["frames"], slice_run["pred"]
    assert frames.shape == (N_IMAGES, 9, SIZE, SIZE, 1)
    assert torch.equal(frames[:, -1], pred)
    # frame 0 is y_T: unit Gaussian noise, not an image
    assert 0.9 < float(frames[:, 0].std()) < 1.1
    want = ti.to_int(ti.afmhot_rgb(
        ti.denormalize(frames)[1, 3, ..., 0].numpy()))
    got = ti.read_png(str(slice_run["dir"] / "process" / "00001_3.png"))
    np.testing.assert_array_equal(got, want)
    other = slice_run["model"].predict(
        slice_run["batch"].x, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(other, pred)
    with pytest.raises(ValueError, match="no weights"):
        Palette(device="cpu").predict(np.zeros((1, 16, 16, 1), np.float32))


def test_flops_include_attention(slice_run, monkeypatch):
    """6 attention blocks (2 input, the middle, 3 output) at T = 484, 4
    heads of D = INNER / 4: the reported FLOPs hold 4*H*T*T*D for each."""
    from pai_tpu_torch.utils.flops import count_flops

    unet = slice_run["model"]._module
    probe = torch.zeros((1, SIZE, SIZE, 1))
    gamma = torch.ones((1,))
    assert count_flops(unet, probe, probe, gamma) == slice_run["stats"]["flops"]
    monkeypatch.setattr(diffusion_unet, "multihead_attention",
                        lambda q, k, v: v)
    without = count_flops(unet, probe, probe, gamma)
    t = (SIZE // 8) ** 2
    assert slice_run["stats"]["flops"] - without == \
        6 * 4 * 4 * t * t * (INNER // 4)


def test_ema_weights_are_what_evaluation_runs(slice_run):
    state = slice_run["model"]._module.state_dict()
    for name, tensor in slice_run["ema"].items():
        assert torch.equal(state[name], tensor), name
    assert slice_run["model"].hparams["ema"] is True
    assert slice_run["model"].model_name == "palette"
    assert not slice_run["model"]._module.training


def _jax_palette_init_defaults():
    """The JAX package's ``Palette.__init__`` defaults, read from its source
    (importing ``pai_tpu.api`` would load the whole JAX trainer)."""
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "pai_tpu", "api.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    cls = next(node for node in tree.body if isinstance(node, ast.ClassDef)
               and node.name == "Palette")
    init = next(node for node in cls.body
                if isinstance(node, ast.FunctionDef)
                and node.name == "__init__")
    args = init.args.args[1:]
    defaults = init.args.defaults
    return {a.arg: ast.literal_eval(d)
            for a, d in zip(args[len(args) - len(defaults):], defaults)}


def test_palette_api_defaults_match_jax():
    import inspect

    ours = inspect.signature(Palette.__init__).parameters
    theirs = _jax_palette_init_defaults()
    assert len(theirs) >= 8
    for name, default in theirs.items():
        assert ours[name].default == default, name
    assert ours["device"].default == "cuda"
    model = Palette(device="cpu")
    assert model.hparams["channel_mults"] == "1,1,2,2,4,4"
    assert model.hparams["attention_res"] == "16,8"
    assert model.hparams["loss_type"] == "mse"
    assert model.hparams["dropout"] == 0.1


def test_new_modules_import_without_jax_or_triton():
    """The modules of the Palette slices and of the Lightning interop and
    native codec, imported in a fresh interpreter (the one
    ``fresh_interpreter_imports`` starts for every port module), load
    neither JAX nor the JAX package nor triton, PIL or yaml."""
    result = fresh_interpreter_imports()
    for name in ["kernels.flash_attention", "ops.attention",
                 "models.diffusion_unet", "diffusion", "diffusion.schedule",
                 "diffusion.gaussian", "diffusion.sampler", "reporting", "api",
                 "train.ema", "train.state", "train.steps", "train.loop",
                 "utils.logging", "utils.checkpoint", "main", "native",
                 "native.png_native", "interop.lightning"]:
        assert "pai_tpu_torch." + name in result["modules"], name
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "pai_tpu", "triton",
              "PIL", "yaml"}
    assert not banned & set(result["loaded"])
