"""The ported slice as a whole: ``pai_tpu_torch.reporting.run_report`` on the
CPU against ``pai_tpu.reporting.run_report`` with the same numpy-made weights,
on a small synthetic dataset written to a temporary directory.

Sizes: 6 images of 176x176 (the smallest size whose 16 depth bands, 11 rows
each, still hold an 11-tap window), channel mults (1,2), batch 4 — so the
last batch is zero-padded. The JAX side gets its weights by a test-side patch
of ``pai_tpu.reporting._rebuild_from_checkpoint`` (nothing in the package
changes); the port reads a real checkpoint written by
``save_eval_checkpoint`` from ``state_dict_from_jax``.

Tolerance 1e-4 on every statistic (float32 forward and float32 SSIM summed in
different orders, see the module tests); PNGs within one grey level."""

import os

import numpy as np
import pytest
import torch

from pai_tpu_torch import reporting as port_reporting
from pai_tpu_torch.api import (AttentionUnetGAN, Pix2Pix, ResUnetGAN,
                               TransUnetGAN)
from pai_tpu_torch.data import BatchLoader, ImageDataset
from pai_tpu_torch.interop import state_dict_from_jax
from pai_tpu_torch.utils import images as ti
from pai_tpu_torch.utils.checkpoint import (load_checkpoint,
                                            save_eval_checkpoint)
from torch_port_util import (fresh_interpreter_imports,
                             pix2pix_numpy_variables, write_blob_dataset)

SIZE, N_IMAGES, BATCH, MULTS = 176, 6, 4, (1, 2)
TOL = 1e-4
HPARAMS = {"model": "pix2pix", "channel_mults": "1,2", "attention_res": "2",
           "dropout": 0.0, "precision": "32", "image_size": SIZE,
           "ema": False, "loss_type": "gan", "learn_variance": False}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both packages' reports of one checkpoint over one dataset."""
    import pai_tpu.reporting as jax_reporting

    root = tmp_path_factory.mktemp("slice")
    manifest = write_blob_dataset(root, N_IMAGES, SIZE, seed=12,
                                  write_png=ti.write_png)
    module, params, stats = pix2pix_numpy_variables(MULTS, SIZE, seed=13)

    sd = state_dict_from_jax("pix2pix", params, stats, HPARAMS)
    slot = save_eval_checkpoint(str(root / "checkpoints"), "run", sd, HPARAMS,
                                slot="best", step=7, epoch=1,
                                monitor_value=0.5)
    port_stats = port_reporting.run_report(
        "port", slot, manifest, "pix2pix", batch_size=BATCH,
        reports_dir=str(root / "reports"), device="cpu")

    patch = pytest.MonkeyPatch()
    patch.setattr(jax_reporting, "_rebuild_from_checkpoint",
                  lambda name, path: (module, params, stats, dict(HPARAMS),
                                      False, SIZE))
    try:
        jax_stats = jax_reporting.run_report(
            "jax", "unused", manifest, "pix2pix", batch_size=BATCH,
            reports_dir=str(root / "reports"))
    finally:
        patch.undo()
    return {"root": root, "manifest": manifest, "slot": slot,
            "port": root / "reports" / "port", "jax": root / "reports" / "jax",
            "port_stats": port_stats, "jax_stats": jax_stats}


def _stats_txt(path):
    return dict(line.split(": ") for line in
                (path / "stats.txt").read_text().splitlines())


def _csv(path):
    lines = path.read_text().splitlines()
    return lines[0], [line.split(",") for line in lines[1:]]


def test_stats_match_jax(reports):
    port, jax_ = _stats_txt(reports["port"]), _stats_txt(reports["jax"])
    assert list(port) == list(jax_) == ["SSIM", "PSNR", "RMSE", "FLOPs",
                                        "Parameter count"]
    for key in ("SSIM", "PSNR", "RMSE"):
        assert float(port[key]) == pytest.approx(float(jax_[key]), abs=TOL)
        assert np.isfinite(float(port[key]))
    assert int(port["Parameter count"]) == int(jax_["Parameter count"]) > 0
    # FlopCounterMode and XLA's cost model count differently: same order only
    assert int(port["FLOPs"]) > 0
    for key, name in (("SSIM", "ssim"), ("PSNR", "psnr"), ("RMSE", "rmse")):
        assert reports["port_stats"][name] == pytest.approx(
            reports["jax_stats"][name], abs=TOL)
        assert reports["port_stats"][name] == float(port[key])
    assert reports["port_stats"]["params"] == reports["jax_stats"]["params"]


@pytest.mark.parametrize("metric", ["ssim", "psnr", "mse"])
def test_per_image_csv_matches_jax(reports, metric):
    head_p, rows_p = _csv(reports["port"] / f"{metric}_per_image.csv")
    head_j, rows_j = _csv(reports["jax"] / f"{metric}_per_image.csv")
    assert head_p == head_j == f"image,{metric}"
    assert [r[0] for r in rows_p] == [r[0] for r in rows_j] == \
        [str(i).zfill(5) for i in range(N_IMAGES)]
    np.testing.assert_allclose([float(r[1]) for r in rows_p],
                               [float(r[1]) for r in rows_j], atol=TOL,
                               rtol=0)


def test_depth_ssim_csv_matches_jax(reports):
    head_p, rows_p = _csv(reports["port"] / "depth_ssim.csv")
    head_j, rows_j = _csv(reports["jax"] / "depth_ssim.csv")
    assert head_p == head_j == "depth,mean,std"
    assert [r[0] for r in rows_p] == [str(d) for d in range(1, 17)]
    got = np.array([[float(v) for v in r[1:]] for r in rows_p])
    want = np.array([[float(v) for v in r[1:]] for r in rows_j])
    assert np.isfinite(got).all() and (got[:, 1] > 0).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("sub,shape", [("outputs", (SIZE, SIZE, 3)),
                                       ("ssim_images", (SIZE, SIZE))])
def test_pngs_match_jax_within_one_grey_level(reports, sub, shape):
    names = sorted(os.listdir(reports["port"] / sub))
    assert names == sorted(os.listdir(reports["jax"] / sub)) == \
        [f"{str(i).zfill(5)}.png" for i in range(N_IMAGES)]
    worst = 0
    for name in names:
        ours = ti.read_png(str(reports["port"] / sub / name))
        theirs = ti.read_png(str(reports["jax"] / sub / name))
        assert ours.shape == theirs.shape == shape
        worst = max(worst, int(np.abs(ours.astype(int)
                                      - theirs.astype(int)).max()))
    assert worst <= 1
    assert int(ours.max()) > int(ours.min())  # not a blank image


def test_api_predict_equals_the_reports_prediction(reports):
    model = Pix2Pix.load_from_checkpoint(reports["slot"], device="cpu")
    assert model.model_name == "pix2pix" and model.image_size == SIZE
    assert model.hparams["channel_mults"] == "1,2"
    loader = BatchLoader(ImageDataset(reports["manifest"], SIZE), BATCH,
                         pad_mode="zero", device="cpu")
    batch = next(iter(loader))
    pred = model.predict(batch.x)
    assert pred.shape == (BATCH, SIZE, SIZE, 1) and pred.dtype == torch.float32
    assert torch.equal(pred, model(batch.x.numpy()))  # arrays and __call__
    # the report's output PNG is this prediction, colormapped
    want = ti.to_int(ti.afmhot_rgb(ti.denormalize(pred)[0, ..., 0].numpy()))
    got = ti.read_png(str(reports["port"] / "outputs" / "00000.png"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        model.predict(batch.x, output_process=True)


def test_checkpoint_layout_and_ema_selection(reports, tmp_path):
    slot = reports["slot"]
    assert sorted(os.listdir(slot)) == ["meta.json", "state.pt"]
    assert slot.endswith(os.path.join("run", "best"))
    sd, meta = load_checkpoint(slot)
    assert meta["step"] == 7 and meta["epoch"] == 1
    assert meta["monitor_value"] == 0.5
    assert meta["hparams"]["channel_mults"] == "1,2"
    assert all(isinstance(v, torch.Tensor) for v in sd.values())

    # EMA shadow weights are what evaluation runs with, when the run kept them
    from pai_tpu_torch.restore import rebuild_eval_model

    ema = {k: v * 0.5 for k, v in sd.items() if k.endswith("weight")}
    ema_slot = save_eval_checkpoint(
        str(tmp_path), "run", sd, dict(HPARAMS, ema=True), slot="last",
        ema_state_dict=ema)
    sd2, meta2 = load_checkpoint(ema_slot)
    with_ema, _ = rebuild_eval_model(sd2, meta2["hparams"], device="cpu")
    without, _ = rebuild_eval_model(sd2, dict(meta2["hparams"], ema=False),
                                    device="cpu")
    key = "encoders.0.weight"
    assert torch.equal(with_ema.state_dict()[key], sd[key] * 0.5)
    assert torch.equal(without.state_dict()[key], sd[key])
    assert not with_ema.training
    assert not any(p.requires_grad for p in with_ema.parameters())


def test_identity_report_matches_jax(reports, tmp_path, monkeypatch):
    import pai_tpu.reporting as jax_reporting

    monkeypatch.setattr(jax_reporting, "IMAGE_SIZE", SIZE)
    monkeypatch.setattr(port_reporting, "IMAGE_SIZE", SIZE)
    ours = port_reporting.run_report(
        "id", None, reports["manifest"], "identity", batch_size=BATCH,
        reports_dir=str(tmp_path / "port"), device="cpu")
    theirs = jax_reporting.run_report(
        "id", None, reports["manifest"], "identity", batch_size=BATCH,
        reports_dir=str(tmp_path / "jax"))
    assert ours["params"] == theirs["params"] == 0
    assert ours["flops"] == theirs["flops"] == 0
    for key in ("ssim", "psnr", "rmse"):
        assert ours[key] == pytest.approx(theirs[key], abs=TOL)
    assert len(os.listdir(tmp_path / "port" / "id" / "outputs")) == N_IMAGES


def test_report_cli_surface_and_errors(reports, tmp_path, capsys):
    from pai_tpu_torch import report

    stats = report.main(["cli", "-d", reports["manifest"], "-m", "identity",
                         "-bs", "3", "--device", "cpu", "--reports-dir",
                         str(tmp_path)])
    assert "report written to" in capsys.readouterr().out
    assert np.isfinite(stats["ssim"])
    assert (tmp_path / "cli" / "stats.txt").exists()

    args = report.build_parser().parse_args(["n"])
    assert args.device == "cuda" and args.batch_size == 2
    assert args.model == "pix2pix" and args.reports_dir == "reports"
    assert report.MODEL_CHOICES == [
        "pix2pix", "attention_unet", "res18_unet", "res50_unet", "resv2_unet",
        "resnext_unet", "trans_unet", "palette", "identity"]
    with pytest.raises(ValueError, match="only supported by palette"):
        port_reporting.run_report("x", None, reports["manifest"], "identity",
                                  output_process=True, device="cpu")
    # -m names the family the slot is rebuilt as: a Pix2Pix slot has no
    # attention gates
    with pytest.raises(RuntimeError, match="attention_blocks"):
        port_reporting.run_report("x", reports["slot"], reports["manifest"],
                                  "attention_unet", device="cpu",
                                  reports_dir=str(tmp_path))


def test_entry_points_default_to_the_card_and_raise_without_one(reports):
    """This host has no CUDA device: every entry point called without
    ``device`` must say so instead of carrying on on the CPU."""
    assert not torch.cuda.is_available()
    from pai_tpu_torch import report
    from pai_tpu_torch.restore import rebuild_eval_model

    sd, meta = load_checkpoint(reports["slot"])
    calls = [
        lambda: port_reporting.run_report("x", reports["slot"],
                                          reports["manifest"], "pix2pix"),
        lambda: report.main(["x", "-d", reports["manifest"], "-m",
                             "identity"]),
        lambda: Pix2Pix.load_from_checkpoint(reports["slot"]),
        lambda: Pix2Pix.from_lightning_checkpoint("run.ckpt"),
        lambda: Pix2Pix(),
        lambda: AttentionUnetGAN(),
        lambda: ResUnetGAN(res_type="next"),
        lambda: TransUnetGAN(channel_mults=(1, 2, 2, 4, 4)),
        lambda: rebuild_eval_model(sd, meta["hparams"]),
        lambda: BatchLoader(ImageDataset(reports["manifest"], SIZE), 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unported_api_surface_names_the_roadmap():
    """Every class of the JAX package's API is ported and takes its family
    from its name (``ResUnetGAN`` from ``res_type``), with
    ``from_lightning_checkpoint`` (ROADMAP.md Queue A item 6; held by
    ``tests/test_torch_port_interop.py``). A class without weights refuses
    to predict, and one loads a slot of its family by the slot's
    hyperparameters."""
    names = {AttentionUnetGAN: "attention_unet", TransUnetGAN: "trans_unet",
             ResUnetGAN: "res18_unet", Pix2Pix: "pix2pix"}
    for cls, name in names.items():
        model = cls(channel_mults=(1, 2), device="cpu")
        assert model.hparams["model"] == name
        assert model.hparams["channel_mults"] == "1,2"
        with pytest.raises(ValueError, match="no weights"):
            model.predict(np.zeros((1, 16, 16, 1), np.float32))
        with pytest.raises(FileNotFoundError):
            cls.load_from_checkpoint("nowhere", device="cpu")
        with pytest.raises(FileNotFoundError):
            cls.from_lightning_checkpoint("nowhere.ckpt", device="cpu")
    for res_type in ("18", "50", "v2", "next"):
        assert ResUnetGAN(res_type=res_type, device="cpu").hparams[
            "model"] == f"res{res_type}_unet"


def test_port_imports_no_jax_and_none_of_the_helpers_it_replaces():
    """In a fresh interpreter, importing every module of the port leaves jax,
    flax, optax, orbax, pai_tpu, yaml, PIL and matplotlib unimported."""
    result = fresh_interpreter_imports()
    assert len(result["modules"]) >= 20, result["modules"]
    for name in ("native", "native.png_native", "interop.lightning"):
        assert "pai_tpu_torch." + name in result["modules"], name
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "pai_tpu", "yaml",
              "PIL", "matplotlib", "triton"}
    assert not banned & set(result["loaded"])
