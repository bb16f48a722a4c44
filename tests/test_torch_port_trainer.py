"""The port's training engine on the CPU, no JAX trainer compiled: the
``Trainer`` (slots, logs, validation samples, resume, divergence), the train
CLI's flag surface against the root ``main.py``, ``api.Palette.fit`` and
``api.Pix2Pix.fit``, the CSV logger and the checkpoint manager against the
JAX package's, and the training loader's order against the JAX loader's.

Sizes: 32x32 images, channel mults (1, 2), attention at downsample rate 2,
the UNet's base width narrowed to 16 (the registry fixes 128; the test wraps
the class it builds) and the 100-step sampling schedule shortened to 4 (the
way the palette report test shortens its own), so that a run of a few
epochs takes seconds. The GAN runs (Pix2Pix, channel mults (1, 2, 4), the
PatchGAN at its published widths) take 32x32 through the CLI (the test sets
its image size, which the CLI fixes at 256), and 176x176 for the one step
whose best slot the report CLI then serves (its 16 depth bands need more
than 10 rows each)."""

import argparse
import contextlib
import csv
import io
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from pai_tpu_torch import main as port_main
from pai_tpu_torch.api import AttentionUnetGAN, Palette, Pix2Pix
from pai_tpu_torch.data import BatchLoader, ImageDataset
from pai_tpu_torch.models import (Discriminator, build_generator,
                                  diffusion_unet, registry)
from pai_tpu_torch.train import loop
from pai_tpu_torch.train import steps as steps_lib
from pai_tpu_torch.utils import images as ti
from pai_tpu_torch.utils.checkpoint import (CheckpointManager,
                                            load_checkpoint)
from pai_tpu_torch.utils.logging import CSVLogger, dump_yaml
from torch_port_util import write_blob_dataset

SIZE, INNER, N_TRAIN, N_VAL, BATCH = 32, 16, 5, 3, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _narrow_unet(**kwargs):
    kwargs["inner_channel"] = INNER
    return diffusion_unet.DiffusionUNet(**kwargs)


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    """A narrow UNet and a 4-step sampling schedule for the whole module,
    and a dataset."""
    patch = pytest.MonkeyPatch()
    patch.setattr(registry, "DiffusionUNet", _narrow_unet)
    real_schedule = loop.make_schedule
    patch.setattr(loop, "make_schedule",
                  lambda kind, n, *a, **kw: real_schedule(
                      kind, 4 if kind == "cosine" else n, *a, **kw))
    root = tmp_path_factory.mktemp("train_data")
    train = write_blob_dataset(root, N_TRAIN, SIZE, seed=31,
                               write_png=ti.write_png)
    os.replace(train, root / "train.yaml")
    val_dir = root / "val"
    val_dir.mkdir()
    val = write_blob_dataset(val_dir, N_VAL, SIZE, seed=32,
                             write_png=ti.write_png)
    try:
        yield {"root": root, "train": str(root / "train.yaml"), "val": val}
    finally:
        patch.undo()


def _hparams(world, out, **overrides):
    base = dict(name="run", data=world["train"], val_data=world["val"],
                model="palette", channel_mults="1,2", attention_res="2",
                batch_size=BATCH, epochs=4, val_epochs=2, ema=True,
                device="cpu", image_size=SIZE, log_dir=str(out / "logs"),
                ckpt_dir=str(out / "ckpt"))
    return dict(base, **overrides)


class _Terminal(io.StringIO):
    """A text stream that says it is a terminal."""

    def isatty(self):
        return True


@pytest.fixture(scope="module")
def run(small_world, tmp_path_factory):
    """4 epochs of 3 steps (5 images, batches of 2, the last one cycled),
    validation after epochs 2 and 4, EMA on; its standard output and error
    kept (streams that are no terminal)."""
    out = tmp_path_factory.mktemp("run")
    h = _hparams(small_world, out)
    trainer = loop.Trainer(h)
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr):
        summary = trainer.fit()
    return {"out": out, "h": h, "trainer": trainer, "summary": summary,
            "ckpt": out / "ckpt" / "run", "log": out / "logs" / "run" /
            "version_0", "stdout": stdout.getvalue(),
            "stderr": stderr.getvalue()}


def test_slots_hold_the_whole_train_state(run):
    assert run["summary"]["steps"] == 12
    assert set(run["summary"]) >= {"val_ssim", "val_psnr", "val_rmse",
                                   "images_per_sec"}
    assert sorted(os.listdir(run["ckpt"])) == ["best", "last"]
    model = run["trainer"].model
    params = dict(model.named_parameters())
    for slot in ("best", "last"):
        assert sorted(os.listdir(run["ckpt"] / slot)) == ["meta.json",
                                                          "state.pt"]
        state, meta = load_checkpoint(str(run["ckpt"] / slot))
        assert set(meta) == {"hparams", "step", "epoch", "monitor_value",
                             "ema_num_updates"}
        assert meta["hparams"]["model"] == "palette"
        assert set(state) >= set(model.state_dict())
        assert {k for k in state if k.startswith("ema.")} == \
            {f"ema.{k}" for k in params}
        opt = {k for k in state if k.startswith("opt.")}
        assert opt == {f"opt.{k}.{m}" for k in params
                       for m in ("exp_avg", "exp_avg_sq", "step")}
    last_state, last = load_checkpoint(str(run["ckpt"] / "last"))
    assert (last["step"], last["epoch"], last["ema_num_updates"]) == \
        (12, 3, 12)
    for name, p in params.items():  # the end of training is what last holds
        assert torch.equal(last_state[name], p.detach()), name
    best = json.loads((run["ckpt"] / "best" / "meta.json").read_text())
    assert best["monitor_value"] == max(
        float(row["val_ssim"]) for row in _csv_rows(run["log"])
        if row["val_ssim"])


def _csv_rows(log_dir):
    with open(log_dir / "metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


def test_metrics_csv_hparams_and_validation_samples(run):
    log = run["log"]
    with open(log / "metrics.csv") as f:
        header = f.readline().strip().split(",")
    # the first validation (step 6) comes before the first training row
    assert header == ["epoch", "step", "val_ssim", "val_psnr", "val_rmse",
                      "loss", "mse_loss", "vlb_loss"]
    rows = _csv_rows(log)
    # validation after epochs 2 and 4; the training row every 10 steps
    assert [(r["epoch"], r["step"]) for r in rows] == [
        ("1", "6"), ("3", "10"), ("3", "12")]
    assert rows[1]["val_ssim"] == "" and np.isfinite(float(rows[1]["loss"]))
    assert all(np.isfinite(float(rows[i]["val_psnr"])) for i in (0, 2))
    import yaml

    hp = yaml.safe_load((log / "hparams.yaml").read_text())
    assert hp["channel_mults"] == "1,2" and hp["ema"] is True
    assert hp["profile_dir"] is None and hp["image_size"] == SIZE
    for epoch in (2, 4):  # one PNG per validation image, per validation
        names = sorted(os.listdir(log / str(epoch)))
        assert names == [f"output_{i}.png" for i in range(N_VAL)]
    assert ti.read_png(str(log / "4" / "output_2.png")).shape == (SIZE, SIZE)


def test_load_from_checkpoint_reads_a_training_slot(run):
    model = Palette.load_from_checkpoint(str(run["ckpt"] / "best"),
                                         device="cpu")
    state, _ = load_checkpoint(str(run["ckpt"] / "best"))
    own = model._module.state_dict()
    for name, tensor in own.items():  # EMA weights over raw, buffers raw
        want = state.get(f"ema.{name}", state[name])
        assert torch.equal(tensor, want), name
    assert not model._module.training


def test_resume_continues_where_an_uninterrupted_run_would_be(
        small_world, tmp_path):
    """1 epoch, then --resume to 2, end bit for bit where 2 epochs in one
    run end: the draws are seeded per step and the order per epoch, and the
    slot carries Adam's state and the EMA. The one run folds its steps in
    pairs (--scan-steps 2), which changes nothing."""
    one = loop.Trainer(_hparams(small_world, tmp_path / "one", epochs=2,
                                val_data=None, scan_steps=2))
    assert one.fit()["steps"] == 6
    first = _hparams(small_world, tmp_path / "two", epochs=1, val_data=None)
    assert loop.Trainer(first).fit()["steps"] == 3
    resumed = loop.Trainer(dict(first, epochs=2, resume=True))
    assert resumed.fit()["steps"] == 6
    a, meta_a = load_checkpoint(str(tmp_path / "one" / "ckpt" / "run" /
                                    "last"))
    b, meta_b = load_checkpoint(str(tmp_path / "two" / "ckpt" / "run" /
                                    "last"))
    assert meta_a == dict(meta_b, hparams=meta_a["hparams"])
    assert meta_a["hparams"]["scan_steps"] == 2
    assert (meta_b["step"], meta_b["epoch"], meta_b["ema_num_updates"]) == \
        (6, 1, 6)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_non_finite_loss_writes_the_diverged_slot_and_halts(
        small_world, tmp_path, monkeypatch):
    real = steps_lib.make_palette_train_step

    def poisoned(*args, **kwargs):
        step = real(*args, **kwargs)

        def train_step(state, x, y, rand=None):
            state, metrics = step(state, x, y, rand)
            if state.step >= 10:
                metrics["loss"] = torch.tensor(float("nan"))
            return state, metrics
        return train_step

    monkeypatch.setattr(steps_lib, "make_palette_train_step", poisoned)
    h = _hparams(small_world, tmp_path, val_data=None)
    with pytest.raises(FloatingPointError, match="step 10"):
        loop.Trainer(h).fit()
    ckpt = tmp_path / "ckpt" / "run"
    assert sorted(os.listdir(ckpt)) == ["diverged"]  # last is not clobbered
    _, meta = load_checkpoint(str(ckpt / "diverged"))
    assert (meta["step"], meta["monitor_value"]) == (10, None)


def test_palette_fit_through_the_api(small_world, tmp_path):
    model = Palette(channel_mults=(1, 2), attention_res=(2,), dropout=0.1,
                    image_size=SIZE, device="cpu")
    summary = model.fit("apirun", small_world["train"], small_world["val"],
                        epochs=1, steps=2, val_epochs=1, batch_size=BATCH,
                        log_dir=str(tmp_path / "logs"),
                        ckpt_dir=str(tmp_path / "ckpt"),
                        profile_dir=str(tmp_path / "profile"))
    assert summary["steps"] == 2 and np.isfinite(summary["val_ssim"])
    # --profile-dir: a trace of the steps (stopped after 12, or at the end)
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]
    x = torch.zeros((1, SIZE, SIZE, 1))
    out = model.predict(x, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, SIZE, SIZE, 1)
    state, meta = load_checkpoint(str(tmp_path / "ckpt" / "apirun" / "last"))
    assert meta["hparams"]["dropout"] == 0.1
    for name, tensor in model._module.state_dict().items():
        assert torch.equal(tensor, state[name]), name


# ------------------------------------------------------- GAN training
GAN_EPOCHS = 4  # 12 steps of 5 images in batches of 2, validations at 2, 4


def _gan_argv(world, out, *extra, validate=True):
    return ["gan", "-d", world["train"], "-m", "pix2pix", "--channel-mults",
            "1,2,4", "--batch-size", str(BATCH), "--device", "cpu",
            "--log-dir", str(out / "logs"), "--ckpt-dir", str(out / "ckpt"),
            *(["-vd", world["val"]] if validate else []), *extra]


@pytest.fixture(scope="module")
def gan_run(small_world, tmp_path_factory):
    """``python -m pai_tpu_torch.main gan -m pix2pix`` (the CLI's default
    ``--loss-type gan``) at 32x32 with the EMA: 12 steps, validations after
    epochs 2 and 4; standard output and error both a terminal, the live
    line redrawn and its loss fetched at every step, each step's loss
    kept."""
    out = tmp_path_factory.mktemp("gan")
    terminal, losses = _Terminal(), []
    real_make = steps_lib.make_gan_train_step

    def recorded(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def run_step(state, x, y):
            state, metrics = step(state, x, y)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run_step

    patch = pytest.MonkeyPatch()
    patch.setattr(loop, "IMAGE_SIZE", SIZE)
    patch.setattr(steps_lib, "make_gan_train_step", recorded)
    patch.setattr(loop._Progress, "_MIN_INTERVAL", 0.0)
    patch.setattr(loop._Progress, "_FETCH_INTERVAL", 0.0)
    patch.setattr(sys, "stdout", terminal)
    patch.setattr(sys, "stderr", terminal)
    try:
        summary = port_main.main(_gan_argv(
            small_world, out, "-e", str(GAN_EPOCHS), "--val-epochs", "2",
            "--ema"))
    finally:
        patch.undo()
    return {"summary": summary, "ckpt": out / "ckpt" / "gan",
            "log": out / "logs" / "gan" / "version_0",
            "terminal": terminal.getvalue(), "losses": losses}


def test_gan_cli_logs_losses_and_train_metrics_at_log_rows(gan_run):
    assert gan_run["summary"]["steps"] == 12
    with open(gan_run["log"] / "metrics.csv") as f:
        header = f.readline().strip().split(",")
    assert header == ["epoch", "step", "val_ssim", "val_psnr", "val_rmse",
                      "loss", "d_loss", "train_ssim", "train_psnr",
                      "train_rmse"]
    rows = _csv_rows(gan_run["log"])
    assert [(r["epoch"], r["step"]) for r in rows] == [
        ("1", "6"), ("3", "10"), ("3", "12")]
    assert all(np.isfinite(float(rows[1][k])) for k in header[5:])
    assert rows[1]["val_ssim"] == ""
    assert all(np.isfinite(float(rows[i][k])) for i in (0, 2)
               for k in header[2:5])
    assert float(rows[2]["val_ssim"]) == pytest.approx(
        gan_run["summary"]["val_ssim"])
    assert not any(name.isdigit() for name in os.listdir(gan_run["log"]))


LIVE = re.compile(r"\[pai_tpu_torch\] epoch (\d+) step (\d+)(.*?)\x1b\[K")


def test_the_live_line_shows_the_previous_steps_loss_on_a_terminal(gan_run):
    """On a terminal every step redraws one inline line (``\\r``, no
    newline): an off-row step shows the loss of the step before it, read
    from the copy that step started (on the CPU: the value itself); the log
    row at step 10 shows every metric; the line is ended before each
    validation prints and at the end (pai_tpu/train/loop.py:50-104)."""
    text, losses = gan_run["terminal"], gan_run["losses"]
    assert len(losses) == 12
    draws = [(int(m.group(1)), int(m.group(2)), m.group(3))
             for m in LIVE.finditer(text)]
    assert [step for _, step, _ in draws] == list(range(1, 13))
    for epoch, step, shown in draws:
        assert epoch == (step - 1) // 3 + 1
        values = dict(re.findall(r"(\w+)=(-?[\d.]+)", shown))
        if step == 1:
            assert values == {}
        elif step == 10:  # the log row, fetched there
            assert set(values) == {"loss", "d_loss", "train_ssim",
                                   "train_psnr", "train_rmse"}
            assert float(values["loss"]) == pytest.approx(losses[9],
                                                          abs=1e-4)
            assert shown.endswith(" img/s")
        else:
            assert float(values["loss"]) == pytest.approx(
                losses[step - 2], abs=1e-4), (step, shown)
    # an inline line is redrawn or ended, never written after
    assert text.count("\x1b[K") == text.count("\x1b[K\r") \
        + text.count("\x1b[K\n")
    lines = text.split("\n")
    validations = [i for i, line in enumerate(lines)
                   if re.match(r"\[pai_tpu_torch\] epoch \d+ step \d+: val_",
                               line)]
    assert len(validations) == 2
    for i in validations:  # the line, ended just before
        assert lines[i - 1].startswith("\r[pai_tpu_torch] epoch ")
        assert lines[i - 1].endswith("\x1b[K")


def test_off_a_terminal_only_the_log_rows_are_printed(run):
    """Not a terminal: standard error holds the log row of step 10 alone,
    a plain line, as before the live line existed; standard output the
    validations."""
    rows = {int(r["step"]): r for r in _csv_rows(run["log"]) if r["loss"]}
    assert set(rows) == {10}
    row = rows[10]
    assert "\r" not in run["stderr"] and "\x1b" not in run["stderr"]
    lines = run["stderr"].splitlines()
    assert len(lines) == 1
    values = " ".join(f"{k}={float(row[k]):.4f}"
                      for k in ("loss", "mse_loss", "vlb_loss"))
    assert re.fullmatch(re.escape(f"[pai_tpu_torch] epoch 4 step 10 "
                                  f"{values} | ") + r"[\d.]+ img/s",
                        lines[0]), lines[0]
    assert [line.split(":")[0] for line in run["stdout"].splitlines()] == [
        "[pai_tpu_torch] epoch 2 step 6", "[pai_tpu_torch] epoch 4 step 12"]


def test_gan_slots_hold_both_networks_and_both_adam_chains(gan_run):
    assert sorted(os.listdir(gan_run["ckpt"])) == ["best", "last"]
    gen = build_generator("pix2pix", channel_mults=(1, 2, 4), device="meta")
    g_params = [k for k, _ in gen.named_parameters()]
    d_params = [f"discriminator.{k}" for k, _ in Discriminator(
        device="meta").named_parameters()]
    state, meta = load_checkpoint(str(gan_run["ckpt"] / "last"))
    assert (meta["step"], meta["epoch"], meta["ema_num_updates"]) == \
        (12, 3, 12)
    assert set(state) == (
        set(gen.state_dict()) | set(d_params)
        | {f"ema.{k}" for k in g_params + d_params}
        | {f"opt.{k}.{m}" for k in g_params + d_params
           for m in ("exp_avg", "exp_avg_sq", "step")})
    best, meta = load_checkpoint(str(gan_run["ckpt"] / "best"))
    assert meta["monitor_value"] == max(
        float(r["val_ssim"]) for r in _csv_rows(gan_run["log"])
        if r["val_ssim"])
    # the report and the API rebuild the generator alone, from the EMA
    model = Pix2Pix.load_from_checkpoint(str(gan_run["ckpt"] / "best"),
                                         device="cpu")
    for name, tensor in model._module.state_dict().items():
        assert torch.equal(tensor, best.get(f"ema.{name}", best[name])), name
    assert not model._module.training


def test_gan_report_cli_serves_the_best_slot(small_world, tmp_path):
    """One GAN step at 176x176 with a validation, then ``python -m
    pai_tpu_torch.report -m pix2pix -c <best>`` on it."""
    from pai_tpu_torch import report as port_report

    h = dict(_hparams(small_world, tmp_path, model="pix2pix",
                      channel_mults="1,2,4", epochs=1, steps=1, val_epochs=1,
                      image_size=176))
    assert loop.Trainer(h).fit()["steps"] == 1
    best = tmp_path / "ckpt" / "run" / "best"
    port_report.main(["rep", "-c", str(best), "-d", small_world["val"],
                      "-m", "pix2pix", "-bs", "2", "--device", "cpu",
                      "--reports-dir", str(tmp_path / "reports")])
    out = tmp_path / "reports" / "rep"
    assert {"stats.txt", "depth_ssim.csv", "outputs",
            "ssim_images"} <= set(os.listdir(out))
    assert len(os.listdir(out / "outputs")) == N_VAL
    assert "SSIM" in (out / "stats.txt").read_text().upper()


def test_gan_resume_continues_where_an_uninterrupted_run_would_be(
        small_world, tmp_path, monkeypatch):
    """As for Palette: 1 epoch, then --resume to 2, ends bit for bit where 2
    epochs in one run end (both networks, both Adam chains, the EMA, the
    running statistics)."""
    monkeypatch.setattr(loop, "IMAGE_SIZE", SIZE)
    for tag, epochs in (("one", ["-e", "2"]), ("two", ["-e", "1"]),
                        ("two", ["-e", "2", "--resume"])):
        port_main.main(_gan_argv(small_world, tmp_path / tag, *epochs,
                                 "--ema", validate=False))
    a, meta_a = load_checkpoint(str(tmp_path / "one" / "ckpt" / "gan" /
                                    "last"))
    b, meta_b = load_checkpoint(str(tmp_path / "two" / "ckpt" / "gan" /
                                    "last"))
    assert meta_a == dict(meta_b, hparams=meta_a["hparams"])
    assert (meta_b["step"], meta_b["epoch"]) == (6, 1)
    assert a.keys() == b.keys()
    assert any(k.startswith("opt.discriminator.") for k in a)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_pix2pix_fit_through_the_api(small_world, tmp_path):
    model = Pix2Pix(channel_mults=(1, 2, 4), loss_type="mse",
                    image_size=SIZE, device="cpu")
    summary = model.fit("apigan", small_world["train"], small_world["val"],
                        epochs=1, val_epochs=1, batch_size=BATCH,
                        log_dir=str(tmp_path / "logs"),
                        ckpt_dir=str(tmp_path / "ckpt"))
    assert summary["steps"] == 3
    assert all(np.isfinite(summary[k]) for k in ("val_ssim", "val_psnr",
                                                  "val_rmse"))
    state, meta = load_checkpoint(str(tmp_path / "ckpt" / "apigan" / "last"))
    assert meta["hparams"]["loss_type"] == "mse"
    assert not any(k.startswith("discriminator.") for k in state)
    for name, tensor in model._module.state_dict().items():
        assert torch.equal(tensor, state[name]), name
    out = model.predict(np.zeros((1, SIZE, SIZE, 1), np.float32))
    assert out.shape == (1, SIZE, SIZE, 1)
    # every family trains (tests/test_torch_port_families_train.py); on a
    # world of one the API raises what pai_tpu raises for a mesh that does
    # not divide its devices (tests/test_torch_port_parallel.py runs meshes)
    with pytest.raises(ValueError, match="does not divide"):
        AttentionUnetGAN(device="cpu").fit("x", small_world["train"], tp=2)


# ------------------------------------------------------------------ the CLI
def _root_main_parser(monkeypatch):
    """The root ``main.py``'s parser, caught as it parses (the script builds
    it under ``__main__``)."""
    caught = {}

    def catch(self, args=None, namespace=None):
        caught["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    monkeypatch.setattr(sys, "argv", ["main.py"])
    with pytest.raises(SystemExit):
        runpy.run_path(os.path.join(REPO, "main.py"), run_name="__main__")
    monkeypatch.undo()
    return caught["parser"]


def test_cli_flag_surface_matches_the_root_main(monkeypatch):
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default,
                         tuple(a.choices) if a.choices else None, a.type,
                         a.nargs) for a in parser._actions
                if a.dest != "help"}

    theirs = surface(_root_main_parser(monkeypatch))
    ours = surface(port_main.build_parser())
    assert set(ours) - set(theirs) == {"device"}
    for dest, spec in theirs.items():
        assert ours[dest] == spec, dest
    assert ours["device"][1] == "cuda"


@pytest.mark.parametrize("argv,error,match", [
    (["-m", "trans_unet"], ValueError, "incompatible with patch_size"),
    (["-m", "palette", "--tp", "2"], ValueError, "does not divide"),
    (["-m", "palette", "--sp", "2"], ValueError, "does not divide"),
    (["-m", "palette", "--fsdp", "--sp", "4"], ValueError,
     "does not divide"),
    (["-m", "palette", "--scan-steps", "3"], ValueError, "scan-steps")])
def test_cli_raises_for_what_is_not_ported(argv, error, match, tmp_path):
    with pytest.raises(error, match=match):
        port_main.main(["run", "-d", "x.yaml", "--device", "cpu",
                        "--log-dir", str(tmp_path)] + argv)
    assert not os.listdir(tmp_path)  # raised before writing anything


# ------------------------------------------- logger, manager and loader
def test_csv_logger_and_hparams_yaml_match_jax(tmp_path):
    import yaml
    from pai_tpu.utils.logging import CSVLogger as JaxCSVLogger

    hp = {"name": "r", "epochs": 3, "dropout": 0.1, "ema": False,
          "profile_dir": None, "channel_mults": "1,2,4", "data": "a b.yaml",
          "seed": -1, "ratio": 1e-06, "mults": [1, 2]}
    loggers = [cls(str(tmp_path / tag), "run")
               for tag, cls in (("jax", JaxCSVLogger), ("port", CSVLogger))]
    assert all(lg.log_dir.endswith(os.path.join("run", "version_0"))
               for lg in loggers)
    for lg in loggers:
        lg.log_hparams(hp)
        lg.log_metrics({"loss": 0.5, "mse_loss": 0.25}, 10, 0)
        lg.log_metrics({"val_ssim": 0.75}, 10, 0)  # the header grows
        lg.log_metrics({"loss": float("nan"), "mse_loss": 1.0}, 20, 1)
    texts = [open(os.path.join(lg.log_dir, "metrics.csv")).read()
             for lg in loggers]
    assert texts[0] == texts[1]
    parsed = [yaml.safe_load(open(os.path.join(lg.log_dir, "hparams.yaml")))
              for lg in loggers]
    assert parsed[0] == parsed[1] == hp
    assert CSVLogger(str(tmp_path / "port"), "run").log_dir.endswith(
        "version_1")
    with pytest.raises(TypeError):
        dump_yaml({"x": object()})


def test_checkpoint_manager_keeps_the_best_val_ssim(tmp_path):
    manager = CheckpointManager(str(tmp_path), "run")
    with pytest.raises(FileNotFoundError):
        manager.restore("last")
    hp = {"model": "palette"}
    for value, saved in ((0.5, True), (0.4, False), (0.6, True)):
        flat = {"w": torch.full((2,), value)}
        assert manager.maybe_save_best(flat, hp, 1, 0, value) is saved
    state, meta = manager.restore("best")
    assert torch.equal(state["w"], torch.full((2,), 0.6))
    assert meta["monitor_value"] == pytest.approx(0.6)
    # a new manager over the same directory knows the best so far
    again = CheckpointManager(str(tmp_path), "run")
    assert again.best_value == pytest.approx(0.6)
    assert not again.maybe_save_best({"w": torch.zeros(2)}, hp, 2, 1, 0.55)
    assert not any(name.endswith(".tmp") for name in os.listdir(again.dir))


@pytest.mark.parametrize("stage", ["fit", "validate", "test", "predict"])
def test_image_data_module_matches_jax(small_world, stage):
    """The same splits per stage, the same loaders (shuffle and pad mode),
    and, for the unshuffled ones, the same batches."""
    from pai_tpu.data import ImageDataModule as JaxImageDataModule
    from pai_tpu_torch.data import ImageDataModule

    args = (small_world["train"], small_world["val"], BATCH)
    ours = ImageDataModule(*args, image_size=SIZE, seed=3, device="cpu")
    theirs = JaxImageDataModule(*args, image_size=SIZE, seed=3)
    ours.setup(stage)
    theirs.setup(stage)
    for split in ("train", "val", "test", "pred"):
        mine, want = (getattr(m, f"{split}_split") for m in (ours, theirs))
        assert (mine is None) == (want is None), split
        if mine is None:
            continue
        assert mine.pairs == want.pairs, split
        name = {"pred": "predict"}.get(split, split)
        loaders = [getattr(m, f"{name}_dataloader")() for m in (ours,
                                                                 theirs)]
        assert [(lo.shuffle, lo.pad_mode, lo.batch_size, lo.seed)
                for lo in loaders] == [(split == "train", "cycle" if
                                        split == "train" else "zero",
                                        BATCH, 3)] * 2
        if split != "train":
            for a, b in zip(loaders[0], loaders[1]):
                assert a.n_valid == b.n_valid
                np.testing.assert_array_equal(a.x.numpy(), np.asarray(b.x))
                np.testing.assert_array_equal(a.y.numpy(), np.asarray(b.y))


@pytest.mark.parametrize("pad_mode", ["cycle", "zero"])
def test_loader_order_matches_the_jax_loader(small_world, pad_mode):
    """Per-epoch seeded shuffles: the same permutations as the JAX loader,
    padded by cycling (training) or with zero rows (validation)."""
    from pai_tpu.data.pipeline import BatchLoader as JaxBatchLoader

    dataset = ImageDataset(small_world["train"], SIZE)
    ours = BatchLoader(dataset, BATCH, shuffle=True, pad_mode=pad_mode,
                       seed=7, device="cpu")
    theirs = JaxBatchLoader(dataset, BATCH, shuffle=True, pad_mode=pad_mode,
                            seed=7)
    orders = set()
    for epoch in range(3):
        ours.epoch = theirs.epoch = epoch
        order = [int(i) for i in theirs._epoch_order()]
        orders.add(tuple(order))
        batches = ours.epoch_batches()
        assert ours.epoch == epoch + 1
        flat = [i for idx, _ in batches for i in idx]
        pad = order[:1] if pad_mode == "cycle" else [-1]
        assert flat == order + pad
        assert [n for _, n in batches] == [2, 2, 1]
    assert len(orders) == 3
