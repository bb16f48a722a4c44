"""``--scan-steps K`` of pai_tpu_torch on the CPU: the chunking of the
train loop, and the steps a CUDA graph records, against pai_tpu.

On the card a chunk's K-1 lean steps are one CUDA graph
(``steps.TrainScan``); on the CPU they are ordinary steps, so the CPU holds
the loop's chunking (which steps a chunk folds, where the epoch's remainder
and the budget fall, none while profiling) and the result (bit-equal to
K = 1). What a graph records, ``TrainScan.fold`` (each step's learning rate
and EMA weight read from a tensor, the counts advanced after), runs eagerly
here against the JAX package's ``make_gan_train_scan`` and
``make_palette_train_scan`` (one ``lax.scan`` over K = 5 steps).

Sizes: Pix2Pix on 32x32 at batch 2, channel mults (1, 2), with the
PatchGAN at its published widths, 7 steps; the Palette UNet on 16x16 at
batch 1, mults (1,) narrowed to 16 channels (the trainer tests'
narrowing), 28 steps. The scan comparisons: Pix2Pix mults (1, 2) with the
``mse`` loss (no discriminator: the cheapest JAX scan to compile), and
Palette's one-level 8x8 UNet (attention in its middle block only) with
``learn_var`` and the EMA, with injected draws ``{"t", "noise", "u"}``
(``external_rand``) on both sides.

Tolerances: the GAN scan is held as one step is in
``tests/test_torch_port_gan_train.py`` (``compare_step``), from the shared
initial state, the parameters' and EMA weights' bounds summed over the five
steps (at mults (1, 2, 4) their largest difference, 0.014 of a learning
rate, exceeded one step's 0.01, and was the same after five ordinary
steps); Palette as three steps are in
``tests/test_torch_port_palette_train.py``, here over five: losses 1e-5
relative, parameters to a fifth of the five learning rates (the biases whose
gradient is float noise, ``_degenerate`` there, to a bound on their move),
running variances 1e-4 relative, the EMA's shadows as the parameters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu.train import steps as jsteps
from pai_tpu_torch.interop import state_dict_from_jax
from pai_tpu_torch.models import diffusion_unet, registry
from pai_tpu_torch.train import loop
from pai_tpu_torch.train import steps as tsteps
from pai_tpu_torch.utils import images as ti
from pai_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_port_palette_train import _degenerate
from torch_port_util import (adam_initial_state, compare_step,
                             ema_initial_state, gan_batches, jax_gan_state,
                             mults_hparams, palette_hparams,
                             palette_numpy_variables, pix2pix_numpy_variables,
                             port_generator, port_palette_model,
                             slot_from_jax, write_blob_dataset)

SIZE, K = 32, 5
# (steps per epoch, step budget, profiled) of the two runs: Pix2Pix folds
# its first 5 steps, then the budget of 7 leaves no room at step 5;
# Palette, traced for its first 12 steps, folds steps 15-19, leaves step 20
# pending at the end of its epoch (the remainder runs it plain), and the
# budget of 28 leaves no room at 25
RUNS = {"pix2pix": (5, 7, False), "palette": (7, 28, True)}


def _narrow_unet(**kwargs):
    kwargs["inner_channel"] = 16
    return diffusion_unet.DiffusionUNet(**kwargs)


def expected_calls(k, steps_per_epoch, max_steps, profiling_steps=0):
    """The loop's calls as ``pai_tpu/train/loop.py:495-517`` makes them:
    ("scan", first step, K-1) and ("step", step)."""
    calls, step = [], 0
    while True:
        pending = 0
        for _ in range(steps_per_epoch):
            if (k > 1 and step >= profiling_steps and step % k == 0
                    and step + k <= max_steps):
                pending += 1
                if pending < k:
                    continue
                calls += [("scan", step, k - 1), ("step", step + k - 1)]
                step, pending = step + k, 0
            else:
                calls.append(("step", step))
                step += 1
            if step >= max_steps:
                return calls
        for _ in range(pending):
            calls.append(("step", step))
            step += 1
            if step >= max_steps:
                return calls


def _spy(monkeypatch):
    """Record the loop's outermost step and scan calls."""
    calls, depth = [], [0]
    for cls, kind in ((tsteps.TrainStep, "step"), (tsteps.TrainScan, "scan")):
        real = cls.__call__

        def call(self, state, *args, _real=real, _kind=kind, **kwargs):
            if not depth[0]:
                calls.append((_kind, state.step, len(args[0]))
                             if _kind == "scan" else (_kind, state.step))
            depth[0] += 1
            out = _real(self, state, *args, **kwargs)
            depth[0] -= 1
            return out

        monkeypatch.setattr(cls, "__call__", call)
    return calls


def _run(data, out, k, model, max_steps, monkeypatch, **extra):
    palette = model == "palette"
    h = dict(name="run", data=data, val_data=None, model=model,
             channel_mults="1" if palette else "1,2", attention_res="2",
             batch_size=1 if palette else 2, epochs=100, steps=max_steps,
             ema=True,
             device="cpu", image_size=16 if palette else SIZE, scan_steps=k,
             log_dir=str(out / "logs"), ckpt_dir=str(out / "ckpt"), **extra)
    with monkeypatch.context() as patch:
        patch.setattr(registry, "DiffusionUNet", _narrow_unet)
        calls = _spy(patch)
        assert loop.Trainer(h).fit()["steps"] == max_steps
    flat, meta = load_checkpoint(str(out / "ckpt" / "run" / "last"))
    rows = out / "logs" / "run" / "version_0" / "metrics.csv"
    return calls, flat, meta, rows.read_text() if rows.exists() else None


@pytest.mark.parametrize("model", list(RUNS))
def test_scan_steps_fold_the_loop_as_pai_tpu_and_change_nothing(
        tmp_path, monkeypatch, model):
    """--scan-steps 5 against 1: chunks from K-aligned steps only,
    the epoch's remainder and the steps the budget leaves no room for as
    plain steps, none while the profiler traces the first 12 steps (the
    Palette run); every slot tensor bit-equal and the same log rows."""
    steps_per_epoch, max_steps, profiled = RUNS[model]
    palette = model == "palette"
    data = write_blob_dataset(tmp_path, steps_per_epoch * (1 if palette
                                                           else 2),
                              16 if palette else SIZE, seed=41,
                              write_png=ti.write_png)
    extra = {"profile_dir": str(tmp_path / "trace")} if profiled else {}
    one = _run(data, tmp_path / "one", 1, model, max_steps, monkeypatch)
    scanned = _run(data, tmp_path / "five", K, model, max_steps, monkeypatch,
                   **extra)
    assert one[0] == expected_calls(1, steps_per_epoch, max_steps)
    assert scanned[0] == expected_calls(
        K, steps_per_epoch, max_steps, loop.PROFILE_STEPS if profiled else 0)
    # one chunk each: Pix2Pix's at 0; Palette's at 15 (none while traced,
    # 20 left to the epoch's remainder, no room at 25)
    assert [c for c in scanned[0] if c[0] == "scan"] == [
        ("scan", 15 if profiled else 0, K - 1)]
    a, b = one[1], scanned[1]
    assert a.keys() == b.keys()
    assert all(torch.equal(a[key], b[key]) for key in a)
    assert one[2]["step"] == scanned[2]["step"] == max_steps
    assert one[3] == scanned[3]


def test_folded_gan_steps_match_pai_tpu_scan():
    """Five ``mse`` steps as a CUDA graph records them (``TrainScan.fold``:
    the EMA weights from a tensor) against ``make_gan_train_scan``."""
    mults = (1, 2)
    module, params, stats = pix2pix_numpy_variables(mults, SIZE, seed=51)
    gen = port_generator("pix2pix", mults, SIZE,
                         generator=torch.Generator().manual_seed(0))
    hp = mults_hparams(mults)
    gen.load_state_dict(state_dict_from_jax("pix2pix", params, stats, hp))
    tstate = tsteps.init_gan_state(gen, None, "mse", use_ema=True)
    jstate = jax_gan_state(params, stats, None, "mse")
    before = slot_from_jax(jstate, "mse", hp)
    batches = gan_batches(52, K)
    xs, ys = (np.stack([b[i] for b in batches]) for i in (0, 1))
    jscan = jax.jit(jsteps.make_gan_train_scan(module, None, "mse"))
    jstate, jm = jscan(jstate, jnp.asarray(xs), jnp.asarray(ys),
                       jax.random.key(0))

    scan = tsteps.make_gan_train_scan(gen, None, "mse")
    values = scan.host_values(tstate, K)
    assert values[:, 1].tolist() == pytest.approx(
        [1.0 - min(0.9999, (1 + n) / (10 + n)) for n in range(1, K + 1)])
    tm = scan.fold(tstate, list(torch.from_numpy(xs)),
                   list(torch.from_numpy(ys)), values)
    tsteps.advance(tstate, K)
    assert tstate.step == int(jstate.step) == K
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    compare_step(tstate, jstate, "mse", before, hp, steps=K)


def test_folded_palette_steps_match_pai_tpu_scan(monkeypatch):
    """Five Palette steps as a CUDA graph records them (each step's
    learning rate and EMA weight from a tensor, across a change of the
    warmup's unit) against ``make_palette_train_scan``, the same draws fed
    to both."""
    from pai_tpu.diffusion import make_schedule as jax_schedule
    from pai_tpu.train.state import PaletteTrainState, palette_optimizer
    from pai_tpu_torch.diffusion import make_schedule as port_schedule

    mults, attn, size, spe = (1,), (2,), 8, 2
    module, params, stats = palette_numpy_variables(
        mults, attn, size, seed=53, learn_var=True, inner=32, num_heads=1)
    model = port_palette_model(mults, attn, params, stats, True, inner=32,
                               num_heads=1)
    initial = {k: v.detach().clone() for k, v in model.named_parameters()}
    rng = np.random.default_rng(54)
    xs, ys = (rng.uniform(-1, 1, (K, 1, size, size, 1)).astype(np.float32)
              for _ in range(2))
    rands = {"t": np.array([[0], [1234], [77], [1999], [5]], np.int32),
             "noise": rng.normal(size=(K, 1, size, size, 1)).astype(
                 np.float32),
             "u": rng.uniform(size=(K, 1)).astype(np.float32)}

    real = jsteps.make_palette_train_step

    def indexed(*args, **kwargs):
        """The external-draws step, each step taking its own draws."""
        step = real(*args, external_rand=True, **kwargs)
        return lambda s, x, y, r: step(
            s, x, y, jax.tree.map(lambda a: a[s.step], r))

    monkeypatch.setattr(jsteps, "make_palette_train_step", indexed)
    jscan = jax.jit(jsteps.make_palette_train_scan(
        module, jax_schedule("linear", 2000, 1e-6, 0.01), True,
        warmup_steps_per_epoch=spe))
    jstate = PaletteTrainState(
        step=np.zeros((), np.int32), params=params, stats=stats,
        opt=adam_initial_state(palette_optimizer(steps_per_epoch=spe),
                               params),
        ema=ema_initial_state({"unet": params}))
    jstate, jm = jscan(jstate, jnp.asarray(xs), jnp.asarray(ys),
                       {k: jnp.asarray(v) for k, v in rands.items()})

    tstate = tsteps.init_palette_state(model, use_ema=True)
    scan = tsteps.make_palette_train_scan(
        model, port_schedule("linear", 2000, 1e-6, 0.01), True,
        warmup_steps_per_epoch=spe, external_rand=True)
    values = scan.host_values(tstate, K)
    assert len(set(values[:, 0].tolist())) == 3  # steps 0-1, 2-3, 4
    tm = scan.fold(tstate, list(torch.from_numpy(xs)),
                   list(torch.from_numpy(ys)), values,
                   rands=[{k: torch.from_numpy(v[i]) for k, v in
                           rands.items()} for i in range(K)])
    tsteps.advance(tstate, K)
    assert tstate.step == int(jstate.step) == K
    assert tstate.ema.num_updates == int(jstate.ema.num_updates) == K
    for key in ("loss", "mse_loss", "vlb_loss"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                               abs=1e-7), key

    hp = palette_hparams(mults, attn)
    want = state_dict_from_jax("palette", jstate.params, jstate.stats, hp)
    shadows = state_dict_from_jax("palette", jstate.ema.params["unet"], {},
                                  hp)
    lr_sum = K * 1e-4
    for name, p in model.named_parameters():
        mask = _degenerate(name, p)
        for got, ref in ((p.detach(), want[name]),
                         (tstate.ema.params[name], shadows[name])):
            if mask.any():  # the degenerate biases: a bound, not a match
                for side in (got, ref):
                    assert float((side - initial[name])[mask].abs().max()) \
                        <= 3.5 * lr_sum, name
            if (~mask).any():
                assert float((got - ref)[~mask].abs().max()) <= \
                    0.2 * lr_sum, name
        if (~mask).any():  # the comparison is not vacuous
            assert float((want[name] - initial[name])[~mask].abs().max()) > \
                0.5 * lr_sum / K, name
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6)
