"""The port's multi-device layer (``pai_tpu_torch.parallel``) against
``pai_tpu`` on meshes of the same shapes, on the CPU.

The JAX references run in this process on the 8 virtual CPU devices that
``tests/conftest.py`` gives it, as the JAX package's own tests run them
(``tests/test_parallel.py``). The port's side is one 4-rank gloo world
(``tests/torch_port_parallel_worker.py``), started once for the module in a
fixture with a time limit, while the JAX references compute (the tests that
compile the most come first): each rank runs every case on its own mesh over
the same world and writes what it computed.

* ring attention, (1, 2, 512, 32) over sp=4: the einsum hop and the flash
  hop (the threshold lowered on both sides so that 128-token shards take
  it; the JAX kernels in interpret mode, the port's plain flash versions),
  forward and gradients within 2e-5, on every rank;
* ``multihead_attention`` under ``sequence_parallel`` on a dp=2 x sp=2 mesh;
* one GAN step of a (1, 2) Pix2Pix at 32x32, batch 8: with the PatchGAN on
  dp=4, ``mse`` on dp=2 x tp=2 and on fsdp over dp=4, each from the same
  weights against the JAX step on the same mesh and against the port's
  one-process step; losses within 1e-3, Adam's state as ``_hold_adam``
  holds it (its moments show a wrong gradient, which the parameters after
  Adam's first step cannot);
* one Palette step of a one-level UNet at 8x8 (attention over 64 tokens in
  the middle block), batch 4, on dp=2 x sp=2 with injected draws, against
  the JAX step on that mesh, Adam's state held the same way;
* ``--fsdp`` through the Trainer on 4 ranks (two steps) against the same
  run on one process, its slot resumed on one process, and the Trainer's
  mesh errors on a world of one.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pai_tpu_torch.interop import state_dict_from_jax
from pai_tpu_torch.train.state import GAN_LR
from torch_port_util import (adam_initial_state, deepest_leaky_inputs,
                             discriminator_numpy_params, gan_batches,
                             jax_gan_state, mults_hparams,
                             palette_hparams, palette_numpy_variables,
                             pix2pix_numpy_variables, port_gan_models, rel,
                             slot_from_jax, write_blob_dataset)

WORLD = 4
MULTS = (1, 2)
PALETTE_MULTS = (1,)  # one level: attention in the middle block, 64 tokens
HERE = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT = 120.0


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _World:
    """The 4 rank processes, started at once; ``rank(r)`` waits for them
    (within ``WORLD_TIMEOUT`` of the start) and reads rank r's results."""

    def __init__(self, directory):
        self.dir = directory
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.logs = [open(os.path.join(directory, f"rank{r}.log"), "w")
                     for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_port_parallel_worker.py"),
             str(r), str(WORLD), str(port), directory],
            stdout=self.logs[r], stderr=subprocess.STDOUT, env=env)
            for r in range(WORLD)]
        self.start = time.monotonic()
        self._results = None

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()

    def results(self):
        if self._results is None:
            for p in self.procs:
                left = WORLD_TIMEOUT - (time.monotonic() - self.start)
                try:
                    p.wait(timeout=max(left, 0.1))
                except subprocess.TimeoutExpired:
                    self.close()
                    pytest.fail("the gloo world did not finish in "
                                f"{WORLD_TIMEOUT} s:\n" + self._log(0))
            codes = [p.returncode for p in self.procs]
            assert codes == [0] * WORLD, (codes, self._log(codes.index(
                next(c for c in codes if c))))
            self._results = [torch.load(os.path.join(self.dir, f"rank{r}.pt"),
                                        weights_only=False)
                             for r in range(WORLD)]
        return self._results

    def _log(self, r):
        with open(os.path.join(self.dir, f"rank{r}.log")) as f:
            return f.read()[-4000:]


def _attention_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Everything both sides start from, made with numpy."""
    from pai_tpu_torch.utils import images as ti

    gen_module, params, stats = pix2pix_numpy_variables(MULTS, 32, seed=11)
    dparams = discriminator_numpy_params(seed=12)
    (x, y), = gan_batches(16, 1, size=32, batch=8)
    pal_module, pparams, pstats = palette_numpy_variables(
        PALETTE_MULTS, (2,), 8, seed=14, inner=32, num_heads=4)
    rng = np.random.default_rng(15)
    px, py = (rng.uniform(-1, 1, (4, 8, 8, 1)).astype(np.float32)
              for _ in range(2))
    rand = {"t": np.array([0, 1234, 77, 1999], np.int32),
            "noise": rng.normal(size=(4, 8, 8, 1)).astype(np.float32),
            "u": rng.uniform(size=(4,)).astype(np.float32)}
    root = tmp_path_factory.mktemp("parallel_world")
    data = write_blob_dataset(root, 8, 32, seed=16, write_png=ti.write_png)
    trainer_hparams = dict(
        name="fsdprun", data=data, val_data=data, model="pix2pix",
        channel_mults="1,2", loss_type="mse", batch_size=4, epochs=1,
        val_epochs=1, ema=True, device="cpu", image_size=32, seed=0)
    hp = mults_hparams(MULTS)
    port = {
        "attn": [torch.from_numpy(a) for a in
                 _attention_inputs(0, (1, 2, 512, 32))],
        "attn_dispatch": [torch.from_numpy(a) for a in
                          _attention_inputs(5, (2, 2, 256, 16))],
        "gen": state_dict_from_jax("pix2pix", params, stats, hp),
        "disc": state_dict_from_jax("discriminator", dparams, {}, {}),
        "gan_batch": (torch.from_numpy(x), torch.from_numpy(y)),
        "unet": state_dict_from_jax("palette", pparams, pstats,
                                    palette_hparams(PALETTE_MULTS, (2,))),
        "palette_batch": (torch.from_numpy(px), torch.from_numpy(py),
                          {k: torch.from_numpy(v) for k, v in rand.items()}),
        "trainer_hparams": trainer_hparams,
    }
    torch.save(port, os.path.join(root, "inputs.pt"))
    return dict(root=str(root), port=port, gen_module=gen_module,
                params=params, stats=stats, dparams=dparams, x=x, y=y,
                pal_module=pal_module, pparams=pparams, pstats=pstats,
                px=px, py=py, rand=rand, hp=hp)


@pytest.fixture(scope="module")
def world(inputs):
    w = _World(inputs["root"])
    yield w
    w.close()


# -------------------------------------------------- the JAX references
def _jax_palette_step(inputs, eight_devices):
    from pai_tpu.diffusion import make_schedule
    from pai_tpu.ops import attention as A
    from pai_tpu.parallel.mesh import make_mesh
    from pai_tpu.train import steps as jsteps
    from pai_tpu.train.state import PaletteTrainState, palette_optimizer

    mesh = make_mesh(eight_devices[:WORLD], tp=1, sp=2)
    params, stats = inputs["pparams"], inputs["pstats"]
    jstate = PaletteTrainState(
        step=np.zeros((), np.int32), params=params, stats=stats,
        opt=adam_initial_state(palette_optimizer(), params), ema=None)
    step = jax.jit(jsteps.make_palette_train_step(
        inputs["pal_module"], make_schedule("linear", 2000, 1e-6, 0.01),
        False, external_rand=True))
    batch = NamedSharding(mesh, P("dp"))
    with A.sequence_parallel(mesh):
        jstate, jm = step(
            jax.device_put(jstate, NamedSharding(mesh, P())),
            jax.device_put(inputs["px"], batch),
            jax.device_put(inputs["py"], batch),
            {k: jax.device_put(v, batch) for k, v in inputs["rand"].items()})
    jstate = jax.device_get(jstate)
    hp = palette_hparams(PALETTE_MULTS, (2,))
    flat = dict(state_dict_from_jax("palette", jstate.params, jstate.stats,
                                    hp))
    adam = jstate.opt[0]
    for moment, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for k, v in state_dict_from_jax("palette", tree, {}, hp).items():
            flat[f"opt.{k}.{moment}"] = v
    return flat, {k: float(v) for k, v in jm.items()}


def _jax_gan_step(inputs, loss_type, mesh, place):
    from pai_tpu.models import Discriminator
    from pai_tpu.train import steps as jsteps

    gan = loss_type == "gan"
    step = jax.jit(jsteps.make_gan_train_step(
        inputs["gen_module"], Discriminator() if gan else None, loss_type))
    state = jax_gan_state(inputs["params"], inputs["stats"],
                          inputs["dparams"], loss_type)
    batch = NamedSharding(mesh, P("dp"))
    state, metrics = step(place(state), jax.device_put(inputs["x"], batch),
                          jax.device_put(inputs["y"], batch),
                          jax.random.key(0))
    return jax.device_get(state), {k: float(v) for k, v in metrics.items()}


def _port_one_process(inputs, loss_type):
    from pai_tpu_torch.train import steps as tsteps
    from pai_tpu_torch.train.loop import train_state_dict

    gen, disc = port_gan_models(inputs["params"], inputs["stats"],
                                inputs["dparams"], MULTS)
    disc = disc if loss_type == "gan" else None
    margins = []
    if disc is not None:
        deepest_leaky_inputs(disc, margins)
    state = tsteps.init_gan_state(gen, disc, loss_type, use_ema=True)
    x, y = inputs["port"]["gan_batch"]
    state, metrics = tsteps.make_gan_train_step(gen, disc, loss_type)(
        state, x, y)
    # an input of the PatchGAN's last LeakyReLU within float noise of 0
    # takes either slope on either side: the batch has none (as in
    # tests/test_torch_port_gan_train.py)
    assert all(m >= 1e-6 for m in margins), margins
    return train_state_dict(state), {k: float(v) for k, v in metrics.items()}


def _gan_references(inputs, mix, eight_devices):
    from pai_tpu.parallel.mesh import make_mesh
    from pai_tpu.parallel.partitioning import shard_state

    loss_type = "gan" if mix == "dp" else "mse"
    mesh = make_mesh(eight_devices[:WORLD], tp=2 if mix == "tp" else 1)
    place = {"dp": lambda s: jax.device_put(s, NamedSharding(mesh, P())),
             "tp": lambda s: shard_state(s, mesh, tp=2),
             "fsdp": lambda s: shard_state(s, mesh, fsdp=True)}[mix]
    jstate, jmetrics = _jax_gan_step(inputs, loss_type, mesh, place)
    before = slot_from_jax(jax_gan_state(inputs["params"], inputs["stats"],
                                         inputs["dparams"], loss_type),
                           loss_type, inputs["hp"])
    one, one_metrics = _port_one_process(inputs, loss_type)
    return {"want": slot_from_jax(jstate, loss_type, inputs["hp"]),
            "jmetrics": jmetrics,
            "before": {k: v for k, v in before.items()
                       if not k.startswith("opt.")},
            "one": one, "one_metrics": one_metrics}


def _jax_ring(mesh, q, k, v):
    from pai_tpu.parallel.ring_attention import sequence_sharded_attention

    def loss(q, k, v):
        out = sequence_sharded_attention(mesh, q, k, v)
        return jnp.sum(jnp.sin(out)), out

    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return [np.asarray(a) for a in (out, *grads)]


def _ring_references(eight_devices):
    from pai_tpu import kernels
    from pai_tpu.parallel import ring_attention as R

    q, k, v = (jnp.asarray(a) for a in _attention_inputs(0, (1, 2, 512, 32)))
    mesh = Mesh(np.asarray(eight_devices[:WORLD]), ("sp",))
    refs = {"einsum": _jax_ring(mesh, q, k, v)}
    prev = R._FLASH_RING_THRESHOLD
    kernels.set_interpret(True)
    R._FLASH_RING_THRESHOLD = 128  # t_local = 512 / 4
    try:
        refs["flash_has_pallas"] = "pallas_call" in str(jax.make_jaxpr(
            lambda *a: R.sequence_sharded_attention(mesh, *a))(q, k, v))
        refs["flash"] = _jax_ring(mesh, q, k, v)
    finally:
        R._FLASH_RING_THRESHOLD = prev
        kernels.set_interpret(False)
    return refs


@pytest.fixture(scope="module")
def references(world, inputs, eight_devices):
    """Every JAX reference of the module, computed while the world runs
    (the world is started first)."""
    return {"palette": _jax_palette_step(inputs, eight_devices),
            "gan": {mix: _gan_references(inputs, mix, eight_devices)
                    for mix in ("dp", "tp", "fsdp")},
            "ring": _ring_references(eight_devices)}


# ------------------------------------------------- Adam state after steps
def _moment_kind(key):
    """(chain, moment) of an ``opt.<name>.<moment>`` key."""
    return (key.startswith("opt.discriminator."), key.rsplit(".", 1)[1])


def _hold_adam(got, want, lr, steps=1):
    """``got``'s Adam state and parameters against ``want``'s after the
    same ``steps`` at rates up to ``lr``. Adam's first step moves every
    element by one rate whatever its gradient, so the parameters alone
    cannot show a wrong gradient: the moments are held within 1e-3 of the
    largest of their chain and kind. The parameters are held within 1e-2 of
    a rate per step where the first moment is at least 1e-3 of its tensor's
    largest, and within two rates per step elsewhere: there, and in a
    tensor whose first moment is below 1e-3 of its chain's largest (the
    biases a BatchNorm takes away), the gradient is float noise and Adam's
    step follows its sign."""
    top = {}
    for key, value in want.items():
        if key.startswith("opt.") and not key.endswith(".step"):
            kind = _moment_kind(key)
            top[kind] = max(top.get(kind, 0.0), float(value.abs().max()))
    assert top, "no Adam moments to compare"
    for key, value in want.items():
        if key.endswith(".step"):
            assert float(got[key]) == float(value), key
        elif key.startswith("opt."):
            assert float((got[key] - value).abs().max()) <= \
                1e-3 * top[_moment_kind(key)], key
        elif f"opt.{key}.exp_avg" in want:
            mu = want[f"opt.{key}.exp_avg"].abs()
            diff = (got[key] - value).abs()
            large = mu >= 1e-3 * mu.max()
            if float(mu.max()) < 1e-3 * top[_moment_kind(
                    f"opt.{key}.exp_avg")]:
                large[...] = False
            assert float(diff.max()) <= 2 * lr * steps, key
            if large.any():
                assert float(diff[large].max()) <= 1e-2 * lr * steps, key


# ------------------------------------------------------------ Palette step
def test_palette_step_over_dp2_sp2_matches_jax(world, inputs, references):
    want, jm = references["palette"]
    before = inputs["port"]["unet"]
    lr = 1e-4 / 3  # the first warmup step's rate
    for r, res in enumerate(world.results()):
        got = res["palette"]
        for key in ("loss", "mse_loss", "vlb_loss"):
            assert got["metrics"][key] == pytest.approx(jm[key], rel=1e-3), \
                key
        assert want.keys() <= got["state"].keys()
        assert all(k.endswith((".step", "num_batches_tracked"))
                   for k in got["state"].keys() - want.keys())
        _hold_adam({k: v for k, v in got["state"].items()
                    if not k.endswith(".step")}, want, lr)
        for key, value in want.items():
            if key.endswith("running_var"):
                assert rel(got["state"][key], value) <= 1e-4, key
            elif key.endswith("running_mean"):  # follows degenerate biases
                diff = float((got["state"][key] - value).abs().max())
                assert diff <= 2 * lr + 1e-4 * float(value.abs().max()), key
        moved = max(float((want[k] - before[k]).abs().max()) for k in before
                    if k.endswith("weight"))
        assert moved > 0.5 * lr


# --------------------------------------------------------------- GAN steps
def _check_step(got, want, before, metrics, want_metrics):
    """Adam's state and parameters as ``_hold_adam`` holds them, the EMA
    within two learning rates, running statistics close, every parameter
    moved from ``before``; losses within 1e-3."""
    assert got.keys() == want.keys()
    _hold_adam({k: v for k, v in got.items() if not k.startswith("ema.")},
               {k: v for k, v in want.items() if not k.startswith("ema.")},
               GAN_LR)
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):  # JAX keeps no such count
            continue
        if key.startswith("ema."):
            assert float((got[key] - value).abs().max()) <= 2 * GAN_LR, key
        elif key.endswith(("running_mean", "running_var")):
            assert rel(got[key], value) <= 1e-4, key
    moved = max(float((want[k] - before[k]).abs().max()) for k in before
                if not k.endswith("num_batches_tracked"))
    assert moved > 0.5 * GAN_LR  # the comparison is not vacuous
    assert metrics.keys() == want_metrics.keys()
    for key, value in want_metrics.items():
        assert metrics[key] == pytest.approx(value, rel=1e-3), key


@pytest.mark.parametrize("mix", ["dp", "tp", "fsdp"])
def test_gan_step_on_a_mesh_matches_jax_and_one_process(mix, world,
                                                        references):
    ref = references["gan"][mix]
    want, before, one = ref["want"], ref["before"], ref["one"]
    _check_step(one, want, before, ref["one_metrics"], ref["jmetrics"])
    results = world.results()
    for r, res in enumerate(results):
        got = res["gan"][mix]
        _check_step(got["state"], want, before, got["metrics"],
                    ref["jmetrics"])
        _check_step(got["state"], one, before, got["metrics"],
                    ref["one_metrics"])
        for key, value in results[0]["gan"][mix]["state"].items():
            assert torch.equal(got["state"][key], value), (r, key)
            if key.endswith("num_batches_tracked"):
                assert torch.equal(value, one[key]), key


# -------------------------------------------------------------------- ring
@pytest.mark.parametrize("hop", ["einsum", "flash"])
def test_ring_attention_over_sp4_matches_jax(hop, world, references):
    want = references["ring"][hop]
    if hop == "flash":
        assert references["ring"]["flash_has_pallas"]
    for r, res in enumerate(world.results()):
        got = res["ring"][hop]
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(got[name].numpy(), w, rtol=2e-5,
                                       atol=2e-5, err_msg=f"{hop} {name} {r}")


def test_multihead_attention_dispatches_to_the_ring(world, eight_devices):
    from pai_tpu.ops import attention as A
    from pai_tpu.parallel.mesh import make_mesh
    from pai_tpu_torch.ops.attention import _full_attention

    q, k, v = _attention_inputs(5, (2, 2, 256, 16))
    mesh = make_mesh(eight_devices[:WORLD], tp=1, sp=2)  # dp=2 x sp=2
    with A.sequence_parallel(mesh):
        want = np.asarray(jax.jit(A.multihead_attention)(q, k, v))
    one = _full_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    for r, res in enumerate(world.results()):
        got = res["ring"]["dispatch"].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, one.numpy(), rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------------- Trainer
def test_fsdp_trainer_slot_resumes_on_one_process(world, inputs, tmp_path):
    from pai_tpu_torch.train import loop
    from pai_tpu_torch.train.loop import Trainer, train_state_dict
    from pai_tpu_torch.utils.checkpoint import load_checkpoint

    results = world.results()
    summaries = [{k: v for k, v in res["trainer"]["summary"].items()
                  if k != "images_per_sec"} for res in results]
    assert all(s == summaries[0] for s in summaries)
    assert summaries[0]["steps"] == 2  # 8 images, global batch 4
    assert np.isfinite(summaries[0]["val_ssim"])
    slot = os.path.join(inputs["root"], "ckpt", "fsdprun", "last")
    flat, meta = load_checkpoint(slot)
    assert meta["hparams"]["fsdp"] is True and meta["step"] == 2

    # the same run on one process: the same losses within 1e-3
    h = dict(inputs["port"]["trainer_hparams"],
             log_dir=str(tmp_path / "logs"), ckpt_dir=str(tmp_path / "ck"))
    one = Trainer(dict(h, name="one")).fit()
    for key in ("val_ssim", "val_psnr", "val_rmse"):
        assert summaries[0][key] == pytest.approx(one[key], rel=1e-3), key
    one_flat, _ = load_checkpoint(str(tmp_path / "ck" / "one" / "last"))
    assert flat.keys() == one_flat.keys()
    _hold_adam({k: v for k, v in flat.items() if not k.startswith("ema.")},
               {k: v for k, v in one_flat.items()
                if not k.startswith("ema.")}, GAN_LR, steps=2)
    for key, value in one_flat.items():
        if "running" in key:
            tol = 4 * GAN_LR + 1e-3 * float(value.abs().max())
            assert float((flat[key] - value).abs().max()) <= tol, key

    # the fsdp slot resumes on one process: loaded bit for bit, one more
    # epoch trained from it
    resumed = Trainer(dict(h, name="fsdprun", epochs=2, resume=True,
                           ckpt_dir=os.path.join(inputs["root"], "ckpt")))
    state, _, _ = resumed._steps(8)
    loop.load_train_state(state, flat, meta)
    for key, value in train_state_dict(state).items():
        assert torch.equal(value, flat[key]), key
    assert resumed.fit()["steps"] == 4


def test_mesh_errors_and_local_batch_rows():
    from pai_tpu.parallel.distributed import local_batch_rows as jrows
    from pai_tpu_torch.parallel.distributed import local_batch_rows
    from pai_tpu_torch.parallel.mesh import mesh_shape
    from pai_tpu_torch.train.loop import Trainer

    for args in ((8, 0, 4), (8, 3, 4), (6, 1, 2), (4, 0, 1)):
        assert local_batch_rows(*args) == jrows(*args)
    with pytest.raises(ValueError, match="not divisible by process_count"):
        local_batch_rows(6, 0, 4)
    assert mesh_shape(8, tp=2) == (4, 2)
    assert mesh_shape(8, tp=2, sp=2) == (2, 2, 2)
    with pytest.raises(ValueError, match="not divisible by tp"):
        mesh_shape(6, tp=4)
    for mix in ({"tp": 2}, {"sp": 3}, {"tp": 2, "sp": 2, "fsdp": True}):
        with pytest.raises(ValueError, match="does not divide 1 devices"):
            Trainer(dict(name="x", data="x.yaml", device="cpu", **mix))


@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 4), (1, 8), (4, 2)])
def test_partition_rules_match_jax(tp, dp):
    """``tp_spec_for_leaf`` and ``fsdp_spec_for_leaf`` on torch layouts give
    the JAX package's specs on the same leaves (a convolution's OIHW, a
    transposed one's IOHW and a dense (out, in) against HWIO and (in, out))."""
    from pai_tpu.parallel import partitioning as jp
    from pai_tpu_torch.parallel import partitioning as tpp

    def jax_spec(spec, ndim):
        spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
        return tuple(spec)

    shapes = [(3, 3, 64, 128), (4, 4, 128, 64), (1, 1, 8, 16), (3, 3, 64, 64),
              (4, 4, 256, 1), (768, 3072), (64,), (2, 2, 12, 24)]
    for hwio in shapes:
        leaf = np.zeros(hwio, np.float32)
        for out_dim in ((0, 1) if len(hwio) == 4 else (0,)):
            if len(hwio) == 4:  # torch: (O, I, H, W) or (I, O, H, W)
                h, w, i, o = hwio
                shape = (o, i, h, w) if out_dim == 0 else (i, o, h, w)
                back = (2, 3, 1, 0) if out_dim == 0 else (2, 3, 0, 1)
            elif len(hwio) == 2:
                shape, back = hwio[::-1], (1, 0)
            else:
                shape, back = hwio, (0,)
            t = torch.zeros(shape)
            for ours, theirs in (
                    (tpp.tp_spec_for_leaf(t, tp, out_dim),
                     jp.tp_spec_for_leaf(leaf, tp)),
                    (tpp.fsdp_spec_for_leaf(t, dp, tp, out_dim),
                     jp.fsdp_spec_for_leaf(leaf, dp, tp))):
                want = jax_spec(theirs, len(hwio))
                assert tuple(ours[a] for a in back) == want, \
                    (hwio, out_dim, ours, want)
