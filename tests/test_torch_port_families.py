"""The other generator families of the port against ``pai_tpu`` on the CPU:
the attention U-Net, the residual U-Nets (blocks 18, 50, v2, NeXt) and
TransUNet, and the layers they add (``LayerNorm``, ``max_pool_2x``, grouped
convolution, the exact GELU). Weights and inputs are made with numpy from a
seed and handed to both packages; the JAX side is jitted with the weights as
arguments.

Sizes: channel mults (1, 2) on 32x32 for the convolutional U-Nets; TransUNet
at mults (1, 1) on 32x32 (a 2x2 grid of 4x4 patches of 64 channels: 4
tokens of 1,024) with a 2-layer ViT, as ``tools/pai_train_parity.py``
builds it. The full widths are built on the ``meta`` device, so the
1.03 B-parameter TransUNet allocates nothing.

Tolerances, each with its reason:

* the forward in eval mode, and TransUNet's and the attention U-Net's in
  train mode: 1e-5 (float32 sums in other orders);
* the residual U-Nets in train mode: 3e-5. Their 3x3 stacks at full
  resolution renormalise by batch statistics layer after layer: each
  package's float32 output lies up to 1.4e-5 from the same network in
  float64 (``tools/torch_family_float_noise.py``), and the two lie
  1.0-2.6e-5 apart over four seeds: float noise;
* the running statistics after one train forward: 1e-5 relative;
* the second witnesses (the reference's outputs stored in
  ``tests/fixtures``): the JAX package's own forward-parity tolerances
  (``tests/test_forward_parity.py``);
* name maps, parameter counts, structure: exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pai_tpu.models import build_generator as jax_build_generator
from pai_tpu.ops import layers as jl
from pai_tpu.train.steps import _generator_dropout_active
from pai_tpu_torch.interop import (jax_from_state_dict, jax_params,
                                   state_dict_from_jax)
from pai_tpu_torch.models import build_generator
from pai_tpu_torch.models.trans_unet import TransUnet
from pai_tpu_torch.ops import layers as tl
from pai_tpu_torch.train.steps import generator_dropout_active
from test_param_parity import GOLDEN, GOLDEN_TRANS_UNET
from torch_port_util import (generator_numpy_variables, jax_generator,
                             mults_hparams, port_generator,
                             reference_state_dict, rel)

FAMILIES = ("attention_unet", "res18_unet", "res50_unet", "resv2_unet",
            "resnext_unet", "trans_unet")
SMALL = {name: (1, 2) for name in FAMILIES}
SMALL["trans_unet"] = (1, 1)
SIZE = 32
FULL_MULTS = {name: (1, 2, 4, 8, 8, 8, 8, 8) for name in FAMILIES}
FULL_MULTS["trans_unet"] = (1, 2, 2, 4, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def variables():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = generator_numpy_variables(
                name, SMALL[name], SIZE, seed=FAMILIES.index(name) + 40)
        return cache[name]

    return get


def _port(name, params, stats):
    model = port_generator(name, SMALL[name], SIZE,
                           generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(
        name, params, stats, mults_hparams(SMALL[name])), strict=True)
    return model


# ------------------------------------------------------------- the families
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name, variables):
    """Eval mode, then train mode (batch statistics) and the running
    statistics it leaves."""
    module, params, stats = variables(name)
    x = np.random.default_rng(1).uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(
        np.float32)
    v = {"params": params, "batch_stats": stats}
    want = jax.jit(lambda v, a: module.apply(v, a, train=False))(v, x)
    want_train, updated = jax.jit(lambda v, a: module.apply(
        v, a, train=True, mutable=["batch_stats"]))(v, x)
    model = _port(name, params, stats)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        got_train = model.train()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, SIZE, SIZE, 1)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5
    train_tol = 3e-5 if name.startswith("res") else 1e-5
    assert float(np.abs(got_train.numpy() - want_train).max()) <= train_tol
    moved = state_dict_from_jax(name, params, updated["batch_stats"],
                                mults_hparams(SMALL[name]))
    before = state_dict_from_jax(name, params, stats,
                                 mults_hparams(SMALL[name]))
    for key, buf in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            assert rel(buf, moved[key]) <= 1e-5, key
            assert not torch.equal(buf, before[key]), key


@pytest.mark.parametrize("name", FAMILIES)
def test_name_map_round_trip(name, variables):
    """``jax_from_state_dict`` after ``state_dict_from_jax`` gives back every
    leaf, and the port's ``state_dict`` holds exactly the mapped names."""
    _, params, stats = variables(name)
    hp = mults_hparams(SMALL[name])
    sd = state_dict_from_jax(name, params, stats, hp)
    model = port_generator(name, SMALL[name], SIZE, device="meta")
    assert sd.keys() == model.state_dict().keys()
    back = jax_from_state_dict(name, sd, hp)
    for tree, got in zip((params, stats), back):
        want = jax.tree_util.tree_leaves_with_path(tree)
        mine = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(want) == len(mine)
        for path, leaf in want:
            np.testing.assert_array_equal(mine[path], leaf)
    with pytest.raises(KeyError, match="not a"):
        jax_from_state_dict(name, {"nowhere.weight": torch.zeros(1)}, hp)


@pytest.mark.parametrize("name", FAMILIES)
def test_full_width_structure_and_parameter_count(name):
    """At the published widths (the CLI-default mults; TransUNet at
    1,2,2,4,4 with its 12-layer ViT), built on ``meta``: every tensor's name
    and shape is what the name map gives the JAX package's tree, and the
    parameter count is the reference's (``tests/test_param_parity.py``)."""
    mults = FULL_MULTS[name]
    module = jax_build_generator(name, channel_mults=mults)
    abstract = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros((1, 256, 256, 1)), train=False))
    name_of, _ = jax_params._mappers(name, mults_hparams(mults))
    want = {}
    for tree in (abstract["params"], abstract["batch_stats"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            torch_name, kind = name_of(tuple(p.key for p in path))
            zeros = np.broadcast_to(np.zeros((), np.float32), leaf.shape)
            want[torch_name] = jax_params._to_torch(zeros, kind).shape
    model = build_generator(name, channel_mults=mults, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
    golden = GOLDEN_TRANS_UNET if name == "trans_unet" else GOLDEN[name]
    assert sum(p.numel() for p in model.parameters()) == golden


def test_trans_unet_refuses_the_cli_default_as_jax_does():
    from pai_tpu.models.trans_unet import TransUnet as JaxTransUnet

    with pytest.raises(ValueError) as theirs:
        JaxTransUnet(image_size=256,
                     channel_mults=(1, 2, 4, 8, 8, 8, 8, 8)).validate()
    with pytest.raises(ValueError) as mine:
        build_generator("trans_unet", device="meta")
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="bottleneck size 2"):
        build_generator("trans_unet", channel_mults=(1, 2, 2, 4),
                        image_size=32, device="meta")


@pytest.mark.parametrize("fixture,name,mults,prefix,atol", [
    ("attention_tiny.npz", "attention_unet", (1, 2), "att.", 1e-5),
    ("res18_tiny.npz", "res18_unet", (1, 2), "res.", 1e-5),
    ("trans_tiny.npz", "trans_unet", (1, 1), "tr.", 2e-5)])
def test_reference_outputs_of_the_fixtures(fixture, name, mults, prefix,
                                           atol, monkeypatch):
    """The reference's own eval forward, stored with its weights' seeded
    stream (``tools/make_parity_fixture.py``): the port loads the
    reference's tensor names as they are. ``trans_tiny`` has the full
    12-layer ViT (at 1,024 wide) over one image."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    from make_parity_fixture import deterministic_weights

    z = np.load(os.path.join(REPO, "tests", "fixtures", fixture))
    weights = deterministic_weights(json.loads(str(z["manifest"])))
    sd = reference_state_dict(weights, prefix)
    if name == "trans_unet":
        model = TransUnet(image_size=SIZE, channel_mults=mults,
                          device="meta")
    else:
        model = build_generator(name, channel_mults=mults, device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    x = torch.from_numpy(z["in0"]).permute(0, 2, 3, 1)
    with torch.no_grad():
        out = model.eval()(x)
    np.testing.assert_allclose(out.permute(0, 3, 1, 2).numpy(), z["out"],
                               rtol=1e-4, atol=atol)


@pytest.mark.parametrize("name", FAMILIES)
def test_dropout_activity_matches_jax(name):
    """Which configurations run the GAN step's literal double forward:
    TransUNet at any nonzero rate (its ViT always drops), the convolutional
    U-Nets only where a deepest widest decoder drops."""
    cases = [(SMALL[name], 0.0), (SMALL[name], 0.5), ((1, 2, 4, 8), 0.5),
             ((1, 2, 2), 0.5), ((1, 2, 4, 8, 8), 0.3)]
    for mults, rate in cases:
        port = port_generator(name, mults, 256, rate, device="meta")
        jax_model = jax_generator(name, mults, 256, rate)
        assert generator_dropout_active(port) == \
            _generator_dropout_active(jax_model), (mults, rate)


# --------------------------------------------------------------- the layers
def test_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0.5, 2.0, (3, 5, 24)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = rng.normal(0, 0.1, 24).astype(np.float32)
    want = jax.jit(lambda v, a: jl.LayerNorm().apply(v, a))(
        {"params": {"LayerNorm_0": {"scale": scale, "bias": bias}}}, x)
    norm = tl.LayerNorm(24)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert rel(got, want) <= 1e-5
    assert tuple(dict(norm.named_parameters())) == ("weight", "bias")


def test_max_pool_2x_and_its_gradient_at_ties_match_jax():
    """The value, and where the gradient of a window goes: to the first
    largest value in row-major order, as XLA's ``reduce_window`` max (select
    ``>=``, scatter) sends it; the windows of a ReLU's zeros and windows
    with a repeated largest value are ties."""
    rng = np.random.default_rng(3)
    x = np.maximum(rng.normal(0, 1, (2, 8, 8, 3)), 0).astype(np.float32)
    x[0, 2:4, 2:4, 0] = 0.7  # four equal values
    x[1, 4, 4:6, 1] = 0.9    # two equal values in a row
    x[1, 0:2, 0:2, 2] = 0.0
    assert np.sum(x == 0) > 32
    g = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    want = jax.jit(jl.max_pool_2x)(x)
    want_grad = jax.jit(jax.grad(lambda a: jnp.sum(jl.max_pool_2x(a) * g)))(x)
    xt = _nchw(x).requires_grad_(True)
    out = tl.max_pool_2x(xt)
    (out * _nchw(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(),
                                  want)
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(),
                                  want_grad)


def test_grouped_convolution_matches_jax_and_its_init():
    """Cardinality 4 over 16 channels; the "torch" init's bias bound takes
    the fan-in of one group, as the JAX package's does."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 6, 6, 16)).astype(np.float32)
    kernel = rng.normal(0, 0.2, (3, 3, 4, 8)).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    want = jax.jit(lambda v, a: jl.Conv(8, 3, padding=1, groups=4).apply(
        v, a))({"params": {"kernel": kernel, "bias": bias}}, x)
    conv = tl.Conv(16, 8, 3, padding=1, groups=4)
    assert tuple(conv.weight.shape) == (8, 4, 3, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            jax_params._to_torch(kernel, "conv").copy()))
        conv.bias.copy_(torch.from_numpy(bias))
        got = conv(_nchw(x)).permute(0, 2, 3, 1)
    assert rel(got, want) <= 1e-5
    init = tl.Conv(64, 256, 3, groups=32, init_mode="torch",
                   generator=torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(2 * 3 * 3)  # 64 / 32 channels per group
    biases, weights = init.bias.detach().abs(), init.weight.detach().abs()
    assert 0.9 * bound < float(biases.max()) <= bound
    assert float(weights.max()) <= bound


@pytest.mark.parametrize("fn", ["gelu", "sigmoid"])
def test_gelu_and_sigmoid_match_jax(fn):
    x = np.random.default_rng(5).normal(0, 3, (4, 64)).astype(np.float32)
    jfn = {"gelu": lambda a: jax.nn.gelu(a, approximate=False),
           "sigmoid": jax.nn.sigmoid}[fn]
    want = jax.jit(jfn)(x)
    got = getattr(tl, fn)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
