"""pai_tpu_torch.models.diffusion_unet (and the layers it brought) vs
pai_tpu: numpy-made weights and running statistics carried across with
``pai_tpu_torch.interop.jax_params``, eval-mode forward on the CPU; the golden
``tests/fixtures/diffusion_tiny.npz`` (outputs of the original PyTorch code)
as a second oracle.

Forward tolerance rtol 1e-4 / atol 1e-5 on the layers and blocks, and on the
whole UNet relative to the output's largest magnitude: float32 convolutions
and attention summed in another order through some thirty layers."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu.models import diffusion_unet as jdu
from pai_tpu.ops import layers as jl
from pai_tpu_torch.interop import jax_from_state_dict, state_dict_from_jax
from pai_tpu_torch.interop import jax_params
from pai_tpu_torch.models import build_generator
from pai_tpu_torch.models import diffusion_unet as tdu
from pai_tpu_torch.ops import layers as tl
from pai_tpu_torch.utils.flops import parameter_count
from torch_port_util import (numpy_tree_like, palette_hparams,
                             palette_numpy_variables, port_palette_model)

RTOL, ATOL = 1e-4, 1e-5
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "diffusion_tiny.npz")


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, scale=None):
    want = np.asarray(want)
    atol = ATOL if scale is None else RTOL * scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


# ---------------------------------------------------------------- layers
def test_silu_pools_and_upsample_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
    _close(tl.silu(torch.from_numpy(x)).numpy(), jl.silu(jnp.asarray(x)))
    _close(_nhwc(tl.avg_pool_2x(_nchw(x))), jl.avg_pool_2x(jnp.asarray(x)))
    got = _nhwc(tl.upsample_nearest_2x(_nchw(x)))
    np.testing.assert_array_equal(
        got, np.asarray(jl.upsample_nearest_2x(jnp.asarray(x))))


@pytest.mark.parametrize("dim", [32, 7])
def test_gamma_embedding_matches_jax(dim):
    gammas = np.array([0.999, 0.5, 1e-3], np.float32)
    got = tl.gamma_embedding(torch.from_numpy(gammas), dim)
    assert got.shape == (3, dim)
    _close(got.numpy(), jl.gamma_embedding(jnp.asarray(gammas), dim))
    if dim % 2:
        assert float(got[:, -1].abs().max()) == 0.0


def test_dense_matches_jax_and_torch_init_bounds():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    kernel = rng.normal(0, 0.3, (12, 7)).astype(np.float32)
    bias = rng.normal(0, 0.1, (7,)).astype(np.float32)
    want = jl.Dense(7, init_mode="torch").apply(
        {"params": {"Dense_0": {"kernel": kernel, "bias": bias}}},
        jnp.asarray(x))
    dense = tl.Dense(12, 7, init_mode="torch",
                     generator=torch.Generator().manual_seed(0))
    # torch's default: weight and bias both U(+-1/sqrt(fan_in))
    bound = 12 ** -0.5
    assert float(dense.weight.detach().abs().max()) <= bound
    assert float(dense.bias.detach().abs().max()) <= bound
    assert float(dense.weight.detach().abs().max()) > 0.8 * bound
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(
            jax_params._to_torch(kernel, "linear").copy()))
        dense.bias.copy_(torch.from_numpy(bias))
    _close(dense(torch.from_numpy(x)).detach().numpy(), want)

    conv = tl.Conv(4, 6, 3, padding=1, init_mode="torch",
                   generator=torch.Generator().manual_seed(0))
    bound = (4 * 9) ** -0.5
    assert 0.8 * bound < float(conv.weight.detach().abs().max()) <= bound
    assert 0.0 < float(conv.bias.detach().abs().max()) <= bound
    same = tl.Conv(4, 6, 3, padding=1, init_mode="torch",
                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(conv.weight, same.weight)
    with pytest.raises(ValueError, match="init_mode"):
        tl.Conv(4, 6, init_mode="xavier")


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_on_tokens_matches_jax(train):
    """(N, L, C) tokens, the reference's BatchNorm1d, with AttentionBlock's
    momentum: 0.81 in flax terms is 0.19 in torch's."""
    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 2.0, (3, 10, 6)).astype(np.float32)
    params = {"BatchNorm_0": {
        "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
        "bias": rng.normal(0, 0.1, 6).astype(np.float32)}}
    stats = {"BatchNorm_0": {
        "mean": rng.normal(0, 0.2, 6).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    module = jl.BatchNorm(use_running_average=not train, momentum=0.81)
    want, updated = module.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), mutable=["batch_stats"])
    norm = tl.BatchNorm(6, momentum=0.19).train(train)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(params["BatchNorm_0"]["scale"]))
        norm.bias.copy_(torch.from_numpy(params["BatchNorm_0"]["bias"]))
        norm.running_mean.copy_(torch.from_numpy(stats["BatchNorm_0"]["mean"]))
        norm.running_var.copy_(torch.from_numpy(stats["BatchNorm_0"]["var"]))
    got = norm(torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got.detach().numpy(), want)
    if train:  # running mean follows the same momentum in both
        _close(norm.running_mean.numpy(),
               updated["batch_stats"]["BatchNorm_0"]["mean"])
    half = norm(torch.from_numpy(x).bfloat16())  # float32 inside, cast back
    assert half.dtype == torch.bfloat16


# ---------------------------------------------------------------- blocks
def _load(module, name_map, params, stats=None):
    """Copy a flax block's numpy leaves into a port block by (torch member,
    flax path, kind) triples."""
    with torch.no_grad():
        for target, path, kind in name_map:
            tree = stats if path[-1] in ("mean", "var") else params
            for key in path:
                tree = tree[key]
            value = jax_params._to_torch(np.asarray(tree, np.float32), kind)
            module.get_parameter(target).copy_(torch.from_numpy(value.copy())) \
                if path[-1] not in ("mean", "var") else \
                module.get_buffer(target).copy_(torch.from_numpy(value.copy()))


def _bn_map(torch_mod, flax_mod):
    return [(f"{torch_mod}.weight", (flax_mod, "BatchNorm_0", "scale"), "1d"),
            (f"{torch_mod}.bias", (flax_mod, "BatchNorm_0", "bias"), "1d"),
            (f"{torch_mod}.running_mean",
             (flax_mod, "BatchNorm_0", "mean"), "1d"),
            (f"{torch_mod}.running_var",
             (flax_mod, "BatchNorm_0", "var"), "1d")]


def _conv_map(torch_mod, flax_mod, kind="conv", inner=()):
    return [(f"{torch_mod}.weight", (flax_mod, *inner, "kernel"), kind),
            (f"{torch_mod}.bias", (flax_mod, *inner, "bias"), "1d")]


@pytest.mark.parametrize("in_ch,out_ch,up,down", [
    (8, 8, False, False), (8, 8, True, False), (8, 8, False, True),
    (8, 12, False, False)])
def test_resblock_matches_jax(in_ch, out_ch, up, down):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, in_ch)).astype(np.float32)
    emb = rng.normal(size=(2, 16)).astype(np.float32)
    module = jdu.ResBlock(out_ch, up=up, down=down)
    abstract = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(emb), False))
    params = numpy_tree_like(abstract["params"], rng, "params")
    stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
    want = jax.jit(module.apply, static_argnums=3)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(emb), False)
    block = tdu.ResBlock(in_ch, out_ch, 16, up=up, down=down).eval()
    names = (_bn_map("in_layers.0", "norm_in")
             + _conv_map("in_layers.2", "conv_in")
             + _conv_map("emb_layers.1", "emb_proj", "linear", ("Dense_0",))
             + _bn_map("out_layers.0", "norm_out")
             + _conv_map("out_layers.3", "conv_out"))
    assert ("skip" in params) == (in_ch != out_ch)
    if in_ch != out_ch:
        names += _conv_map("skip_connection", "skip")
    _load(block, names, params, stats)
    got = block(_nchw(x), torch.from_numpy(emb))
    assert got.shape[2] == 8 * (2 if up else 1) // (2 if down else 1)
    assert float(np.abs(np.asarray(want)).mean()) > 0.1
    _close(_nhwc(got), want)


def test_attention_block_matches_jax_and_uses_the_legacy_qkv_split():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    module = jdu.AttentionBlock(num_heads=4)
    abstract = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.asarray(x), False))
    params = numpy_tree_like(abstract["params"], rng, "params")
    stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
    want = np.asarray(jax.jit(lambda v, a: module.apply(v, a, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    block = tdu.AttentionBlock(16, num_heads=4).eval()
    assert tuple(block.qkv.weight.shape) == (48, 16, 1)
    assert not bool(block.proj_out.weight.any())  # zero-initialised
    assert block.norm.momentum == pytest.approx(0.19)
    names = (_bn_map("norm", "norm")
             + _conv_map("qkv", "qkv", "qkv1d", ("Dense_0",))
             + _conv_map("proj_out", "proj", "qkv1d"))
    _load(block, names, params, stats)
    got = _nhwc(block(_nchw(x)))
    assert float(np.abs(want - x).mean()) > 0.05  # attention contributes
    _close(got, want)

    # ({q,k,v}, head, D) instead of (head, {q,k,v}, D) is a different function
    with torch.no_grad():
        w = block.qkv.weight.reshape(4, 3, 4, 16, 1).transpose(0, 1)
        b = block.qkv.bias.reshape(4, 3, 4).transpose(0, 1)
        block.qkv.weight.copy_(w.reshape(48, 16, 1))
        block.qkv.bias.copy_(b.reshape(48))
    assert float(np.abs(_nhwc(block(_nchw(x))) - want).max()) > 1e-2


# ---------------------------------------------------------------- the UNet
def _inputs(size, seed, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, size, size, 1)).astype(np.float32)
    y = rng.normal(0, 1, (n, size, size, 1)).astype(np.float32)
    gammas = rng.uniform(0.1, 0.9, (n,)).astype(np.float32)
    return x, y, gammas


# 16², attention at 8x8 and the 8x8 middle block; then one case whose
# attention crosses the 4,096-token threshold (64², one level: T = 4096,
# inner 32 in one head so that D = 32, one image): the plain flash version
# on this side, the blockwise formulation on the JAX side
@pytest.mark.parametrize("mults,attn,size,learn_var,inner,heads", [
    ((1, 2), (2,), 16, False, 32, 4), ((1, 2), (2,), 16, True, 32, 4),
    ((1,), (1,), 64, False, 32, 1)])
def test_unet_forward_matches_jax(mults, attn, size, learn_var, inner, heads,
                                  monkeypatch):
    from pai_tpu_torch.ops import attention as port_attention

    flash_calls = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a: flash_calls.append(a[0].shape) or real(*a))
    module, params, stats = palette_numpy_variables(
        mults, attn, size, seed=5, learn_var=learn_var, inner=inner,
        num_heads=heads)
    n = 1 if size == 64 else 2
    x, y, gammas = _inputs(size, 6, n)
    want = np.asarray(jax.jit(module.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(gammas), train=False))
    model = port_palette_model(mults, attn, params, stats, learn_var, inner,
                               heads)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(y),
                    torch.from_numpy(gammas))
    assert got.shape == (n, size, size, 2 if learn_var else 1)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert float(np.abs(want).mean()) > 0.1  # not a vacuous comparison
    _close(got.numpy(), want, scale=float(np.abs(want).max()))
    if size == 64:  # 2 input blocks, the middle block, 3 output blocks
        assert flash_calls == [(1, 1, 4096, 32)] * 6
    else:
        assert not flash_calls


@pytest.fixture(scope="module")
def golden():
    z = np.load(FIXTURE)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "tools"))
    from make_parity_fixture import deterministic_weights

    weights = deterministic_weights(json.loads(str(z["manifest"])))
    return z, {k[len("gd."):]: v for k, v in weights.items()}


def test_unet_matches_the_original_codes_golden_output(golden):
    """The fixture's weights carry the original PyTorch names: they load into
    the port's module as they are, and the output is the original code's."""
    z, weights = golden
    model = tdu.DiffusionUNet(in_channels=2, out_channels=1, inner_channel=32,
                              res_blocks=2, channel_mults=(1, 2),
                              attn_res=(2,), num_heads=4).eval()
    own = {k for k in model.state_dict()
           if not k.endswith("num_batches_tracked")}
    assert own == set(weights)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()}, strict=False)
    nhwc = [np.transpose(z[k], (0, 2, 3, 1)) for k in ("x", "y", "out")]
    with torch.inference_mode():
        got = model(torch.from_numpy(nhwc[0]), torch.from_numpy(nhwc[1]),
                    torch.from_numpy(z["gammas"]))
    np.testing.assert_allclose(got.numpy(), nhwc[2], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mults,attn", [((1, 2), (2,)), ((1, 2, 2), (1, 4))])
def test_state_dict_round_trip_and_reference_layout(mults, attn):
    """jax -> port -> jax is the identity; the port's own copy of the name
    map agrees with the JAX package's exporter (whose names carry a ``unet.``
    prefix, and which adds the schedule buffers)."""
    from pai_tpu.interop.torch_import import export_lightning_state_dict

    _, params, stats = palette_numpy_variables(mults, attn, 16, seed=7)
    hp = dict(palette_hparams(mults, attn), schedule_type="linear")
    sd = state_dict_from_jax("palette", params, stats, hp)
    model = tdu.DiffusionUNet(inner_channel=32, channel_mults=mults,
                              attn_res=attn, device="meta")
    assert sd.keys() == model.state_dict().keys()
    for name, tensor in model.state_dict().items():
        assert tuple(tensor.shape) == tuple(sd[name].shape), name

    params_back, stats_back = jax_from_state_dict("palette", sd, hp)
    for tree, back in ((params, params_back), (stats, stats_back)):
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        assert flat.keys() == flat_back.keys()
        for key in flat:
            np.testing.assert_array_equal(flat[key], flat_back[key])

    exported = export_lightning_state_dict("palette", params, stats, hp)
    unet = {k: v for k, v in exported.items() if k.startswith("unet.")}
    assert {f"unet.{k}" for k in sd} == set(unet)
    assert all(not k.startswith("unet.") for k in set(exported) - set(unet))
    for name, tensor in sd.items():
        np.testing.assert_array_equal(tensor.numpy(), unet[f"unet.{name}"])
    with pytest.raises(KeyError, match="not a DiffusionUNet"):
        jax_from_state_dict("palette", {"input_blocks.99.0.weight":
                                        torch.zeros(1)}, hp)


def test_full_width_structure_matches_jax_without_compute():
    """At the CLI defaults (mults 1,2,4,8,8,8,8,8, attention 8,4,2) the
    port's module, built on the ``meta`` device, has the JAX package's
    parameter count and sixteen attention blocks, ten of them at the two
    resolutions that take the flash path at 256²."""
    from pai_tpu.models import build_generator as jax_build
    from pai_tpu.utils.flops import parameter_count as jax_parameter_count

    module = jax_build("palette")
    zeros = jnp.zeros((1, 256, 256, 1))
    abstract = jax.eval_shape(lambda: module.init(
        jax.random.key(0), zeros, zeros, jnp.zeros((1,)), train=False))
    model = build_generator("palette", device="meta")
    assert parameter_count(model) == jax_parameter_count(abstract["params"])
    blocks = [m for m in model.modules()
              if isinstance(m, tdu.AttentionBlock)]
    widths = sorted(b.qkv.in_channels for b in blocks)
    assert widths == [256] * 5 + [512] * 5 + [1024] * 6
    learned = build_generator("palette", learn_var=True, device="meta")
    assert learned.out[2].out_channels == 2
    assert learned.input_blocks[0][0].in_channels == 2
