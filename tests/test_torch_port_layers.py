"""pai_tpu_torch.ops.layers vs pai_tpu.ops.layers: the same numpy weights and
inputs through both, float32 on the CPU.

Tolerance 1e-5 (absolute, on outputs of order 1): both sides accumulate the
same float32 products in a different order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pai_tpu.ops import layers as jl
from pai_tpu_torch.interop import jax_params
from pai_tpu_torch.ops import layers as tl

TOL = 1e-5


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("in_ch,features,size", [(1, 8, 16), (6, 4, 9)])
def test_conv_matches_jax(in_ch, features, size):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, size, size, in_ch)).astype(np.float32)
    kernel = rng.normal(0, 0.1, (4, 4, in_ch, features)).astype(np.float32)
    bias = rng.normal(0, 0.1, (features,)).astype(np.float32)
    want = jl.Conv(features, kernel_size=4, stride=2, padding=1).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    conv = tl.Conv(in_ch, features, kernel_size=4, stride=2, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            np.transpose(kernel, jax_params._TO_TORCH["conv"]).copy()))
        conv.bias.copy_(torch.from_numpy(bias))
    np.testing.assert_allclose(_nhwc(conv(_nchw(x))), np.asarray(want),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("in_ch,features,size", [(8, 3, 8), (5, 1, 7)])
def test_conv_transpose_matches_jax(in_ch, features, size):
    """The JAX kernel is stored un-flipped (kh, kw, in, out) and flipped at
    apply time; the torch weight is its plain transpose."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, size, size, in_ch)).astype(np.float32)
    kernel = rng.normal(0, 0.1, (4, 4, in_ch, features)).astype(np.float32)
    bias = rng.normal(0, 0.1, (features,)).astype(np.float32)
    want = jl.ConvTranspose(features).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    convt = tl.ConvTranspose(in_ch, features)
    with torch.no_grad():
        convt.weight.copy_(torch.from_numpy(
            np.transpose(kernel, jax_params._TO_TORCH["convt"]).copy()))
        convt.bias.copy_(torch.from_numpy(bias))
    got = _nhwc(convt(_nchw(x)))
    assert got.shape == (2, 2 * size, 2 * size, features)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def _bn_pair(rng, ch):
    scale = rng.uniform(0.5, 1.5, ch).astype(np.float32)
    bias = rng.normal(0, 0.2, ch).astype(np.float32)
    mean = rng.normal(0, 0.3, ch).astype(np.float32)
    var = rng.uniform(0.5, 2.0, ch).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    bn = tl.BatchNorm(ch)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    return variables, bn


def test_batchnorm_eval_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 6, 7)).astype(np.float32)
    variables, bn = _bn_pair(rng, 7)
    want = jl.BatchNorm(use_running_average=True).apply(
        variables, jnp.asarray(x))
    got = _nhwc(bn.eval()(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_batchnorm_train_output_and_mean_update_match_jax():
    """Train mode normalises with the batch statistics in both; the running
    mean and the running variance take the same momentum-0.1 step, the
    variance toward the biased batch variance, as the JAX package's does
    (torch's own module would take the unbiased one)."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, size=(4, 5, 6, 3)).astype(np.float32)
    variables, bn = _bn_pair(rng, 3)
    want, updates = jl.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    got = _nhwc(bn.train()(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn, name).numpy(),
            np.asarray(updates["batch_stats"]["BatchNorm_0"][key]),
            atol=TOL, rtol=0)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.9 * variables["batch_stats"]["BatchNorm_0"]["var"]
        + 0.1 * x.reshape(-1, 3).var(axis=0), atol=1e-4, rtol=0)


def test_batchnorm_computes_in_float32_and_casts_back():
    bn = tl.BatchNorm(4).eval()
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    out = bn(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    want = bn(x.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(out, want)


def test_leaky_relu_matches_jax():
    x = np.linspace(-3, 3, 25, dtype=np.float32).reshape(1, 5, 5, 1)
    np.testing.assert_array_equal(
        tl.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(jl.leaky_relu(jnp.asarray(x))))


def test_init_is_normal_002_zero_bias_and_seeded():
    def make(seed):
        return tl.Conv(16, 32, kernel_size=4, stride=2, padding=1,
                       generator=torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.weight, c.weight)
    assert float(a.bias.detach().abs().max()) == 0.0
    assert abs(float(a.weight.detach().std()) - 0.02) < 2e-3
    assert abs(float(a.weight.detach().mean())) < 2e-3


def test_dropout2d_drops_whole_channels_from_its_generator():
    drop = tl.Dropout2d(0.5, generator=torch.Generator().manual_seed(0))
    x = torch.ones(4, 16, 5, 5)
    assert drop.eval()(x) is x
    out = drop.train()(x)
    per_channel = out.flatten(2)
    assert bool((per_channel.min(dim=2).values
                 == per_channel.max(dim=2).values).all())
    assert set(out.unique().tolist()) == {0.0, 2.0}
    again = tl.Dropout2d(0.5, generator=torch.Generator().manual_seed(0)
                         ).train()(x)
    assert torch.equal(out, again)
    assert tl.Dropout2d(0.0).train()(x) is x
