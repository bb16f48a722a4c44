"""``--precision bf16-mixed`` against the JAX package at ``dtype=bfloat16``, on
the CPU: the port's layers under bf16 autocast round where XLA rounds the
JAX layers (``pai_tpu_torch/ops/layers.py``), layer by layer, block by block,
and for the Pix2Pix forward, the diffusion-UNet forward and one Palette
training step. Weights and inputs are made with numpy from a seed and handed
to both; the JAX side is jitted with the weights as arguments, as its
training and report steps run.

Bounds, each with its reason:

* A layer alone, fed the same bfloat16 input: within one bfloat16 unit in
  the last place of the JAX output everywhere (``UNIT``), and bit-equal in at
  least ``BIT_EQUAL`` of the outputs. The port reproduces every rounding
  point; what remains is float32 arithmetic taken in another order by two
  libraries (a convolution's sum of products, the softmax's exp, BatchNorm's
  batch mean), which lands on the other side of a bf16 rounding point in
  about 3e-5 of the values. The elementwise layers (SiLU, the pool, the leaky
  ReLU) and BatchNorm with running statistics are bit-equal.
* A block (ResBlock, attention block): within two units, as a one-unit
  difference inside the block can move its output by one more.
* The models, against JAX's bfloat16 result, with JAX's own bfloat16-vs-
  float32 difference on the same inputs (the "gap") as the scale. Three
  readings (``_agreement``): ``gap``, the largest difference over the
  largest gap; ``equal``, the share of values equal bit for bit; ``corr``,
  the cosine between the port's bfloat16-minus-float32 error and JAX's (1:
  the same rounding errors, 0: unrelated ones). Each model test also runs
  the port at float32 on the same inputs as a control, which reads gap 1,
  equal 0 and corr near 0 by construction, and asserts that the control
  fails the bounds: a port that skipped the rounding would not pass.
  Pix2Pix: gap at most 0.5 (measured 2.5e-5: the float32 tanh alone). The
  diffusion UNet: equal at least 0.1 and corr at least 0.45 (measured 0.28
  and 0.63; 0 and 0.15 before the port followed these rounding points, 0
  and 0.06 for the float32 control), gap at most 0.75 (measured 0.66; 0.99
  before): one value in 10^4 of the second ResBlock leaves bit-equality
  (float32 arithmetic in another order, as below), the attention blocks
  spread it to every token, and at the output one bfloat16 unit of the
  last convolution's product is already 0.66 of the gap, so the target of
  half the gap needs every output bit-equal. One Palette training step
  (train mode): the mean corr of the output and four named gradients at
  least 0.37 (measured 0.55; 0.22 before, 0.05 for the control), the
  output's equal share at least 0.03 (measured 0.16). The loss is a float32
  mean whose difference from JAX's bf16 loss is about two gaps (3.3 before,
  1 for the control): a scalar that cannot tell the rounding apart, so it
  is read, not bounded. The half-gap target is met by Pix2Pix only;
  ROADMAP.md Queue C item 1 keeps the rest.
* One GAN training step of Pix2Pix (mults (1, 2, 4), 32x32) with its
  PatchGAN, both at bfloat16, in train mode: the prediction and five
  gradients (the generator's first, second and last convolutions, the
  PatchGAN's first and its head) read as the Palette step's, mean corr at
  least 0.7 (measured 0.90, control -0.01), the prediction's equal share
  at least 0.1 (measured 0.25, control 0); the generator's and the
  discriminator's losses within 0.75 of their gaps (measured 0.41 and 0.02,
  control 1.0). Not bounded: the gradients' largest differences (0.06-0.74
  of their gaps, about one bf16 unit of a product summed over the batch, as
  the control's 1.0), and every gradient's equal share (float32 sums of
  bf16 products in other orders: 0 for both).
* Float32 is unchanged: the same layers at float32 against JAX at float32
  within the float32 tests' tolerances (rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu.models import diffusion_unet as jdu
from pai_tpu.ops import layers as jl
from pai_tpu_torch.interop import jax_params, state_dict_from_jax
from pai_tpu_torch.models import build_generator
from pai_tpu_torch.models import diffusion_unet as tdu
from pai_tpu_torch.ops import layers as tl
from torch_port_util import (bn_map, conv_map, discriminator_numpy_params,
                             gan_batches, jax_gan_state, load_flax_block,
                             numpy_tree_like, palette_numpy_variables,
                             pix2pix_numpy_variables, port_gan_models,
                             port_palette_model)

BF16 = jnp.bfloat16
UNIT = 1.0          # bfloat16 units in the last place, one layer alone
BLOCK_UNITS = 2.0   # a block of layers
BIT_EQUAL = 0.995   # share of a layer's outputs equal bit for bit
PIX2PIX_GAP = 0.5   # of JAX's own bf16-vs-float32 difference
UNET_GAP = 0.75
UNET_EQUAL = 0.1    # share of the UNet's outputs bit-equal to JAX's
UNET_CORR = 0.45    # cosine of the two bf16-minus-float32 errors
STEP_CORR = 0.37    # mean over the step's output and named gradients
STEP_EQUAL = 0.03


def _round16(x):
    return np.asarray(jnp.asarray(x).astype(BF16).astype(jnp.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _units(got, want):
    """|got - want| in bfloat16 units in the last place of the larger of the
    two (a unit of 2^-133 at zero)."""
    got, want = _np(got), _np(want)
    big = np.maximum(np.abs(got), np.abs(want))
    unit = np.exp2(np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    return np.abs(got - want) / unit


def _assert_layer(got, want, units=UNIT, bit_equal=BIT_EQUAL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    diff = _units(got, want)
    assert float(diff.max()) <= units, float(diff.max())
    assert float(np.mean(got == want)) >= bit_equal, np.mean(got != want)


def _nchw(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).to(
        dtype).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _bf16_input(rng, shape, scale=1.0):
    return _round16(rng.normal(0.0, scale, shape).astype(np.float32))


def _jit_apply(module, *args, **kwargs):
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(*args)


# ------------------------------------------------------------ layer by layer
def _conv_case(rng, dtype, transpose=False, zero=False):
    x = _bf16_input(rng, (2, 8, 8, 16))
    if transpose:
        jmod, kind = jl.ConvTranspose(8, dtype=dtype), "convt"
        kernel = rng.normal(0, 0.1, (4, 4, 16, 8)).astype(np.float32)
        port = tl.ConvTranspose(16, 8)
    elif zero:
        jmod, kind = jdu.ZeroConv(8, dtype=dtype), "conv"
        kernel = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
        port = tdu.ZeroConv(16, 8)
    else:
        jmod, kind = jl.Conv(8, 3, padding=1, dtype=dtype), "conv"
        kernel = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
        port = tl.Conv(16, 8, 3, padding=1)
    bias = rng.normal(0, 0.3, (8,)).astype(np.float32)
    want = _jit_apply(jmod, {"params": {"kernel": kernel, "bias": bias}},
                      jnp.asarray(x).astype(dtype))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            jax_params._to_torch(kernel, kind).copy()))
        port.bias.copy_(torch.from_numpy(bias))
    return port.to(memory_format=torch.channels_last), x, want


def _dense_case(rng, dtype, token_conv=False):
    x = _bf16_input(rng, (2, 10, 24))
    kernel = rng.normal(0, 0.2, (24, 12)).astype(np.float32)
    bias = rng.normal(0, 0.3, (12,)).astype(np.float32)
    want = _jit_apply(jl.Dense(12, dtype=dtype),
                      {"params": {"Dense_0": {"kernel": kernel,
                                              "bias": bias}}},
                      jnp.asarray(x).astype(dtype))
    port = tdu.TokenConv1d(24, 12) if token_conv else tl.Dense(24, 12)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(jax_params._to_torch(
            kernel, "qkv1d" if token_conv else "linear").copy()))
        port.bias.copy_(torch.from_numpy(bias))
    return port, x, want


def _run_port(port, x, dtype, nchw=True):
    """The port's layer on ``x`` (NHWC numpy) under bf16 autocast when
    ``dtype`` is bf16, else in float32; NHWC out."""
    bf16 = dtype == BF16
    inp = _nchw(x, torch.bfloat16 if bf16 else torch.float32) if nchw \
        else torch.from_numpy(np.asarray(x)).to(
            torch.bfloat16 if bf16 else torch.float32)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                         enabled=bf16):
        out = port(inp)
    return _nhwc(out) if nchw else out


PRODUCT_LAYERS = ["conv", "conv_transpose", "zero_conv", "dense",
                  "token_conv1d"]


def _product_case(name, rng, dtype):
    if name in ("conv", "conv_transpose", "zero_conv"):
        port, x, want = _conv_case(rng, dtype, transpose=name ==
                                   "conv_transpose", zero=name == "zero_conv")
        return _run_port(port, x, dtype), want
    port, x, want = _dense_case(rng, dtype, token_conv=name == "token_conv1d")
    return _run_port(port, x, dtype, nchw=False), want


@pytest.mark.parametrize("name", PRODUCT_LAYERS)
def test_product_layers_round_as_jax_at_bf16(name):
    """The product rounded to bfloat16, then the bfloat16 bias added and
    rounded again (pai_tpu/ops/layers.py:111-113, 150-154, flax nn.Dense,
    pai_tpu/models/diffusion_unet.py:66)."""
    got, want = _product_case(name, np.random.default_rng(1), BF16)
    assert got.dtype == torch.bfloat16
    _assert_layer(got, want)


@pytest.mark.parametrize("name", PRODUCT_LAYERS)
def test_product_layers_at_float32_are_unchanged(name):
    got, want = _product_case(name, np.random.default_rng(1), jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


def test_bias_rounding_order_matters_and_float32_takes_one_call():
    """Rounding the product and the sum separately is what JAX does, and it
    is a different function from the bias inside the product: the single
    rounding differs from JAX in a good share of the outputs."""
    port, x, want = _conv_case(np.random.default_rng(2), BF16)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        inside = torch.nn.functional.conv2d(_nchw(x), port.weight, port.bias,
                                            padding=1)
    assert float(np.mean(_np(_nhwc(inside)) != _np(want))) > 0.05
    _assert_layer(_run_port(port, x, BF16), want)


@pytest.mark.parametrize("name", ["silu", "avg_pool_2x", "leaky_relu"])
@pytest.mark.parametrize("dtype", [BF16, jnp.float32])
def test_elementwise_layers_round_as_jax(name, dtype):
    """SiLU as 1 / (1 + exp(-x)) times x, rounded after each op
    (pai_tpu/ops/layers.py:71-73); the pool's window summed in row-major
    order, rounded after each add (:283-294); the leaky ReLU's slope rounded
    to x's dtype (:67-68). bfloat16: bit-equal. float32: as before."""
    rng = np.random.default_rng(3)
    x = _bf16_input(rng, (2, 8, 8, 16), scale=3.0)
    jfn = getattr(jl, name)
    want = jax.jit(jfn)(jnp.asarray(x).astype(dtype))
    tdtype = torch.bfloat16 if dtype == BF16 else torch.float32
    if name == "avg_pool_2x":
        got = _nhwc(tl.avg_pool_2x(_nchw(x, tdtype)))
    else:
        got = getattr(tl, name)(torch.from_numpy(x).to(tdtype))
    assert got.dtype == tdtype
    if dtype == BF16:
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
    if name == "silu":  # the module the UNet holds is the same function
        np.testing.assert_array_equal(
            _np(tl.SiLU()(torch.from_numpy(x).to(tdtype))), _np(got))
    if name == "leaky_relu":
        np.testing.assert_array_equal(
            _np(tl.LeakyReLU(0.2)(torch.from_numpy(x).to(tdtype))), _np(got))


def _bn_variables(rng, c):
    params = {"BatchNorm_0": {
        "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": rng.normal(0, 0.1, c).astype(np.float32)}}
    stats = {"BatchNorm_0": {
        "mean": rng.normal(0, 0.2, c).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    return params, stats


@pytest.mark.parametrize("tokens", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_rounds_as_flax_at_bf16(tokens, train):
    """Eval mode: flax's BatchNorm formula in float32 on a bfloat16 input,
    rounded once (pai_tpu/ops/layers.py:178-188), bit-equal. Train mode: the
    library's float32 batch norm, rounded once: the batch statistics and
    the normalisation are float32 arithmetic in another order, within one
    unit, and the running statistics move as flax moves them. The
    attention's norm over (N, L, C) tokens with its momentum 0.81."""
    rng = np.random.default_rng(4)
    shape = (3, 20, 16) if tokens else (2, 6, 6, 16)
    x = _bf16_input(rng, shape, scale=2.0) + 0.5
    params, stats = _bn_variables(rng, 16)
    momentum = 0.81 if tokens else 0.9
    want, updated = jax.jit(lambda v, a: jl.BatchNorm(
        use_running_average=not train, momentum=momentum).apply(
        v, a, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x).astype(BF16))
    norm = tl.BatchNorm(16, momentum=round(1 - momentum, 2)).train(train)
    load_flax_block(norm, [
        ("weight", ("BatchNorm_0", "scale"), "1d"),
        ("bias", ("BatchNorm_0", "bias"), "1d"),
        ("running_mean", ("BatchNorm_0", "mean"), "1d"),
        ("running_var", ("BatchNorm_0", "var"), "1d")], params, stats)
    inp = torch.from_numpy(x).bfloat16() if tokens else _nchw(x)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = norm(inp)
    got = got if tokens else _nhwc(got)
    assert got.dtype == torch.bfloat16
    if train:
        _assert_layer(got, want)
        for mine, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(norm, mine).numpy(),
                updated["batch_stats"]["BatchNorm_0"][theirs], rtol=1e-6,
                atol=1e-7)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


def test_a_convolution_read_by_batchnorm_hands_it_the_float32_sum():
    """XLA keeps conv + bias in float32 where the only reader casts it to
    float32 (a BatchNorm): ``float32_sum`` (ops/layers.py)."""
    rng = np.random.default_rng(5)
    x = _bf16_input(rng, (2, 8, 8, 16))
    kernel = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    bias = rng.normal(0, 0.3, (8,)).astype(np.float32)
    params, stats = _bn_variables(rng, 8)

    def jfn(v, a):
        h = jl.Conv(8, 3, padding=1, dtype=BF16).apply(
            {"params": v["conv"]}, a)
        return jl.BatchNorm(use_running_average=True).apply(
            {"params": v["norm"], "batch_stats": v["stats"]}, h)

    want = jax.jit(jfn)({"conv": {"kernel": kernel, "bias": bias},
                         "norm": params, "stats": stats},
                        jnp.asarray(x).astype(BF16))
    conv = tl.Conv(16, 8, 3, padding=1, float32_sum=True).to(
        memory_format=torch.channels_last)
    norm = tl.BatchNorm(8).eval()
    load_flax_block(conv, [("weight", ("kernel",), "conv"),
                           ("bias", ("bias",), "1d")],
                    {"kernel": kernel, "bias": bias})
    load_flax_block(norm, [("weight", ("BatchNorm_0", "scale"), "1d"),
                           ("bias", ("BatchNorm_0", "bias"), "1d"),
                           ("running_mean", ("BatchNorm_0", "mean"), "1d"),
                           ("running_var", ("BatchNorm_0", "var"), "1d")],
                    params, stats)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        mid = conv(_nchw(x))
        got = _nhwc(norm(mid))
    assert mid.dtype == torch.float32 and got.dtype == torch.bfloat16
    _assert_layer(got, want)


# ------------------------------------- the layers of the other families
def _family_layer(name, rng, tdtype, jdtype=BF16):
    """(the port's output with ``tdtype`` inputs under bf16 autocast when
    ``tdtype`` is bfloat16, the JAX package's at ``jdtype``) for one layer
    the attention, residual and transformer U-Nets add."""
    bf16 = tdtype == torch.bfloat16

    def port(fn, *arrays, nchw=False):
        args = [(_nchw(a, tdtype) if nchw else torch.from_numpy(a).to(tdtype))
                for a in arrays]
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                             enabled=bf16):
            out = fn(*args)
        return _nhwc(out) if nchw else out

    def jax_fn(fn, variables, *arrays):
        return jax.jit(fn)(variables, *(jnp.asarray(a).astype(jdtype)
                                        for a in arrays))

    if name == "layer_norm":
        x = _bf16_input(rng, (3, 5, 64), 2.0) + 0.5
        scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
        bias = rng.normal(0, 0.1, 64).astype(np.float32)
        norm = tl.LayerNorm(64)
        load_flax_block(norm, [("weight", ("LayerNorm_0", "scale"), "1d"),
                               ("bias", ("LayerNorm_0", "bias"), "1d")],
                        {"LayerNorm_0": {"scale": scale, "bias": bias}})
        return port(norm, x), jax_fn(
            lambda v, a: jl.LayerNorm(dtype=jdtype).apply(v, a),
            {"params": {"LayerNorm_0": {"scale": scale, "bias": bias}}}, x)
    if name == "gate":  # the attention gate's mask and product
        x = _bf16_input(rng, (2, 8, 8, 16))
        a = _bf16_input(rng, (2, 8, 8, 1), 2.0)
        return port(lambda p, q: p * tl.sigmoid(q), x, a, nchw=True), \
            jax_fn(lambda v, p, q: p * jax.nn.sigmoid(q), {}, x, a)
    if name == "gelu":
        x = _bf16_input(rng, (4, 256), 3.0)
        return port(tl.gelu, x), jax_fn(
            lambda v, a: jax.nn.gelu(a, approximate=False), {}, x)
    if name == "vit_attention":  # pai_tpu/models/trans_unet.py:89-97
        from pai_tpu_torch.models.trans_unet import attention

        q, k, v = (_bf16_input(rng, (2, 8, 4, 32), 1.5) for _ in range(3))

        def jattn(_, q, k, v):
            logits = jnp.einsum("nhqd,nhkd->nhqk", q, k,
                                preferred_element_type=jnp.float32)
            w = jax.nn.softmax(logits / np.sqrt(q.shape[-1]), axis=-1)
            return jnp.einsum("nhqk,nhkd->nhqd", w.astype(q.dtype), v,
                              preferred_element_type=jnp.float32
                              ).astype(q.dtype)

        return port(lambda *a: attention(*a, tl.Dropout(0.0)), q, k, v), \
            jax_fn(jattn, {}, q, k, v)
    if name == "grouped_conv":  # ResNeXt's 3x3, here 8 groups of 4
        x = _bf16_input(rng, (2, 8, 8, 32))
        kernel = rng.normal(0, 0.1, (3, 3, 4, 16)).astype(np.float32)
        bias = rng.normal(0, 0.3, (16,)).astype(np.float32)
        conv = tl.Conv(32, 16, 3, padding=1, groups=8)
        load_flax_block(conv, [
            ("weight", ("kernel",), "conv"), ("bias", ("bias",), "1d")],
            {"kernel": kernel, "bias": bias})
        return port(conv.to(memory_format=torch.channels_last), x,
                    nchw=True), jax_fn(
            lambda v, a: jl.Conv(16, 3, padding=1, groups=8,
                                 dtype=jdtype).apply(v, a),
            {"params": {"kernel": kernel, "bias": bias}}, x)
    x = _bf16_input(rng, (2, 8, 8, 16), 2.0)  # max_pool_2x
    return port(tl.max_pool_2x, x, nchw=True), jax_fn(
        lambda v, a: jl.max_pool_2x(a), {}, x)


FAMILY_LAYERS = ["layer_norm", "gate", "gelu", "vit_attention",
                 "grouped_conv", "max_pool_2x"]


@pytest.mark.parametrize("name", FAMILY_LAYERS)
def test_family_layers_round_as_jax_at_bf16(name):
    """LayerNorm in float32, rounded once (pai_tpu/ops/layers.py:252-263);
    the gate's sigmoid expanded and rounded op by op, then the product
    (pai_tpu/models/attention_unet.py:33-34); the exact GELU with its erfc
    argument kept in float32, the erfc and the product rounded; the ViT's
    attention with float32 logits, softmax and weighted sum, its weights and
    its result rounded; a grouped convolution through
    ``_bias_after_rounding``; the max pool, exact. Each bit-equal to
    pai_tpu's here, and within one unit by the layers' bound."""
    got, want = _family_layer(name, np.random.default_rng(8), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_layer(got, want)


@pytest.mark.parametrize("name", FAMILY_LAYERS[:-1])
def test_family_layers_float32_control_fails_at_bf16(name):
    """The same layer in float32 on the same bfloat16-valued inputs, held
    against pai_tpu's bfloat16 result, fails the bound: without the
    rounding points the port would not pass. The max pool has none (a
    maximum is exact in any dtype), so it has no such control."""
    got, want = _family_layer(name, np.random.default_rng(8), torch.float32)
    with pytest.raises(AssertionError):
        _assert_layer(got, want)


@pytest.mark.parametrize("name", FAMILY_LAYERS)
def test_family_layers_at_float32_are_unchanged(name):
    got, want = _family_layer(name, np.random.default_rng(8), torch.float32,
                              jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


def test_library_ops_differ_from_jax_at_bf16():
    """The rounding points matter: the library's bfloat16 GELU and sigmoid,
    and a grouped convolution with its bias inside, differ from pai_tpu's
    in a good share of the outputs."""
    rng = np.random.default_rng(8)
    x = _bf16_input(rng, (4, 256), 3.0)
    for lib, jfn in ((torch.nn.functional.gelu,
                      lambda a: jax.nn.gelu(a, approximate=False)),
                     (torch.sigmoid, jax.nn.sigmoid)):
        want = jax.jit(jfn)(jnp.asarray(x).astype(BF16))
        got = lib(torch.from_numpy(x).bfloat16())
        assert float(np.mean(_np(got) != _np(want))) > 0.05
    _, want = _family_layer("grouped_conv", np.random.default_rng(8),
                            torch.bfloat16)
    rng = np.random.default_rng(8)
    x = _bf16_input(rng, (2, 8, 8, 32))
    kernel = rng.normal(0, 0.1, (3, 3, 4, 16)).astype(np.float32)
    bias = rng.normal(0, 0.3, (16,)).astype(np.float32)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        inside = torch.nn.functional.conv2d(
            _nchw(x), torch.from_numpy(jax_params._to_torch(kernel, "conv")
                                       .copy()),
            torch.from_numpy(bias), padding=1, groups=8)
    assert float(np.mean(_np(_nhwc(inside)) != _np(want))) > 0.05


# -------------------------------------------------------------- blocks
def _resblock(rng, in_ch, out_ch, down):
    x = _bf16_input(rng, (2, 8, 8, in_ch))
    emb = _bf16_input(rng, (2, 16))
    module = jdu.ResBlock(out_ch, down=down, dtype=BF16)
    abstract = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(emb), False))
    params = numpy_tree_like(abstract["params"], rng, "params")
    stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
    want = jax.jit(lambda v, a, e: module.apply(v, a, e, False))(
        {"params": params, "batch_stats": stats},
        jnp.asarray(x).astype(BF16), jnp.asarray(emb).astype(BF16))
    block = tdu.ResBlock(in_ch, out_ch, 16, down=down).eval()
    names = (bn_map("in_layers.0", "norm_in") + conv_map("in_layers.2",
                                                         "conv_in")
             + conv_map("emb_layers.1", "emb_proj", "linear", ("Dense_0",))
             + bn_map("out_layers.0", "norm_out")
             + conv_map("out_layers.3", "conv_out"))
    if in_ch != out_ch:
        names += conv_map("skip_connection", "skip")
    load_flax_block(block, names, params, stats)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = block(_nchw(x), torch.from_numpy(emb).bfloat16())
    assert got.dtype == torch.float32  # the residual sum, for a BatchNorm
    return _nhwc(got).bfloat16(), want


@pytest.mark.parametrize("in_ch,out_ch,down", [(8, 8, False), (8, 12, True)])
def test_resblock_rounds_as_jax_at_bf16(in_ch, out_ch, down):
    got, want = _resblock(np.random.default_rng(6), in_ch, out_ch, down)
    _assert_layer(got, want, units=BLOCK_UNITS)


def test_attention_block_rounds_as_jax_at_bf16():
    """BatchNorm over tokens, the qkv and output projections, the full
    softmax (T < 4096) with its weights rounded to bfloat16, the residual;
    64 channels in 4 heads (D = 16), as in the UNet tests. At D = 4 or 32,
    XLA on the CPU keeps the attention's output in float32 for the output
    projection, where the JAX source rounds it (``.astype(v.dtype)``,
    pai_tpu/ops/attention.py:80-83), and the port follows the source: a
    third of the outputs differ there (ROADMAP.md Queue C item 1)."""
    rng = np.random.default_rng(7)
    x = _bf16_input(rng, (2, 4, 6, 64))
    module = jdu.AttentionBlock(num_heads=4, dtype=BF16)
    abstract = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.asarray(x), False))
    params = numpy_tree_like(abstract["params"], rng, "params")
    stats = numpy_tree_like(abstract["batch_stats"], rng, "stats")
    want = jax.jit(lambda v, a: module.apply(v, a, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x).astype(BF16))
    block = tdu.AttentionBlock(64, num_heads=4).eval()
    load_flax_block(block, bn_map("norm", "norm")
                    + conv_map("qkv", "qkv", "qkv1d", ("Dense_0",))
                    + conv_map("proj_out", "proj", "qkv1d"), params, stats)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = _nhwc(block(_nchw(x)))
    assert got.dtype == torch.bfloat16
    _assert_layer(got, want, units=BLOCK_UNITS)


# -------------------------------------------------------------- models
def _agreement(port16, jax16, jax32):
    """The port's bfloat16 result against JAX's: ``gap``, the largest
    difference over JAX's own largest bf16-vs-float32 difference; ``equal``,
    the share of values equal bit for bit; ``corr``, the cosine between the
    port's bf16-minus-float32 error and JAX's."""
    port16, jax16, jax32 = (_np(a).astype(np.float64)
                            for a in (port16, jax16, jax32))
    mine, theirs = port16 - jax32, jax16 - jax32
    norm = np.linalg.norm(mine) * np.linalg.norm(theirs)
    assert np.abs(theirs).max() > 0  # bf16 is not float32: not vacuous
    return {"gap": float(np.abs(port16 - jax16).max()
                         / np.abs(theirs).max()),
            "equal": float(np.mean(port16 == jax16)),
            "corr": float((mine * theirs).sum() / norm) if norm else 0.0}


def test_pix2pix_forward_at_bf16_matches_jax():
    mults = (1, 2, 2, 2)
    module, params, stats = pix2pix_numpy_variables(mults, 16, seed=5)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 1)).astype(
        np.float32)
    variables = {"params": params, "batch_stats": stats}
    outs = {}
    for dtype in (BF16, jnp.float32):
        jmod = type(module)(channel_mults=mults, dtype=dtype)
        outs[dtype] = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
            variables, jnp.asarray(x))
    got = {}
    for dtype in (torch.bfloat16, torch.float32):  # the port, its control
        model = build_generator(
            "pix2pix", channel_mults=mults, dtype=dtype,
            generator=torch.Generator().manual_seed(0)).eval()
        model.load_state_dict(state_dict_from_jax(
            "pix2pix", params, stats, {"channel_mults": "1,2,2,2"}))
        with torch.inference_mode():
            got[dtype] = _agreement(model(torch.from_numpy(x)), outs[BF16],
                                    outs[jnp.float32])["gap"]
    assert got[torch.bfloat16] <= PIX2PIX_GAP, got
    assert got[torch.float32] > PIX2PIX_GAP, got


def _unet_inputs(seed, size=16):
    rng = np.random.default_rng(seed)
    x, y = (rng.normal(size=(2, size, size, 1)).astype(np.float32)
            for _ in range(2))
    return x, y, rng.uniform(0.1, 0.9, 2).astype(np.float32)


def _unet_passes(a):
    return (a["gap"] <= UNET_GAP and a["equal"] >= UNET_EQUAL
            and a["corr"] >= UNET_CORR)


def test_unet_forward_at_bf16_matches_jax():
    mults, attn = (1, 2), (2,)
    _, params, stats = palette_numpy_variables(mults, attn, 16, seed=5)
    x, y, g = _unet_inputs(5)
    outs = {}
    for dtype in (BF16, jnp.float32):
        jmod = jdu.DiffusionUNet(in_channels=2, out_channels=1,
                                 inner_channel=32, res_blocks=2,
                                 channel_mults=mults, attn_res=attn,
                                 num_heads=4, dtype=dtype)
        outs[dtype] = jax.jit(lambda v, a, b, c: jmod.apply(
            v, a, b, c, train=False))(
            {"params": params, "batch_stats": stats}, x, y, g)
    model = port_palette_model(mults, attn, params, stats)
    got = {}
    for dtype in (torch.bfloat16, torch.float32):  # the port, its control
        model.compute_dtype = dtype
        with torch.inference_mode():
            out = model(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(g))
        assert out.dtype == torch.float32
        got[dtype] = _agreement(out, outs[BF16], outs[jnp.float32])
    assert _unet_passes(got[torch.bfloat16]), got
    assert not _unet_passes(got[torch.float32]), got


# gradients from both ends of the UNet and its middle
NAMED_GRADIENTS = {
    "out.2.weight": ("out_conv", "kernel", "conv"),
    "input_blocks.0.0.weight": ("in_conv", "kernel", "conv"),
    "middle_block.1.qkv.weight": ("mid_attn", "qkv", "Dense_0", "kernel",
                                  "qkv1d"),
    "cond_embed.0.weight": ("cond_embed_0", "Dense_0", "kernel", "linear"),
}


def _step_agreement(model, x, y, g, noise, jax16, jax32):
    """One training step of the port: the output's and each named
    gradient's ``_agreement`` with JAX's ((output, gradients) pairs), and
    the loss."""
    out = model(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(g))
    loss = torch.mean((out - torch.from_numpy(noise)) ** 2)
    loss.backward()
    found = {"output": _agreement(out, jax16[0], jax32[0])}
    grads = dict(model.named_parameters())
    for name, path in NAMED_GRADIENTS.items():
        *keys, kind = path
        want16, want32 = jax16[1], jax32[1]
        for key in keys:
            want16, want32 = want16[key], want32[key]
        want16, want32 = (jax_params._to_torch(np.asarray(w), kind)
                          for w in (want16, want32))
        found[name] = _agreement(grads[name].grad, want16, want32)
    corr = float(np.mean([a["corr"] for a in found.values()]))
    return corr, found, loss.item()


def test_palette_step_at_bf16_matches_jax():
    """One training step, mean((UNet(x, y_t, gamma) - noise)^2) in train
    mode (batch statistics): its output and gradients; one level of 8x8
    with attention (a JAX gradient compiles in half the time of two
    levels)."""
    mults, attn = (1,), (1,)
    _, params, stats = palette_numpy_variables(mults, attn, 8, seed=5)
    x, y, g = _unet_inputs(5, 8)
    noise = np.random.default_rng(6).normal(size=(2, 8, 8, 1)).astype(
        np.float32)
    results = {}
    for dtype in (BF16, jnp.float32):
        jmod = jdu.DiffusionUNet(in_channels=2, out_channels=1,
                                 inner_channel=32, res_blocks=2,
                                 channel_mults=mults, attn_res=attn,
                                 num_heads=4, dtype=dtype)

        def loss_fn(p, jmod=jmod):
            out, _ = jmod.apply({"params": p, "batch_stats": stats}, x, y, g,
                                train=True, mutable=["batch_stats"])
            return jnp.mean((out - noise) ** 2), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params)
        results[dtype] = (out, grads)
    got = {}
    for dtype in (torch.bfloat16, torch.float32):  # the port, its control
        model = port_palette_model(mults, attn, params, stats).train()
        model.compute_dtype = dtype
        got[dtype] = _step_agreement(model, x, y, g, noise, results[BF16],
                                     results[jnp.float32])
    corr, found, _ = got[torch.bfloat16]
    assert corr >= STEP_CORR and found["output"]["equal"] >= STEP_EQUAL, got
    corr, found, _ = got[torch.float32]
    assert corr < STEP_CORR and found["output"]["equal"] < STEP_EQUAL, got


# the generator's first, second and last convolutions, the PatchGAN's first
# and its head: (name, flax path, kind) per network
GAN_GRADIENTS = {
    "g_grads": {"encoders.0.weight": ("stem", "kernel", "conv"),
                "encoders.1.encode.1.weight": ("enc_1", "Conv_0", "kernel",
                                               "conv"),
                "decoders.2.weight": ("head", "kernel", "convt")},
    "d_grads": {"discriminator.0.block.0.weight": (
                    "DiscriminatorBlock_0", "Conv_0", "kernel", "conv"),
                "discriminator.4.weight": ("Conv_0", "kernel", "conv")},
}
GAN_STEP_CORR = 0.7
GAN_STEP_EQUAL = 0.1
GAN_LOSS_GAP = 0.75


def test_gan_step_at_bf16_matches_jax():
    """One ``gan`` training step (train mode, the PatchGAN's update, the
    generator's loss against the updated PatchGAN): the prediction, named
    gradients of both networks and both losses (module docstring)."""
    from pai_tpu.models import Discriminator as JaxDiscriminator
    from pai_tpu.models.pix2pix import Pix2PixUnet
    from pai_tpu.train import steps as jsteps
    from pai_tpu_torch.train import steps as tsteps

    mults = (1, 2, 4)
    _, params, stats = pix2pix_numpy_variables(mults, 32, seed=5)
    dparams = discriminator_numpy_params(6)
    x, y = gan_batches(7, 1)[0]
    results = {}
    for dtype in (BF16, jnp.float32):
        gen = Pix2PixUnet(channel_mults=mults, dtype=dtype)
        step = jax.jit(jsteps.make_gan_train_step(
            gen, JaxDiscriminator(dtype=dtype), "gan",
            compute_metrics=False, with_grads=True))
        _, found = step(jax_gan_state(params, stats, dparams, "gan"), x, y,
                        jax.random.key(0))
        pred, _ = jax.jit(lambda v, a, gen=gen: gen.apply(
            v, a, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, x)
        results[dtype] = (pred, found)

    def readings(dtype):
        gen, disc = port_gan_models(params, stats, dparams, mults)
        gen.compute_dtype = disc.compute_dtype = dtype
        preds = []
        gen.register_forward_hook(lambda m, a, out: preds.append(out))
        state = tsteps.init_gan_state(gen, disc, "gan", use_ema=False)
        _, got = tsteps.make_gan_train_step(
            gen, disc, "gan", compute_metrics=False, with_grads=True)(
            state, torch.from_numpy(x), torch.from_numpy(y))
        found = {"output": _agreement(preds[0], results[BF16][0],
                                      results[jnp.float32][0])}
        for key, names in GAN_GRADIENTS.items():
            for name, path in names.items():
                *keys, kind = path
                want16, want32 = results[BF16][1][key], \
                    results[jnp.float32][1][key]
                for k in keys:
                    want16, want32 = want16[k], want32[k]
                want16, want32 = (jax_params._to_torch(np.asarray(w), kind)
                                  for w in (want16, want32))
                found[name] = _agreement(got[key][name], want16, want32)
        corr = float(np.mean([a["corr"] for a in found.values()]))
        losses = {k: abs(float(got[k]) - float(results[BF16][1][k]))
                  / abs(float(results[BF16][1][k])
                        - float(results[jnp.float32][1][k]))
                  for k in ("loss", "d_loss")}
        return corr, found, losses

    def passes(corr, found, losses):
        return (corr >= GAN_STEP_CORR
                and found["output"]["equal"] >= GAN_STEP_EQUAL
                and max(losses.values()) <= GAN_LOSS_GAP)

    port = readings(torch.bfloat16)
    assert passes(*port), port
    control = readings(torch.float32)  # the same model unrounded
    assert control[0] < GAN_STEP_CORR, control
    assert control[1]["output"]["equal"] < GAN_STEP_EQUAL, control
    assert min(control[2].values()) > GAN_LOSS_GAP, control
