"""``--precision bf16-mixed`` against the JAX package at ``dtype=bfloat16``, on
the CPU: the port's layers under bf16 autocast round where XLA rounds the
JAX layers (``pai_tpu_torch/ops/layers.py``), layer by layer, block by block,
and for the Pix2Pix forward, the diffusion-UNet forward, one Palette
training step, one GAN step of Pix2Pix and of the attention U-Net, a
TransUNet ViT layer and the attention and ResNeXt U-Nets' forwards.
Weights and inputs are made with numpy from a seed and handed to both; the
JAX side is jitted with the weights as arguments, as its training and
report steps run.

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
* The models, against JAX's bfloat16 result, with its difference from the
  float32 result on the same inputs (the "gap") as the scale. The float32
  result is the port's own, which the float32 tests hold to the JAX
  package's within 1e-5 to 1e-4 (no JAX float32 compile here; against
  JAX's float32 the readings below differed by 0.01 at most). Three
  readings (``_agreement``): ``gap``, the largest difference over the
  largest gap; ``equal``, the share of values equal bit for bit; ``corr``,
  the cosine between the port's bfloat16-minus-float32 error and JAX's (1:
  the same rounding errors, 0: unrelated ones). Each model test also runs
  the port at float32 on the same inputs as a control, which reads gap 1,
  equal 0 and corr 0 by construction, and asserts that the control fails
  the bounds: a port that skipped the rounding would not pass.
  Pix2Pix: gap at most 0.5 (measured 0). The diffusion UNet: equal at
  least 0.1 and corr at least 0.45 (measured 0.28 and 0.63; 0 and 0.15
  before the port followed these rounding points), gap at most 0.75
  (measured 0.66; 0.99
  before): one value in 10^4 of the second ResBlock leaves bit-equality
  (float32 arithmetic in another order, as below), the attention blocks
  spread it to every token, and at the output one bfloat16 unit of the
  last convolution's product is already 0.66 of the gap, so the target of
  half the gap needs every output bit-equal. One Palette training step
  (train mode): the mean corr of the output and four named gradients at
  least 0.37 (measured 0.55; 0.22 before), the output's equal share at
  least 0.03 (measured 0.16). The loss, a float32 mean about two gaps from
  JAX's bf16 loss, cannot tell the rounding apart and is not held. The
  half-gap target is met by Pix2Pix only;
  ROADMAP.md Queue C item 1 keeps the rest.
* One GAN training step of Pix2Pix (mults (1, 2, 4), 32x32) with its
  PatchGAN, both at bfloat16, in train mode: the prediction and five
  gradients (the generator's first, second and last convolutions, the
  PatchGAN's first and its head) read as the Palette step's: mean corr at
  least 0.7 (measured 0.90), the prediction's equal share at least 0.1
  (measured 0.25); the generator's and the discriminator's losses within
  0.75 of their gaps (measured 0.41 and 0.02; the control 1.0 by
  construction). Not bounded: the gradients' largest differences (0.06-0.74
  of their gaps, about one bf16 unit of a product summed over the batch, as
  the control's 1.0), and every gradient's equal share (float32 sums of
  bf16 products in other orders: 0 for both).
* The other families as a whole, each with its float32 control:
  - one TransUNet ViT layer (8 tokens of 64, 8 heads, FFN 256): bit-equal
    in at least 0.99 of the outputs, corr at least 0.99 (measured 1.0 and
    1.0; 0.47 and 0.80 while each branch handed its residual a float32
    sum of product and bias: XLA rounds the branch and sums the residual
    in float32 for the LayerNorm);
  - the attention U-Net's and the ResNeXt U-Net's eval forward at mults
    (1, 2, 4) on 32x32: equal at least 0.1, corr at least 0.9 (measured
    0.23 and 0.99, 0.45 and 0.9997). The equal share is capped by the
    float32 sum and tanh at the output, whose last bit the two libraries
    round differently;
  - one attention U-Net step at ``gan`` and at ``ssim`` (the prediction,
    the stem, second convolution, a gate's mask convolution and head, for
    ``gan`` also the PatchGAN's first and last convolutions): the Pix2Pix
    step's bounds (measured mean corr 0.89 and 0.92, the prediction 0.26
    bit-equal, losses 0.41 and 0.01, and 0.16, of their gaps);
  - a bias-free convolution read by a BatchNorm (TransUNet's encoder):
    the layers' bound (the product reaches the BatchNorm unrounded;
    rounding it left 0.80 of an encoder block's outputs bit-equal,
    ``tools/bf16_family_agreement.py``);
  - ResUNet-v2's first block after the stem: equal at least 0.99 and one
    bfloat16 unit at the largest output (measured 0.994; its BatchNorm
    reads the stem's float32 sum; the stem rounded first, the control,
    reads 0.64 in the tool at 32x32).
* Float32 is unchanged: the same layers at float32 against JAX at float32
  within the float32 tests' tolerances (rtol 1e-4, atol 1e-5).
"""

import functools

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
from pai_tpu_torch.train import steps as tsteps
from torch_port_util import (bn_map, conv_map, discriminator_numpy_params,
                             gan_batches, generator_numpy_variables,
                             jax_gan_state, load_flax_block, mults_hparams,
                             numpy_tree_like, palette_numpy_variables,
                             pix2pix_numpy_variables, port_gan_models,
                             port_generator, port_palette_model)

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
RESV2_EQUAL = 0.99  # ResUNet-v2's first block after the stem


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


def test_a_bias_free_convolution_read_by_batchnorm_hands_it_the_product():
    """Without a bias (TransUNet's encoder), the BatchNorm that reads a
    convolution gets the float32 product itself: XLA drops its rounding as
    it drops the sum's (``float32_sum``)."""
    rng = np.random.default_rng(10)
    x = _bf16_input(rng, (2, 8, 8, 16))
    kernel = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    params, stats = _bn_variables(rng, 8)

    def jfn(v, a):
        h = jl.Conv(8, 3, padding=1, use_bias=False, dtype=BF16).apply(
            {"params": v["conv"]}, a)
        return jl.BatchNorm(use_running_average=True).apply(
            {"params": v["norm"], "batch_stats": v["stats"]}, h)

    want = jax.jit(jfn)({"conv": {"kernel": kernel}, "norm": params,
                         "stats": stats}, jnp.asarray(x).astype(BF16))
    conv = tl.Conv(16, 8, 3, padding=1, bias=False, float32_sum=True).to(
        memory_format=torch.channels_last)
    norm = tl.BatchNorm(8).eval()
    load_flax_block(conv, [("weight", ("kernel",), "conv")],
                    {"kernel": kernel})
    load_flax_block(norm, [
        ("weight", ("BatchNorm_0", "scale"), "1d"),
        ("bias", ("BatchNorm_0", "bias"), "1d"),
        ("running_mean", ("BatchNorm_0", "mean"), "1d"),
        ("running_var", ("BatchNorm_0", "var"), "1d")], params, stats)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        mid = conv(_nchw(x))
        got = _nhwc(norm(mid))
    assert mid.dtype == torch.float32 and got.dtype == torch.bfloat16
    _assert_layer(got, want)


def test_resv2_first_block_reads_the_stems_float32_sum():
    """ResUNet-v2's first block opens with a BatchNorm on the stem's output:
    it reads the stem's float32 sum, and the identity skip the rounded one
    (pai_tpu/models/res_unet.py:108-130, 259-268), through the port model's
    own stem and block. Bound: bit-equal in at least ``RESV2_EQUAL`` of the
    outputs and within one bfloat16 unit at the largest output's magnitude
    (the second convolution spreads a BatchNorm value that float32 order
    moved across a rounding point to its 3x3 neighbours, measured 0.994);
    the stem rounded first, as every other family's is, must fall below
    it."""
    from pai_tpu.models.res_unet import ResidualBlockV2

    rng = np.random.default_rng(11)
    x = _bf16_input(rng, (2, 8, 8, 1))

    def jfn(v, a):
        h = jl.Conv(64, 3, padding=1, dtype=BF16).apply(
            {"params": v["params"]["stem"]}, a)
        return ResidualBlockV2(64, dtype=BF16).apply(
            {"params": v["params"]["enc_0"],
             "batch_stats": v["batch_stats"]["enc_0"]}, h, False)

    _, params, stats = generator_numpy_variables("resv2_unet", (1, 2), 16,
                                                 seed=11)
    want = _np(jax.jit(jfn)({"params": params, "batch_stats": stats},
                            jnp.asarray(x).astype(BF16)))
    model = port_generator("resv2_unet", (1, 2), 16,
                           generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(
        "resv2_unet", params, stats, mults_hparams((1, 2))), strict=True)
    model.eval()
    block = model.encoders[0]["encode"][0]
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        stem = model.in_conv(_nchw(x, torch.float32))
        got = _np(_nhwc(block(stem)))
        control = _np(_nhwc(block(stem.bfloat16())))
    unit = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert stem.dtype == torch.float32
    assert np.mean(got == want) >= RESV2_EQUAL, np.mean(got == want)
    assert np.abs(got - want).max() <= unit
    assert np.mean(control == want) < RESV2_EQUAL, np.mean(control == want)


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
    want = _jit_apply(type(module)(channel_mults=mults, dtype=BF16),
                      {"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=False)
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):  # the port, its control
        model = build_generator(
            "pix2pix", channel_mults=mults, dtype=dtype,
            generator=torch.Generator().manual_seed(0)).eval()
        model.load_state_dict(state_dict_from_jax(
            "pix2pix", params, stats, {"channel_mults": "1,2,2,2"}))
        with torch.inference_mode():
            outs[dtype] = model(torch.from_numpy(x))
    got = {dtype: _agreement(out, want, outs[torch.float32])["gap"]
           for dtype, out in outs.items()}
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
    jmod = jdu.DiffusionUNet(in_channels=2, out_channels=1, inner_channel=32,
                             res_blocks=2, channel_mults=mults,
                             attn_res=attn, num_heads=4, dtype=BF16)
    want = _jit_apply(jmod, {"params": params, "batch_stats": stats}, x, y,
                      g, train=False)
    model = port_palette_model(mults, attn, params, stats)
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):  # the port, its control
        model.compute_dtype = dtype
        with torch.inference_mode():
            outs[dtype] = model(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(g))
        assert outs[dtype].dtype == torch.float32
    got = {dtype: _agreement(out, want, outs[torch.float32])
           for dtype, out in outs.items()}
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


def _port_palette_step(model, x, y, g, noise):
    """One training step of the port: (output, named gradients)."""
    out = model(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(g))
    torch.mean((out - torch.from_numpy(noise)) ** 2).backward()
    grads = dict(model.named_parameters())
    return out, {name: grads[name].grad for name in NAMED_GRADIENTS}


def _step_agreement(port, jax16, port32):
    """The output's and each named gradient's ``_agreement`` of a port step
    with JAX's ((output, gradients) pairs), and their mean corr."""
    found = {"output": _agreement(port[0], jax16[0], port32[0])}
    for name, path in NAMED_GRADIENTS.items():
        *keys, kind = path
        want = jax16[1]
        for key in keys:
            want = want[key]
        found[name] = _agreement(port[1][name], jax_params._to_torch(
            np.asarray(want), kind), port32[1][name])
    corr = float(np.mean([a["corr"] for a in found.values()]))
    return corr, found


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
    jmod = jdu.DiffusionUNet(in_channels=2, out_channels=1, inner_channel=32,
                             res_blocks=2, channel_mults=mults,
                             attn_res=attn, num_heads=4, dtype=BF16)

    def loss_fn(p):
        out, _ = jmod.apply({"params": p, "batch_stats": stats}, x, y, g,
                            train=True, mutable=["batch_stats"])
        return jnp.mean((out - noise) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    steps = {}
    for dtype in (torch.bfloat16, torch.float32):  # the port, its control
        model = port_palette_model(mults, attn, params, stats).train()
        model.compute_dtype = dtype
        steps[dtype] = _port_palette_step(model, x, y, g, noise)
    got = {dtype: _step_agreement(step, (out, grads), steps[torch.float32])
           for dtype, step in steps.items()}
    corr, found = got[torch.bfloat16]
    assert corr >= STEP_CORR and found["output"]["equal"] >= STEP_EQUAL, got
    corr, found = got[torch.float32]
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


def _jax_gan_step(family, module, dparams, loss_type, dtype):
    """The JAX package's ``loss_type`` GAN step of ``family`` at ``dtype``
    (its gradients returned) and the generator's train-mode prediction,
    compiled together: ``fn(state, variables, x, y) -> (metrics, pred)``."""
    from pai_tpu.models import Discriminator as JaxDiscriminator
    from pai_tpu.train import steps as jsteps

    gen = module.clone(dtype=dtype)
    step = jsteps.make_gan_train_step(
        gen, JaxDiscriminator(dtype=dtype) if loss_type == "gan" else None,
        loss_type, compute_metrics=False, with_grads=True)

    def run(state, variables, x, y):
        _, found = step(state, x, y, jax.random.key(0))
        pred, _ = gen.apply(variables, x, train=True,
                            mutable=["batch_stats"])
        return found, pred

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _gan_step_inputs(family, mults, seed):
    """(module, params, batch_stats, PatchGAN params, (x, y)) of a step
    test, made once per module for the tests that share them."""
    return (*generator_numpy_variables(family, mults, 32, seed),
            discriminator_numpy_params(6), gan_batches(7, 1)[0])


def _gan_step_readings(family, mults, loss_type, grads, seed=5):
    """One ``loss_type`` GAN step of ``family`` at ``mults`` on 32x32: the
    JAX package's at bfloat16, the port's at bfloat16 and at float32 (the
    control, and the float32 result the errors are taken from: the port's
    float32 steps are held to the JAX package's within 1e-4 by
    ``tests/test_torch_port_gan_train.py`` and
    ``tests/test_torch_port_families_train.py``, so no JAX float32 step is
    compiled here). Per dtype of the port ``(corr, found, losses)``: the
    mean error cosine over the prediction and the ``grads`` (network ->
    port name -> flax path and kind), each one's ``_agreement``, and each
    loss's difference over its gap."""
    module, params, stats, dparams, (x, y) = _gan_step_inputs(family,
                                                              mults, seed)
    jax_found, jax_pred = jax.device_get(_jax_gan_step(
        family, module, dparams, loss_type, BF16)(
        jax_gan_state(params, stats, dparams, loss_type),
        {"params": params, "batch_stats": stats}, x, y))
    keys = ("loss", "d_loss") if loss_type == "gan" else ("loss",)

    def port_step(dtype):
        gen, disc = port_gan_models(params, stats, dparams, mults,
                                    family=family)
        gen.compute_dtype = disc.compute_dtype = dtype
        preds = []
        gen.register_forward_hook(lambda m, a, out: preds.append(out))
        state = tsteps.init_gan_state(gen, disc, loss_type, use_ema=False)
        _, got = tsteps.make_gan_train_step(
            gen, state.discriminator, loss_type, compute_metrics=False,
            with_grads=True)(state, torch.from_numpy(x), torch.from_numpy(y))
        return preds[0], got

    port32 = port_step(torch.float32)

    def readings(pred, got):
        found = {"output": _agreement(pred, jax_pred, port32[0])}
        for key, names in grads.items():
            for name, path in names.items():
                *keys_, kind = path
                want = jax_found[key]
                for k in keys_:
                    want = want[k]
                found[name] = _agreement(
                    got[key][name], jax_params._to_torch(np.asarray(want),
                                                         kind),
                    port32[1][key][name])
        corr = float(np.mean([a["corr"] for a in found.values()]))
        losses = {k: abs(float(got[k]) - float(jax_found[k]))
                  / abs(float(jax_found[k]) - float(port32[1][k]))
                  for k in keys}
        return corr, found, losses

    return readings(*port_step(torch.bfloat16)), readings(*port32)


def _gan_step_passes(corr, found, losses, bounds):
    min_corr, min_equal, max_loss_gap = bounds
    return (corr >= min_corr and found["output"]["equal"] >= min_equal
            and max(losses.values()) <= max_loss_gap)


def _gan_step_control_fails(corr, found, losses, bounds):
    """The float32 control fails every one of the three bounds."""
    min_corr, min_equal, max_loss_gap = bounds
    return (corr < min_corr and found["output"]["equal"] < min_equal
            and min(losses.values()) > max_loss_gap)


def test_gan_step_at_bf16_matches_jax():
    """One ``gan`` training step (train mode, the PatchGAN's update, the
    generator's loss against the updated PatchGAN): the prediction, named
    gradients of both networks and both losses (module docstring)."""
    port, control = _gan_step_readings("pix2pix", (1, 2, 4), "gan",
                                       GAN_GRADIENTS)
    bounds = (GAN_STEP_CORR, GAN_STEP_EQUAL, GAN_LOSS_GAP)
    assert _gan_step_passes(*port, bounds), port
    assert _gan_step_control_fails(*control, bounds), control


# ------------------------------------------ the other families, as a whole
FAMILY_MULTS = (1, 2, 4)  # three levels at 32x32
VIT_DIM, VIT_HEADS, VIT_FFN, VIT_TOKENS = 64, 8, 256, 8
VIT_BOUNDS = (0.99, 0.99)     # equal, corr: one ViT layer
FAMILY_BOUNDS = (0.1, 0.9)    # equal, corr: a family's forward


def _trans_layer_map():
    """(port member, flax path, kind) of one ViT layer."""
    dense = [conv_map(port, flax, "linear", ("Dense_0",)) for port, flax in
             (("self_attn.out_proj", "out_proj"), ("linear1", "ffn1"),
              ("linear2", "ffn2"))]
    norms = [(f"norm{i + 1}.{leaf}", (f"LayerNorm_{i}", "LayerNorm_0", key),
              "1d") for i in range(2)
             for leaf, key in (("weight", "scale"), ("bias", "bias"))]
    return [("self_attn.in_proj_weight", ("in_proj", "Dense_0", "kernel"),
             "linear"),
            ("self_attn.in_proj_bias", ("in_proj", "Dense_0", "bias"), "1d"),
            *dense[0], *dense[1], *dense[2], *norms]


def test_trans_unet_vit_layer_at_bf16_matches_jax():
    """One post-LN ViT layer of TransUNet (pai_tpu/models/trans_unet.py:
    59-102): the packed in-projection, attention with float32 logits and
    softmax, the output projection, the residual into LayerNorm, the MLP
    with the exact GELU, its residual into the second LayerNorm; 8 tokens
    of 64 in 8 heads, FFN 256 (module docstring's bounds)."""
    from pai_tpu.models.trans_unet import TransformerLayer as JaxLayer
    from pai_tpu_torch.models.trans_unet import TransformerLayer

    rng = np.random.default_rng(9)
    x = _bf16_input(rng, (2, VIT_TOKENS, VIT_DIM), 2.0)
    abstract = jax.eval_shape(lambda: JaxLayer(VIT_HEADS, VIT_FFN).init(
        jax.random.key(0), jnp.zeros(x.shape), False))
    params = numpy_tree_like(abstract["params"], rng, "params")
    want = _jit_apply(JaxLayer(VIT_HEADS, VIT_FFN, dtype=BF16),
                      {"params": params}, jnp.asarray(x).astype(BF16),
                      train=False)
    layer = TransformerLayer(VIT_DIM, VIT_HEADS, VIT_FFN).eval()
    load_flax_block(layer, _trans_layer_map(), params)
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):  # the port, its control
        with torch.no_grad(), torch.autocast(
                "cpu", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
            outs[dtype] = layer(torch.from_numpy(x.copy()).to(dtype))
        assert outs[dtype].dtype == dtype
    got = {dtype: _agreement(out, want, outs[torch.float32])
           for dtype, out in outs.items()}
    assert _passes(got[torch.bfloat16], *VIT_BOUNDS), got
    assert _fails(got[torch.float32], *VIT_BOUNDS), got


def _passes(a, min_equal, min_corr):
    return a["equal"] >= min_equal and a["corr"] >= min_corr


def _fails(a, min_equal, min_corr):
    """A control fails both bounds."""
    return a["equal"] < min_equal and a["corr"] < min_corr


@pytest.mark.parametrize("name", ["attention_unet", "resnext_unet"])
def test_family_forward_at_bf16_matches_jax(name):
    """The eval forward of the attention U-Net (the gates' product into the
    concatenation) and of the ResNeXt U-Net (the grouped convolution,
    BatchNorm and the residual sum), mults (1, 2, 4) on 32x32, against
    pai_tpu at bfloat16 (module docstring's bounds)."""
    module, params, stats = generator_numpy_variables(name, FAMILY_MULTS,
                                                      32, seed=21)
    x = np.random.default_rng(21).uniform(-1, 1, (2, 32, 32, 1)).astype(
        np.float32)
    want = _jit_apply(module.clone(dtype=BF16),
                      {"params": params, "batch_stats": stats}, x,
                      train=False)
    model = port_generator(name, FAMILY_MULTS,
                           generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(
        name, params, stats, mults_hparams(FAMILY_MULTS)), strict=True)
    model.eval()
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):  # the port, its control
        model.compute_dtype = dtype
        with torch.inference_mode():
            outs[dtype] = model(torch.from_numpy(x))
        assert outs[dtype].dtype == torch.float32
    got = {dtype: _agreement(out, want, outs[torch.float32])
           for dtype, out in outs.items()}
    assert _passes(got[torch.bfloat16], *FAMILY_BOUNDS), got
    assert _fails(got[torch.float32], *FAMILY_BOUNDS), got


# the attention U-Net's stem, second convolution, a gate's mask
# convolution and head, and the PatchGAN's first and last convolutions
ATTENTION_GRADIENTS = {
    "g_grads": {"encoders.0.weight": ("stem", "kernel", "conv"),
                "encoders.1.encode.1.weight": ("enc_1", "Conv_0", "kernel",
                                               "conv"),
                "attention_blocks.0.attention.0.weight": (
                    "gate_0", "attention", "kernel", "conv"),
                "decoders.2.weight": ("head", "kernel", "convt")},
    "d_grads": GAN_GRADIENTS["d_grads"],
}


@pytest.mark.parametrize("loss_type", ["gan", "ssim"])
def test_attention_unet_step_at_bf16_matches_jax(loss_type):
    """One training step of the attention U-Net at bfloat16, ``gan`` (the
    PatchGAN's update, then the generator against it) and ``ssim`` (the
    SSIM loss's scalar path on the prediction, its backward through the
    plain version as pai_tpu's ``custom_vjp`` recomputes it): the
    prediction, named gradients and the losses (module docstring)."""
    grads = ATTENTION_GRADIENTS if loss_type == "gan" else {
        "g_grads": ATTENTION_GRADIENTS["g_grads"]}
    port, control = _gan_step_readings("attention_unet", FAMILY_MULTS,
                                       loss_type, grads, seed=23)
    bounds = (GAN_STEP_CORR, GAN_STEP_EQUAL, GAN_LOSS_GAP)
    assert _gan_step_passes(*port, bounds), port
    assert _gan_step_control_fails(*control, bounds), control
