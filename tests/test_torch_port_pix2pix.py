"""pai_tpu_torch.models.pix2pix vs pai_tpu.models.Pix2PixUnet: numpy-made
weights and non-trivial BatchNorm running statistics carried across with
``pai_tpu_torch.interop.jax_params``, eval-mode forward on the CPU.

Forward tolerance 1e-4 (absolute, outputs in [-1, 1]): float32 convolutions
summed in a different order through up to ten layers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu_torch.interop import jax_from_state_dict, state_dict_from_jax
from pai_tpu_torch.models import GENERATOR_NAMES, build_generator
from pai_tpu_torch.models.pix2pix import dropout_for_level
from pai_tpu_torch.utils.flops import parameter_count
from torch_port_util import pix2pix_numpy_variables

FULL_MULTS = (1, 2, 4, 8, 8, 8, 8, 8)


def _hparams(mults):
    return {"channel_mults": ",".join(str(m) for m in mults)}


def _port_model(mults, params, stats):
    model = build_generator("pix2pix", channel_mults=mults,
                            generator=torch.Generator().manual_seed(0))
    model.load_state_dict(
        state_dict_from_jax("pix2pix", params, stats, _hparams(mults)),
        strict=True)
    return model.eval()


# (1,2): the smallest net; (1,2,4,8,8) at 32²: reaches the norm-less 1x1
# innermost level and the widest-decoder (dropout) branch.
@pytest.mark.parametrize("mults", [(1, 2), (1, 2, 4, 8, 8)])
def test_forward_matches_jax(mults):
    module, params, stats = pix2pix_numpy_variables(mults, 32, seed=4)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 1)
                                         ).astype(np.float32)
    want = np.asarray(jax.jit(module.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False))
    model = _port_model(mults, params, stats)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 1) and got.dtype == torch.float32
    assert got.is_contiguous()
    # not a vacuous comparison: a spread of unsaturated values
    assert 0.05 < float(np.abs(want).mean()) < 0.9
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mults", [(1, 2), (1, 2, 4, 8, 8)])
def test_state_dict_round_trip_and_reference_layout(mults):
    """jax -> port -> jax is the identity, and the port's own copy of the
    layout rules agrees with the JAX package's exporter (whose names carry a
    ``unet.`` prefix)."""
    from pai_tpu.interop.torch_import import export_lightning_state_dict

    _, params, stats = pix2pix_numpy_variables(mults, 32, seed=6)
    sd = state_dict_from_jax("pix2pix", params, stats, _hparams(mults))

    params_back, stats_back = jax_from_state_dict("pix2pix", sd,
                                                  _hparams(mults))
    for tree, back in ((params, params_back), (stats, stats_back)):
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        assert flat.keys() == flat_back.keys()
        for key in flat:
            np.testing.assert_array_equal(flat[key], flat_back[key])

    exported = export_lightning_state_dict("pix2pix", params, stats,
                                           _hparams(mults))
    assert {f"unet.{k}" for k in sd} == set(exported)
    for name, tensor in sd.items():
        np.testing.assert_array_equal(tensor.numpy(),
                                      exported[f"unet.{name}"])


def test_full_width_structure_matches_jax_without_compute():
    """At mults (1,2,4,8,8,8,8,8) the port's module, built on the ``meta``
    device, has the JAX package's parameter count, and every tensor a
    conversion would produce has the shape the module expects."""
    from pai_tpu.models import build_generator as jax_build
    from pai_tpu.utils.flops import parameter_count as jax_parameter_count

    module = jax_build("pix2pix", channel_mults=FULL_MULTS)
    abstract = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.zeros((1, 256, 256, 1)),
                            train=False))
    model = build_generator("pix2pix", channel_mults=FULL_MULTS,
                            device="meta")
    assert parameter_count(model) == jax_parameter_count(abstract["params"])
    assert parameter_count(model) == 54_413_313

    # shapes only: broadcast zero-strided arrays stand in for the weights
    def stand_in(tree):
        return jax.tree.map(
            lambda s: np.lib.stride_tricks.as_strided(
                np.zeros((), np.float32), s.shape, (0,) * len(s.shape)),
            tree)

    sd = state_dict_from_jax("pix2pix", stand_in(abstract["params"]),
                             stand_in(abstract["batch_stats"]),
                             _hparams(FULL_MULTS))
    expected = model.state_dict()
    assert sd.keys() == expected.keys()
    for name, tensor in sd.items():
        assert tuple(tensor.shape) == tuple(expected[name].shape), name


def test_parameter_names_are_the_reference_ones():
    model = build_generator("pix2pix", channel_mults=(1, 2, 4), device="meta")
    names = set(model.state_dict())
    for name in ("encoders.0.weight", "encoders.0.bias",
                 "encoders.1.encode.1.weight",
                 "encoders.1.encode.2.running_mean",
                 "decoders.0.decode.1.weight", "decoders.0.decode.2.bias",
                 "decoders.2.weight"):
        assert name in names, name
    # innermost encoder has no norm
    assert not any(n.startswith("encoders.2.encode.2") for n in names)
    sd = model.state_dict()
    assert tuple(sd["encoders.1.encode.1.weight"].shape) == (128, 64, 4, 4)
    assert tuple(sd["decoders.1.decode.1.weight"].shape) == (256, 64, 4, 4)


def test_dropout_for_level_matches_jax():
    from pai_tpu.models.pix2pix import dropout_for_level as jax_rule

    for mults in (FULL_MULTS, (1, 2), (1, 2, 4, 8, 8)):
        for level, mult in enumerate(mults):
            assert dropout_for_level(level, mult, mults, 0.5) == \
                jax_rule(level, mult, mults, 0.5)


def test_registry_builds_pix2pix_and_names_the_roadmap_for_the_rest():
    """Every name builds the class the JAX registry builds for it; none is
    left to a later ROADMAP item. TransUNet refuses the CLI default of eight
    levels, as the JAX package does."""
    from pai_tpu.models import GENERATOR_NAMES as JAX_NAMES
    from pai_tpu.models import build_generator as jax_build_generator

    assert GENERATOR_NAMES == JAX_NAMES
    for name in GENERATOR_NAMES:
        built = build_generator(name, channel_mults=(1, 2), device="meta")
        want = jax_build_generator(name, channel_mults=(1, 2))
        assert type(built).__name__ == type(want).__name__, name
    with pytest.raises(ValueError, match="incompatible with patch_size"):
        build_generator("trans_unet", device="meta")
    with pytest.raises(ValueError):
        build_generator("nope")


def test_bf16_policy_keeps_float32_params_and_output():
    model = build_generator("pix2pix", channel_mults=(1, 2),
                            dtype=torch.bfloat16,
                            generator=torch.Generator().manual_seed(0)).eval()
    ref = build_generator("pix2pix", channel_mults=(1, 2),
                          generator=torch.Generator().manual_seed(0)).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.rand(1, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out, want = model(x), ref(x)
    assert out.dtype == torch.float32
    # bfloat16 keeps 8 bits of mantissa
    assert float((out - want).abs().max()) < 2e-2
