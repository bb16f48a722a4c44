"""The flash-attention backward of pai_tpu_torch vs pai_tpu: the plain
version of the two backward kernels and ``FlashAttention``'s gradients
against ``jax.grad`` of the JAX ``flash_attention`` (its ``custom_vjp``, whose
backward is ``_flash_backward``: the Pallas kernels, in interpret mode), and
what the wrapper decides in Python (shapes, strides, what raises, the
operations it reports).

Inputs are numpy-made and handed to both frameworks. Tolerance 1e-5 relative
to each gradient's largest magnitude: float32 throughout, the same formulas
summed in other orders."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu_torch import kernels
from pai_tpu_torch.kernels import flash_attention as fa

TOL = 1e-5


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 1.0, shape).astype(np.float32) for _ in range(n)]


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(scale, 1.0))


# T = 256 / 512, D = 32 / 64; T = 2048: two 1,024-row blocks per side in both
# the plain version and the Pallas kernels (the accumulation across blocks)
SHAPES = [(1, 2, 256, 32), (2, 1, 512, 64), (1, 1, 2048, 32)]


@functools.lru_cache(maxsize=None)
def _jax_reference(shape):
    """numpy ``(q, k, v, g)``, the JAX forward's ``(o, lse)`` and
    ``jax.grad`` of ``sum(flash_attention(q, k, v) * g)``, both Pallas
    kernels in interpret mode. The ``custom_vjp``'s backward rule is
    ``_flash_backward(q, k, v, o, lse, g)``: these gradients are what its
    two kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) return."""
    from pai_tpu import kernels as jax_kernels
    from pai_tpu.kernels.flash_attention import (_flash_forward_with_lse,
                                                 flash_attention)

    q, k, v, g = _arrays(shape, 0)
    jax_kernels.set_interpret(True)
    try:
        o, lse = _flash_forward_with_lse(*map(jnp.asarray, (q, k, v)))
        grads = jax.grad(
            lambda a, b, c: jnp.sum(flash_attention(a, b, c) * g),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    finally:
        jax_kernels.set_interpret(False)
    b, h, t, _ = shape
    return ((q, k, v, g), np.array(o), np.array(lse)[:, :, 0].reshape(b * h, t),
            [np.array(x) for x in grads])


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_the_pallas_kernels(shape):
    (q, k, v, g), o, lse, want = _jax_reference(shape)
    args = [torch.from_numpy(a) for a in (q, k, v, o, lse, g)]
    got = fa.flash_attention_backward_plain(*args)
    for dx, want_dx in zip(got, want):
        assert dx.shape == shape and dx.dtype == torch.float32
        _close(dx.numpy(), want_dx)
    # a CPU tensor takes the plain version through the wrapper, bit for bit
    for dx, same in zip(got, fa.flash_attention_backward(*args)):
        assert torch.equal(dx, same)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_jax_grad_of_the_custom_vjp(shape):
    (q, k, v, g), _, _, want = _jax_reference(shape)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    for leaf, want_dx in zip((tq, tk, tv), want):
        _close(leaf.grad.numpy(), want_dx)


def test_packed_views_and_bfloat16():
    """Gradients of q, k, v taken as views of one packed (N, T, heads, 3, D)
    tensor, the way AttentionBlock hands them over, land in the packed
    tensor's gradient as the contiguous copies' do; bfloat16 operands compute
    in float32 and round once."""
    rng = np.random.default_rng(2)
    packed = torch.from_numpy(rng.normal(0, 1, (1, 256, 2, 3, 32)).astype(
        np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(0, 1, (1, 2, 256, 32)).astype(np.float32))
    views = [packed[:, :, :, i].permute(0, 2, 1, 3) for i in range(3)]
    fa.flash_attention(*views).backward(g)
    copies = [x.detach().contiguous().requires_grad_(True) for x in views]
    fa.flash_attention(*copies).backward(g)
    for i, copy in enumerate(copies):
        assert torch.equal(packed.grad[:, :, :, i].permute(0, 2, 1, 3),
                           copy.grad)

    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _arrays((1, 1, 256, 32), 3))
    o, lse = fa.flash_attention(q, k, v, emit_lse=True)
    got = fa.flash_attention_backward(q, k, v, o, lse, do)
    want = fa.flash_attention_backward_plain(q.float(), k.float(), v.float(),
                                             o.float(), lse, do.float())
    for dx, want_dx in zip(got, want):
        assert dx.dtype == torch.bfloat16
        assert torch.equal(dx, want_dx.bfloat16())


def test_shapes_that_must_raise_still_raise():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays((1, 1, 128, 48), 4))
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, k, v)
    q, k, v, g = (torch.from_numpy(a) for a in _arrays((1, 1, 128, 32), 4))
    o, lse = fa.flash_attention(q, k, v, emit_lse=True)
    leaf = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="not differentiable"):
        fa.flash_attention(leaf, k, v, emit_lse=True)
    with torch.no_grad():  # lse with no gradient wanted is fine
        assert fa.flash_attention(leaf, k, v, emit_lse=True)[1].shape == \
            (1, 128)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_backward(q, k, v, o, lse[:, :64], g)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_backward(q, k, v, o, lse.double(), g)
    with pytest.raises(ValueError, match="do must match"):
        fa.flash_attention_backward(q, k, v, o, lse, g[:, :, :64])
    with pytest.raises(ValueError, match="o must match"):
        fa.flash_attention_backward(q, k, v, o.bfloat16(), lse, g)
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention_backward_plain(q[:, :, :100], k[:, :, :100],
                                          v[:, :, :100], o[:, :, :100],
                                          lse[:, :100], g[:, :, :100])


def test_backward_operations_launch_counters_and_source():
    """On the card the wrapper adds 6*B*H*T*T*D (dq: the logits, dO V^T and
    dS K) and 8*B*H*T*T*D (dkv: the same two, P^T dO and dS^T Q) to
    ``kernels.launched_flops``; the CPU launches nothing."""
    assert fa.flash_attention_backward_flops((4, 4, 16384, 64)) == (
        6 * 16 * 16384 ** 2 * 64, 8 * 16 * 16384 ** 2 * 64)
    assert kernels.SOURCES["flash_attention_bwd"] == "flash_attention_bwd.cu"
    q, k, v, g = (torch.from_numpy(a).requires_grad_(True)
                  for a in _arrays((1, 1, 128, 32), 5))
    before = dict(kernels.launch_counts)
    fa.flash_attention(q, k, v).backward(g.detach())
    assert kernels.launch_counts == before
    assert before["flash_bwd_dq"] == before["flash_bwd_dkv"] == 0
