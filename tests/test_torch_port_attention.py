"""pai_tpu_torch attention vs pai_tpu: the plain (blockwise) version of the
flash-attention kernel against the Pallas kernel in interpret mode and
against full-softmax attention, the dispatcher against the JAX dispatcher on
both sides of the 4,096-token threshold, and everything the wrapper decides in
Python (shapes, strides, what raises, the operations it reports).

Inputs are numpy-made and handed to both frameworks. Tolerance 5e-5 (the JAX
package's own for the kernel): float32 throughout, summed in other orders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pai_tpu_torch import kernels
from pai_tpu_torch.kernels import flash_attention as fa
from pai_tpu_torch.ops import attention as port_attention
from pai_tpu_torch.utils.flops import count_flops

TOL = 5e-5


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 1.0, shape).astype(np.float32) for _ in range(3)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


# single block (T = 1024), and 2 x 2 blocks (T = 2048): the rescaling of the
# running maximum and denominator between K/V blocks
@pytest.mark.parametrize("shape", [(1, 2, 1024, 64), (1, 1, 2048, 32)])
def test_plain_version_matches_the_pallas_kernel(shape):
    from pai_tpu.kernels.flash_attention import _flash_forward

    arrays = _qkv(shape, 0)
    want = np.asarray(_flash_forward(*_jax(arrays), interpret=True))
    got = fa.flash_attention_plain(*_torch(arrays))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # a CPU tensor takes the plain version through the wrapper, bit for bit
    assert torch.equal(fa.flash_attention(*_torch(arrays)), got)


def test_plain_version_lse_matches_the_pallas_kernel():
    from pai_tpu.kernels.flash_attention import _flash_forward_with_lse

    shape = (1, 2, 2048, 32)
    arrays = _qkv(shape, 1)
    want_o, want_lse = _flash_forward_with_lse(*_jax(arrays), interpret=True)
    got_o, got_lse = fa.flash_attention(*_torch(arrays), emit_lse=True)
    assert got_lse.shape == (2, 2048) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse)[:, :, 0], rtol=TOL,
                               atol=TOL)
    # and against the definition
    q, k, v = _torch(arrays)
    s = 32 ** -0.25
    logits = torch.matmul(q * s, (k * s).transpose(-1, -2))
    np.testing.assert_allclose(
        got_lse.numpy(), torch.logsumexp(logits, -1).reshape(2, 2048).numpy(),
        rtol=TOL, atol=TOL)


def test_plain_version_and_full_attention_match_jax_full_attention():
    from pai_tpu.ops.attention import _full_attention

    arrays = _qkv((2, 2, 1024, 32), 2)
    want = np.asarray(_full_attention(*_jax(arrays)))
    full = port_attention._full_attention(*_torch(arrays))
    plain = fa.flash_attention_plain(*_torch(arrays))
    np.testing.assert_allclose(full.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(plain.numpy(), want, rtol=TOL, atol=TOL)


def test_bfloat16_operands_compute_in_float32_and_round_once():
    q, k, v = (t.bfloat16() for t in _torch(_qkv((1, 1, 1024, 32), 3)))
    want = fa.flash_attention_plain(q.float(), k.float(), v.float())
    got = fa.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())
    full = port_attention._full_attention(q, k, v)
    assert full.dtype == torch.bfloat16
    assert float((full.float() - want).abs().max()) < 2.0 ** -8


# T = 1024 and 3072 (below the threshold), 4096 + 512 (not a multiple of
# 1024) take the full softmax; T = 4096 the flash path. B=1, H=1, D=8 keeps
# the short ones cheap; the flash path needs a head dim the kernel has.
@pytest.mark.parametrize("shape,flash", [((1, 1, 1024, 8), False),
                                         ((1, 1, 3072, 8), False),
                                         ((1, 1, 4608, 8), False),
                                         ((1, 1, 4096, 32), True)])
def test_dispatcher_matches_jax_on_both_sides_of_the_threshold(
        shape, flash, monkeypatch):
    from pai_tpu.ops.attention import multihead_attention

    calls = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    arrays = _qkv(shape, 4)
    want = np.asarray(multihead_attention(*_jax(arrays)))
    got = port_attention.multihead_attention(*_torch(arrays))
    assert bool(calls) == flash
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_strided_views_equal_contiguous_copies():
    """q, k, v as AttentionBlock hands them over: views of one packed
    (N, T, heads, 3, D) tensor."""
    rng = np.random.default_rng(5)
    packed = torch.from_numpy(
        rng.normal(0, 1, (2, 1024, 2, 3, 32)).astype(np.float32))
    q, k, v = (packed[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    assert not q.is_contiguous() and q.stride(3) == 1
    got, lse = fa.flash_attention(q, k, v, emit_lse=True)
    want, want_lse = fa.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), emit_lse=True)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    for name, x in (("q", q), ("k", k), ("v", v)):
        fa._check_strides(name, x)  # what the launcher accepts
    with pytest.raises(ValueError, match="contiguous along D"):
        fa._check_strides("q", q.transpose(2, 3))
    with pytest.raises(ValueError, match="multiples of 4"):
        fa._check_strides("q", torch.zeros(1, 1, 128, 33)[..., :32])


def test_bad_shapes_raise_on_any_device():
    ok = _torch(_qkv((1, 1, 128, 32), 6))
    assert fa.flash_attention(*ok).shape == (1, 1, 128, 32)
    for shape in [(1, 1, 128, 48), (1, 1, 128, 16), (1, 1, 192, 32),
                  (1, 1, 100, 64)]:
        with pytest.raises(ValueError):
            fa.flash_attention(*_torch(_qkv(shape, 6)))
        with pytest.raises(ValueError):
            fa.flash_attention_plain(*_torch(_qkv(shape, 6)))
    q, k, v = ok
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_attention(q, k[:, :, :64], v)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_attention(q[0], k[0], v[0])
    assert fa.HEAD_DIMS == (32, 64, 128, 256) and fa.BLOCK_Q == 128


def test_cpu_flop_count_equals_what_the_card_would_add():
    """On the CPU FlopCounterMode sees the plain version's two products; on
    the card the wrapper adds ``flash_attention_flops`` to
    ``kernels.launched_flops`` at launch. Both are 4*B*H*T*T*D."""
    shape = (1, 2, 1024, 32)
    tensors = _torch(_qkv(shape, 7))
    kernels.launched_flops = 123  # count_flops zeroes it
    counted = count_flops(fa.flash_attention, *tensors)
    assert counted == fa.flash_attention_flops(shape) == 4 * 2 * 1024**2 * 32
    assert kernels.launched_flops == 0  # nothing was launched on the CPU
    kernels.launched_flops = 10**9  # as a launch inside fn would leave it
    assert count_flops(lambda: None) == 0
    # the JAX kernel declares the same cost (flash_attention.py, cost_estimate)
    assert fa.flash_attention_flops((2, 4, 16384, 64)) == 4 * 2 * 4 * 16384**2 * 64
    assert "flash_fwd" in kernels.launch_counts
    assert kernels.SOURCES["flash_attention"] == "flash_attention.cu"
    assert kernels.launch_counts["flash_fwd"] == 0  # CPU runs launch nothing


def test_grad_flows_through_the_plain_version_on_the_cpu():
    """The card raises for tensors that require grad (no backward kernel
    yet); the CPU's plain version is ordinary differentiable PyTorch."""
    q, k, v = _torch(_qkv((1, 1, 128, 32), 8))
    q.requires_grad_(True)
    out = fa.flash_attention(q, k, v)
    out.square().sum().backward()
    ref = q.detach().clone().requires_grad_(True)
    port_attention._full_attention(ref, k, v).square().sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), ref.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
