"""pai_tpu_torch.diffusion vs pai_tpu.diffusion: schedules, the Gaussian
reverse distributions and the DDPM sampler, fed the same numpy-made weights,
inputs, ``y_T`` and per-step noise on the CPU.

Schedules agree to the last bit in float64 and within 1e-7 as float32 tensors;
the distributions within 1e-5; a whole 8-step chain through the tiny UNet
within 1e-4 (each step's float32 forward differs by ~1e-5 and the chain
contracts towards the clamped x0 estimate)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu.diffusion import gaussian as jg
from pai_tpu.diffusion import sampler as js
from pai_tpu.diffusion import schedule as jsched
from pai_tpu_torch.diffusion import gaussian as tg
from pai_tpu_torch.diffusion import sampler as ts
from pai_tpu_torch.diffusion import schedule as tsched
from torch_port_util import palette_numpy_variables, port_palette_model


@pytest.mark.parametrize("kind,steps", [("linear", 2000), ("cosine", 100),
                                        ("cosine", 8)])
def test_schedules_match_jax(kind, steps):
    betas = {"linear": (tsched.linear_beta_schedule,
                        jsched.linear_beta_schedule),
             "cosine": (tsched.cosine_beta_schedule,
                        jsched.cosine_beta_schedule)}[kind]
    ours, theirs = betas[0](steps), betas[1](steps)
    assert ours.dtype == np.float64
    np.testing.assert_array_equal(ours, theirs)
    got, want = tsched.make_schedule(kind, steps), \
        jsched.make_schedule(kind, steps)
    assert got.timesteps == want.timesteps == steps
    for name in ("alphas", "gammas", "gammas_prev"):
        tensor = getattr(got, name)
        assert tensor.dtype == torch.float32 and tensor.shape == (steps,)
        np.testing.assert_allclose(tensor.numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-7)
    assert float(got.gammas_prev[0]) == 1.0
    with pytest.raises(ValueError, match="not supported"):
        tsched.make_schedule("sigmoid", 10)


def test_cosine_schedule_is_not_squared():
    """The reference's cosine schedule uses cos, not cos^2."""
    betas = tsched.cosine_beta_schedule(100)
    x = np.linspace(0, 100, 101)
    g = np.cos((np.pi / 2) * ((x / 100) + 0.008) / 1.008)
    np.testing.assert_allclose(betas, np.clip(1 - g[1:] / g[:-1], 1e-4,
                                              0.9999), rtol=1e-12)


@pytest.mark.parametrize("learn_var", [False, True])
def test_p_and_q_mean_variance_match_jax(learn_var):
    rng = np.random.default_rng(0)
    got_s, want_s = tsched.make_schedule("cosine", 100), \
        jsched.make_schedule("cosine", 100)
    y_t = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    y_0 = rng.uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32)
    out = rng.normal(size=(3, 8, 8, 2 if learn_var else 1)).astype(np.float32)
    t = np.array([0, 57, 99], np.int32)

    want = jg.p_mean_variance(want_s, jnp.asarray(out), jnp.asarray(y_t),
                              jnp.asarray(t), learn_var)
    got = tg.p_mean_variance(got_s, torch.from_numpy(out),
                             torch.from_numpy(y_t),
                             torch.from_numpy(t).long(), learn_var)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # a Python int step (what the sampler passes) is the same function
    for i, step in enumerate(t):
        mean, logvar = tg.p_mean_variance(
            got_s, torch.from_numpy(out[i:i + 1]),
            torch.from_numpy(y_t[i:i + 1]), int(step), learn_var)
        assert torch.equal(mean, got[0][i:i + 1])
        assert torch.equal(logvar.expand(got[1][i:i + 1].shape),
                           got[1][i:i + 1])

    want = jg.q_mean_variance(want_s, jnp.asarray(y_0), jnp.asarray(y_t),
                              jnp.asarray(t))
    got = tg.q_mean_variance(got_s, torch.from_numpy(y_0),
                             torch.from_numpy(y_t),
                             torch.from_numpy(t).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("learn_var", [False, True])
def test_ddpm_sample_matches_jax_with_the_same_draws(learn_var):
    steps, size = 8, 16
    module, params, stats = palette_numpy_variables(
        (1, 2), (2,), size, seed=1, learn_var=learn_var)
    model = port_palette_model((1, 2), (2,), params, stats, learn_var)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, size, size, 1)).astype(np.float32)
    y_T = rng.normal(size=x.shape).astype(np.float32)
    noise = rng.normal(size=(steps,) + x.shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}

    want_y, want_frames = js.ddpm_sample(
        jsched.make_schedule("cosine", steps),
        lambda c, y, g: module.apply(variables, c, y, g, train=False),
        jnp.asarray(x), jax.random.key(0), learn_var, capture_every=3,
        y_T=jnp.asarray(y_T), step_noise=jnp.asarray(noise))
    got_y, got_frames = ts.ddpm_sample(
        tsched.make_schedule("cosine", steps), model, torch.from_numpy(x),
        None, learn_var, capture_every=3, y_T=torch.from_numpy(y_T),
        step_noise=torch.from_numpy(noise))
    # y_T, then y_{t-1} at t = 6, 3, 0
    assert got_frames.shape == (2, 4, size, size, 1) == want_frames.shape
    assert float(np.abs(np.asarray(want_y)).mean()) > 0.05
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(want_frames),
                               rtol=0, atol=1e-4)
    assert torch.equal(got_frames[:, 0], torch.from_numpy(y_T))
    assert torch.equal(got_frames[:, -1], got_y)
    # without capture: the same y_0, alone
    alone = ts.ddpm_sample(
        tsched.make_schedule("cosine", steps), model, torch.from_numpy(x),
        None, learn_var, y_T=torch.from_numpy(y_T),
        step_noise=torch.from_numpy(noise))
    assert torch.equal(alone, got_y)


def test_sampler_draws_from_the_generator_and_masks_the_last_two_steps():
    """No model needed: a denoiser that returns zeros. The same seed gives
    the same bits; noise enters at every step but t = 1 and t = 0."""
    sched = tsched.make_schedule("cosine", 6)
    x = torch.zeros(2, 4, 4, 1)
    seen = []

    def denoise(c, y_t, gamma):
        assert gamma.shape == (2,)
        seen.append(float(gamma[0]))
        return torch.zeros_like(y_t)

    a = ts.ddpm_sample(sched, denoise, x, torch.Generator().manual_seed(3))
    b = ts.ddpm_sample(sched, denoise, x, torch.Generator().manual_seed(3))
    c = ts.ddpm_sample(sched, denoise, x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_allclose(seen[:6], sched.gammas.numpy()[::-1])
    # with all-zero step noise the chain is deterministic given y_T; adding
    # noise only at the masked steps t <= 1 must change nothing
    y_T = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    quiet = torch.zeros((6,) + tuple(x.shape))
    loud_tail = quiet.clone()
    loud_tail[4:] = 10.0  # steps t = 1 and t = 0
    loud_head = quiet.clone()
    loud_head[3] = 10.0   # step t = 2
    base = ts.ddpm_sample(sched, denoise, x, y_T=y_T, step_noise=quiet)
    assert torch.equal(
        ts.ddpm_sample(sched, denoise, x, y_T=y_T, step_noise=loud_tail), base)
    assert not torch.equal(
        ts.ddpm_sample(sched, denoise, x, y_T=y_T, step_noise=loud_head), base)


def test_capture_frames_for_the_100_step_chain():
    """F = 9 for 100 steps captured every 100 // 7 = 14: y_T, then t = 98,
    84, ..., 0 — computed without running a model."""
    steps = ts.capture_steps(100, 100 // 7)
    assert steps == [98, 84, 70, 56, 42, 28, 14, 0]
    assert 1 + len(steps) == 9
    keep = [t for t in range(99, -1, -1) if t % 14 == 0]  # the JAX rule
    assert steps == keep
    assert ts.capture_steps(8, 8 // 7) == list(range(7, -1, -1))
