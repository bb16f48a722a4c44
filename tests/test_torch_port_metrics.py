"""pai_tpu_torch.utils.metrics (the module that holds both SSIM kernels) vs
pai_tpu.utils.metrics, vs the Pallas kernels run in interpret mode, and vs
the frozen torchmetrics goldens. The port runs on CPU tensors here and so
through the kernels' plain versions; the kernels themselves are held against
those plain versions on the card by chip_smoke.py.

Tolerances: per-image SSIM 1e-5 and the SSIM map 1e-4 (absolute, values in
[-1, 1]) — every side is float32, and the formulations sum the eleven taps in
a different order (explicit tap sums here; banded matrix products in the JAX
package, with the reflect taps folded at the borders in the Pallas map
kernel); the SSIM ratio amplifies that reordering noise where the local
variance is small. The measured differences are about ten times smaller."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pai_tpu.kernels import ssim_pallas
from pai_tpu.utils import metrics as jm
from pai_tpu_torch.kernels import ssim as port_ssim
from pai_tpu_torch.utils import metrics as tm

PER_IMAGE_TOL = 1e-5
MAP_TOL = 1e-4

GOLDENS = os.path.join(os.path.dirname(__file__), "fixtures",
                       "metric_goldens.npz")

# 64²; an odd size; one report depth band; and multi-channel
SHAPES = {"64sq": (3, 64, 64, 1), "37x53": (2, 37, 53, 1),
          "band": (2, 16, 256, 1), "rgb": (2, 48, 40, 3)}


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    # a correlated target, so SSIM is well away from zero
    target = np.clip(pred * 0.6 + 0.4 * rng.uniform(0, 1, shape), 0, 1
                     ).astype(np.float32)
    return pred, target


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_ssim_parts_matches_jax(case):
    p, t = _pair(SHAPES[case], seed=1)
    want_per, want_map = jm.ssim_parts_xla(jnp.asarray(p), jnp.asarray(t))
    got_per, got_map = tm.ssim_parts(torch.from_numpy(p),
                                     torch.from_numpy(t))
    assert got_map.shape == SHAPES[case]
    _close(got_per, want_per, PER_IMAGE_TOL)
    _close(got_map, want_map, MAP_TOL)
    # and through the JAX package's public dispatcher
    _close(got_per, jm.ssim_parts(jnp.asarray(p), jnp.asarray(t))[0],
           PER_IMAGE_TOL)
    _close(tm.ssim_per_image(torch.from_numpy(p), torch.from_numpy(t)),
           jm.ssim_per_image(jnp.asarray(p), jnp.asarray(t)), PER_IMAGE_TOL)


@pytest.mark.parametrize("case", ["64sq", "37x53", "band"])
def test_ssim_matches_pallas_kernels_in_interpret_mode(case):
    """The TPU kernels' own outputs (single channel, like the kernels)."""
    p, t = _pair(SHAPES[case], seed=2)
    k_per, k_map = ssim_pallas._fused_forward(jnp.asarray(p), jnp.asarray(t),
                                              interpret=True)
    k_scalar = ssim_pallas._scalar_forward(jnp.asarray(p), jnp.asarray(t),
                                           interpret=True)
    got_per, got_map = tm.ssim_parts(torch.from_numpy(p),
                                     torch.from_numpy(t))
    got_scalar = tm.ssim_per_image(torch.from_numpy(p), torch.from_numpy(t))
    _close(got_per, k_per, PER_IMAGE_TOL)
    _close(got_map, k_map, MAP_TOL)
    _close(got_scalar, k_scalar, PER_IMAGE_TOL)


def test_metrics_match_torchmetrics_goldens():
    """The frozen torchmetrics-0.11 goldens (NCHW in the file)."""
    goldens = np.load(GOLDENS)
    for i in range(int(goldens["n_cases"])):
        a = torch.from_numpy(goldens[f"case{i}_a"]).permute(0, 2, 3, 1)
        b = torch.from_numpy(goldens[f"case{i}_b"]).permute(0, 2, 3, 1)
        per_image, full = tm.ssim_parts(a, b)
        _close(per_image, goldens[f"case{i}_ssim_per_image"], PER_IMAGE_TOL)
        _close(full.permute(0, 3, 1, 2), goldens[f"case{i}_ssim_full"],
               MAP_TOL)
        assert float(tm.ssim(a, b)) == pytest.approx(
            float(goldens[f"case{i}_ssim"]), abs=PER_IMAGE_TOL), i
        if f"case{i}_psnr" in goldens:
            assert float(tm.psnr(a, b)) == pytest.approx(
                float(goldens[f"case{i}_psnr"]), abs=1e-3), i
        assert float(tm.mse(a, b)) == pytest.approx(
            float(goldens[f"case{i}_mse"]), rel=1e-5), i
        assert float(tm.rmse(a, b)) == pytest.approx(
            float(goldens[f"case{i}_rmse"]), rel=1e-5), i


@pytest.mark.parametrize("name", ["ssim", "psnr", "psnr_per_image", "mse",
                                  "mse_per_image", "rmse"])
def test_scalar_metrics_match_jax(name):
    p, t = _pair((3, 32, 40, 1), seed=3)
    want = getattr(jm, name)(jnp.asarray(p), jnp.asarray(t))
    got = getattr(tm, name)(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# 256 rows -> 16 bands of 16, the report's case; 72 rows -> 6 even bands of
# 12; 71 rows -> torch.chunk's ceil-sized bands of 12 with a short last one
# of 11
@pytest.mark.parametrize("h,w,depths", [(256, 32, 16), (72, 24, 6),
                                        (71, 24, 6)])
def test_depth_ssim_matches_jax(h, w, depths):
    p, t = _pair((3, h, w, 1), seed=4)
    want_per = jm.depth_ssim_per_image(jnp.asarray(p), jnp.asarray(t), depths)
    got_per = tm.depth_ssim_per_image(torch.from_numpy(p),
                                      torch.from_numpy(t), depths)
    assert got_per.shape == want_per.shape
    _close(got_per, want_per, PER_IMAGE_TOL)
    want = jm.depth_ssim(jnp.asarray(p), jnp.asarray(t), depths)
    got = tm.depth_ssim(torch.from_numpy(p), torch.from_numpy(t), depths)
    _close(got, want, PER_IMAGE_TOL)


def test_depth_ssim_std_is_unbiased():
    p, t = _pair((4, 64, 24, 1), seed=5)
    per = tm.depth_ssim_per_image(torch.from_numpy(p), torch.from_numpy(t), 4)
    got = tm.depth_ssim(torch.from_numpy(p), torch.from_numpy(t), 4)
    _close(got[:, 1], per.numpy().std(axis=0, ddof=1), 1e-6)


@pytest.mark.parametrize("fn", ["ssim_per_image", "ssim_parts"])
def test_ssim_gradient_matches_jax(fn):
    """d(-mean per-image SSIM)/d pred through the port's autograd.Function
    (whose backward recomputes through the plain version) vs jax.grad."""
    p, t = _pair((2, 32, 32, 1), seed=6)
    want = jax.grad(lambda a: -jnp.mean(
        jm.ssim_parts_xla(a, jnp.asarray(t))[0]))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    out = getattr(tm, fn)(pt, torch.from_numpy(t))
    per_image = out if fn == "ssim_per_image" else out[0]
    assert per_image.grad_fn is not None
    assert "Ssim" in type(per_image.grad_fn).__name__
    (-per_image.mean()).backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)


def test_ssim_map_gradient_matches_plain_version():
    """A cotangent on the map as well as on the scalar."""
    p, t = _pair((1, 24, 20, 2), seed=7)
    weight = torch.from_numpy(_pair((1, 24, 20, 2), seed=8)[0])
    grads = []
    for f in (tm.ssim_parts, port_ssim.ssim_parts_plain):
        pt = torch.from_numpy(p).requires_grad_(True)
        tt = torch.from_numpy(t).requires_grad_(True)
        per_image, full = f(pt, tt)
        (per_image.sum() + (full * weight).sum()).backward()
        grads.append((pt.grad, tt.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-8)


def test_gaussian_taps_match_jax():
    np.testing.assert_array_equal(port_ssim.gaussian_1d(),
                                  jm._gaussian_1d(11, 1.5))


def test_small_images_and_mismatched_shapes_raise():
    small = torch.zeros(1, 10, 32, 1)
    with pytest.raises(ValueError, match="above 10"):
        tm.ssim_parts(small, small)
    with pytest.raises(ValueError, match="above 10"):
        tm.ssim_per_image(small.permute(0, 2, 1, 3), small.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="one shape"):
        tm.ssim_parts(torch.zeros(1, 16, 16, 1), torch.zeros(1, 16, 17, 1))


def test_cpu_tensors_launch_no_kernel():
    from pai_tpu_torch import kernels

    before = dict(kernels.launch_counts)
    p, t = _pair((1, 16, 16, 1), seed=9)
    tm.ssim_parts(torch.from_numpy(p), torch.from_numpy(t))
    tm.ssim_per_image(torch.from_numpy(p), torch.from_numpy(t))
    assert kernels.launch_counts == before
    assert set(before) == {"ssim_map", "ssim_scalar", "flash_fwd"}
