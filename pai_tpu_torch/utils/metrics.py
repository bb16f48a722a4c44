"""SSIM / PSNR / MSE / RMSE with torchmetrics-0.11 functional semantics,
counterpart of ``pai_tpu/utils/metrics.py``.

* SSIM: 11x11 Gaussian window (sigma 1.5), k1 = 0.01, k2 = 0.03, reflect pad
  by 5, VALID windows so the similarity map is full resolution; the scalar is
  the mean over the map cropped by the pad on each side.
* PSNR: ``10 * log10(data_range^2 / mean_sq_err)`` over the whole tensor.
* MSE / RMSE: plain mean squared error.

The whole-batch reductions (``ssim``, ``psnr``, ``mse``, ``rmse``) are the
global batch's when a mesh with a 'dp' axis is installed
(``pai_tpu_torch.parallel.context``), as the JAX functions are on a
dp-sharded array; the per-image ones are this rank's rows.

Everything is NHWC on ``torch`` tensors and stays on the tensors' device. On a
CUDA tensor the two SSIM functions launch the hand-written kernels of
``pai_tpu_torch.kernels.ssim`` (or raise); on a CPU tensor they take the plain
version there. No input shape sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch

from pai_tpu_torch.parallel.mesh import dp_mean
from pai_tpu_torch.kernels.ssim import (
    ssim_bands_fused,
    ssim_parts_fused,
    ssim_parts_plain,
    ssim_per_image_fused,
    ssim_report_fused,
)

__all__ = [
    "ssim_parts", "ssim_parts_plain", "ssim_report", "ssim_per_image", "ssim",
    "psnr",
    "psnr_per_image", "mse", "mse_per_image", "rmse", "depth_ssim_per_image",
    "depth_ssim",
]


def ssim_parts(pred, target, data_range: float = 1.0, kernel_size: int = 11,
               sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """``(per_image_ssim [N], full_image_map [N,H,W,C])``, torchmetrics
    ``_ssim_update``. Kernel ``ssim_map`` on a CUDA tensor; gradients
    recompute through ``ssim_parts_plain``."""
    return ssim_parts_fused(pred, target, data_range, kernel_size, sigma,
                            k1, k2)


def ssim_report(pred, target, num_depths: int = 16):
    """``(per_image [N], map [N,H,W,C], bands [N, bands])``: what a report
    keeps of SSIM, one ``ssim_map`` launch on a CUDA tensor. ``bands`` are
    ``depth_ssim_per_image``'s."""
    return ssim_report_fused(pred, target, num_depths)


def ssim_per_image(pred, target, data_range: float = 1.0):
    """Per-image scalar SSIM [N]. Kernel ``ssim_scalar`` on a CUDA tensor (no
    padded copy, no map); gradients recompute through ``ssim_parts_plain``."""
    return ssim_per_image_fused(pred, target, data_range)


def ssim(pred, target, data_range: float = 1.0):
    """Scalar SSIM, torchmetrics default elementwise-mean reduction (== mean
    of per-image means at equal image sizes); the global batch's under a dp
    mesh (``parallel.mesh.dp_mean``)."""
    return dp_mean(ssim_per_image(pred, target, data_range).mean())


def _sq_err(pred, target):
    return (pred.float() - target.float()) ** 2


def psnr(pred, target, data_range: float = 1.0):
    """Whole-tensor PSNR (torchmetrics default dim=None), from the global
    batch's MSE under a dp mesh."""
    return 10.0 * torch.log10(data_range ** 2 / mse(pred, target))


def psnr_per_image(pred, target, data_range: float = 1.0):
    """Per-image PSNR [N] (one psnr() call per image in the reference)."""
    return 10.0 * torch.log10(data_range ** 2 / mse_per_image(pred, target))


def mse(pred, target):
    """Whole-tensor MSE; the global batch's under a dp mesh."""
    return dp_mean(_sq_err(pred, target).mean())


def mse_per_image(pred, target):
    se = _sq_err(pred, target)
    return se.reshape(se.shape[0], -1).mean(dim=-1)


def rmse(pred, target):
    """torchmetrics mean_squared_error(squared=False)."""
    return torch.sqrt(mse(pred, target))


def depth_ssim_per_image(preds, targets, num_depths: int = 16):
    """Per-image SSIM over ``num_depths`` horizontal bands (depth axis = H)
    -> [N, bands]. torch.chunk semantics: ceil-sized bands, short last; a
    band of 10 rows or fewer raises ``ValueError``. Kernel ``ssim_scalar``
    on a CUDA tensor: one launch for every band (each band's mean is a mean
    over rows of the whole image's interior, ``kernels.ssim.band_interiors``);
    the band-by-band plain version on a CPU tensor."""
    return ssim_bands_fused(preds, targets, num_depths)


def depth_ssim(preds, targets, num_depths: int = 16):
    """[num_depths, 2] of (mean, std) of per-image SSIM per band; std is the
    unbiased (n-1) estimator like torch.std (0 for a single image)."""
    per = depth_ssim_per_image(preds, targets, num_depths)
    mean = per.mean(dim=0)
    n = per.shape[0]
    std = torch.sqrt(((per - mean[None, :]) ** 2).sum(dim=0) / max(n - 1, 1))
    return torch.stack([mean, std], dim=1)
