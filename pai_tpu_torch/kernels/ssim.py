"""Fused windowed-SSIM: two CUDA kernels, their plain PyTorch version, and the
wrappers that choose between them by where the tensor lies.

torchmetrics SSIM semantics (11x11 Gaussian window, sigma 1.5, k1/k2 =
0.01/0.03, torch 'reflect' padding, full-resolution map, scalar = mean of the
map cropped by 5 on every side). Two entry points, NHWC like the JAX package:

* ``ssim_parts_fused(pred, target)`` -> ``(per_image [N], map [N,H,W,C])``.
  Kernel ``ssim_map`` (``csrc/ssim.cu::ssim_map_kernel``) replaces the TPU
  kernel ``pai_tpu/kernels/ssim_pallas.py::_ssim_map_kernel``: the reflect
  padding is folded into the blur's source index, so no padded copy exists.
  The interior mean is taken outside the kernel, as the JAX wrapper does.
* ``ssim_per_image_fused(pred, target)`` -> ``per_image [N]``. Kernel
  ``ssim_scalar`` (``ssim_scalar_kernel`` + ``ssim_finish_kernel``) replaces
  ``_ssim_scalar_kernel``: the interior crop removes exactly the pixels whose
  windows touch the padding, so it blurs VALID windows of the unpadded image
  and writes no map; the mean is part of the kernel (block partials, then a
  fixed-order finishing kernel).

Bound on an H100 (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s float32 on the CUDA
cores): bytes. Each pixel is read twice as float32 (and written once by the
map kernel) against about 240 float32 operations, so at (8,256,256,1) the card
needs about 1.9 us for the bytes and the same for the arithmetic, less than a
launch costs. The design keeps everything between the two reads and the one
write in shared memory and registers; measured times are in PERF.md.

Both kernels take any float dtype (cast to float32 first), any C (each
(image, channel) pair is one plane; the per-image mean runs over C x interior)
and any strides, so the row-band views ``depth_ssim_per_image`` makes are read
in place. ``H <= 10`` or ``W <= 10`` raises. A CUDA tensor with a window other
than 11 taps at sigma 1.5 raises: the kernels are built for that window.

Gradients: the JAX package has no backward kernel for SSIM, its ``custom_vjp``
recomputes through the plain formulation. The two ``autograd.Function``s here
do the same, so the forward is the kernel on the card and gradient numerics
are those of the plain version everywhere.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from pai_tpu_torch import kernels

KERNEL_SIZE = 11
SIGMA = 1.5
PAD = (KERNEL_SIZE - 1) // 2


@functools.lru_cache(maxsize=None)
def gaussian_1d(kernel_size: int = KERNEL_SIZE, sigma: float = SIGMA
                ) -> np.ndarray:
    """torchmetrics ``_gaussian``: dist = arange((1-k)/2, (1+k)/2),
    g ~ exp(-(d/s)^2/2), normalised; float32 throughout. Read-only."""
    dist = np.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0,
                     dtype=np.float32)
    g = np.exp(-((dist / sigma) ** 2) / 2.0)
    g = g / g.sum()
    g.setflags(write=False)
    return g


def _constants(data_range: float, k1: float, k2: float) -> Tuple[float, float]:
    return (k1 * data_range) ** 2, (k2 * data_range) ** 2


def _check_shapes(pred: torch.Tensor, target: torch.Tensor,
                  kernel_size: int) -> None:
    if pred.dim() != 4 or pred.shape != target.shape:
        raise ValueError(
            "ssim expects two (N, H, W, C) tensors of one shape, got "
            f"{tuple(pred.shape)} and {tuple(target.shape)}")
    if pred.shape[1] <= kernel_size - 1 or pred.shape[2] <= kernel_size - 1:
        raise ValueError(
            f"ssim needs H and W above {kernel_size - 1} (window "
            f"{kernel_size}), got {tuple(pred.shape)}")


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def _blur_valid(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable VALID blur over H and W of (N, H, W, C) as explicit float32
    tap sums — plain elementwise arithmetic, so it is true float32 on any
    device whatever the TF32 switches say."""
    k = len(taps)
    h_out = x.shape[1] - k + 1
    w_out = x.shape[2] - k + 1
    acc = float(taps[0]) * x[:, :, 0:w_out]
    for i in range(1, k):
        acc = acc + float(taps[i]) * x[:, :, i:i + w_out]
    out = float(taps[0]) * acc[:, 0:h_out]
    for i in range(1, k):
        out = out + float(taps[i]) * acc[:, i:i + h_out]
    return out


def ssim_parts_plain(pred: torch.Tensor, target: torch.Tensor,
                     data_range: float = 1.0, kernel_size: int = KERNEL_SIZE,
                     sigma: float = SIGMA, k1: float = 0.01, k2: float = 0.03
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain formulation (torchmetrics ``_ssim_update``): reflect-pad by
    (k-1)//2, blur the five stacked moment maps with VALID windows, evaluate
    the ratio at full resolution, scalar = mean over the map cropped by the
    pad. Differentiable; what both kernels are held against and what their
    backward passes recompute through."""
    _check_shapes(pred, target, kernel_size)
    pred = pred.float()
    target = target.float()
    pad = (kernel_size - 1) // 2
    c1, c2 = _constants(data_range, k1, k2)
    taps = gaussian_1d(kernel_size, sigma)

    def reflect(x):  # F.pad pads the last dims of NCHW
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                    (pad, pad, pad, pad), mode="reflect")
        return x.permute(0, 2, 3, 1)

    p = reflect(pred)
    t = reflect(target)
    stacked = torch.cat([p, t, p * p, t * t, p * t], dim=-1)
    blurred = _blur_valid(stacked, taps)
    mu_p, mu_t, e_pp, e_tt, e_pt = blurred.chunk(5, dim=-1)
    mu_p_sq = mu_p * mu_p
    mu_t_sq = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sigma_p = e_pp - mu_p_sq
    sigma_t = e_tt - mu_t_sq
    sigma_pt = e_pt - mu_pt
    full = ((2 * mu_pt + c1) * (2 * sigma_pt + c2)) / (
        (mu_p_sq + mu_t_sq + c1) * (sigma_p + sigma_t + c2))
    interior = full[:, pad:-pad, pad:-pad, :]
    per_image = interior.reshape(interior.shape[0], -1).mean(dim=-1)
    return per_image, full


# --------------------------------------------------------------------------
# the kernels' launchers
# --------------------------------------------------------------------------
_ready_devices = set()


def _library(device: torch.device) -> ctypes.CDLL:
    lib = kernels.load_library("ssim")
    if not getattr(lib, "_pai_declared", False):
        ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_float)
        view = [ptr, i64, i64, i64, i64]
        lib.pai_ssim_set_taps.argtypes = [ptr]
        lib.pai_ssim_map.argtypes = view + view + [
            ptr, i32, i32, i32, i32, f32, f32, ptr]
        lib.pai_ssim_scalar.argtypes = view + view + [
            ptr, ptr, i32, i32, i32, i32, f32, f32, ptr]
        for fn in (lib.pai_ssim_set_taps, lib.pai_ssim_map,
                   lib.pai_ssim_scalar, lib.pai_ssim_tile_w,
                   lib.pai_ssim_tile_h):
            fn.restype = i32
        lib._pai_declared = True
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _ready_devices:
        taps = np.ascontiguousarray(gaussian_1d(), np.float32)
        with torch.cuda.device(index):
            kernels.check_launch(
                lib.pai_ssim_set_taps(taps.ctypes.data), "pai_ssim_set_taps")
        _ready_devices.add(index)
    return lib


def _prepare(pred: torch.Tensor, target: torch.Tensor, kernel_size: int,
             sigma: float):
    _check_shapes(pred, target, kernel_size)
    if kernel_size != KERNEL_SIZE or sigma != SIGMA:
        raise NotImplementedError(
            "the CUDA SSIM kernels are built for the 11-tap sigma-1.5 window; "
            f"got kernel_size={kernel_size}, sigma={sigma}")
    if target.device != pred.device:
        raise ValueError("pred and target lie on different devices")
    if not (pred.is_floating_point() and target.is_floating_point()):
        raise TypeError("ssim expects floating-point tensors")
    n, h, w, c = pred.shape
    if n * h * w * c >= 2 ** 31:
        raise ValueError("ssim kernels index with 32-bit ints: tensor too big")
    return pred.float(), target.float()


def _view_args(x: torch.Tensor):
    return (x.data_ptr(), *x.stride())


def _launch_map(pred, target, c1: float, c2: float) -> torch.Tensor:
    lib = _library(pred.device)
    n, h, w, c = pred.shape
    full = torch.empty((n, h, w, c), dtype=torch.float32, device=pred.device)
    if full.numel():
        with torch.cuda.device(pred.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.pai_ssim_map(*_view_args(pred), *_view_args(target),
                                    full.data_ptr(), n, h, w, c, c1, c2,
                                    stream)
        kernels.check_launch(code, "ssim_map")
        kernels.launch_counts["ssim_map"] += 1
    return full


def _launch_scalar(pred, target, c1: float, c2: float) -> torch.Tensor:
    lib = _library(pred.device)
    n, h, w, c = pred.shape
    tiles = (-(-(w - 2 * PAD) // lib.pai_ssim_tile_w())
             * -(-(h - 2 * PAD) // lib.pai_ssim_tile_h()))
    out = torch.empty((n,), dtype=torch.float32, device=pred.device)
    if n:
        partials = torch.empty((n, c * tiles), dtype=torch.float32,
                               device=pred.device)
        with torch.cuda.device(pred.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.pai_ssim_scalar(*_view_args(pred), *_view_args(target),
                                       partials.data_ptr(), out.data_ptr(),
                                       n, h, w, c, c1, c2, stream)
        kernels.check_launch(code, "ssim_scalar")
        kernels.launch_counts["ssim_scalar"] += 1
    return out


def _plain_vjp(pred, target, needs, grads, consts, want_map: bool):
    """Gradients of the plain version w.r.t. (pred, target) — the backward of
    both kernels."""
    with torch.enable_grad():
        p = pred.detach().requires_grad_(needs[0])
        t = target.detach().requires_grad_(needs[1])
        per_image, full = ssim_parts_plain(p, t, *consts)
        outputs = (per_image, full) if want_map else (per_image,)
        inputs = [x for x, need in ((p, needs[0]), (t, needs[1])) if need]
        pairs = [(o, g) for o, g in zip(outputs, grads) if g is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], inputs,
                                       [g for _, g in pairs]))
    return tuple(next(got).to(x.dtype) if need else None
                 for x, need in ((pred, needs[0]), (target, needs[1])))


class _SsimPartsFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, data_range, kernel_size, sigma, k1, k2):
        ctx.save_for_backward(pred, target)
        ctx.consts = (data_range, kernel_size, sigma, k1, k2)
        if not pred.is_cuda:  # CPU tensor: the plain version
            return ssim_parts_plain(pred, target, *ctx.consts)
        p, t = _prepare(pred, target, kernel_size, sigma)
        full = _launch_map(p, t, *_constants(data_range, k1, k2))
        interior = full[:, PAD:-PAD, PAD:-PAD, :]
        return interior.reshape(full.shape[0], -1).mean(dim=-1), full

    @staticmethod
    def backward(ctx, g_per_image, g_full):
        pred, target = ctx.saved_tensors
        grads = _plain_vjp(pred, target, ctx.needs_input_grad[:2],
                           (g_per_image, g_full), ctx.consts, want_map=True)
        return (*grads, None, None, None, None, None)


class _SsimPerImageFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, data_range, k1, k2):
        ctx.save_for_backward(pred, target)
        ctx.consts = (data_range, KERNEL_SIZE, SIGMA, k1, k2)
        if not pred.is_cuda:  # CPU tensor: the plain version
            return ssim_parts_plain(pred, target, *ctx.consts)[0]
        p, t = _prepare(pred, target, KERNEL_SIZE, SIGMA)
        return _launch_scalar(p, t, *_constants(data_range, k1, k2))

    @staticmethod
    def backward(ctx, g_per_image):
        pred, target = ctx.saved_tensors
        grads = _plain_vjp(pred, target, ctx.needs_input_grad[:2],
                           (g_per_image,), ctx.consts, want_map=False)
        return (*grads, None, None, None)


def ssim_parts_fused(pred: torch.Tensor, target: torch.Tensor,
                     data_range: float = 1.0, kernel_size: int = KERNEL_SIZE,
                     sigma: float = SIGMA, k1: float = 0.01, k2: float = 0.03
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(per_image [N], map [N,H,W,C])``: the ``ssim_map`` kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    return _SsimPartsFused.apply(pred, target, float(data_range),
                                 int(kernel_size), float(sigma), float(k1),
                                 float(k2))


def ssim_per_image_fused(pred: torch.Tensor, target: torch.Tensor,
                         data_range: float = 1.0, k1: float = 0.01,
                         k2: float = 0.03) -> torch.Tensor:
    """``per_image [N]``: the ``ssim_scalar`` kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    return _SsimPerImageFused.apply(pred, target, float(data_range),
                                    float(k1), float(k2))
