"""Fused windowed-SSIM: two CUDA kernels, their plain PyTorch version, and the
wrappers that choose between them by where the tensor lies.

torchmetrics SSIM semantics (11x11 Gaussian window, sigma 1.5, k1/k2 =
0.01/0.03, torch 'reflect' padding, full-resolution map, scalar = mean of the
map cropped by 5 on every side). Entry points, NHWC like the JAX package:

* ``ssim_parts_fused(pred, target)`` -> ``(per_image [N], map [N,H,W,C])``
  and ``ssim_report_fused(pred, target, num_depths=16)`` -> ``(per_image,
  map, bands [N, num_depths])``, everything a report batch keeps of SSIM in
  one kernel launch. Kernel ``ssim_map`` (``csrc/ssim.cu::
  ssim_rows_kernel<true>`` + ``ssim_finish_kernel``) replaces the TPU kernel
  ``pai_tpu/kernels/ssim_pallas.py::_ssim_map_kernel``: the reflect padding
  is folded into the blur's source index, so no padded copy exists. It
  writes the map and, per (plane, strip of 32 columns, row), the sum of the
  row's interior columns [5, W-5); the finishing kernel adds, in a fixed
  order, each image's interior rows into ``per_image`` and each depth band's
  interior rows into ``bands``.
* ``ssim_per_image_fused(pred, target)`` -> ``per_image [N]`` and
  ``ssim_bands_fused(pred, target, num_depths)`` -> ``bands``. Kernel
  ``ssim_scalar`` (``ssim_rows_kernel<false>`` + ``ssim_finish_kernel``)
  replaces ``_ssim_scalar_kernel``: the interior crop removes exactly the
  pixels whose windows touch the padding, so it computes only the interior
  (VALID windows of the unpadded image) and writes no map.

Depth bands: torch.chunk's ceil-sized bands over H with a short last one
(``band_rows``). A band [s, e) has per-image SSIM = the mean over its
interior, rows [s+5, e-5) and columns [5, W-5); each of those windows lies
inside the band and at least 5 pixels from every image edge, so the whole
image's map has the very same values there, from the same source values and
the same taps in the same order. The band means are therefore means over row
ranges of the one map (``band_interiors``); bands of 10 rows or fewer have
no interior and raise ``ValueError``.

Bound on an H100 (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s float32 on the CUDA
cores): bytes. Each pixel is read twice as float32 (and written once by the
map kernel) against about 240 float32 operations, so at (8,256,256,1) the
card needs about 1.9 us for the bytes and the same for the arithmetic, less
than a launch costs. The kernels' design is in ``csrc/ssim.cu``; measured
times are in PERF.md.

The kernels take any float dtype (cast to float32 first), any C (each
(image, channel) pair is one plane; the per-image mean runs over C x
interior) and any strides. ``H <= 10`` or ``W <= 10`` raises. A CUDA tensor
with a window other than 11 taps at sigma 1.5 raises: the kernels are built
for that window.

Gradients: the JAX package has no backward kernel for SSIM, its
``custom_vjp`` recomputes through the plain formulation. The
``autograd.Function`` here does the same, so the forward is the kernel on
the card and gradient numerics are those of the plain version everywhere.
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


def band_rows(h: int, num_depths: int):
    """torch.chunk's bands over ``h`` rows: ``[(start, stop)]``, ceil-sized,
    the last one short (``pai_tpu/utils/metrics.py::depth_ssim_per_image``)."""
    band = -(-h // num_depths)
    return [(start, min(start + band, h)) for start in range(0, h, band)]


def band_interiors(h: int, num_depths: int):
    """The map rows ``[(start + 5, stop - 5)]`` whose mean over the interior
    columns is each band's per-image SSIM. A band of 10 rows or fewer has no
    interior: ``ValueError``, as ``ssim_parts`` raises on such an image."""
    rows = band_rows(h, num_depths)
    short = [stop - start for start, stop in rows if stop - start <= 2 * PAD]
    if short:
        raise ValueError(
            f"ssim needs H and W above {2 * PAD} (window {KERNEL_SIZE}): "
            f"{num_depths} depth bands of {h} rows include one of "
            f"{short[0]} rows")
    return [(start + PAD, stop - PAD) for start, stop in rows]


def ssim_report_plain(pred: torch.Tensor, target: torch.Tensor,
                      num_depths: int = 16, data_range: float = 1.0,
                      kernel_size: int = KERNEL_SIZE, sigma: float = SIGMA,
                      k1: float = 0.01, k2: float = 0.03):
    """``(per_image [N], map [N,H,W,C], bands [N, bands])`` as the JAX package
    defines them: ``ssim_parts_plain`` of the whole image, then of every row
    band on its own (``num_depths`` 0: no bands). Differentiable."""
    consts = (data_range, kernel_size, sigma, k1, k2)
    per_image, full = ssim_parts_plain(pred, target, *consts)
    bands = [ssim_parts_plain(pred[:, start:stop], target[:, start:stop],
                              *consts)[0]
             for start, stop in (band_rows(pred.shape[1], num_depths)
                                 if num_depths else [])]
    bands = torch.stack(bands, dim=1) if bands else full.new_zeros(
        (full.shape[0], 0))
    return per_image, full, bands


# --------------------------------------------------------------------------
# the kernels' launcher
# --------------------------------------------------------------------------
_ready_devices = set()


def _library(device: torch.device) -> ctypes.CDLL:
    lib = kernels.load_library("ssim")
    if not getattr(lib, "_pai_declared", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        view = [ptr] + [ctypes.c_longlong] * 4
        lib.pai_ssim_set_taps.argtypes = [ptr]
        lib.pai_ssim_rows.argtypes = view + view + [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, i32, f32,
            f32, ptr]
        for fn in (lib.pai_ssim_set_taps, lib.pai_ssim_rows,
                   lib.pai_ssim_strip, lib.pai_ssim_max_segments):
            fn.restype = i32
        lib._pai_strip = lib.pai_ssim_strip()
        lib._pai_max_segments = lib.pai_ssim_max_segments()
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


@functools.lru_cache(maxsize=64)
def _segment_arrays(segments: Tuple[Tuple[int, int], ...]):
    """The row ranges as two C int arrays (cached: a report asks for the same
    ranges every batch)."""
    n = len(segments)
    return ((ctypes.c_int * n)(*(lo for lo, _ in segments)),
            (ctypes.c_int * n)(*(hi for _, hi in segments)))


def _rows_aligned(x: torch.Tensor) -> bool:
    """Whether every row of ``x`` is contiguous and starts 16-byte aligned,
    so the kernel may copy it in 16-byte pieces."""
    sn, sh, sw, sc = x.stride()
    return (sw == 1 and sh % 4 == 0 and sn % 4 == 0
            and (x.shape[3] == 1 or sc % 4 == 0) and x.data_ptr() % 16 == 0)


def _launch(pred, target, write_map: bool, num_depths: int, c1: float,
            c2: float):
    """One launch of the row kernel and the finishing kernel: ``(per_image,
    map or None, bands)``; map, row sums and outputs share one allocation."""
    lib = _library(pred.device)
    n, h, w, c = pred.shape
    segments = ((PAD, h - PAD),) + tuple(
        band_interiors(h, num_depths) if num_depths else ())
    if len(segments) > lib._pai_max_segments:
        raise ValueError(f"at most {lib._pai_max_segments - 1} depth bands")
    strip = lib._pai_strip
    x_lo, x_hi, rows = (0, w, h) if write_map else (PAD, w - PAD, h - 2 * PAD)
    strips = -(-x_hi // strip) - x_lo // strip
    n_map = n * h * w * c if write_map else 0
    n_sums = n * c * strips * rows
    buf = torch.empty(n_map + n_sums + len(segments) * n,
                      dtype=torch.float32, device=pred.device)
    out = buf[n_map + n_sums:].view(len(segments), n)
    if n:
        lo, hi = _segment_arrays(segments)
        args = (pred.data_ptr(), *pred.stride(), target.data_ptr(),
                *target.stride(), buf.data_ptr(), buf.data_ptr() + 4 * n_map,
                out.data_ptr(), n, h, w, c, int(write_map),
                int(_rows_aligned(pred) and _rows_aligned(target)), lo, hi,
                len(segments), c1, c2,
                torch.cuda.current_stream(pred.device).cuda_stream)
        if pred.device.index == torch.cuda.current_device():
            code = lib.pai_ssim_rows(*args)
        else:
            with torch.cuda.device(pred.device):
                code = lib.pai_ssim_rows(*args)
        name = "ssim_map" if write_map else "ssim_scalar"
        kernels.check_launch(code, name)
        kernels.launch_counts[name] += 1
    full = buf[:n_map].view(n, h, w, c) if write_map else None
    return out[0], full, out[1:].t()


class _SsimFused(torch.autograd.Function):
    """``(per_image, map, bands)``; ``write_map`` False: the map is not
    computed (an empty tensor is returned in its place). Backward: the plain
    version's gradient (``ssim_report_plain``)."""

    @staticmethod
    def forward(ctx, pred, target, write_map, num_depths, data_range,
                kernel_size, sigma, k1, k2):
        ctx.save_for_backward(pred, target)
        ctx.consts = (num_depths, data_range, kernel_size, sigma, k1, k2)
        if not pred.is_cuda:  # CPU tensor: the plain version
            per_image, full, bands = ssim_report_plain(pred, target,
                                                       *ctx.consts)
        else:
            p, t = _prepare(pred, target, kernel_size, sigma)
            per_image, full, bands = _launch(
                p, t, write_map, num_depths, *_constants(data_range, k1, k2))
        if not write_map:
            full = per_image.new_zeros((0,))
        return per_image, full, bands

    @staticmethod
    def backward(ctx, g_per_image, g_full, g_bands):
        pred, target = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            p = pred.detach().requires_grad_(needs[0])
            t = target.detach().requires_grad_(needs[1])
            outputs = ssim_report_plain(p, t, *ctx.consts)
            pairs = [(o, g) for o, g in zip(outputs, (g_per_image, g_full,
                                                       g_bands))
                     if g is not None and g.shape == o.shape and o.numel()]
            inputs = [x for x, need in ((p, needs[0]), (t, needs[1]))
                      if need]
            got = iter(torch.autograd.grad([o for o, _ in pairs], inputs,
                                           [g for _, g in pairs]))
        return (*(next(got).to(x.dtype) if need else None
                  for x, need in ((pred, needs[0]), (target, needs[1]))),
                None, None, None, None, None, None, None)


def _fused(pred, target, write_map, num_depths, data_range=1.0,
           kernel_size=KERNEL_SIZE, sigma=SIGMA, k1=0.01, k2=0.03):
    return _SsimFused.apply(pred, target, write_map, int(num_depths),
                            float(data_range), int(kernel_size), float(sigma),
                            float(k1), float(k2))


def ssim_parts_fused(pred: torch.Tensor, target: torch.Tensor,
                     data_range: float = 1.0, kernel_size: int = KERNEL_SIZE,
                     sigma: float = SIGMA, k1: float = 0.01, k2: float = 0.03
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(per_image [N], map [N,H,W,C])``: the ``ssim_map`` kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    per_image, full, _ = _fused(pred, target, True, 0, data_range,
                                kernel_size, sigma, k1, k2)
    return per_image, full


def ssim_report_fused(pred: torch.Tensor, target: torch.Tensor,
                      num_depths: int = 16, data_range: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(per_image [N], map [N,H,W,C], bands [N, bands])``: one ``ssim_map``
    launch on a CUDA tensor, ``ssim_report_plain`` on a CPU tensor."""
    return _fused(pred, target, True, num_depths, data_range)


def ssim_per_image_fused(pred: torch.Tensor, target: torch.Tensor,
                         data_range: float = 1.0, k1: float = 0.01,
                         k2: float = 0.03) -> torch.Tensor:
    """``per_image [N]``: the ``ssim_scalar`` kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    return _fused(pred, target, False, 0, data_range, k1=k1, k2=k2)[0]


def ssim_bands_fused(pred: torch.Tensor, target: torch.Tensor,
                     num_depths: int = 16) -> torch.Tensor:
    """``bands [N, bands]``, per-image SSIM of each depth band: the
    ``ssim_scalar`` kernel (no map written) on a CUDA tensor, the band-by-band
    plain version on a CPU tensor."""
    return _fused(pred, target, False, num_depths)[2]
