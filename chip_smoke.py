#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's two serving paths once each at full width — Pix2Pix
(channel mults 1,2,4,8,8,8,8,8 — 54.4 M parameters, 256x256 grayscale) and
Palette sampling (the CLI-default diffusion UNet: the same mults at inner
width 128, attention at downsample rates 8,4,2, 100-step DDPM chain) —
through the entry points a user calls, and holds every hand-written kernel
against its plain PyTorch version on the card. It imports ``pai_tpu_torch`` only (no JAX),
builds the kernels from the sources in this checkout, needs no network and
starts no process that outlives it (``nvcc`` and ``nvidia-smi`` are waited
for). Phases, each printing one JSON line:

1. ``device``  — card name and power limit, torch/CUDA versions, the precision
   switches as set, seconds spent building the kernels.
2. ``kernels`` — each kernel's wrapper against its plain version on CUDA
   tensors at the shapes the report path gives it and at ragged and
   multi-channel shapes; times by CUDA events (warmed, median of 25 samples
   of 20 calls).
   The flash-attention cases: the two shapes the Palette path launches, two
   more head dims, bfloat16 operands, strided views of a packed qkv tensor,
   the log-sum-exp output, and the inputs that must raise; beside the
   kernel's time the plain version's and that of PyTorch's own fused
   attention call on the same tensors (timed here, used nowhere in the
   port).
3. ``report``  — a 32-pair 256x256 synthetic dataset written with the port's
   own PNG writer, a full-width Pix2Pix with random weights from a seeded
   generator and non-trivial BatchNorm statistics saved as a checkpoint, then
   ``pai_tpu_torch.report`` (``-bs 8 --device cuda``) and
   ``pai_tpu_torch.api.Pix2Pix.load_from_checkpoint(...).predict`` scored with
   ``metrics.ssim_per_image``. The launch counts are set to 0 just before and
   read just after; the outputs are checked against the plain version and
   against a CPU forward of the same weights.
4. ``palette`` — a full-width Palette with random weights from a seeded
   generator (the zero-initialised layers given small weights, the
   BatchNorms the statistics of one calibration batch) saved as a
   checkpoint, then ``pai_tpu_torch.report -m palette --output-process`` over
   2 images with the real 100-step chain and
   ``pai_tpu_torch.api.Palette.load_from_checkpoint(...).predict(...,
   output_process=True)``; launch counts set to 0 just before and read just
   after; one denoising step on the card against the same step on the CPU.

Then one line ``{"kernels": [...]}`` with, per kernel, its route, source, the
TPU kernel it replaces, its launches in phase 3, its error against the plain
version, its time, the plain version's time and the card's bound for the same
work and the library call's time where there is one; then the card's name and power limit; then, last,
``{"ok": true, "device": {...}}``.

Any failure — no GPU, a failed build, a refused launch, a mismatch, a missing
file — ends the run with a non-zero exit code and no ``ok`` line.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# float32 rate of the CUDA cores (the SSIM kernels use no tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense bf16 rate of the tensor cores: the operations bound of bf16 operands
BF16_FLOP_PER_S = 989e12
# 5 maps x 11 taps x 2 passes x 2 (multiply-add) + 3 products + 17 for the
# ratio, per output pixel
SSIM_FLOP_PER_PIXEL = 5 * 11 * 2 * 2 + 3 + 17

MAP_TOL = 2e-5        # SSIM map, kernel vs plain: float32 FMAs vs separate
PER_IMAGE_TOL = 1e-5  # multiply and add, summed in another order
FORWARD_TOL = 1e-3    # card vs CPU forward, true float32 both, 16 conv layers

# flash attention, kernel vs plain version. float32 operands: the same
# float32 arithmetic summed in another order, exp2 against exp. bfloat16
# operands: both compute in float32 and round the output once, so they differ
# by at most one bf16 unit in the last place (2^-8 relative).
FLASH_TOL = 2e-5
FLASH_LSE_TOL = 2e-5
FLASH_BF16_REL_TOL = 2.0 ** -8
# one full-width UNet evaluation, card vs CPU, true float32 both: some 60
# convolutions and 16 attention blocks summed in other orders; relative to
# the output's largest magnitude (a random-weight UNet's output is not of
# order one)
DENOISE_STEP_TOL = 1e-3

FULL_MULTS = "1,2,4,8,8,8,8,8"
PALETTE_ATTENTION_RES = "8,4,2"
PALETTE_IMAGES, PALETTE_BATCH = 2, 2
FLASH_LAUNCHES_PER_FORWARD = 10  # 5 blocks at T=16384 and 5 at T=4096
N_IMAGES, BATCH, SIZE = 32, 8, 256


class SmokeFailure(Exception):
    pass


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, samples=25, calls=20):
    """Median over ``samples`` of the CUDA-event time of ``calls`` calls,
    per call, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_kernel_us(fn, kernel_names, calls=20):
    """Mean device time per call of the named CUDA kernels, from
    torch.profiler; None where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for event in prof.key_averages():
        if any(name in event.key for name in kernel_names):
            total += float(getattr(event, "self_device_time_total", 0.0))
    return total / calls if total > 0 else None


def ssim_bound(shape, kernel):
    """(bound_ms, bound_by): the larger of bytes over the memory rate (each
    input read once, each output written once) and operations over the
    float32 rate."""
    n, h, w, c = shape
    if kernel == "ssim_map":
        pixels = n * h * w * c
        out_bytes = 4 * pixels
    else:
        pixels = n * (h - 10) * (w - 10) * c
        out_bytes = 4 * n
    bytes_ms = (2 * 4 * n * h * w * c + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = pixels * SSIM_FLOP_PER_PIXEL / F32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def random_pair(shape, seed, device):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    target = np.clip(0.6 * pred + 0.4 * rng.uniform(0, 1, shape), 0, 1
                     ).astype(np.float32)
    return (torch.from_numpy(pred).to(device),
            torch.from_numpy(target).to(device))


def phase_kernels(device):
    """Each kernel's wrapper vs its plain version on the card."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import ssim

    # (shape, which kernels); the first two are the report path's shapes
    cases = [((8, 256, 256, 1), ("ssim_map", "ssim_scalar")),
             ((8, 16, 256, 1), ("ssim_map",)),
             ((3, 37, 53, 1), ("ssim_map", "ssim_scalar")),
             ((2, 48, 48, 3), ("ssim_map", "ssim_scalar"))]
    wrappers = {"ssim_map": ssim.ssim_parts_fused,
                "ssim_scalar": ssim.ssim_per_image_fused}
    cuda_names = {"ssim_map": ("ssim_map_kernel",),
                  "ssim_scalar": ("ssim_scalar_kernel", "ssim_finish_kernel")}
    results = {name: [] for name in wrappers}
    for seed, (shape, names) in enumerate(cases):
        pred, target = random_pair(shape, seed, device)
        want_per, want_map = ssim.ssim_parts_plain(pred, target)
        torch.cuda.synchronize()
        for name in names:
            before = kernels.launch_counts[name]
            out = wrappers[name](pred, target)
            torch.cuda.synchronize()
            check(kernels.launch_counts[name] == before + 1,
                  f"{name} did not count its launch at {shape}")
            entry = {"shape": list(shape)}
            if name == "ssim_map":
                got_per, got_map = out
                check(got_map.shape == pred.shape and got_map.is_cuda,
                      f"ssim_map output shape {tuple(got_map.shape)}")
                entry["max_abs_err_map"] = float(
                    (got_map - want_map).abs().max())
                check(entry["max_abs_err_map"] <= MAP_TOL,
                      f"ssim_map map differs from plain at {shape}: "
                      f"{entry['max_abs_err_map']} > {MAP_TOL}")
            else:
                got_per = out
            check(got_per.shape == (shape[0],),
                  f"{name} per-image shape {tuple(got_per.shape)}")
            check(bool(torch.isfinite(got_per).all()), f"{name} not finite")
            entry["max_abs_err_per_image"] = float(
                (got_per - want_per).abs().max())
            check(entry["max_abs_err_per_image"] <= PER_IMAGE_TOL,
                  f"{name} per-image differs from plain at {shape}: "
                  f"{entry['max_abs_err_per_image']} > {PER_IMAGE_TOL}")
            bound_ms, bound_by = ssim_bound(shape, name)
            entry.update(
                ms=time_ms(lambda: wrappers[name](pred, target)),
                plain_ms=time_ms(lambda: ssim.ssim_parts_plain(pred, target),
                                 samples=20, calls=3),
                kernel_us=device_kernel_us(
                    lambda: wrappers[name](pred, target), cuda_names[name]),
                bound_ms=bound_ms, bound_by=bound_by)
            results[name].append(entry)

    # strided inputs: a row band of a larger tensor, read in place
    pred, target = random_pair((4, 64, 80, 1), 11, device)
    band_p, band_t = pred[:, 16:40], target[:, 16:40]
    check(not band_p.is_contiguous(), "band view unexpectedly contiguous")
    want_per, want_map = ssim.ssim_parts_plain(band_p.contiguous(),
                                               band_t.contiguous())
    got_per, got_map = ssim.ssim_parts_fused(band_p, band_t)
    got_scalar = ssim.ssim_per_image_fused(band_p, band_t)
    torch.cuda.synchronize()
    strided = {
        "map": float((got_map - want_map).abs().max()),
        "per_image": float((got_per - want_per).abs().max()),
        "scalar": float((got_scalar - want_per).abs().max())}
    check(strided["map"] <= MAP_TOL and strided["per_image"] <= PER_IMAGE_TOL
          and strided["scalar"] <= PER_IMAGE_TOL,
          f"kernels differ from plain on a strided band view: {strided}")

    # gradients: forward through the kernels, backward recomputed through the
    # plain version, against the plain version's own gradient
    pred, target = random_pair((2, 32, 40, 1), 12, device)
    grads = []
    for fn in (lambda a, b: ssim.ssim_per_image_fused(a, b).sum()
               + ssim.ssim_parts_fused(a, b)[1].square().sum(),
               lambda a, b: ssim.ssim_parts_plain(a, b)[0].sum()
               + ssim.ssim_parts_plain(a, b)[1].square().sum()):
        leaf = pred.clone().requires_grad_(True)
        fn(leaf, target).backward()
        grads.append(leaf.grad)
    torch.cuda.synchronize()
    grad_err = float((grads[0] - grads[1]).abs().max())
    check(grad_err <= 1e-4 * float(grads[1].abs().max()),
          f"gradient through the kernels' backward differs from the plain "
          f"version's: {grad_err}")

    # what a CUDA tensor may not do: fall back to the plain version
    small = torch.zeros((1, 10, 32, 1), device=device)
    for fn in wrappers.values():
        try:
            fn(small, small)
        except ValueError:
            continue
        raise SmokeFailure("a 10-row CUDA tensor did not raise")

    emit({"phase": "kernels", "kernels": sorted(results),
          "limits": {"map": MAP_TOL, "per_image": PER_IMAGE_TOL},
          "strided_band_max_abs_err": strided,
          "gradient_max_abs_err": grad_err, "cases": results})
    return results



def flash_bound(shape, dtype, emit_lse=False):
    """(bound_ms, bound_by) of one attention call: q, k, v read once and o
    (and lse) written once over the memory rate, against 4*B*H*T*T*D
    operations over the peak rate of the operands' type (float32: the CUDA
    cores; bfloat16: the tensor cores' dense rate)."""
    b, h, t, d = shape
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = 4 * b * h * t * d * size + (4 * b * h * t if emit_lse else 0)
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * b * h * t * t * d / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def random_qkv(shape, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(
        np.float32)).to(device).to(dtype) for _ in range(3))


def expect_raises(kind, fn, what):
    try:
        fn()
    except kind:
        return
    raise SmokeFailure(f"{what} did not raise {kind.__name__}")


def phase_flash(device):
    """The flash-attention wrapper vs its plain version on the card."""
    import torch.nn.functional as F

    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels.flash_attention import (flash_attention,
                                                       flash_attention_plain)

    # (shape, dtype, timed in full); the first two are the Palette path's
    cases = [((2, 4, 16384, 64), torch.float32, True),
             ((2, 4, 4096, 128), torch.float32, True),
             ((1, 2, 4096, 32), torch.float32, False),
             ((1, 1, 1024, 256), torch.float32, False),
             ((2, 4, 4096, 64), torch.bfloat16, True)]
    results = []
    for seed, (shape, dtype, full) in enumerate(cases):
        q, k, v = random_qkv(shape, 100 + seed, device, dtype)
        want = flash_attention_plain(q, k, v)
        before = kernels.launch_counts["flash_fwd"]
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        check(kernels.launch_counts["flash_fwd"] == before + 1,
              f"flash_fwd did not count its launch at {shape}")
        check(got.shape == q.shape and got.dtype == dtype and got.is_cuda,
              f"flash_fwd output {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"flash_fwd not finite {shape}")
        err = float((got.float() - want.float()).abs().max())
        limit = FLASH_TOL if dtype == torch.float32 else \
            FLASH_BF16_REL_TOL * max(1.0, float(want.float().abs().max()))
        check(err <= limit, f"flash_fwd differs from plain at {shape} "
              f"{dtype}: {err} > {limit}")
        check(torch.equal(got, flash_attention(q, k, v)),
              f"flash_fwd is not bit-reproducible at {shape}")
        bound_ms, bound_by = flash_bound(shape, dtype)
        entry = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                 "max_abs_err": err, "limit": limit,
                 "ms": time_ms(lambda: flash_attention(q, k, v), samples=5,
                               calls=3),
                 "bound_ms": bound_ms, "bound_by": bound_by}
        if full:
            entry.update(
                plain_ms=time_ms(lambda: flash_attention_plain(q, k, v),
                                 samples=3, calls=1),
                kernel_us=device_kernel_us(lambda: flash_attention(q, k, v),
                                           ("flash_fwd_kernel",), calls=3),
                # the yardstick: timed only (float32 with TF32 off, as set)
                library_ms=time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=shape[-1] ** -0.5),
                    samples=5, calls=3))
            entry["tflops"] = 4 * shape[0] * shape[1] * shape[2] ** 2 \
                * shape[3] / entry["ms"] / 1e9
        results.append(entry)
        del q, k, v, want, got

    # strided: q, k, v as views of one packed (N, T, heads, 3, D) tensor,
    # the way AttentionBlock hands them over
    rng = np.random.default_rng(110)
    packed = torch.from_numpy(rng.normal(0.0, 1.0, (2, 4096, 4, 3, 64)).astype(
        np.float32)).to(device)
    q, k, v = (packed[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    check(not q.is_contiguous(), "packed view unexpectedly contiguous")
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    strided_err = float((got - want).abs().max())
    check(strided_err <= FLASH_TOL,
          f"flash_fwd differs from plain on packed views: {strided_err}")
    check(got.permute(0, 2, 1, 3).reshape(2, 4096, 256).data_ptr()
          == got.data_ptr(), "flash_fwd output is not token-major")

    # lse against logsumexp of the plain logits
    q, k, v = random_qkv((1, 2, 4096, 64), 111, device)
    got, lse = flash_attention(q, k, v, emit_lse=True)
    torch.cuda.synchronize()
    scale = 64 ** -0.25
    logits = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
    want_lse = torch.logsumexp(logits, dim=-1).reshape(2, 4096)
    lse_err = float((lse - want_lse).abs().max())
    check(lse.shape == (2, 4096) and lse.dtype == torch.float32,
          f"lse {tuple(lse.shape)} {lse.dtype}")
    check(lse_err <= FLASH_LSE_TOL, f"flash_fwd lse: {lse_err}")
    out_err = float((got - torch.matmul(torch.softmax(logits, -1), v)
                     ).abs().max())
    check(out_err <= FLASH_TOL, f"flash_fwd (with lse) output: {out_err}")
    del logits

    # what a CUDA tensor may not do: fall back to the plain version
    bad_d = random_qkv((1, 1, 1024, 48), 112, device)
    ragged = random_qkv((1, 1, 4096 + 64, 64), 113, device)
    expect_raises(ValueError, lambda: flash_attention(*bad_d), "D = 48")
    expect_raises(ValueError, lambda: flash_attention(*ragged), "ragged T")
    leaf = q.clone().requires_grad_(True)
    expect_raises(NotImplementedError, lambda: flash_attention(leaf, k, v),
                  "requires_grad on the card")

    emit({"phase": "kernels", "kernels": ["flash_fwd"],
          "limits": {"float32": FLASH_TOL, "lse": FLASH_LSE_TOL,
                     "bfloat16_relative": FLASH_BF16_REL_TOL},
          "packed_views_max_abs_err": strided_err,
          "lse_max_abs_err": lse_err, "with_lse_output_max_abs_err": out_err,
          "cases": results})
    return results


def blob_image(rng):
    """256x256 uint8: six Gaussian blobs with a little texture."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    img = np.zeros((SIZE, SIZE), np.float32)
    for _ in range(6):
        cx, cy = rng.uniform(0.1, 0.9, 2)
        s = rng.uniform(0.03, 0.15)
        img += rng.uniform(0.3, 1.0) * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    img = np.clip(img / img.max() * 0.9
                  + rng.uniform(0.0, 0.1, img.shape), 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def write_dataset(directory, n_images=N_IMAGES):
    """Pairs of blob images and their inversion, written with the port's PNG
    writer, plus the manifest."""
    from pai_tpu_torch.utils.images import write_png

    rng = np.random.default_rng(0)
    entries = []
    for i in range(n_images):
        x = blob_image(rng)
        write_png(x, os.path.join(directory, f"in_{i}.png"))
        write_png(255 - x, os.path.join(directory, f"gt_{i}.png"))
        entries.append(f"- input: in_{i}.png\n  ground_truth: gt_{i}.png\n")
    manifest = os.path.join(directory, "test.yaml")
    with open(manifest, "w") as f:
        f.write("".join(entries))
    return manifest


def make_checkpoint(directory, device):
    """Full-width Pix2Pix initialised on the card from a seeded generator,
    BatchNorm statistics moved off their defaults, saved as an eval
    checkpoint. Returns (slot path, parameter count)."""
    from pai_tpu_torch.config import TRAIN_DEFAULTS
    from pai_tpu_torch.models import build_generator
    from pai_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from pai_tpu_torch.utils.flops import parameter_count

    gen = torch.Generator(device=device).manual_seed(0)
    hparams = dict(TRAIN_DEFAULTS, model="pix2pix", channel_mults=FULL_MULTS,
                   precision="32", image_size=SIZE, in_channels=1,
                   out_channels=1)
    model = build_generator("pix2pix", channel_mults=(1, 2, 4, 8, 8, 8, 8, 8),
                            generator=gen, device=device)
    # Random N(0, 0.02) weights leave activations far from unit scale, so
    # default running statistics (0, 1) would flatten the output. Give every
    # BatchNorm a random affine and the statistics of one random batch
    # (momentum None = plain average), as a short training run would.
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for module in norms:
            module.weight.uniform_(0.8, 1.2, generator=gen)
            module.bias.normal_(0.0, 0.1, generator=gen)
            module.momentum = None
        calib = torch.empty((BATCH, SIZE, SIZE, 1), device=device)
        model.train()(calib.uniform_(-1.0, 1.0, generator=gen))
        for module in norms:
            module.momentum = 0.1
        model.eval()
    slot = save_eval_checkpoint(os.path.join(directory, "checkpoints"),
                                "smoke", model.state_dict(), hparams,
                                slot="best", monitor_value=0.0)
    return slot, parameter_count(model)


def read_csv_column(path, header):
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0] == header, f"{path}: header {lines[0]!r}")
    return np.array([float(line.split(",")[1]) for line in lines[1:]])


def phase_report(device, workdir):
    from pai_tpu_torch import kernels, report
    from pai_tpu_torch.api import Pix2Pix
    from pai_tpu_torch.data import BatchLoader, ImageDataset
    from pai_tpu_torch.kernels.ssim import ssim_parts_plain
    from pai_tpu_torch.reporting import chunk_metrics
    from pai_tpu_torch.utils import metrics
    from pai_tpu_torch.utils.flops import count_flops
    from pai_tpu_torch.utils.images import (afmhot_rgb, denormalize, read_png,
                                            to_int, write_png)

    manifest = write_dataset(workdir)
    slot, n_params = make_checkpoint(workdir, device)
    reports_dir = os.path.join(workdir, "reports")
    n_batches = N_IMAGES // BATCH

    # ---- the main path, counted --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    stats = report.main(["smoke", "-c", slot, "-d", manifest, "-m", "pix2pix",
                         "-bs", str(BATCH), "--device", "cuda",
                         "--reports-dir", reports_dir])
    torch.cuda.synchronize()
    report_seconds = time.perf_counter() - start
    peak_bytes = torch.cuda.max_memory_allocated()
    map_launches_report = kernels.launch_counts["ssim_map"]

    start = time.perf_counter()
    model = Pix2Pix.load_from_checkpoint(slot, device="cuda")
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - start
    loader = BatchLoader(ImageDataset(manifest, SIZE), BATCH, pad_mode="zero",
                         device="cuda")
    batches, scalar_ssim = [], []
    for batch in loader:
        pred = model.predict(batch.x)
        p, t = denormalize(pred), denormalize(batch.y)
        scalar_ssim.append(metrics.ssim_per_image(p, t))
        batches.append((batch.x, p, t))
    loader.close()
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    # ---- end of the counted window -----------------------------------

    check(map_launches_report == 17 * n_batches,
          f"ssim_map launched {map_launches_report} times in the report, "
          f"expected 17 x {n_batches}")
    check(launches["ssim_map"] == 17 * n_batches,
          f"ssim_map count moved outside the report: {launches}")
    check(launches["ssim_scalar"] == n_batches,
          f"ssim_scalar launched {launches['ssim_scalar']} times, expected "
          f"{n_batches}")

    rdir = os.path.join(reports_dir, "smoke")
    report_ssim = read_csv_column(os.path.join(rdir, "ssim_per_image.csv"),
                                  "image,ssim")
    report_psnr = read_csv_column(os.path.join(rdir, "psnr_per_image.csv"),
                                  "image,psnr")
    report_mse = read_csv_column(os.path.join(rdir, "mse_per_image.csv"),
                                 "image,mse")
    for name, values in (("ssim", report_ssim), ("psnr", report_psnr),
                         ("mse", report_mse)):
        check(values.shape == (N_IMAGES,) and np.isfinite(values).all(),
              f"{name}_per_image.csv: {values.shape}, finite "
              f"{np.isfinite(values).all()}")
    with open(os.path.join(rdir, "depth_ssim.csv")) as f:
        check(len(f.read().splitlines()) == 17, "depth_ssim.csv rows")
    for sub in ("outputs", "ssim_images"):
        files = sorted(os.listdir(os.path.join(rdir, sub)))
        check(len(files) == N_IMAGES and files[0] == "00000.png",
              f"{sub}: {len(files)} files")
    check(read_png(os.path.join(rdir, "outputs", "00000.png")).shape
          == (SIZE, SIZE, 3), "output PNG is not 256x256 RGB")
    check(read_png(os.path.join(rdir, "ssim_images", "00031.png")).shape
          == (SIZE, SIZE), "SSIM-map PNG is not 256x256 gray")
    with open(os.path.join(rdir, "stats.txt")) as f:
        stats_txt = dict(line.split(": ") for line in f.read().splitlines())
    check(all(np.isfinite(float(stats_txt[k]))
              for k in ("SSIM", "PSNR", "RMSE")), f"stats.txt: {stats_txt}")
    check(int(stats_txt["Parameter count"]) == n_params == stats["params"],
          f"parameter count {stats_txt['Parameter count']} vs {n_params}")
    check(int(stats_txt["FLOPs"]) > 0, "FLOPs not counted")

    # the report's numbers against the plain version and the scalar kernel,
    # recomputed from the API's predictions on the card
    plain_ssim = torch.cat([ssim_parts_plain(p, t)[0] for _, p, t in batches])
    scalar_ssim = torch.cat(scalar_ssim)
    err_plain = float(np.abs(report_ssim - plain_ssim.cpu().numpy()).max())
    err_scalar = float(np.abs(report_ssim - scalar_ssim.cpu().numpy()).max())
    check(err_plain <= PER_IMAGE_TOL,
          f"report SSIM vs plain version: {err_plain} > {PER_IMAGE_TOL}")
    check(err_scalar <= PER_IMAGE_TOL,
          f"report SSIM vs scalar kernel: {err_scalar} > {PER_IMAGE_TOL}")
    check(abs(float(stats_txt["SSIM"]) - float(plain_ssim.mean()))
          <= PER_IMAGE_TOL, "stats.txt SSIM vs plain version")

    # the card's forward against a CPU forward of the same checkpoint
    cpu_model = Pix2Pix.load_from_checkpoint(slot, device="cpu")
    x_small = batches[0][0][:2]
    forward_err = float((model.predict(x_small).cpu()
                         - cpu_model.predict(x_small.cpu())).abs().max())
    check(forward_err <= FORWARD_TOL,
          f"forward on the card vs on the CPU: {forward_err} > {FORWARD_TOL}")
    spread = float(batches[0][1].std())
    check(spread > 0.01, f"predictions are flat (std {spread})")

    # where the report's host time goes: one pass of each host stage alone
    start = time.perf_counter()
    decode_loader = BatchLoader(ImageDataset(manifest, SIZE), BATCH,
                                pad_mode="zero", device="cuda")
    for _ in decode_loader:
        pass
    decode_loader.close()
    torch.cuda.synchronize()
    decode_seconds = time.perf_counter() - start
    pred_host = batches[0][1].cpu().numpy()
    start = time.perf_counter()
    for i in range(N_IMAGES):
        img = pred_host[i % BATCH]
        write_png(to_int(afmhot_rgb(img[..., 0])),
                  os.path.join(workdir, "probe_rgb.png"))
        write_png(to_int(np.clip(img, 0.0, 1.0)),
                  os.path.join(workdir, "probe_gray.png"))
    png_write_seconds = time.perf_counter() - start
    start = time.perf_counter()
    count_flops(model.predict, batches[0][0][:1])
    torch.cuda.synchronize()
    flops_seconds = time.perf_counter() - start

    # timings of the two halves of a report batch
    x0, p0, t0 = batches[0]
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model.predict(x0), samples=10, calls=3)
        metrics_ms = time_ms(lambda: chunk_metrics(p0, t0), samples=10,
                             calls=3)
    emit({"phase": "report", "images": N_IMAGES, "batch_size": BATCH,
          "channel_mults": FULL_MULTS, "parameters": n_params,
          "flops_per_image": int(stats_txt["FLOPs"]),
          "report_seconds": report_seconds,
          "images_per_second": N_IMAGES / report_seconds,
          "forward_ms_per_batch": forward_ms,
          "metrics_ms_per_batch": metrics_ms,
          "host_seconds": {"checkpoint_load": load_seconds,
                           "decode_and_copy_all_batches": decode_seconds,
                           "png_write_all_images": png_write_seconds,
                           "flop_count_forward": flops_seconds},
          "max_memory_allocated_bytes": peak_bytes,
          "launches": launches,
          "ssim": float(stats_txt["SSIM"]), "psnr": float(stats_txt["PSNR"]),
          "rmse": float(stats_txt["RMSE"]),
          "report_ssim_vs_plain_max_abs_err": err_plain,
          "report_ssim_vs_scalar_kernel_max_abs_err": err_scalar,
          "forward_cuda_vs_cpu_max_abs_err": forward_err,
          "limits": {"per_image": PER_IMAGE_TOL, "forward": FORWARD_TOL}})
    return launches



def make_palette_checkpoint(directory, device):
    """Full-width Palette UNet initialised on the card from a seeded
    generator and saved as an eval checkpoint. Returns (slot path, parameter
    count).

    With the default init the output is identically zero (every ResBlock's
    last convolution, every attention projection and the output convolution
    start at zero), so no fault in attention could show. Those layers get
    small random weights, and every BatchNorm the statistics of one
    calibration batch (momentum None = plain average), as a short training
    run would leave them. The calibration batch is what the chain will see —
    blob images as the condition, their inversions noised to eight levels
    spread over the schedule — and eight images deep, because the innermost
    level is 2x2 and its statistics come from batch x 4 values."""
    from pai_tpu_torch.config import TRAIN_DEFAULTS
    from pai_tpu_torch.models import build_generator
    from pai_tpu_torch.models.diffusion_unet import TokenConv1d, ZeroConv
    from pai_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from pai_tpu_torch.utils.flops import parameter_count

    gen = torch.Generator(device=device).manual_seed(1)
    hparams = dict(TRAIN_DEFAULTS, model="palette", channel_mults=FULL_MULTS,
                   attention_res=PALETTE_ATTENTION_RES, precision="32",
                   image_size=SIZE, in_channels=1, out_channels=1,
                   loss_type="mse", learn_variance=False)
    model = build_generator(
        "palette", channel_mults=(1, 2, 4, 8, 8, 8, 8, 8),
        attention_res=(8, 4, 2), generator=gen, device=device)
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for module in model.modules():
            zero_init = isinstance(module, ZeroConv) or (
                isinstance(module, TokenConv1d)
                and not bool(module.weight.any()))
            if zero_init:
                fan_in = module.weight[0].numel()
                scale = 1.0 if module is model.out[2] else 0.5
                module.weight.normal_(0.0, scale * fan_in ** -0.5,
                                      generator=gen)
        for module in norms:
            module.weight.uniform_(0.8, 1.2, generator=gen)
            module.bias.normal_(0.0, 0.1, generator=gen)
            module.momentum = None
        rng = np.random.default_rng(5)
        blobs = np.stack([blob_image(rng) for _ in range(8)])[..., None]
        cond = torch.from_numpy(blobs.astype(np.float32) / 127.5 - 1.0
                                ).to(device)
        gammas = torch.linspace(0.02, 0.98, 8, device=device)
        g = gammas.reshape(-1, 1, 1, 1)
        noisy = torch.sqrt(g) * -cond + torch.sqrt(1.0 - g) * torch.randn(
            cond.shape, device=device, generator=gen)
        model.train()(cond, noisy, gammas)
        for module in norms:
            module.momentum = 0.1
        model.eval()
    slot = save_eval_checkpoint(os.path.join(directory, "checkpoints"),
                                "palette_smoke", model.state_dict(), hparams,
                                slot="best", monitor_value=0.0)
    return slot, parameter_count(model)


def device_events_us(fn, calls=2):
    """Device time per call of every device-side profiler event of ``fn``,
    by name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {event.key: float(event.self_device_time_total) / calls
            for event in prof.key_averages()
            if event.device_type == DeviceType.CUDA}


def phase_palette(device, workdir):
    from pai_tpu_torch import kernels, report
    from pai_tpu_torch.api import Palette
    from pai_tpu_torch.data import BatchLoader, ImageDataset
    from pai_tpu_torch.reporting import SAMPLING_STEPS
    from pai_tpu_torch.utils import metrics
    from pai_tpu_torch.utils.images import denormalize, read_png

    data_dir = os.path.join(workdir, "palette_data")
    os.makedirs(data_dir)
    manifest = write_dataset(data_dir, PALETTE_IMAGES)
    start = time.perf_counter()
    slot, n_params = make_palette_checkpoint(workdir, device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    checkpoint_seconds = time.perf_counter() - start
    reports_dir = os.path.join(workdir, "palette_reports")
    n_batches = PALETTE_IMAGES // PALETTE_BATCH

    # ---- the main path, counted --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    stats = report.main(["palette_smoke", "-c", slot, "-d", manifest, "-m",
                         "palette", "-bs", str(PALETTE_BATCH), "--device",
                         "cuda", "--output-process", "--reports-dir",
                         reports_dir])
    torch.cuda.synchronize()
    report_seconds = time.perf_counter() - start
    launches_report = dict(kernels.launch_counts)

    model = Palette.load_from_checkpoint(slot, device="cuda")
    loader = BatchLoader(ImageDataset(manifest, SIZE), PALETTE_BATCH,
                         pad_mode="zero", device="cuda")
    batch = next(iter(loader))
    loader.close()
    x1 = batch.x[:1]
    torch.cuda.synchronize()
    start = time.perf_counter()
    pred, frames = model.predict(
        x1, generator=torch.Generator(device="cuda").manual_seed(7),
        output_process=True)
    torch.cuda.synchronize()
    chain_seconds_batch1 = time.perf_counter() - start
    launches = dict(kernels.launch_counts)
    peak_bytes = torch.cuda.max_memory_allocated()
    # ---- end of the counted window -----------------------------------

    forwards_report = SAMPLING_STEPS * n_batches + 1  # + the FLOP probe
    check(launches_report["flash_fwd"]
          == FLASH_LAUNCHES_PER_FORWARD * forwards_report,
          f"flash_fwd launched {launches_report['flash_fwd']} times in the "
          f"report, expected {FLASH_LAUNCHES_PER_FORWARD} x {forwards_report}")
    check(launches["flash_fwd"] == FLASH_LAUNCHES_PER_FORWARD
          * (forwards_report + SAMPLING_STEPS),
          f"flash_fwd launched {launches['flash_fwd']} times on the Palette "
          f"path, expected {FLASH_LAUNCHES_PER_FORWARD} x "
          f"{forwards_report + SAMPLING_STEPS}")
    check(launches["ssim_map"] == 17 * n_batches,
          f"ssim_map launched {launches['ssim_map']} times, expected "
          f"17 x {n_batches}")

    rdir = os.path.join(reports_dir, "palette_smoke")
    for name in ("ssim", "psnr", "mse"):
        values = read_csv_column(os.path.join(rdir, f"{name}_per_image.csv"),
                                 f"image,{name}")
        check(values.shape == (PALETTE_IMAGES,) and np.isfinite(values).all(),
              f"palette {name}_per_image.csv: {values}")
    with open(os.path.join(rdir, "depth_ssim.csv")) as f:
        check(len(f.read().splitlines()) == 17, "palette depth_ssim.csv rows")
    for sub, count in (("outputs", PALETTE_IMAGES),
                       ("ssim_images", PALETTE_IMAGES),
                       ("process", 9 * PALETTE_IMAGES)):
        files = sorted(os.listdir(os.path.join(rdir, sub)))
        check(len(files) == count, f"palette {sub}: {len(files)} files")
    check(read_png(os.path.join(rdir, "process", "00001_8.png")).shape
          == (SIZE, SIZE, 3), "process frame is not 256x256 RGB")
    with open(os.path.join(rdir, "stats.txt")) as f:
        stats_txt = dict(line.split(": ") for line in f.read().splitlines())
    check(all(np.isfinite(float(stats_txt[k]))
              for k in ("SSIM", "PSNR", "RMSE")), f"stats.txt: {stats_txt}")
    check(int(stats_txt["Parameter count"]) == n_params == stats["params"],
          f"parameter count {stats_txt['Parameter count']} vs {n_params}")
    flops = int(stats_txt["FLOPs"])
    check(flops >= 1.5e12, f"FLOPs {flops} leave out the attention")

    # the API's prediction
    check(pred.shape == (1, SIZE, SIZE, 1) and frames.shape
          == (1, 9, SIZE, SIZE, 1), f"predict: {tuple(pred.shape)}, "
          f"{tuple(frames.shape)}")
    check(bool(torch.isfinite(pred).all() and torch.isfinite(frames).all()),
          "prediction not finite")
    check(float(pred.min()) >= -1.0 and float(pred.max()) <= 1.0,
          "prediction outside [-1, 1]")
    spread = float(pred.std())
    check(spread > 0.01, f"prediction is flat (std {spread})")
    check(torch.equal(frames[:, -1], pred), "last frame is not y_0")
    api_ssim = float(metrics.ssim_per_image(denormalize(pred),
                                            denormalize(batch.y[:1]))[0])
    check(np.isfinite(api_ssim), "API prediction's SSIM not finite")

    # the same seed twice gives identical bits (no atomics in the kernel)
    again = model.predict(
        x1, generator=torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    check(torch.equal(again, pred),
          "the same seed gave different bits: max |d| "
          f"{float((again - pred).abs().max())}")

    # one denoising step on the card against the same step on the CPU
    unet = model._module
    rng = np.random.default_rng(21)
    y_t = torch.from_numpy(rng.normal(0.0, 1.0, (1, SIZE, SIZE, 1)).astype(
        np.float32))
    gamma = torch.tensor([0.5])
    with torch.inference_mode():
        on_card = unet(x1, y_t.to(device), gamma.to(device)).cpu()
    start = time.perf_counter()
    cpu_unet = Palette.load_from_checkpoint(slot, device="cpu")._module
    with torch.inference_mode():
        on_cpu = cpu_unet(x1.cpu(), y_t, gamma)
    cpu_step_seconds = time.perf_counter() - start
    del cpu_unet
    step_err = float((on_card - on_cpu).abs().max())
    step_scale = float(on_cpu.abs().max())
    step_limit = DENOISE_STEP_TOL * max(1.0, step_scale)
    check(step_err <= step_limit,
          f"one denoising step, card vs CPU: {step_err} (output up to "
          f"{step_scale}) > {step_limit}")

    # where a forward's device time goes, at the report's batch size
    xb = batch.x
    yb = torch.randn(xb.shape, device=device,
                     generator=torch.Generator(device="cuda").manual_seed(3))
    gb = torch.full((xb.shape[0],), 0.5, device=device)
    with torch.inference_mode():
        forward_ms = time_ms(lambda: unet(xb, yb, gb), samples=3, calls=2)
        events = device_events_us(lambda: unet(xb, yb, gb))
        flash_us = sum(us for name, us in events.items()
                       if "flash_fwd_kernel" in name)
        top_events = sorted(events.items(), key=lambda kv: -kv[1])[:12]
        # how long the host takes to enqueue one forward, against how long
        # the device takes to finish it
        torch.cuda.synchronize()
        start = time.perf_counter()
        unet(xb, yb, gb)
        enqueue_ms = (time.perf_counter() - start) * 1e3
        torch.cuda.synchronize()
        enqueue_and_run_ms = (time.perf_counter() - start) * 1e3
    emit({"phase": "palette", "images": PALETTE_IMAGES,
          "batch_size": PALETTE_BATCH, "channel_mults": FULL_MULTS,
          "attention_res": PALETTE_ATTENTION_RES, "steps": SAMPLING_STEPS,
          "parameters": n_params, "flops_per_forward_per_image": flops,
          "checkpoint_build_and_save_seconds": checkpoint_seconds,
          "report_seconds": report_seconds,
          "chain_seconds_batch_1": chain_seconds_batch1,
          "unet_forward_ms_batch_2": forward_ms,
          "forward_flash_fwd_us": flash_us,
          "flash_share_of_forward":
              flash_us / 1e3 / forward_ms if flash_us else None,
          "forward_top_device_events_us": [[name[:80], us]
                                           for name, us in top_events],
          "forward_host_enqueue_ms": enqueue_ms,
          "forward_enqueue_and_run_ms": enqueue_and_run_ms,
          "cpu_load_and_step_seconds": cpu_step_seconds,
          "max_memory_allocated_bytes": peak_bytes,
          "launches": launches, "launches_in_report": launches_report,
          "ssim": float(stats_txt["SSIM"]), "psnr": float(stats_txt["PSNR"]),
          "rmse": float(stats_txt["RMSE"]), "api_ssim": api_ssim,
          "prediction_std": spread,
          "denoise_step_cuda_vs_cpu_max_abs_err": step_err,
          "denoise_step_output_max_abs": step_scale,
          "limits": {"denoise_step": step_limit}})
    return launches


def kernels_line(cases, launches, flash_cases, palette_launches):
    described = {
        "ssim_map": ("pai_tpu_torch/kernels/csrc/ssim.cu",
                     "pai_tpu/kernels/ssim_pallas.py:137"),
        "ssim_scalar": ("pai_tpu_torch/kernels/csrc/ssim.cu",
                        "pai_tpu/kernels/ssim_pallas.py:172")}
    out = []
    for name, (source, replaces) in described.items():
        main = cases[name][0]  # (8,256,256,1): the report batch
        errs = [e.get("max_abs_err_map", 0.0) for e in cases[name]] + \
            [e["max_abs_err_per_image"] for e in cases[name]]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs), "shape": main["shape"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,  # no single PyTorch call computes SSIM
            "kernel_us": main["kernel_us"],
            "other_shapes": [
                {k: e[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "kernel_us")}
                for e in cases[name][1:]]})
        if name == "ssim_map":
            out[-1]["launches_palette_path"] = palette_launches[name]
    main = flash_cases[0]  # (2,4,16384,64): the longer of the Palette path's
    out.append({
        "name": "flash_fwd", "route": "cuda",
        "source": "pai_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "pai_tpu/kernels/flash_attention.py:148",
        "launches": palette_launches["flash_fwd"],
        "max_abs_err": max(e["max_abs_err"] for e in flash_cases
                           if e["dtype"] == "float32"),
        "max_abs_err_bfloat16": max(e["max_abs_err"] for e in flash_cases
                                    if e["dtype"] == "bfloat16"),
        "shape": main["shape"], "dtype": main["dtype"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "kernel_us": main["kernel_us"], "tflops": main["tflops"],
        "other_shapes": flash_cases[1:]})
    return {"kernels": out}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1

    from pai_tpu_torch import kernels
    from pai_tpu_torch.config import apply_precision_policy

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    flags = apply_precision_policy("32")
    kernels.load_library("ssim")  # builds every source, in parallel
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "precision": "32", **flags,
          "kernel_build_seconds": kernels.build_seconds})

    cases = phase_kernels(device)
    flash_cases = phase_flash(device)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_") as workdir:
        launches = phase_report(device, workdir)
        palette_launches = phase_palette(device, workdir)
    for name in ("ssim_map", "ssim_scalar"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the Pix2Pix path")
    for name in ("flash_fwd", "ssim_map"):
        check(palette_launches[name] > 0,
              f"kernel {name} was not launched on the Palette path")

    emit(kernels_line(cases, launches, flash_cases, palette_launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as failure:
        print(f"chip_smoke FAILED: {failure}", file=sys.stderr)
        sys.exit(1)
