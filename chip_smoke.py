#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Drives the port's main paths once each at full width — the Pix2Pix report
(channel mults 1,2,4,8,8,8,8,8 — 54.4 M parameters, 256x256 grayscale),
Palette sampling (the CLI-default diffusion UNet: the same mults at inner
width 128, attention at downsample rates 8,4,2, 100-step DDPM chain),
Palette training (float32, and a bf16-mixed step), GAN training (Pix2Pix
with the PatchGAN, the train CLI's default), the other generator
families' training and report (TransUNet through the CLIs; the attention
U-Net and TransUNet also under ``--precision bf16-mixed``) and a reference
Lightning ``.ckpt`` imported, reported, resumed and exported — through the
entry points a user calls, and holds every hand-written kernel against its
plain PyTorch version on the card. It imports ``pai_tpu_torch`` only (no
JAX), builds the kernels and the native PNG codec from the sources in this
checkout, needs no network and starts no process that outlives it
(``nvcc``, the C++ compiler and ``nvidia-smi`` are waited for). Phases, each
printing one JSON line:

1. ``device``  — card name and power limit, torch/CUDA versions, the precision
   switches as set, seconds spent building the kernels and the PNG codec.
   ``build`` — per flash kernel instantiation, its route, ptxas's registers
   and spills (``-Xptxas -v``) and, where the toolkit has ``cuobjdump``, the
   counts of HMMA (warp-level tensor-core), HGMMA (warpgroup ``wgmma``) and
   UTMALDG (TMA load) instructions in its SASS: the forward, dq and dkv in
   bfloat16 at D = 64 and 128, the forward and dkv in float32 there and dq
   in float32 at D = 64, must have HGMMA and UTMALDG, every other flash
   kernel (forward, dq, dkv) HMMA, none may spill up to D = 128 and ptxas
   may serialise no kernel's wgmmas (C7520); the same report of the three
   SSIM kernels and the split pass, none of which may spill.
2. ``kernels`` — each kernel's wrapper against its plain version on CUDA
   tensors at the shapes the report path gives it and at ragged and
   multi-channel shapes; times by CUDA events (warmed, median of 25 samples
   of 20 calls). The report's one SSIM launch (map, per-image SSIM and the
   depth bands) against the band-by-band plain version at the report's batch
   and at two shapes with a short last band, bit-reproducible, and a band of
   10 rows raising.
   The flash-attention cases, forward and backward: the shapes the Palette
   paths launch, every head dim in float32 and bfloat16, a peaked case of
   each type (q and k four times larger: a nearly one-hot softmax), strided
   views of a packed qkv tensor, the log-sum-exp output (in every bfloat16
   and peaked case too, and beside every backward case the o and lse that
   the backward takes), and the inputs that must raise; per case the
   arithmetic route (``wgmma-bf16``, ``wgmma-3xtf32``, ``mma-bf16`` or
   ``mma-3xtf32``) of the
   kernel that the build phase saw launch at its type and head dim, two
   launches bit-equal, and the bound at its rate, for float32 also at the
   CUDA cores' rate; beside the kernel's time the plain version's and that
   of PyTorch's own fused attention call on the same tensors (timed here,
   used nowhere in the port). The split pass (``flash_split``) of the
   float32 forward and backward at the Palette paths' shapes and on packed
   views,
   bit-equal to its plain version, timed beside it.
3. ``report``  — a 32-pair 256x256 synthetic dataset written with the port's
   native PNG writer, a full-width Pix2Pix with random weights from a seeded
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

5. ``gradcheck`` — one training step of a small UNet, card against CPU.
6. ``train`` — full-width Palette training through ``pai_tpu_torch.main``
   at ``--precision 32``: 4 steps, a validation, best and last slots; then
   single steps at batch 4 (profiled: device busy time and per-kernel time)
   and 8.
7. ``bf16`` — each bf16 rounding point of the layers, and a small UNet's
   bf16 forward, on the card against the same code on the CPU, each with a
   control that must fail; then the full-width UNet under ``--precision
   bf16-mixed``: one forward at batch 2 and one training step at batch 4,
   timed, with the flash launches and the dtype of their operands
   (bfloat16), finite outputs and gradients.
8. ``gan`` — GAN training at the published width through
   ``pai_tpu_torch.main -m pix2pix --loss-type gan`` (the CLI's defaults,
   ``--precision 32``, batch 8): 10 steps with a log row at step 10, a
   validation over 32 pairs (one ``ssim_scalar`` launch per batch), best
   and last slots; ``--resume`` to a second epoch (it must start at step
   10); the report CLI on the best slot (one ``ssim_map`` launch per
   batch); a profiled lean step (device busy time, the convolutions'
   share, peak memory); one timed step of each other loss type, with the
   SSIM losses' one ``ssim_scalar`` launch per lean step and the time of
   their backward (the plain version's, as the JAX package's
   ``custom_vjp``); a small GAN step of every loss type on the card against
   the CPU; one bf16-mixed GAN step.
9. ``families`` — the other six generator families (attention U-Net, the
   four residual U-Nets, TransUNet) at their published widths, float32,
   batch 8: per family the parameter count against the reference's, an
   eval forward, three warm lean ``gan`` steps timed (CUDA events, host
   enqueue) and one profiled (device busy time, the convolutions' share,
   the top kernels), and a small ``gan`` step card vs CPU; the max pool's
   gradient at tied windows card vs CPU; then ``pai_tpu_torch.main -m
   trans_unet --channel-mults 1,2,2,4,4`` (1.03 B parameters) through 10
   steps, a validation, best and last slots, ``--resume`` to a second
   epoch, and the report CLI on the best slot, with ``ssim_scalar`` counted
   on the training path and ``ssim_map`` on the report.
10. ``families_bf16`` — the same six families under ``--precision
   bf16-mixed`` at their published widths, batch 8: the parameters float32
   and a convolution's input bfloat16, an eval forward, three warm lean
   ``gan`` steps timed and one profiled, peak memory, finite losses and
   gradients; a small model of each family's bf16 forward card vs CPU,
   with a float32 control that must fail; then ``pai_tpu_torch.main -m
   attention_unet --loss-type ssim`` and ``-m trans_unet --channel-mults
   1,2,2,4,4`` at ``--precision bf16-mixed`` (10 steps, a validation; the
   TransUNet run's last slot gathered but not written) and the report CLI
   on each best slot, ``ssim_scalar`` and ``ssim_map`` counted per run and
   per step; and the live progress line: 20 Pix2Pix GAN steps through the
   train CLI with ``sys.stderr`` a pseudo-terminal, where a profiler window
   over the off-row steps must hold no host synchronisation and the line
   must show the losses the steps returned.
11. ``interop`` — the native PNG codec: its batch decoder against the plain
   version over the report's 32 pairs (byte-equal) and over RGB, palette
   and 16-bit files with every filter type at 256x256 (byte-equal) and
   300x200 (resized: the exact share and the largest difference, at most
   one level), and ms per 32 pairs, native on 8 threads against plain.
   Then a reference-layout Lightning ``.ckpt`` of Pix2Pix at the published
   widths with the PatchGAN and a torch_ema payload (shadow weights unlike
   the raw ones) through ``python -m pai_tpu_torch.interop.lightning import
   --slot best`` and the report CLI over 32 images at batch 8 (launch
   counts set to 0 just before and read just after: 4 ``ssim_map``), its
   outputs and per-image numbers bit-equal to the shadow weights loaded
   directly, as are ``load_from_checkpoint`` and
   ``from_lightning_checkpoint`` predictions (with cuDNN deterministic: its
   default forward differs between two runs of one module, which is read); ``import --slot last`` and
   ``pai_tpu_torch.main --resume`` for 10 steps from the checkpoint's
   ``global_step`` with its EMA update count carried on; ``export`` of the
   best slot bit-equal to the source's shadow and PatchGAN tensors.

12. ``parallel`` — the multi-device layer on this one card. Ring attention
   (``parallel.ring_attention.sequence_sharded_attention``) over 2 and 4
   ranks, spawned together on the card over gloo (``--rank-job``), at
   (2,4,16384,64) float32 and bfloat16 and (2,4,4096,128) float32, forward
   and dq, dk, dv against the one-process ``FlashAttention`` on the card
   (float32 2e-5 forward, 1e-4 of the largest gradient backward; bfloat16
   2^-8 plus one bf16 unit), launches per rank and ring exactly n of
   ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` where the shard
   takes the flash hop (none on the einsum hop, where t/n < 2048), and each
   ring's time beside the one-process time. ``pai_tpu_torch.main -m pix2pix
   --fsdp`` on a world of one over NCCL (started by the Trainer from a
   launcher's environment): 10 steps at the published widths, a
   validation, slots, ``--resume`` to step 20, every loss and every slot
   tensor bit-equal to the plain run's (cuDNN deterministic in both), step
   times side by side. ``--tp 2`` Pix2Pix GAN with 2 ranks and ``--sp 2``
   Palette at the CLI-default width (batch 2, 2 steps and a validation
   whose sampling chain is cut from 100 steps to 5, its slots gathered but
   not written: the ring's flash hops counted) through ``pai_tpu_torch.main.main``, each against a one-process
   run from the same state: every step's loss within 1e-3; after the first
   step, Adam's moments within 1e-3 of the largest of their chain and kind,
   parameters within 1e-2 of the learning rate where the first moment is
   at least 1e-3 of its tensor's largest and within two learning rates
   where the gradient is float noise (``adam_agreement``; ``--tp 2`` with
   cuDNN deterministic in both); peak memory per rank.
   ``--fsdp`` with 2 ranks is not run here (FSDP2 over gloo on CUDA tensors
   ends the process; a line says so); the CPU tests hold it.
13. ``graphs`` — the CUDA graphs, with cuDNN deterministic on both sides of
   every comparison. Through ``pai_tpu_torch.main`` at the published widths,
   batch 8, 80 pairs (10 steps per epoch), with ``--ema``: Pix2Pix GAN at
   ``--precision 32`` with ``--dropout 0.5`` (the literal double forward,
   its masks drawn in the graph) and at bf16-mixed (also ``--scan-steps
   10``), 20 steps, and the attention U-Net with ``--loss-type ssim`` at
   bf16-mixed, 10 steps, each with ``--scan-steps 5`` against 1: every
   tensor of the last slot (parameters, running statistics, Adam's moments
   and counts, the EMA) bit-equal, the CSV rows equal, the launch counts
   equal (``ssim_scalar`` > 0); per side the enqueue and CUDA-event ms per
   step from the second chunk on, peak memory, the graph's capture and
   instantiate seconds and pool bytes, and the device busy time per step
   over one profiled chunk (Palette's is not read here). Palette at the CLI
   defaults, bf16-mixed, batch 4, with the EMA: 10 steps as chunks of
   ``TrainScan`` and an ordinary step against 10 ordinary steps, bit-equal,
   the flash launches per step equal. Its UNet's 100-step chain at batch 2
   with the report's frames through ``reporting.palette_predictor`` (one
   graph, recorded at the first call and replayed at the second) against
   ``diffusion.sampler.ddpm_loop``: ``y_0`` and the frames bit-equal, the
   launches equal (the recording call's plus one warm-up UNet evaluation),
   the generator left at the same offset, seconds per chain. One ``flash_fwd``, and one dq and dkv, recorded alone in a graph, in
   bfloat16 and in float32 (with the split pass): bit-equal to the eager
   launch and within the flash gates of the plain version.

Then one line ``{"kernels": [...]}`` with, per kernel, its route, source, the
TPU kernel it replaces (the split pass: none), its launches in phase 3, its
error against the plain version, its time, the plain version's time and the
card's bound for the same work and the library call's time where there is
one; then the card's name and power limit; then, last,
``{"ok": true, "device": {...}}``.

Any failure — no GPU, a failed build, a refused launch, a mismatch, a missing
file — ends the run with a non-zero exit code and no ``ok`` line.
"""

import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# float32 rate of the CUDA cores (the SSIM kernels use no tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense bf16 rate of the tensor cores: the operations bound of bf16 operands
BF16_FLOP_PER_S = 989e12
# float32 products as three TF32 products on the tensor cores (3xTF32; 495
# TFLOP/s dense TF32): the operations bound of float32 operands in the flash
# kernels (forward, dq, dkv), which run them that way
TF32X3_FLOP_PER_S = 495e12 / 3
# 5 maps x 11 taps x 2 passes x 2 (multiply-add) + 3 products + 17 for the
# ratio, per output pixel
SSIM_FLOP_PER_PIXEL = 5 * 11 * 2 * 2 + 3 + 17

MAP_TOL = 2e-5        # SSIM map, kernel vs plain: float32 FMAs vs separate
PER_IMAGE_TOL = 1e-5  # multiply and add, summed in another order
# one ssim_map launch per report batch: the map, the per-image SSIM and the
# 16 depth bands (ssim_report_fused)
SSIM_MAP_LAUNCHES_PER_BATCH = 1
# the CUDA kernels each SSIM wrapper launches, as the profiler names them
SSIM_KERNEL_NAMES = {"ssim_map": ("ssim_rows_kernel<true>",
                                  "ssim_finish_kernel"),
                     "ssim_scalar": ("ssim_rows_kernel<false>",
                                     "ssim_finish_kernel")}
FORWARD_TOL = 1e-3    # card vs CPU forward, true float32 both, 16 conv layers

# flash attention, kernel vs plain version. float32 operands: the same
# float32 arithmetic summed in another order, exp2 against exp. bfloat16
# operands: both compute in float32 and round the output once, so they differ
# by at most one bf16 unit in the last place (2^-8 relative).
FLASH_TOL = 2e-5
FLASH_LSE_TOL = 2e-5
FLASH_BF16_REL_TOL = 2.0 ** -8
# the peaked cases, forward and backward: q and k FLASH_PEAK times larger, a
# nearly one-hot softmax where a probability rounded to one bf16 term would
# show. The logits are 16 times larger, and so is every absolute float32
# rounding in and after them, in both versions: float32 limits 16 times the
# ones of the unit-variance cases (FLASH_PEAKED_FACTOR). bfloat16 outputs reach
# the [4, 8) binade, where one bf16 unit is 2^-5, more than 2^-8 of the
# largest output: each output is held to one bf16 unit in the last place of
# itself (outputs under 2^-8 of the largest: of that magnitude), see
# bf16_ulps. Fixed before the cases first ran on the card. The unit-variance
# bfloat16 cases are held to the same unit as well as to their relative
# limits: both versions round one float32 value once.
FLASH_PEAK = 4.0
FLASH_PEAKED_FACTOR = 16
FLASH_BF16_ULPS = 1.0
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


# the CUDA kernels each flash wrapper launches, as the profiler and ptxas
# name them: warp-level mma.sync, and at D = 64 and 128 on warpgroup wgmma
# with TMA loads (all three in bfloat16; in float32 the forward, dkv and,
# at D = 64, dq)
FLASH_KERNEL_NAMES = {
    "flash_fwd": ("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
    "flash_bwd_dq": ("flash_bwd_dq_kernel", "flash_bwd_dq_wgmma_kernel"),
    "flash_bwd_dkv": ("flash_bwd_dkv_kernel", "flash_bwd_dkv_wgmma_kernel")}
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel")
# the wgmma instantiations of each type: (kernel, D)
WGMMA_INSTANTIATIONS = {
    "bfloat16": [(k, d) for k in sorted(WGMMA_KERNELS) for d in (64, 128)],
    "float32": sorted([(k, d) for k in ("flash_bwd_dkv_wgmma_kernel",
                                        "flash_fwd_wgmma_kernel")
                       for d in (64, 128)]
                      + [("flash_bwd_dq_wgmma_kernel", 64)])}
# the split pass of the float32 forward and backward at D = 64 and 128, as
# the profiler and ptxas name it
SPLIT_KERNEL = "flash_split_kernel"
# the head dims at which ptxas must report no spills for them
NO_SPILL_HEAD_DIMS = (32, 64, 128)


def flash_kernel_ms(events, name):
    """Device ms of the CUDA kernels of flash wrapper `name` (or of the
    split pass, ``flash_split``) among profiler events ({name: us})."""
    names = (SPLIT_KERNEL,) if name == "flash_split" \
        else FLASH_KERNEL_NAMES[name]
    return sum(us for key, us in events.items()
               if any(k + "<" in key for k in names)) / 1e3


def describe_instantiation(mangled):
    """(kernel, dtype, template integers) of a mangled kernel name, e.g.
    flash_fwd_kernel<float, 64, 128, 64> -> ("flash_fwd_kernel", "float32",
    [64, 128, 64]), or None for a name of no flash kernel."""
    for kernel in (k for ks in FLASH_KERNEL_NAMES.values() for k in ks):
        at = mangled.find(kernel + "I")
        if at >= 0:
            rest = mangled[at + len(kernel) + 1:]
            dtype = "bfloat16" if rest.startswith("13__nv_bfloat16") \
                else "float32"
            return kernel, dtype, [int(x) for x in re.findall(r"Li(\d+)E",
                                                              rest)]
    return None


def launched_instantiations(fn):
    """{(kernel, dtype, template integers): profiler args} of every flash
    kernel launch that ``fn`` makes, from the Chrome trace of
    torch.profiler, whose kernel events carry the launch's registers per
    thread and shared memory (static and dynamic) in bytes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="pai_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    found = {}
    flash = {k for ks in FLASH_KERNEL_NAMES.values() for k in ks}
    for event in events:
        m = re.search(r"(flash_\w+_kernel)<([^>]*)>", event.get("name", ""))
        if m is None or event.get("cat") != "kernel" \
                or m.group(1) not in flash:
            continue
        dtype, *ints = (x.strip() for x in m.group(2).split(","))
        found[(m.group(1), "bfloat16" if "bfloat16" in dtype else "float32",
               tuple(int(x) for x in ints))] = event.get("args", {})
    return found


def flash_route(kernel, dtype):
    """The arithmetic route of CUDA kernel `kernel` on `dtype` operands
    ("bfloat16" or "float32")."""
    arith = "bf16" if dtype == "bfloat16" else "3xtf32"
    return ("wgmma-" if kernel in WGMMA_KERNELS else "mma-") + arith


def phase_build():
    """What ptxas reported for every flash kernel instantiation (registers,
    spills), how many HMMA (mma.sync), HGMMA (wgmma) and UTMALDG (TMA load)
    instructions cuobjdump finds in it, where the toolkit has cuobjdump, and
    the shared memory of one launch of it (T = 256), from the profiler's
    trace. Returns that report and the route each flash wrapper took at each
    (dtype, D), {(wrapper, "float32" or "bfloat16", D): route}, read from
    the name of the kernel that launched. Fails if a kernel spills at
    D <= 128, if a wgmma kernel (the forward, dq and dkv in bfloat16 at
    D = 64 and 128, the forward and dkv in float32 there and dq in float32
    at D = 64, all eleven present)
    lacks HGMMA or UTMALDG or has its wgmmas serialised by ptxas (C7520),
    if another flash kernel lacks HMMA, or if the split pass spills."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa

    entries, serialised = {}, []
    for lib in ("flash_attention", "flash_attention_bwd"):
        entry = None
        for line in kernels.build_log(lib).splitlines():
            m = re.search(r"wgmma.mma_async instructions are serialized .* "
                          r"in the function '(\S+)'", line)
            if m:
                serialised.append(m.group(1))
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                found = describe_instantiation(m.group(1))
                entry = None if found is None else entries.setdefault(
                    m.group(1), {"kernel": found[0], "dtype": found[1],
                                 "template": found[2], "library": lib})
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                entry["spill_stores"] = int(m.group(1))
                entry["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
                entry["ptxas"] = line.split(":", 1)[-1].strip()
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    have_cuobjdump = os.path.isfile(cuobjdump)
    if have_cuobjdump:
        for lib in ("flash_attention", "flash_attention_bwd"):
            sass = subprocess.run(
                [cuobjdump, "-sass", kernels._library_path(lib)], check=True,
                capture_output=True, text=True, timeout=300).stdout
            current = None
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    current = m.group(1) if m.group(1) in entries else None
                    if current:
                        entries[current].update(hmma=0, hgmma=0, utmaldg=0)
                elif current:
                    for op in ("HMMA", "HGMMA", "UTMALDG"):
                        entries[current][op.lower()] += op in line

    def launch_every_instantiation():
        for dtype in (torch.float32, torch.bfloat16):
            for d in (32, 64, 128, 256):
                q, k, v = random_qkv((1, 1, 256, d), d, "cuda", dtype)
                o, lse = fa.flash_attention(q, k, v, emit_lse=True)
                fa.flash_attention_backward(q, k, v, o, lse, v)

    launched = launched_instantiations(launch_every_instantiation)
    routes = {}
    for kernel, dtype, template in launched:
        wrapper = next(w for w, ks in FLASH_KERNEL_NAMES.items()
                       if kernel in ks)
        key = (wrapper, dtype, template[0])
        check(key not in routes, f"{wrapper} {dtype} D={template[0]} "
              "launched two kernels")
        routes[key] = flash_route(kernel, dtype)
    for e in entries.values():
        args = launched.get((e["kernel"], e["dtype"], tuple(e["template"])))
        check(args is not None, f"no launch of {e['kernel']} {e['dtype']} "
              f"{e['template']} in the profiler's trace")
        e["smem_bytes"] = args.get("shared memory")
        e["registers_launched"] = args.get("registers per thread")
    rows = sorted(entries.values(), key=lambda e: (e["kernel"], e["dtype"],
                                                   e["template"]))
    check(len(rows) == 24, f"ptxas reported {len(rows)} flash kernel "
          "instantiations, expected 24 (3 kernels x 2 types x 4 head dims)")
    for dtype, want in WGMMA_INSTANTIATIONS.items():
        wgmma = sorted((e["kernel"], e["template"][0]) for e in rows
                       if e["kernel"] in WGMMA_KERNELS
                       and e["dtype"] == dtype)
        check(wgmma == want, f"{dtype} wgmma instantiations {wgmma}: "
              f"expected {want}")
    check(not serialised, f"ptxas serialised the wgmmas of {serialised}")
    for e in rows:
        d = e["template"][0]
        e["route"] = flash_route(e["kernel"], e["dtype"])
        if d in NO_SPILL_HEAD_DIMS:
            check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
                  f"{e['kernel']} {e['dtype']} D={d} spills: {e}")
        if not have_cuobjdump:
            continue
        if e["kernel"] in WGMMA_KERNELS:
            check(e.get("hgmma", 0) > 0 and e.get("utmaldg", 0) > 0,
                  f"{e['kernel']} {e['dtype']} D={d} has {e.get('hgmma')} "
                  f"HGMMA and {e.get('utmaldg')} UTMALDG: not on wgmma with "
                  "TMA loads")
        else:
            check(e.get("hmma", 0) > 0, f"{e['kernel']} {e['dtype']} D={d} "
                  "has no HMMA instruction: not on the tensor cores")
    ssim_rows = ssim_ptxas(kernels.build_log("ssim"))
    check(len(ssim_rows) == 3, f"ptxas reported {len(ssim_rows)} SSIM "
          "kernels, expected 3 (rows<true>, rows<false>, finish)")
    for e in ssim_rows:
        check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
              f"SSIM kernel {e['kernel']} spills: {e}")
    split_rows = split_ptxas(kernels.build_log("flash_split"))
    check([e["d"] for e in split_rows] == [64, 128], f"ptxas reported the "
          f"split pass at {[e['d'] for e in split_rows]}, expected D = 64 "
          "and 128")
    for e in split_rows:
        check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
              f"the split pass spills: {e}")
    return {"phase": "build", "cuobjdump": have_cuobjdump,
            "kernel_build_seconds": kernels.build_seconds,
            "wgmma_serialised": serialised, "instantiations": rows,
            "ssim": ssim_rows, "flash_split": split_rows}, routes


def split_ptxas(log):
    """Registers, spills and ptxas's resource line of the split pass at each
    head dim, from the ``-Xptxas -v`` report of its library."""
    rows, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            d = re.search(SPLIT_KERNEL + r"ILi(\d+)E", m.group(1))
            entry = {"kernel": SPLIT_KERNEL, "d": int(d.group(1))} \
                if d else None
            if entry:
                rows.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"] = int(m.group(1))
            entry["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            entry["ptxas"] = line.split(":", 1)[-1].strip()
    return sorted(rows, key=lambda e: e["d"])


def ssim_ptxas(log):
    """Registers, spills and ptxas's resource line of each SSIM kernel, from
    the ``-Xptxas -v`` report of its library."""
    rows, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernel = ("ssim_rows_kernel<true>" if "ssim_rows_kernelILb1" in name
                      else "ssim_rows_kernel<false>"
                      if "ssim_rows_kernelILb0" in name
                      else "ssim_finish_kernel"
                      if "ssim_finish_kernel" in name else None)
            entry = None if kernel is None else {"kernel": kernel}
            if entry is not None:
                rows.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"] = int(m.group(1))
            entry["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            entry["ptxas"] = line.split(":", 1)[-1].strip()
    return rows


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
    cuda_names = {"ssim_map": SSIM_KERNEL_NAMES["ssim_map"],
                  "ssim_scalar": SSIM_KERNEL_NAMES["ssim_scalar"]}
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

    report = report_cases(device)
    emit({"phase": "kernels", "kernels": sorted(results),
          "limits": {"map": MAP_TOL, "per_image": PER_IMAGE_TOL},
          "strided_band_max_abs_err": strided,
          "gradient_max_abs_err": grad_err, "cases": results,
          "report_cases": report})
    return results, report


def report_cases(device):
    """``ssim_report_fused`` (one ``ssim_map`` launch: map, per-image SSIM
    and every depth band) and ``ssim_bands_fused`` (``ssim_scalar``, no map)
    against the plain band-by-band formulation, ``ssim_report_plain``, which
    computes each band as an image of its own: the card checks the identity
    the kernels rely on (a band's SSIM is a mean over rows of the whole
    map). The report's batch; a ragged width with a short last band; three
    channels with 6 bands and a short last band. Two calls must agree bit for
    bit, and a band of 10 rows must raise."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import ssim

    out = []
    for seed, (shape, depths) in enumerate((((8, 256, 256, 1), 16),
                                            ((3, 252, 97, 1), 16),
                                            ((2, 71, 40, 3), 6))):
        pred, target = random_pair(shape, 20 + seed, device)
        want = ssim.ssim_report_plain(pred, target, depths)
        before = dict(kernels.launch_counts)
        got = ssim.ssim_report_fused(pred, target, depths)
        again = ssim.ssim_report_fused(pred, target, depths)
        bands_only = ssim.ssim_bands_fused(pred, target, depths)
        torch.cuda.synchronize()
        check(kernels.launch_counts["ssim_map"] == before["ssim_map"] + 2
              and kernels.launch_counts["ssim_scalar"]
              == before["ssim_scalar"] + 1,
              f"report entry launches at {shape}: {kernels.launch_counts}")
        check(got[1].shape == pred.shape
              and got[2].shape == want[2].shape == (shape[0], depths),
              f"report entry shapes at {shape}: "
              f"{[tuple(t.shape) for t in got]}")
        entry = {"shape": list(shape), "num_depths": depths,
                 "band_rows": ssim.band_rows(shape[1], depths)[-1],
                 "max_abs_err_map": float((got[1] - want[1]).abs().max()),
                 "max_abs_err_per_image": float(
                     (got[0] - want[0]).abs().max()),
                 "max_abs_err_bands": float((got[2] - want[2]).abs().max()),
                 "max_abs_err_bands_no_map": float(
                     (bands_only - want[2]).abs().max()),
                 "bit_identical": all(torch.equal(a, b)
                                      for a, b in zip(got, again))}
        check(entry["max_abs_err_map"] <= MAP_TOL
              and max(entry["max_abs_err_per_image"],
                      entry["max_abs_err_bands"],
                      entry["max_abs_err_bands_no_map"]) <= PER_IMAGE_TOL,
              f"ssim_report_fused differs from the band-by-band plain "
              f"version at {shape}: {entry}")
        check(entry["bit_identical"],
              f"two ssim_report_fused calls differ at {shape}")
        if seed == 0:  # the report batch: timed
            bound_ms, bound_by = ssim_bound(shape, "ssim_map")
            entry.update(
                ms=time_ms(lambda: ssim.ssim_report_fused(pred, target)),
                plain_ms=time_ms(lambda: ssim.ssim_report_plain(pred, target),
                                 samples=10, calls=3),
                kernel_us=device_kernel_us(
                    lambda: ssim.ssim_report_fused(pred, target),
                    SSIM_KERNEL_NAMES["ssim_map"]),
                bound_ms=bound_ms, bound_by=bound_by)
        out.append(entry)
    # a band of 10 rows: no interior, as an image of 10 rows
    pred, target = random_pair((2, 160, 32, 1), 30, device)
    expect_raises(ValueError, lambda: ssim.ssim_report_fused(pred, target),
                  "a depth band of 10 rows")
    expect_raises(ValueError, lambda: ssim.ssim_bands_fused(pred, target),
                  "a depth band of 10 rows (no map)")
    return out





def tensor_core_rate(dtype):
    return BF16_FLOP_PER_S if dtype == torch.bfloat16 else TF32X3_FLOP_PER_S


def larger_bound(nbytes, ops, rate):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over `rate`."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def flash_bound(shape, dtype, emit_lse=False, rate=None):
    """(bound_ms, bound_by) of one attention call: q, k, v read once and o
    (and lse) written once over the memory rate, against 4*B*H*T*T*D
    operations over `rate`, by default the kernel's tensor-core rate for the
    operands' type (bfloat16: the dense bf16 rate; float32: 3xTF32, a third
    of the TF32 rate)."""
    b, h, t, d = shape
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = 4 * b * h * t * d * size + (4 * b * h * t if emit_lse else 0)
    return larger_bound(nbytes, 4 * b * h * t * t * d,
                        rate or tensor_core_rate(dtype))


def bf16_ulps(got, want):
    """The largest |got - want| in bf16 units in the last place of the larger
    of the two, outputs under 2^-8 of the largest output held to the unit at
    that magnitude (2^-15 of the largest)."""
    got, want = got.float(), want.float()
    floor = 2.0 ** -8 * float(want.abs().max())
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(max(floor, 1e-30))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())


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


def phase_flash(device, routes):
    """The flash-attention wrapper vs its plain version on the card; each
    case's route from ``routes`` (phase_build's)."""
    import torch.nn.functional as F

    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels.flash_attention import (flash_attention,
                                                       flash_attention_plain)

    # (shape, dtype, timed in full, q and k times); the first two are the
    # Palette path's, in float32 and (bf16-mixed) in bfloat16, the last two
    # the peaked cases
    cases = [((2, 4, 16384, 64), torch.float32, True, 1.0),
             ((2, 4, 4096, 128), torch.float32, True, 1.0),
             ((1, 2, 4096, 32), torch.float32, False, 1.0),
             ((1, 1, 1024, 256), torch.float32, False, 1.0),
             ((2, 4, 16384, 64), torch.bfloat16, True, 1.0),
             ((2, 4, 4096, 128), torch.bfloat16, True, 1.0),
             ((2, 4, 4096, 64), torch.bfloat16, True, 1.0),
             ((1, 2, 4096, 32), torch.bfloat16, False, 1.0),
             ((1, 1, 1024, 256), torch.bfloat16, False, 1.0),
             ((2, 4, 4096, 64), torch.float32, False, FLASH_PEAK),
             ((2, 4, 4096, 64), torch.bfloat16, False, FLASH_PEAK)]
    results = []
    for seed, (shape, dtype, full, peak) in enumerate(cases):
        q, k, v = random_qkv(shape, 100 + seed, device, dtype)
        if peak != 1.0:
            q, k = q * peak, k * peak
        want, want_lse = flash_attention_plain(q, k, v, emit_lse=True)
        before = kernels.launch_counts["flash_fwd"]
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        check(kernels.launch_counts["flash_fwd"] == before + 1,
              f"flash_fwd did not count its launch at {shape}")
        check(got.shape == q.shape and got.dtype == dtype and got.is_cuda,
              f"flash_fwd output {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"flash_fwd not finite {shape}")
        err = float((got.float() - want.float()).abs().max())
        entry = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                 "peak": peak, "max_abs_err": err}
        entry["arith_route"] = routes[("flash_fwd", entry["dtype"],
                                       shape[-1])]
        if peak == 1.0:
            limit = FLASH_TOL if dtype == torch.float32 else \
                FLASH_BF16_REL_TOL * max(1.0, float(want.float().abs().max()))
            check(err <= limit, f"flash_fwd differs from plain at {shape} "
                  f"{dtype}: {err} > {limit}")
            entry["limit"] = limit
            if dtype == torch.bfloat16:
                ulps = bf16_ulps(got, want)
                check(ulps <= FLASH_BF16_ULPS, f"flash_fwd differs from "
                      f"plain at {shape} bf16: {ulps} bf16 units")
                entry.update(bf16_ulps=ulps, limit_ulps=FLASH_BF16_ULPS)
        elif dtype == torch.float32:
            limit = FLASH_PEAKED_FACTOR * FLASH_TOL
            check(err <= limit, f"flash_fwd differs from plain at {shape} "
                  f"peaked: {err} > {limit}")
            entry["limit"] = limit
        else:
            ulps = bf16_ulps(got, want)
            check(ulps <= FLASH_BF16_ULPS, f"flash_fwd differs from "
                  f"plain at {shape} bf16 peaked: {ulps} bf16 units")
            entry.update(bf16_ulps=ulps, limit_ulps=FLASH_BF16_ULPS)
        # the lse that the backward and ring attention's hops take, held
        # against the plain one in every bfloat16 case and the peaked ones
        if dtype == torch.bfloat16 or peak != 1.0:
            _, lse = flash_attention(q, k, v, emit_lse=True)
            lse_err = float((lse - want_lse).abs().max())
            lse_limit = FLASH_LSE_TOL * (FLASH_PEAKED_FACTOR if peak != 1.0
                                         else 1)
            check(lse_err <= lse_limit, f"flash_fwd lse at {shape} {dtype} "
                  f"(q, k x {peak}): {lse_err} > {lse_limit}")
            entry.update(lse_max_abs_err=lse_err, lse_limit=lse_limit)
            del lse
        check(torch.equal(got, flash_attention(q, k, v)),
              f"flash_fwd ({entry['arith_route']}) is not bit-reproducible "
              f"at {shape}: two launches differ")
        bound_ms, bound_by = flash_bound(shape, dtype)
        entry.update(ms=time_ms(lambda: flash_attention(q, k, v), samples=5,
                                calls=3),
                     bound_ms=bound_ms, bound_by=bound_by)
        if dtype == torch.float32:
            entry["bound_ms_cuda_cores"] = flash_bound(
                shape, dtype, rate=F32_FLOP_PER_S)[0]
        if full:
            entry.update(
                plain_ms=time_ms(lambda: flash_attention_plain(q, k, v),
                                 samples=3, calls=1),
                kernel_us=device_kernel_us(lambda: flash_attention(q, k, v),
                                           FLASH_KERNEL_NAMES["flash_fwd"],
                                           calls=3),
                # the yardstick: timed only (float32 with TF32 off, as set)
                library_ms=time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=shape[-1] ** -0.5),
                    samples=5, calls=3))
            entry["tflops"] = 4 * shape[0] * shape[1] * shape[2] ** 2 \
                * shape[3] / entry["ms"] / 1e9
        results.append(entry)
        del q, k, v, want, want_lse, got

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
    # the same views in bfloat16 (row stride 768 elements: whole 16-byte
    # copies), as AttentionBlock hands them over under bf16 autocast
    packed16 = packed.bfloat16()
    q, k, v = (packed16[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous())
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    strided_bf16_err = float((got.float() - want.float()).abs().max())
    strided_bf16_limit = FLASH_BF16_REL_TOL * max(
        1.0, float(want.float().abs().max()))
    check(strided_bf16_err <= strided_bf16_limit,
          f"flash_fwd differs from plain on bf16 packed views: "
          f"{strided_bf16_err}")
    del packed16

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
    expect_raises(ValueError,
                  lambda: flash_attention(leaf, k, v, emit_lse=True),
                  "lse asked for under grad on the card")

    emit({"phase": "kernels", "kernels": ["flash_fwd"],
          "limits": {"float32": FLASH_TOL, "lse": FLASH_LSE_TOL,
                     "bfloat16_relative": FLASH_BF16_REL_TOL},
          "packed_views_max_abs_err": strided_err,
          "packed_views_bf16_max_abs_err": strided_bf16_err,
          "lse_max_abs_err": lse_err, "with_lse_output_max_abs_err": out_err,
          "cases": results})
    return results


def split_bound(shape, modes):
    """(bound_ms, "bytes") of one split pass: each operand read once and its
    planes written once, over the memory rate (two flops an element)."""
    from pai_tpu_torch.kernels.flash_attention import split_planes

    b, h, t, d = shape
    n = b * h * t * d * 4
    return larger_bound(n * (len(modes) + split_planes(modes)),
                        2 * b * h * t * d * len(modes), F32_FLOP_PER_S)


def phase_split(device):
    """The split pass of the float32 forward and backward (their wgmma
    routes at D = 64 and 128; one pass per backward call for dq and dkv)
    against its plain version on the card: bit for bit, at the Palette
    paths' shapes and on packed views, its launch counted, timed beside the
    plain version."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa

    cases = [((2, 4, 16384, 64), "forward", fa.FORWARD_SPLIT),
             ((2, 4, 4096, 128), "forward", fa.FORWARD_SPLIT),
             ((4, 4, 16384, 64), "backward", fa.BACKWARD_SPLIT),
             ((4, 4, 4096, 128), "backward", fa.BACKWARD_SPLIT)]
    results = []
    for seed, (shape, kind, modes) in enumerate(cases):
        xs = random_qkv(shape, 120 + seed, device) + random_qkv(
            shape, 130 + seed, device)[:1]
        xs = xs[:len(modes)]
        want = fa.flash_split_plain(xs, modes)
        before = kernels.launch_counts["flash_split"]
        got = fa.flash_split(xs, modes)
        torch.cuda.synchronize()
        check(kernels.launch_counts["flash_split"] == before + 1,
              f"flash_split did not count its launch at {shape}")
        check(got.shape == want.shape and torch.equal(got, want),
              f"flash_split ({kind}) differs from plain at {shape}: "
              f"{float((got - want).abs().max())}")
        bound_ms, bound_by = split_bound(shape, modes)
        results.append({
            "shape": list(shape), "for": kind, "planes": got.shape[0],
            "bit_equal": True, "max_abs_err": 0.0,
            "ms": time_ms(lambda: fa.flash_split(xs, modes), samples=5,
                          calls=3),
            "plain_ms": time_ms(lambda: fa.flash_split_plain(xs, modes),
                                samples=3, calls=1),
            "kernel_us": device_kernel_us(
                lambda: fa.flash_split(xs, modes), (SPLIT_KERNEL,),
                calls=3),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del xs, want, got
    # q, k, v as views of one packed (N, T, heads, 3, D) tensor, as the
    # attention block hands them to the forward
    rng = np.random.default_rng(140)
    packed = torch.from_numpy(rng.normal(0.0, 1.0, (2, 4096, 4, 3, 64)).astype(
        np.float32)).to(device)
    views = tuple(packed[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    check(torch.equal(fa.flash_split(views, fa.FORWARD_SPLIT),
                      fa.flash_split_plain(tuple(v.contiguous()
                                                 for v in views),
                                           fa.FORWARD_SPLIT)),
          "flash_split differs from plain on packed views")
    expect_raises(ValueError, lambda: fa.flash_split(
        random_qkv((1, 1, 256, 32), 141, device), fa.FORWARD_SPLIT),
        "the split pass at D = 32")
    emit({"phase": "kernels", "kernels": ["flash_split"],
          "limits": {"bit_equal": True}, "packed_views_bit_equal": True,
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


def seeded_pix2pix(device, seed):
    """Full-width Pix2Pix initialised on the card from a generator seeded
    ``seed``, BatchNorm statistics moved off their defaults; eval mode."""
    from pai_tpu_torch.models import build_generator

    gen = torch.Generator(device=device).manual_seed(seed)
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
    return model.eval()


def make_checkpoint(directory, device):
    """``seeded_pix2pix`` saved as an eval checkpoint. Returns (slot path,
    parameter count)."""
    from pai_tpu_torch.config import TRAIN_DEFAULTS
    from pai_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from pai_tpu_torch.utils.flops import parameter_count

    hparams = dict(TRAIN_DEFAULTS, model="pix2pix", channel_mults=FULL_MULTS,
                   precision="32", image_size=SIZE, in_channels=1,
                   out_channels=1)
    model = seeded_pix2pix(device, 0)
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
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    # ---- end of the counted window -----------------------------------

    check(map_launches_report == SSIM_MAP_LAUNCHES_PER_BATCH * n_batches,
          f"ssim_map launched {map_launches_report} times in the report, "
          f"expected {SSIM_MAP_LAUNCHES_PER_BATCH} x {n_batches}")
    check(launches["ssim_map"] == SSIM_MAP_LAUNCHES_PER_BATCH * n_batches,
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


def device_profile(fn, calls=2):
    """(events, busy_ms, span_ms) of ``fn`` from torch.profiler: the device
    time per call of every device-side event, by name; the device's busy
    time per call, the union of the intervals of its kernels, copies and
    memsets in the trace (work that overlaps counts once; the spans the
    profiler draws for annotated host regions, such as the optimizer's, not
    at all); and the time per call from the first of them to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = {event.key: float(event.self_device_time_total) / calls
              for event in prof.key_averages()
              if event.device_type == DeviceType.CUDA}
    with tempfile.TemporaryDirectory(prefix="pai_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    span = end - spans[0][0] if spans else 0.0
    return events, busy / 1e3 / calls, span / 1e3 / calls


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

    # + the FLOP probe, + one warm-up UNet evaluation where the chain's
    # CUDA graph is recorded (the report's batches share one graph; the
    # API's batch of one records its own)
    forwards_report = SAMPLING_STEPS * n_batches + 1 + 1
    forwards_api = SAMPLING_STEPS + 1
    check(launches_report["flash_fwd"]
          == FLASH_LAUNCHES_PER_FORWARD * forwards_report,
          f"flash_fwd launched {launches_report['flash_fwd']} times in the "
          f"report, expected {FLASH_LAUNCHES_PER_FORWARD} x {forwards_report}")
    check(launches["flash_fwd"] == FLASH_LAUNCHES_PER_FORWARD
          * (forwards_report + forwards_api),
          f"flash_fwd launched {launches['flash_fwd']} times on the Palette "
          f"path, expected {FLASH_LAUNCHES_PER_FORWARD} x "
          f"{forwards_report + forwards_api}")
    check(launches["ssim_map"] == SSIM_MAP_LAUNCHES_PER_BATCH * n_batches,
          f"ssim_map launched {launches['ssim_map']} times, expected "
          f"{SSIM_MAP_LAUNCHES_PER_BATCH} x {n_batches}")
    # float32 at D = 64 and 128: every forward launch splits its operands
    check(launches["flash_split"] == launches["flash_fwd"],
          f"flash_split launched {launches['flash_split']} times on the "
          f"Palette path, expected one per flash_fwd ({launches['flash_fwd']})")

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
        events = device_profile(lambda: unet(xb, yb, gb))[0]
        flash_us = 1e3 * flash_kernel_ms(events, "flash_fwd")
        split_us = 1e3 * flash_kernel_ms(events, "flash_split")
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
          "forward_flash_split_us": split_us,
          "flash_share_of_forward":
              (flash_us + split_us) / 1e3 / forward_ms if flash_us else None,
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


# flash attention backward, kernels vs plain version. float32 operands: the
# same float32 arithmetic summed in another order (exp2 against exp), limit
# relative to the plain output's largest magnitude; bfloat16 operands: both
# compute in float32 and round each output once, so they differ by at most
# one bf16 unit in the last place.
FLASH_BWD_TOL = 1e-4
FLASH_BWD_BF16_REL_TOL = 2.0 ** -8
# one training step of a small UNet, card vs CPU, true float32 both: loss and
# every gradient relative to that gradient's largest magnitude, or to a
# thousandth of the largest gradient of all for the tensors whose gradient is
# float noise (biases a BatchNorm makes irrelevant)
GRAD_CHECK_TOL = 1e-3
# bf16-mixed on the card against the same code on the CPU. Layer by layer
# (bf16_layer_cases): bit-equal in at least BF16_LAYER_EQUAL of the outputs
# and every output within one bf16 unit at the largest output's magnitude
# (cuDNN, cuBLAS and the card's exp take float32 sums and functions in
# another order than the CPU, which moves one value in 10^4 or 10^5 across
# a bf16 rounding point; where a conv's product and bias nearly cancel, that
# one unit of the product is many units of the small sum). The library op
# without the rounding point (the bias inside the linear map, F.silu,
# F.avg_pool2d) must fall below BF16_LAYER_EQUAL, so the check sees the
# rounding; a convolution has no such control on the card, because cuDNN
# adds the bias by an op of its own after the product is rounded, as the JAX
# package does. The small UNet (bf16_unet_readings): the card's bf16 output
# against the CPU's, with the CPU's bf16-vs-float32 difference as the scale,
# the share of outputs bit-equal and the cosine of the two bf16-minus-
# float32 errors at least BF16_CARD_EQUAL and BF16_CARD_CORR, which the same
# model on the card in float32 (the control) must fail. Its largest
# difference is read, not bounded: it is about one bf16 unit of the output
# for the bf16 model and for the control alike, so it cannot tell them
# apart.
BF16_LAYER_EQUAL = 0.999
BF16_CARD_EQUAL = 0.1
BF16_CARD_CORR = 0.5
# per training step of the CLI-default UNet: its 10 flash-path attention
# calls run forward once in the step and again in the checkpoint's
# recomputation, and backward once
TRAIN_LAUNCHES_PER_STEP = {"flash_fwd": 20, "flash_bwd_dq": 10,
                           "flash_bwd_dkv": 10}
# float32: each forward launch and each backward call (dq and dkv) split
# their operands once
TRAIN_SPLIT_LAUNCHES_PER_STEP = (TRAIN_LAUNCHES_PER_STEP["flash_fwd"]
                                 + TRAIN_LAUNCHES_PER_STEP["flash_bwd_dkv"])
TRAIN_IMAGES, VAL_IMAGES, TRAIN_BATCH = 16, 2, 4
PALETTE_PARAMETERS = 974_508_161
# float32 weights and Adam's two moments (no EMA): what one slot holds
SLOT_BYTES = 3 * 4 * PALETTE_PARAMETERS


def flash_bwd_bounds(shape, dtype):
    """{kernel: {"bound_ms", "bound_by"}} of the two backward kernels:
    operations (6 and 8 x B*H*T*T*D) over the peak rate of the operands'
    type, against the bytes each must move (q, k, v, dO, lse, delta read
    once; dq, or dk and dv, written once) over the memory rate. Both run on
    the tensor cores (at tensor_core_rate); for float32 operands the bound at
    the CUDA cores' rate is given beside it."""
    b, h, t, d = shape
    size = 2 if dtype == torch.bfloat16 else 4
    out = {}
    for name, ops, outputs in (("flash_bwd_dq", 6, 1),
                               ("flash_bwd_dkv", 8, 2)):
        nbytes = (4 + outputs) * b * h * t * d * size + 2 * 4 * b * h * t
        flops = ops * b * h * t * t * d
        bound_ms, bound_by = larger_bound(nbytes, flops,
                                          tensor_core_rate(dtype))
        out[name] = {"bound_ms": bound_ms, "bound_by": bound_by}
        if dtype == torch.float32:
            out[name]["bound_ms_cuda_cores"] = larger_bound(
                nbytes, flops, F32_FLOP_PER_S)[0]
    return out


def phase_flash_backward(device, routes):
    """The flash-attention backward wrapper vs its plain version on the
    card, each kernel timed alone; each case's routes from ``routes``
    (phase_build's)."""
    import torch.nn.functional as F

    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa

    # (shape, dtype, timed in full, q and k times); the first two are the
    # training path's, in float32 and (bf16-mixed) in bfloat16, the last two
    # the peaked cases
    cases = [((4, 4, 16384, 64), torch.float32, True, 1.0),
             ((4, 4, 4096, 128), torch.float32, True, 1.0),
             ((1, 2, 4096, 32), torch.float32, False, 1.0),
             ((1, 1, 1024, 256), torch.float32, False, 1.0),
             ((4, 4, 16384, 64), torch.bfloat16, True, 1.0),
             ((4, 4, 4096, 128), torch.bfloat16, True, 1.0),
             ((2, 4, 4096, 64), torch.bfloat16, True, 1.0),
             ((1, 2, 4096, 32), torch.bfloat16, False, 1.0),
             ((1, 1, 1024, 256), torch.bfloat16, False, 1.0),
             ((2, 4, 4096, 64), torch.float32, False, FLASH_PEAK),
             ((2, 4, 4096, 64), torch.bfloat16, False, FLASH_PEAK)]
    results = []
    for seed, (shape, dtype, full, peak) in enumerate(cases):
        q, k, v = random_qkv(shape, 200 + seed, device, dtype)
        if peak != 1.0:
            q, k = q * peak, k * peak
        do = random_qkv(shape, 300 + seed, device, dtype)[0]
        o, lse = fa.flash_attention(q, k, v, emit_lse=True)
        want = fa.flash_attention_backward_plain(q, k, v, o, lse, do)
        before = dict(kernels.launch_counts)
        got = fa.flash_attention_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            check(kernels.launch_counts[name] == before[name] + 1,
                  f"{name} did not count its launch at {shape}")
        entry = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                 "peak": peak}
        # both backwards take the forward kernel's o and lse, as training
        # does: hold those to the plain forward's at the forward's gates
        want_o, want_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
        factor = FLASH_PEAKED_FACTOR if peak != 1.0 else 1
        lse_err = float((lse - want_lse).abs().max())
        check(lse_err <= factor * FLASH_LSE_TOL, f"flash_fwd lse at {shape} "
              f"{dtype} (q, k x {peak}): {lse_err} > {factor * FLASH_LSE_TOL}")
        entry["lse_max_abs_err"] = lse_err
        if dtype == torch.bfloat16:
            o_ulps = bf16_ulps(o, want_o)
            check(o_ulps <= FLASH_BF16_ULPS, f"flash_fwd o at {shape} bf16 "
                  f"(q, k x {peak}): {o_ulps} bf16 units")
            entry["o_bf16_ulps"] = o_ulps
        else:
            o_err = float((o - want_o).abs().max())
            check(o_err <= factor * FLASH_TOL, f"flash_fwd o at {shape} "
                  f"(q, k x {peak}): {o_err} > {factor * FLASH_TOL}")
            entry["o_max_abs_err"] = o_err
        del want_o, want_lse
        for tag, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.shape == q.shape and g.dtype == dtype and g.is_cuda,
                  f"flash backward {tag}: {tuple(g.shape)} {g.dtype}")
            check(bool(torch.isfinite(g).all()), f"{tag} not finite {shape}")
            scale = float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            entry[f"{tag}_max_abs_err"] = err
            if dtype == torch.bfloat16:
                ulps = bf16_ulps(g, w)
                check(ulps <= FLASH_BF16_ULPS, f"flash backward {tag} "
                      f"differs from plain at {shape} bf16 (q, k x {peak}): "
                      f"{ulps} bf16 units")
                entry[f"{tag}_bf16_ulps"] = ulps
                if peak != 1.0:
                    continue
            limit = (FLASH_BWD_TOL if dtype == torch.float32
                     else FLASH_BWD_BF16_REL_TOL) * scale
            if peak != 1.0:
                limit *= FLASH_PEAKED_FACTOR
            check(err <= limit, f"flash backward {tag} differs from plain at "
                  f"{shape} {dtype} (q, k x {peak}): {err} > {limit}")
            entry[f"{tag}_limit"] = limit
        again = fa.flash_attention_backward(q, k, v, o, lse, do)
        check(all(torch.equal(a, b) for a, b in zip(again, got)),
              f"flash backward is not bit-reproducible at {shape} {dtype}: "
              "two launches differ")
        call = fa.prepare_backward(q, k, v, o, lse, do)
        bounds = flash_bwd_bounds(shape, dtype)
        for name, launch in (("flash_bwd_dq", fa.launch_dq),
                             ("flash_bwd_dkv", fa.launch_dkv)):
            entry[name] = {"ms": time_ms(lambda: launch(call), samples=5,
                                         calls=3),
                           "arith_route": routes[(name, entry["dtype"],
                                                  shape[-1])],
                           **bounds[name]}
        entry["backward_ms"] = time_ms(
            lambda: fa.flash_attention_backward(q, k, v, o, lse, do),
            samples=5, calls=3)
        if full:
            entry["plain_ms"] = time_ms(
                lambda: fa.flash_attention_backward_plain(q, k, v, o, lse, do),
                samples=3, calls=1)
            for name in ("flash_bwd_dq", "flash_bwd_dkv"):
                entry[name]["kernel_us"] = device_kernel_us(
                    lambda: fa.flash_attention_backward(q, k, v, o, lse, do),
                    FLASH_KERNEL_NAMES[name], calls=3)
            # the yardstick: the backward of PyTorch's fused attention on the
            # same tensors (timed only; float32 with TF32 off, as set)
            leaves = [x.detach().clone().requires_grad_(True)
                      for x in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves,
                                                 scale=shape[-1] ** -0.5)
            entry["library_ms"] = time_ms(
                lambda: torch.autograd.grad(out, leaves, do,
                                            retain_graph=True),
                samples=5, calls=3)
            del leaves, out
        results.append(entry)
        del q, k, v, do, o, lse, want, got, again, call

    # strided: q, k, v as views of one packed (N, T, heads, 3, D) tensor
    rng = np.random.default_rng(210)
    packed = torch.from_numpy(rng.normal(0.0, 1.0, (2, 4096, 4, 3, 64)).astype(
        np.float32)).to(device)
    q, k, v = (packed[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    do = random_qkv((2, 4, 4096, 64), 211, device)[0]
    o, lse = fa.flash_attention(q, k, v, emit_lse=True)
    want = fa.flash_attention_backward_plain(
        q.contiguous(), k.contiguous(), v.contiguous(),
        *fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                  v.contiguous(), emit_lse=True), do)
    got = fa.flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    strided_err = max(float((g - w).abs().max()) / float(w.abs().max())
                      for g, w in zip(got, want))
    check(strided_err <= FLASH_BWD_TOL,
          f"flash backward differs from plain on packed views: {strided_err}")

    # the autograd.Function on the card against the plain backward
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*leaves).backward(do)
    function_err = max(float((leaf.grad - w).abs().max()) / float(
        w.abs().max()) for leaf, w in zip(leaves, want))
    check(function_err <= FLASH_BWD_TOL,
          f"FlashAttention's gradients on the card: {function_err}")
    expect_raises(ValueError, lambda: fa.flash_attention_backward(
        q, k, v, o, lse[:, :64], do), "a short lse")

    emit({"phase": "kernels", "kernels": ["flash_bwd_dq", "flash_bwd_dkv"],
          "limits": {"float32_relative": FLASH_BWD_TOL,
                     "bfloat16_relative": FLASH_BWD_BF16_REL_TOL},
          "packed_views_max_rel_err": strided_err,
          "function_max_rel_err": function_err, "cases": results})
    return results


def perturb_zero_layers(model, generator):
    """Give a DiffusionUNet's zero-initialised layers small random weights
    (or its output, and most gradients, would be zero); `generator` lives on
    the model's device."""
    from pai_tpu_torch.models.diffusion_unet import TokenConv1d, ZeroConv

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, ZeroConv) or (
                    isinstance(module, TokenConv1d)
                    and not bool(module.weight.any())):
                module.weight.normal_(0.0, 0.5 * module.weight[0].numel()
                                      ** -0.5, generator=generator)
    return model


def perturbed_unet(generator, **kwargs):
    """A DiffusionUNet on the CPU with perturb_zero_layers applied."""
    from pai_tpu_torch.models.diffusion_unet import DiffusionUNet

    return perturb_zero_layers(DiffusionUNet(generator=generator, **kwargs),
                               generator)


def phase_gradcheck(device):
    """One training step of a small UNet on the card and on the CPU from the
    same weights and draws: mults (1, 2), inner 64, 2 heads, attention at
    rates 1 and 2 over 64x64 images, so rate 1 is T = 4,096 of D = 32 (the
    flash kernels on the card) and rate 2 T = 1,024 (full softmax)."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.diffusion import make_schedule
    from pai_tpu_torch.train import steps as steps_lib

    kwargs = dict(in_channels=2, out_channels=1, inner_channel=64,
                  channel_mults=(1, 2), attn_res=(1, 2), num_heads=2)
    from pai_tpu_torch.models.diffusion_unet import DiffusionUNet

    cpu_model = perturbed_unet(torch.Generator().manual_seed(5), **kwargs)
    card_model = DiffusionUNet(device="meta", **kwargs)
    card_model.load_state_dict(cpu_model.state_dict(), assign=True)
    card_model = card_model.to(device).to(memory_format=torch.channels_last)
    rng = np.random.default_rng(9)
    x, y = (rng.uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
            for _ in range(2))
    rand = {"t": np.array([0, 700], np.int64),
            "noise": rng.normal(size=(2, 64, 64, 1)).astype(np.float32),
            "u": rng.uniform(size=(2,)).astype(np.float32)}
    results = {}
    for where, model in (("cuda", card_model), ("cpu", cpu_model)):
        dev = torch.device(where)
        state = steps_lib.init_palette_state(model, use_ema=False)
        step = steps_lib.make_palette_train_step(
            model, make_schedule("linear", 2000, 1e-6, 0.01, device=dev),
            False, external_rand=True)
        before = dict(kernels.launch_counts)
        start = time.perf_counter()
        _, metrics = step(state, torch.from_numpy(x).to(dev),
                          torch.from_numpy(y).to(dev),
                          {k: torch.from_numpy(v).to(dev)
                           for k, v in rand.items()})
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - start
        launched = {k: kernels.launch_counts[k] - before[k] for k in before}
        results[where] = (loss, {n: p.grad.detach().cpu()
                                 for n, p in model.named_parameters()},
                          launched, seconds)
    card_loss, card_grads, card_launched, card_s = results["cuda"]
    cpu_loss, cpu_grads, cpu_launched, cpu_s = results["cpu"]
    check(card_launched["flash_fwd"] == 10 and card_launched["flash_bwd_dq"]
          == 5 and card_launched["flash_bwd_dkv"] == 5,
          f"gradient check step launched {card_launched}")
    check(not any(cpu_launched.values()), "the CPU step launched a kernel")
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(loss_err <= GRAD_CHECK_TOL, f"loss card {card_loss} vs CPU "
          f"{cpu_loss}: {loss_err} > {GRAD_CHECK_TOL}")
    top = max(float(g.abs().max()) for g in cpu_grads.values())
    worst, worst_name = 0.0, None
    for name, want in cpu_grads.items():
        scale = max(float(want.abs().max()), 1e-3 * top)
        err = float((card_grads[name] - want).abs().max()) / scale
        if err > worst:
            worst, worst_name = err, name
    check(worst <= GRAD_CHECK_TOL, f"gradient {worst_name}, card vs CPU: "
          f"{worst} > {GRAD_CHECK_TOL}")
    emit({"phase": "gradcheck", "loss_cuda": card_loss, "loss_cpu": cpu_loss,
          "loss_rel_err": loss_err, "grad_max_rel_err": worst,
          "grad_worst_tensor": worst_name, "tensors": len(cpu_grads),
          "launches_cuda_step": card_launched, "limit": GRAD_CHECK_TOL,
          "step_seconds": {"cuda": card_s, "cpu": cpu_s}})


def write_pairs(directory, n_images, seed):
    from pai_tpu_torch.utils.images import write_png

    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n_images):
        x = blob_image(rng)
        write_png(x, os.path.join(directory, f"in_{i}.png"))
        write_png(255 - x, os.path.join(directory, f"gt_{i}.png"))
        entries.append(f"- input: in_{i}.png\n  ground_truth: gt_{i}.png\n")
    manifest = os.path.join(directory, "data.yaml")
    with open(manifest, "w") as f:
        f.write("".join(entries))
    return manifest


def step_event_ms(fn, repeats):
    """Mean CUDA-event time of ``repeats`` calls of a whole training step."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def phase_train(device, workdir):
    """``python -m pai_tpu_torch.main smoke -m palette --batch-size 4
    --epochs 1 --val-epochs 1 --precision 32 --device cuda`` in this process
    (the launch counts live here) at the CLI-default width: 4 steps, one
    validation with the 100-step chain, best and last slots. Then the same
    seed again for one step, a profiled step and a step at batch 8."""
    import gc
    import shutil

    from pai_tpu_torch import kernels
    from pai_tpu_torch import main as train_main
    from pai_tpu_torch.api import Palette
    from pai_tpu_torch.data import BatchLoader, ImageDataset
    from pai_tpu_torch.train import loop
    from pai_tpu_torch.train import steps as steps_lib
    from pai_tpu_torch.utils import checkpoint as ckpt_lib

    free = shutil.disk_usage(workdir).free
    need = 3 * SLOT_BYTES + 2 * 10 ** 9
    check(free >= need, f"{free / 1e9:.1f} GB free under {workdir}: the train "
          f"phase writes a best and a last slot of ~{SLOT_BYTES / 1e9:.1f} GB "
          f"and rewrites last beside itself, {need / 1e9:.1f} GB in all")
    train = write_pairs(os.path.join(workdir, "train"), TRAIN_IMAGES, 1)
    val = write_pairs(os.path.join(workdir, "val"), VAL_IMAGES, 2)
    logs, ckpts = (os.path.join(workdir, d) for d in ("tlogs", "tckpt"))

    steps, saves, validations, captured = [], [], [], {}
    real_make = steps_lib.make_palette_train_step
    real_write = ckpt_lib._write_slot
    real_validate = loop.Trainer.validate

    def instrumented(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def timed(state, x, y, rand=None):
            torch.cuda.synchronize()
            before = dict(kernels.launch_counts)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            host = time.perf_counter()
            start.record()
            state, metrics = step(state, x, y, rand)
            enqueue_ms = (time.perf_counter() - host) * 1e3
            end.record()
            torch.cuda.synchronize()
            captured["state"] = state
            steps.append({"ms": start.elapsed_time(end),
                          "enqueue_ms": enqueue_ms,
                          "loss": float(metrics["loss"]),
                          "launches": {k: kernels.launch_counts[k] - before[k]
                                       for k in before}})
            return state, metrics
        return timed

    def timed_write(slot_dir, flat, meta):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real_write(slot_dir, flat, meta)
        saves.append({"slot": os.path.basename(slot_dir),
                      "seconds": time.perf_counter() - start,
                      "bytes": os.path.getsize(os.path.join(slot_dir,
                                                            "state.pt"))})
        return out

    def timed_validate(self, state, epoch):
        torch.cuda.synchronize()
        before = dict(kernels.launch_counts)
        start = time.perf_counter()
        out = real_validate(self, state, epoch)
        torch.cuda.synchronize()
        validations.append({"seconds": time.perf_counter() - start,
                            "launches": {k: kernels.launch_counts[k]
                                         - before[k] for k in before}})
        return out

    steps_lib.make_palette_train_step = instrumented
    ckpt_lib._write_slot = timed_write
    loop.Trainer.validate = timed_validate
    try:
        # ---- the main path, counted ----------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        summary = train_main.main([
            "smoke", "-d", train, "-vd", val, "-m", "palette",
            "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
            "--val-epochs", "1", "--precision", "32", "--device", "cuda",
            "--log-dir", logs, "--ckpt-dir", ckpts])
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - start
        launches = dict(kernels.launch_counts)
        peak_fit = torch.cuda.max_memory_allocated()
        # ---- end of the counted window -------------------------------
    finally:
        steps_lib.make_palette_train_step = real_make
        ckpt_lib._write_slot = real_write
        loop.Trainer.validate = real_validate

    n_steps = TRAIN_IMAGES // TRAIN_BATCH
    check(summary["steps"] == n_steps and len(steps) == n_steps,
          f"trained {summary['steps']} steps, expected {n_steps}")
    for i, entry in enumerate(steps):
        for name, count in (*TRAIN_LAUNCHES_PER_STEP.items(),
                            ("flash_split", TRAIN_SPLIT_LAUNCHES_PER_STEP)):
            check(entry["launches"][name] == count,
                  f"step {i + 1} launched {name} {entry['launches'][name]} "
                  f"times, expected {count}")
        check(np.isfinite(entry["loss"]), f"step {i + 1} loss not finite")
    check(len(validations) == 1 and validations[0]["launches"]["ssim_scalar"]
          >= 1, f"validation did not launch ssim_scalar: {validations}")
    check(all(np.isfinite(summary[k]) for k in ("val_ssim", "val_psnr",
                                                  "val_rmse")),
          f"validation metrics: {summary}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ssim_scalar"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the training path")
    slots = sorted(os.listdir(os.path.join(ckpts, "smoke")))
    check(slots == ["best", "last"], f"checkpoint slots {slots}")
    check([s["slot"] for s in saves] == ["best", "last", "last"],
          f"saves {saves}")
    outputs = sorted(os.listdir(os.path.join(logs, "smoke", "version_0",
                                             "1")))
    check(outputs == [f"output_{i}.png" for i in range(VAL_IMAGES)],
          f"validation samples {outputs}")

    # the best slot through the API: the trainer's weights
    state = captured.pop("state")
    start = time.perf_counter()
    api_model = Palette.load_from_checkpoint(
        os.path.join(ckpts, "smoke", "best"), device="cuda")
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - start
    own = dict(state.model.named_parameters())
    loaded = api_model._module.state_dict()
    check(all(torch.equal(loaded[k], p.detach()) for k, p in own.items()),
          "the best slot's weights differ from the trainer's")
    del state, own, loaded, api_model
    gc.collect()
    torch.cuda.empty_cache()

    # the same seed again: a new trainer's first step on the same batch
    trainer = loop.Trainer(dict(
        name="again", data=train, val_data=None, model="palette",
        batch_size=TRAIN_BATCH, precision="32", device="cuda",
        log_dir=logs, ckpt_dir=ckpts))
    loader = BatchLoader(ImageDataset(train, SIZE), TRAIN_BATCH,
                         shuffle=True, pad_mode="cycle", seed=0,
                         device="cuda")
    batch = next(iter(loader))
    state = steps_lib.init_palette_state(trainer.model, use_ema=False)
    step = steps_lib.make_palette_train_step(
        trainer.model, trainer.sched_train, False,
        warmup_steps_per_epoch=n_steps, generator=trainer.generator, seed=0)
    state, metrics = step(state, batch.x, batch.y)
    again_loss = float(metrics["loss"])
    check(again_loss == steps[0]["loss"], f"the same seed gave first-step "
          f"loss {again_loss} after {steps[0]['loss']}")

    # where a step's device time goes (warm: Adam's state exists); the
    # profiler's device time per kernel over the CUDA-event time of a step
    events, busy_ms, span_ms = device_profile(
        lambda: step(state, batch.x, batch.y), calls=1)
    kernel_ms = {name: flash_kernel_ms(events, name)
                 for name in (*TRAIN_LAUNCHES_PER_STEP, "flash_split")}
    step_ms = step_event_ms(lambda: step(state, batch.x, batch.y), 2)
    top_events = sorted(events.items(), key=lambda kv: -kv[1])[:12]

    # one step at the CLI's default batch of 8 (after one to warm up)
    x8, y8 = (torch.cat([t, t]) for t in (batch.x, batch.y))
    step(state, x8, y8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms_8 = step_event_ms(lambda: step(state, x8, y8), 1)
    peak_8 = torch.cuda.max_memory_allocated()
    del state, step, trainer, batch, x8, y8
    gc.collect()
    torch.cuda.empty_cache()

    train_ms = [e["ms"] for e in steps]
    emit({"phase": "train", "images": TRAIN_IMAGES,
          "batch_size": TRAIN_BATCH, "steps": n_steps,
          "channel_mults": FULL_MULTS,
          "attention_res": PALETTE_ATTENTION_RES,
          "parameters": PALETTE_PARAMETERS, "fit_seconds": fit_seconds,
          "step_ms": train_ms, "step_ms_median_after_first":
              statistics.median(train_ms[1:]),
          "step_enqueue_ms": [e["enqueue_ms"] for e in steps],
          "images_per_second_training": TRAIN_BATCH * len(train_ms[1:])
              / (sum(train_ms[1:]) / 1e3),
          "launches_per_step": [e["launches"] for e in steps],
          "validation": validations, "checkpoint_saves": saves,
          "best_slot_load_seconds": load_seconds,
          "max_memory_allocated_bytes_fit": peak_fit,
          "losses": [e["loss"] for e in steps],
          "same_seed_first_step_loss": again_loss,
          "profiled_step_ms": step_ms,
          "step_device_ms": busy_ms, "step_device_span_ms": span_ms,
          "kernel_device_ms_per_step": kernel_ms,
          "kernel_share_of_step": {k: v / step_ms
                                   for k, v in kernel_ms.items()},
          "step_top_device_events_us": [[name[:80], us]
                                        for name, us in top_events],
          "step_ms_batch_8": step_ms_8,
          "max_memory_allocated_bytes_batch_8": peak_8,
          "launches": launches, "summary": summary})
    return launches


def flash_operand_types(events):
    """The operand types (template's first argument) of the flash kernels
    among profiler event names."""
    return sorted({m.group(1) for name in events for m in [re.search(
        r"flash_\w+_kernel<([^,>]+)", name)] if m})


def bf16_path(device, workdir):
    """Palette under ``--precision bf16-mixed`` at the CLI-default width, as
    ``python -m pai_tpu_torch.main ... --precision bf16-mixed`` builds it
    (``loop.Trainer``: bf16 autocast, float32 parameters and BatchNorm, TF32
    allowed for what stays float32): one UNet forward at the report's batch
    of 2 and one training step at batch 4, each warmed up, timed by CUDA
    events; the flash launches per forward and per step, the operand type
    of every flash kernel the profiler saw (``__nv_bfloat16`` instantiations:
    the kernels' mma-bf16 route), finite outputs and gradients. The
    precision policy is set back to "32" after."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.config import apply_precision_policy
    from pai_tpu_torch.train import loop
    from pai_tpu_torch.train import steps as steps_lib

    try:
        apply_precision_policy("bf16-mixed")
        trainer = loop.Trainer(dict(
            name="bf16", data=None, val_data=None, model="palette",
            batch_size=TRAIN_BATCH, precision="bf16-mixed", device="cuda",
            log_dir=os.path.join(workdir, "logs"),
            ckpt_dir=os.path.join(workdir, "ckpt")))
        model = trainer.model
        check(model.compute_dtype == torch.bfloat16,
              f"bf16-mixed built a {model.compute_dtype} UNet")
        gen = torch.Generator(device="cuda").manual_seed(11)
        perturb_zero_layers(model, gen)
        x, y = (torch.rand((TRAIN_BATCH, SIZE, SIZE, 1), generator=gen,
                           device=device) * 2 - 1 for _ in range(2))

        # one UNet forward at the report's batch size
        model.eval()
        xs, ys = x[:PALETTE_BATCH], y[:PALETTE_BATCH]
        gamma = torch.full((PALETTE_BATCH,), 0.5, device=device)
        with torch.inference_mode():
            model(xs, ys, gamma)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            out = model(xs, ys, gamma)
            torch.cuda.synchronize()
            forward_launches = dict(kernels.launch_counts)
            # as many samples as the float32 forward of phase_palette
            forward_ms = time_ms(lambda: model(xs, ys, gamma), samples=10,
                                 calls=3)
            events, forward_device_ms, _ = device_profile(
                lambda: model(xs, ys, gamma))
        forward_dtypes = flash_operand_types(events)
        forward_flash_ms = flash_kernel_ms(events, "flash_fwd")
        check(out.shape == (PALETTE_BATCH, SIZE, SIZE, 1)
              and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()) and float(out.std()) > 0,
              f"bf16 forward: {tuple(out.shape)} {out.dtype}, finite "
              f"{bool(torch.isfinite(out).all())}")
        check(forward_launches["flash_fwd"] == FLASH_LAUNCHES_PER_FORWARD,
              f"bf16 forward launched flash_fwd "
              f"{forward_launches['flash_fwd']} times")
        check(forward_dtypes == ["__nv_bfloat16"],
              f"flash kernels under bf16-mixed: {forward_dtypes}")

        # one training step at batch 4, after one that creates Adam's state
        state = steps_lib.init_palette_state(model, use_ema=False)
        step = steps_lib.make_palette_train_step(
            model, trainer.sched_train, False, warmup_steps_per_epoch=1,
            generator=trainer.generator, seed=0)
        state, _ = step(state, x, y)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        host = time.perf_counter()
        state, metrics = step(state, x, y)
        enqueue_ms = (time.perf_counter() - host) * 1e3
        loss = float(metrics["loss"])
        step_launches = dict(kernels.launch_counts)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grads_finite = all(bool(torch.isfinite(g).all()) for g in grads)
        attention_grad = float(sum(
            m.qkv.weight.grad.abs().sum() for m in model.modules()
            if hasattr(m, "qkv") and m.qkv.weight.grad is not None))
        for name, count in TRAIN_LAUNCHES_PER_STEP.items():
            check(step_launches[name] == count, f"bf16 step launched {name} "
                  f"{step_launches[name]} times, expected {count}")
        check(np.isfinite(loss) and grads_finite and attention_grad > 0,
              f"bf16 step: loss {loss}, gradients finite {grads_finite}, "
              f"attention qkv gradient mass {attention_grad}")
        events, step_device_ms, step_span_ms = device_profile(
            lambda: step(state, x, y), calls=1)
        step_dtypes = flash_operand_types(events)
        check(step_dtypes == ["__nv_bfloat16"],
              f"flash kernels in the bf16 step: {step_dtypes}")
        kernel_ms = {name: flash_kernel_ms(events, name)
                     for name in TRAIN_LAUNCHES_PER_STEP}
        step_ms = step_event_ms(lambda: step(state, x, y), 2)
        top_events = sorted(events.items(), key=lambda kv: -kv[1])[:12]
        del state, step, trainer, model
    finally:
        apply_precision_policy("32")
    torch.cuda.empty_cache()
    return {"unet_forward_ms_batch_2": forward_ms,
          "forward_flash_fwd_ms": forward_flash_ms,
          "forward_device_ms": forward_device_ms,
          "forward_launches": forward_launches,
          "forward_flash_dtypes": forward_dtypes,
          "forward_output_max_abs": float(out.abs().max()),
          "step_ms_batch_4": step_ms, "step_enqueue_ms": enqueue_ms,
          "step_device_ms": step_device_ms,
          "step_device_span_ms": step_span_ms,
          "step_loss": loss, "step_launches": step_launches,
          "attention_qkv_grad_abs_sum": attention_grad,
          "step_flash_dtypes": step_dtypes,
          "kernel_device_ms_per_step": kernel_ms,
          "kernel_share_of_step": {k: v / step_ms
                                   for k, v in kernel_ms.items()},
          "step_top_device_events_us": [[name[:80], us]
                                        for name, us in top_events]}


def phase_bf16(device, workdir):
    """bf16-mixed: bf16_card_vs_cpu under the bf16-mixed precision policy,
    then bf16_path."""
    from pai_tpu_torch.config import apply_precision_policy

    try:
        apply_precision_policy("bf16-mixed")
        held = bf16_card_vs_cpu(device)
    finally:
        apply_precision_policy("32")
    emit({"phase": "bf16", "precision": "bf16-mixed",
          "bf16_card_vs_cpu": held, **bf16_path(device, workdir)})


def bf16_layer_cases(device):
    """Each bf16 rounding point of ``pai_tpu_torch/ops/layers.py`` on the
    card against the CPU, same weights and bf16 input, under bf16 autocast:
    (name, largest difference in bf16 units at the largest output's
    magnitude, equal share, control's equal share or None)."""
    import copy

    from pai_tpu_torch.models.diffusion_unet import TokenConv1d
    from pai_tpu_torch.ops import layers as L

    gen = torch.Generator().manual_seed(21)
    x = torch.randn((4, 64, 32, 32), generator=gen).bfloat16().contiguous(
        memory_format=torch.channels_last)
    tokens = torch.randn((4, 256, 64), generator=gen).bfloat16()
    nn_f = torch.nn.functional

    def product(module, inp, library=None):
        module.bias.data.normal_(0.0, 0.3, generator=gen)
        return module, inp, library

    conv = L.Conv(64, 64, 3, padding=1, init_mode="torch", generator=gen)
    convt = L.ConvTranspose(64, 32, generator=gen)
    dense = L.Dense(64, 128, init_mode="torch", generator=gen)
    token = TokenConv1d(64, 192, generator=gen)
    norm = L.BatchNorm(64)
    norm.running_mean.normal_(0.0, 0.2, generator=gen)
    norm.running_var.uniform_(0.5, 1.5, generator=gen)
    fused = L.Conv(64, 64, 3, padding=1, init_mode="torch", generator=gen,
                   float32_sum=True)
    cases = {
        "conv": product(conv, x),
        "conv_transpose": product(convt, x),
        "dense": product(dense, tokens, lambda m, a: nn_f.linear(
            a, m.weight, m.bias)),
        "token_conv1d": product(token, tokens, lambda m, a: nn_f.linear(
            a, m.weight[:, :, 0], m.bias)),
        "silu": (L.SiLU(), 3 * x, lambda m, a: nn_f.silu(a)),
        "avg_pool_2x": (None, x, lambda m, a: nn_f.avg_pool2d(a, 2)),
        "batchnorm_eval": (norm.eval(), x, None),
        "batchnorm_train": (copy.deepcopy(norm).train(), x, None),
        "conv_float32_sum_batchnorm": (torch.nn.Sequential(
            fused, copy.deepcopy(norm).eval()), x, None),
    }
    rows = []
    for name, (module, inp, library) in cases.items():
        card_module = None if module is None else copy.deepcopy(
            module).to(device)
        outs = []
        for m, a in ((module, inp), (card_module, inp.to(device))):
            with torch.no_grad(), torch.autocast(a.device.type,
                                                 dtype=torch.bfloat16):
                outs.append((L.avg_pool_2x(a) if m is None else m(a)).cpu())
                if library is not None and m is card_module:
                    control = library(m, a).cpu()
        cpu, card = outs
        check(card.dtype == cpu.dtype == torch.bfloat16,
              f"bf16 layer {name}: {card.dtype}, CPU {cpu.dtype}")
        unit = float(2.0 ** (np.floor(np.log2(float(cpu.abs().max()))) - 7))
        rows.append((name, float((card - cpu).abs().max()) / unit,
                     float((card == cpu).float().mean()),
                     None if library is None
                     else float((control == cpu).float().mean())))
    return rows


def bf16_unet_readings(device):
    """The gradient check's small UNet (mults 1,2, inner 64, attention at
    rates 1 and 2 over 64x64 images: the flash kernels' bf16 route at rate 1)
    at bf16 and at float32, one eval forward each on the card and on the CPU
    from the same weights and inputs. Per card result against the CPU's bf16
    output: ``gap``, the largest difference over the CPU's largest
    bf16-vs-float32 difference; ``equal``, the share bit-equal; ``corr``,
    the cosine between the card's error against the CPU's float32 output and
    the CPU's bf16 error."""
    from pai_tpu_torch.models.diffusion_unet import DiffusionUNet

    kwargs = dict(in_channels=2, out_channels=1, inner_channel=64,
                  channel_mults=(1, 2), attn_res=(1, 2), num_heads=2)
    cpu_model = perturbed_unet(torch.Generator().manual_seed(5),
                               **kwargs).eval()
    card_model = DiffusionUNet(device="meta", **kwargs)
    card_model.load_state_dict(cpu_model.state_dict(), assign=True)
    card_model = card_model.to(device).to(
        memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(13)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 1)).astype(
        np.float32)) for _ in range(2))
    gamma = torch.tensor([0.3, 0.8])
    outs = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for where, model, dev in (("cpu", cpu_model, "cpu"),
                                      ("card", card_model, device)):
                model.compute_dtype = dtype
                outs[where, dtype] = model(x.to(dev), y.to(dev),
                                           gamma.to(dev)).cpu().double()
    return card_cpu_readings(outs, "small UNet")


def card_cpu_readings(outs, what):
    """``gap``, ``equal`` and ``corr`` (bf16_unet_readings) of the card's
    bf16 output and of its float32 control, from ``outs[where, dtype]``
    (float64 CPU copies of one eval forward each)."""
    ref16, ref32 = outs["cpu", torch.bfloat16], outs["cpu", torch.float32]
    theirs = ref16 - ref32
    readings = {"cpu_bf16_vs_float32": float(theirs.abs().max()),
                "output_max_abs": float(ref16.abs().max())}
    for dtype, key in ((torch.bfloat16, "card_bf16"),
                       (torch.float32, "card_float32_control")):
        got = outs["card", dtype]
        check(bool(torch.isfinite(got).all()),
              f"{what} {key}: non-finite output")
        mine = got - ref32
        readings[key] = {
            "gap": float((got - ref16).abs().max() / theirs.abs().max()),
            "equal": float((got == ref16).double().mean()),
            "corr": float((mine * theirs).sum()
                          / (mine.norm() * theirs.norm()).clamp_min(1e-300))}
    return readings


def bf16_card_vs_cpu(device):
    """bf16-mixed on the card against the CPU: bf16_layer_cases and
    bf16_unet_readings, held to the BF16_* limits above."""
    layers = bf16_layer_cases(device)
    for name, units, equal, control in layers:
        check(units <= 1.0 and equal >= BF16_LAYER_EQUAL,
              f"bf16 layer {name}, card vs CPU: {units} units at the largest "
              f"output, {equal} bit-equal (limits 1, {BF16_LAYER_EQUAL})")
        check(control is None or control < BF16_LAYER_EQUAL,
              f"bf16 layer {name}: the library op without the rounding point "
              f"is {control} bit-equal to the CPU, so the check cannot see it")
    unet = bf16_unet_readings(device)

    def passes(r):
        return r["equal"] >= BF16_CARD_EQUAL and r["corr"] >= BF16_CARD_CORR

    check(passes(unet["card_bf16"]) and not passes(
        unet["card_float32_control"]),
          f"small UNet at bf16, card vs CPU: {unet} (limits equal "
          f">= {BF16_CARD_EQUAL}, corr >= {BF16_CARD_CORR}; the float32 "
          f"control must fail them)")
    return {"layers": [{"name": n, "max_units": u, "equal": e,
                        "control_equal": c} for n, u, e, c in layers],
            "unet": unet,
            "limits": {"layer_units": 1.0, "layer_equal": BF16_LAYER_EQUAL,
                       "unet_equal": BF16_CARD_EQUAL,
                       "unet_corr": BF16_CARD_CORR}}


# GAN training (phase_gan). The full-width run: 80 pairs at batch 8 (10
# steps; step 10 is a log row) and 32 validation pairs (4 batches), then
# the report over the same 32 pairs from the best slot. Card vs CPU: one
# step of a small Pix2Pix (mults 1,2,4 at 32x32, batch 2) with the PatchGAN
# at its published widths, true float32 both, every loss type: the loss, the
# prediction and every parameter and running statistic after the step
# within GAN_CARD_CPU_TOL of its largest magnitude. The first Adam step
# moves an element by g / (|g| + eps) learning rates (eps 1e-7, lr 2e-4):
# about one whatever the gradient's size, so the parameters after it agree
# as their gradients do, against weights and biases drawn at 0.02 and 0.1;
# but an element whose gradient is within float noise of eps moves by a
# noise-sensitive fraction of the learning rate. So the limit holds for the
# elements whose gradient (on the CPU) is at least a thousandth of their
# tensor's largest, and every element is held within two learning rates,
# Adam's bound; a tensor whose gradient is float noise throughout (its
# largest below a thousandth of its network's, as the biases a BatchNorm
# follows: the Palette gradient check's rule) is held to that bound alone.
GAN_TRAIN_IMAGES, GAN_VAL_IMAGES, GAN_BATCH = 80, 32, 8
GAN_LOSS_TYPES = ("gan", "ssim", "psnr", "ssim+psnr", "mse")
GAN_CARD_CPU_TOL = 1e-3
PIX2PIX_PARAMETERS = 54_413_313
PATCHGAN_PARAMETERS = 2_763_712
# float32 weights and Adam's two moments of both networks (no EMA)
GAN_SLOT_BYTES = 3 * 4 * (PIX2PIX_PARAMETERS + PATCHGAN_PARAMETERS)


def small_generator(family, generator):
    """A small generator of ``family`` at 32x32: mults (1, 2, 4); TransUNet
    at (1, 1) with a 2-layer ViT of width 1,024."""
    from pai_tpu_torch.models import build_generator
    from pai_tpu_torch.models.trans_unet import TransUnet

    if family == "trans_unet":
        return TransUnet(image_size=32, channel_mults=(1, 1), vit_layers=2,
                         generator=generator)
    return build_generator(family, channel_mults=(1, 2, 4),
                           generator=generator)


def gan_small_models(seed, family="pix2pix"):
    """A small generator of ``family`` and the PatchGAN on the CPU with
    every parameter and running statistic drawn from ``seed`` (biases too,
    so that no tensor is at the scale of one Adam step)."""
    from pai_tpu_torch.models import Discriminator

    gen = torch.Generator().manual_seed(seed)
    model = small_generator(family, gen)
    disc = Discriminator(generator=gen)
    with torch.no_grad():
        for net in (model, disc):
            for name, tensor in net.state_dict().items():
                if name.endswith("num_batches_tracked"):
                    continue
                if name.endswith(("running_var", "weight")) \
                        and tensor.dim() == 1:
                    tensor.uniform_(0.5, 1.5, generator=gen)
                elif tensor.dim() == 1:
                    tensor.normal_(0.0, 0.1, generator=gen)
    return model, disc


def gan_card_vs_cpu(device, family="pix2pix", loss_types=GAN_LOSS_TYPES,
                    large=1e-3):
    """One GAN step of each loss type on the card and on the CPU from the
    same weights and batch (true float32 both): loss, d_loss, prediction,
    parameters and running statistics after the step, and the launches.
    ``large``: the share of its tensor's largest gradient from which an
    element's parameter is held to ``GAN_CARD_CPU_TOL`` (every element is
    held to two learning rates)."""
    import copy

    from pai_tpu_torch import kernels
    from pai_tpu_torch.train import steps as steps_lib
    from pai_tpu_torch.train.state import GAN_LR

    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    y = np.where(-0.8 * x + rng.normal(0, 0.2, x.shape) > 0, 1.0,
                 -1.0).astype(np.float32)
    out = {}
    for loss_type in loss_types:
        cpu_nets = gan_small_models(3, family)
        results = {}
        for where in ("cuda", "cpu"):
            nets = [copy.deepcopy(n).to(where).to(
                memory_format=torch.channels_last) for n in cpu_nets]
            preds = []
            nets[0].register_forward_hook(
                lambda m, a, o: preds.append(o.detach().cpu()))
            state = steps_lib.init_gan_state(nets[0], nets[1], loss_type,
                                             use_ema=False)
            step = steps_lib.make_gan_train_step(nets[0], nets[1], loss_type)
            before = dict(kernels.launch_counts)
            _, metrics = step(state, torch.from_numpy(x).to(where),
                              torch.from_numpy(y).to(where))
            launched = {k: kernels.launch_counts[k] - before[k]
                        for k in before}
            tensors, grads = {}, {}
            for tag, net, opt in (("g", nets[0], state.g_opt),
                                  ("d", nets[1], state.d_opt)):
                tensors.update({f"{tag}.{k}": v.detach().cpu()
                                for k, v in net.state_dict().items()})
                # after one step Adam's first moment is half the gradient
                grads[tag] = {f"{tag}.{k}": opt.state[p]["exp_avg"].cpu()
                              for k, p in net.named_parameters()} \
                    if opt else {}
            results[where] = ({k: float(v) for k, v in metrics.items()},
                              preds[0], tensors, launched, grads)
        card, cpu = results["cuda"], results["cpu"]
        errs = {k: abs(card[0][k] - cpu[0][k]) / abs(cpu[0][k])
                for k in cpu[0]}
        errs["prediction"] = float((card[1] - cpu[1]).abs().max()
                                   / cpu[1].abs().max())
        grads = {k: v.abs() for net in cpu[4].values()
                 for k, v in net.items()}
        noise = {name for net in cpu[4].values() if net
                 for name, g in net.items()
                 if g.abs().max() < 1e-3 * max(v.abs().max()
                                               for v in net.values())}
        # the gradients themselves, read (not gated): the largest
        # difference over each tensor's largest, and its L2 ratio
        card_g = {k: v for net in card[4].values() for k, v in net.items()}
        grad_err = {name: (float((card_g[name] - g).abs().max()
                                 / g.abs().max()),
                           float((card_g[name] - g).norm() / g.norm()))
                    for net in cpu[4].values() for name, g in net.items()
                    if name not in noise}
        worst, worst_name = 0.0, None
        for name, want in cpu[2].items():
            if name.endswith("num_batches_tracked"):
                continue
            diff = (card[2][name] - want).abs()
            if name in grads:
                check(float(diff.max()) <= 2 * GAN_LR, f"GAN step "
                      f"{loss_type}, card vs CPU: {name} {float(diff.max())}"
                      " > two learning rates")
                if name in noise:
                    continue
                diff = diff[grads[name] >= large * grads[name].max()]
            err = float(diff.max() / want.abs().max())
            if err > worst:
                worst, worst_name = err, name
        errs["tensors"] = worst
        for key, err in errs.items():
            check(err <= GAN_CARD_CPU_TOL, f"GAN step {loss_type}, card vs "
                  f"CPU: {key} {err} > {GAN_CARD_CPU_TOL} ({worst_name})")
        check(not any(cpu[3].values()), "the CPU GAN step launched a kernel")
        # the SSIM losses' forward and train_ssim; nothing else
        want = 2 if loss_type in ("ssim", "ssim+psnr") else 1
        check(card[3]["ssim_scalar"] == want and card[3]["ssim_map"] == 0,
              f"GAN step {loss_type} on the card launched {card[3]}")
        worst_grad = max(grad_err, key=lambda k: grad_err[k][0])
        out[loss_type] = {"max_rel_err": errs, "worst_tensor": worst_name,
                          "gradient_max_rel_err": grad_err[worst_grad][0],
                          "gradient_worst_tensor": worst_grad,
                          "gradient_l2_rel_err": max(
                              v[1] for v in grad_err.values()),
                          "float_noise_gradients": sorted(noise),
                          "loss_cuda": card[0]["loss"],
                          "loss_cpu": cpu[0]["loss"]}
    return out


def gan_loss_step(device, model, loss_type, x, y):
    """One timed lean step of a loss type other than ``gan`` on the
    full-width generator (its own Adam state), and for the SSIM losses the
    ``ssim_scalar`` launches of a lean step and the time of the loss's
    backward, which recomputes through the plain version."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.train import steps as steps_lib
    from pai_tpu_torch.train.losses import generator_loss

    state = steps_lib.init_gan_state(model, None, loss_type, use_ema=False)
    step = steps_lib.make_gan_train_step(model, None, loss_type,
                                         compute_metrics=False)
    state, metrics = step(state, x, y)  # warm: Adam's state exists after
    torch.cuda.synchronize()
    before = dict(kernels.launch_counts)
    ms = step_event_ms(lambda: step(state, x, y), 1)
    launched = {k: kernels.launch_counts[k] - before[k] for k in before}
    check(np.isfinite(float(metrics["loss"])), f"{loss_type} loss")
    entry = {"step_ms": ms, "launches_per_lean_step": launched,
             "loss": float(metrics["loss"])}
    if loss_type in ("ssim", "ssim+psnr"):
        check(launched["ssim_scalar"] == 1,
              f"a lean {loss_type} step launched ssim_scalar "
              f"{launched['ssim_scalar']} times, expected 1")
        with torch.no_grad():
            pred = model.train()(x)
        leaf = pred.clone().requires_grad_(True)
        loss = generator_loss(loss_type, leaf, y)

        def backward():
            torch.autograd.grad(loss, leaf, retain_graph=True)

        backward()
        entry["loss_backward_ms"] = step_event_ms(backward, 10)
        entry["loss_forward_ms"] = step_event_ms(
            lambda: generator_loss(loss_type, leaf.detach(), y), 10)
    return entry


def phase_gan(device, workdir):
    """``python -m pai_tpu_torch.main smoke -m pix2pix --loss-type gan
    --batch-size 8 --epochs 1 --val-epochs 1 --precision 32 --device cuda``
    in this process at the published width (Pix2Pix mults 1,2,4,8,8,8,8,8
    and the PatchGAN): 10 steps, one validation, best and last slots; then
    ``--resume`` to a second epoch, the report CLI on the best slot, a step
    of each other loss type, a GAN step card vs CPU for every loss type, and
    a bf16-mixed step."""
    import gc

    from pai_tpu_torch import kernels, report
    from pai_tpu_torch import main as train_main
    from pai_tpu_torch.config import apply_precision_policy
    from pai_tpu_torch.data import BatchLoader, ImageDataset
    from pai_tpu_torch.models import Discriminator, build_generator
    from pai_tpu_torch.train import loop
    from pai_tpu_torch.train import steps as steps_lib
    from pai_tpu_torch.utils import checkpoint as ckpt_lib
    from pai_tpu_torch.utils.flops import parameter_count

    free = shutil.disk_usage(workdir).free
    need = 4 * GAN_SLOT_BYTES + 10 ** 9
    check(free >= need, f"{free / 1e9:.1f} GB free under {workdir}: the GAN "
          f"phase needs {need / 1e9:.1f} GB")
    train = write_pairs(os.path.join(workdir, "train"), GAN_TRAIN_IMAGES, 3)
    val = write_pairs(os.path.join(workdir, "val"), GAN_VAL_IMAGES, 4)
    logs, ckpts = (os.path.join(workdir, d) for d in ("glogs", "gckpt"))
    argv = ["smoke", "-d", train, "-vd", val, "-m", "pix2pix", "--loss-type",
            "gan", "--batch-size", str(GAN_BATCH), "--val-epochs", "1",
            "--precision", "32", "--device", "cuda", "--log-dir", logs,
            "--ckpt-dir", ckpts]

    steps, saves, validations, captured = [], [], [], {}
    real_make = steps_lib.make_gan_train_step
    real_write = ckpt_lib._write_slot
    real_validate = loop.Trainer.validate

    def instrumented(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def timed(state, x, y):
            torch.cuda.synchronize()
            before = dict(kernels.launch_counts)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            first = state.step
            host = time.perf_counter()
            start.record()
            state, metrics = step(state, x, y)
            enqueue_ms = (time.perf_counter() - host) * 1e3
            end.record()
            torch.cuda.synchronize()
            captured["state"] = state
            steps.append({"step": first, "ms": start.elapsed_time(end),
                          "enqueue_ms": enqueue_ms,
                          "log_row": "train_ssim" in metrics,
                          "loss": float(metrics["loss"]),
                          "d_loss": float(metrics["d_loss"]),
                          "launches": {k: kernels.launch_counts[k] - before[k]
                                       for k in before}})
            return state, metrics
        return timed

    def timed_write(slot_dir, flat, meta):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real_write(slot_dir, flat, meta)
        saves.append({"slot": os.path.basename(slot_dir),
                      "seconds": time.perf_counter() - start,
                      "bytes": os.path.getsize(os.path.join(slot_dir,
                                                            "state.pt"))})
        return out

    def timed_validate(self, state, epoch):
        torch.cuda.synchronize()
        before = dict(kernels.launch_counts)
        start = time.perf_counter()
        out = real_validate(self, state, epoch)
        torch.cuda.synchronize()
        validations.append({"seconds": time.perf_counter() - start,
                            "launches": {k: kernels.launch_counts[k]
                                         - before[k] for k in before}})
        return out

    steps_lib.make_gan_train_step = instrumented
    ckpt_lib._write_slot = timed_write
    loop.Trainer.validate = timed_validate
    try:
        # ---- the main path, counted ----------------------------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        summary = train_main.main(argv + ["--epochs", "1"])
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - start
        launches = dict(kernels.launch_counts)
        peak_fit = torch.cuda.max_memory_allocated()
        # ---- end of the counted window -------------------------------
        first_run = list(steps)
        steps.clear()
        resumed = train_main.main(argv + ["--epochs", "2", "--resume"])
    finally:
        steps_lib.make_gan_train_step = real_make
        ckpt_lib._write_slot = real_write
        loop.Trainer.validate = real_validate

    n_steps = GAN_TRAIN_IMAGES // GAN_BATCH
    n_val = GAN_VAL_IMAGES // GAN_BATCH
    check(summary["steps"] == n_steps and len(first_run) == n_steps,
          f"trained {summary['steps']} steps, expected {n_steps}")
    for entry in first_run:
        want = 1 if entry["log_row"] else 0  # train_ssim at a log row
        check(entry["launches"]["ssim_scalar"] == want
              and entry["launches"]["ssim_map"] == 0,
              f"step {entry['step'] + 1} launched {entry['launches']}")
        check(np.isfinite(entry["loss"]) and np.isfinite(entry["d_loss"]),
              f"step {entry['step'] + 1} losses not finite")
    check([e["log_row"] for e in first_run] == [False] * 9 + [True],
          "the log row is not step 10")
    check(validations[0]["launches"]["ssim_scalar"] == n_val,
          f"validation launched {validations[0]['launches']}, expected "
          f"{n_val} ssim_scalar (one per batch)")
    check(launches["ssim_scalar"] == n_val + 1,
          f"ssim_scalar launched {launches['ssim_scalar']} times on the GAN "
          f"path, expected {n_val + 1}")
    check(all(np.isfinite(summary[k]) for k in ("val_ssim", "val_psnr",
                                                  "val_rmse")),
          f"validation metrics: {summary}")
    slots = sorted(os.listdir(os.path.join(ckpts, "smoke")))
    check(slots == ["best", "last"], f"checkpoint slots {slots}")
    check([s["slot"] for s in saves[:3]] == ["best", "last", "last"],
          f"saves {saves}")
    rows = open(os.path.join(logs, "smoke", "version_0", "metrics.csv")
                ).read().splitlines()
    check(rows[0] == "epoch,step,loss,d_loss,train_ssim,train_psnr,"
          "train_rmse,val_ssim,val_psnr,val_rmse", f"metrics.csv {rows[0]}")
    check([e["step"] for e in steps] == list(range(n_steps, 2 * n_steps))
          and resumed["steps"] == 2 * n_steps,
          f"--resume ran steps {[e['step'] for e in steps]}, summary "
          f"{resumed['steps']}")

    # the best slot served by the report CLI (its launches gated as the
    # report phase gates them)
    best = os.path.join(ckpts, "smoke", "best")
    reports_dir = os.path.join(workdir, "greports")
    before = dict(kernels.launch_counts)
    start = time.perf_counter()
    report.main(["gan", "-c", best, "-d", val, "-m", "pix2pix", "-bs",
                 str(GAN_BATCH), "--device", "cuda", "--reports-dir",
                 reports_dir])
    torch.cuda.synchronize()
    report_seconds = time.perf_counter() - start
    report_launches = {k: kernels.launch_counts[k] - before[k]
                       for k in before}
    check(report_launches["ssim_map"] == SSIM_MAP_LAUNCHES_PER_BATCH * n_val,
          f"the GAN slot's report launched {report_launches}")
    rdir = os.path.join(reports_dir, "gan")
    for name in ("stats.txt", "depth_ssim.csv", "ssim_per_image.csv",
                 "psnr_per_image.csv", "mse_per_image.csv"):
        check(os.path.exists(os.path.join(rdir, name)), f"report {name}")
    outputs = os.listdir(os.path.join(rdir, "outputs"))
    check(len(outputs) == GAN_VAL_IMAGES, f"report outputs {len(outputs)}")
    best_ssim = read_csv_column(os.path.join(rdir, "ssim_per_image.csv"),
                                "image,ssim")
    check(np.isfinite(best_ssim).all(), "report SSIM not finite")

    # where the device time of a warm step goes, and a step's peak memory
    state = captured.pop("state")
    loader = BatchLoader(ImageDataset(train, SIZE), GAN_BATCH, shuffle=True,
                         pad_mode="cycle", device="cuda")
    batch = next(iter(loader))
    lean = real_make(state.generator, state.discriminator, "gan",
                     compute_metrics=False)
    lean(state, batch.x, batch.y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, busy_ms, span_ms = device_profile(
        lambda: lean(state, batch.x, batch.y), calls=2)
    peak_step = torch.cuda.max_memory_allocated()
    step_ms = step_event_ms(lambda: lean(state, batch.x, batch.y), 5)
    host = time.perf_counter()
    lean(state, batch.x, batch.y)
    enqueue_ms = (time.perf_counter() - host) * 1e3
    torch.cuda.synchronize()
    conv = re.compile(r"conv|cudnn|sm90_|sm80_|xmma|implicit_gemm|wgrad|"
                      r"dgrad|fprop|gemm|fft|nhwc", re.I)
    conv_ms = sum(us for key, us in events.items() if conv.search(key)) / 1e3
    top_events = sorted(events.items(), key=lambda kv: -kv[1])[:12]
    n_g = parameter_count(state.generator)
    n_d = parameter_count(state.discriminator)
    check(n_g == PIX2PIX_PARAMETERS and n_d == PATCHGAN_PARAMETERS,
          f"parameters {n_g} + {n_d}")
    x, y = batch.x, batch.y
    del state, lean, captured
    gc.collect()
    torch.cuda.empty_cache()

    # one timed step of each other loss type on the published width
    gen = torch.Generator(device=device).manual_seed(7)
    others = {}
    for loss_type in GAN_LOSS_TYPES[1:]:
        model = build_generator("pix2pix", channel_mults=(1, 2, 4, 8, 8, 8,
                                                          8, 8),
                                generator=gen, device=device)
        others[loss_type] = gan_loss_step(device, model, loss_type, x, y)
        del model
    gc.collect()
    torch.cuda.empty_cache()

    card_cpu = gan_card_vs_cpu(device)

    # one bf16-mixed GAN step at the published width
    apply_precision_policy("bf16-mixed")
    try:
        model = build_generator("pix2pix", channel_mults=(1, 2, 4, 8, 8, 8,
                                                          8, 8),
                                dtype=torch.bfloat16, generator=gen,
                                device=device)
        disc = Discriminator(dtype=torch.bfloat16, generator=gen,
                             device=device)
        state = steps_lib.init_gan_state(model, disc, "gan", use_ema=False)
        step = steps_lib.make_gan_train_step(model, disc, "gan",
                                             compute_metrics=False)
        state, metrics = step(state, x, y)
        _, bf16_busy, _ = device_profile(lambda: step(state, x, y), calls=1)
        bf16_ms = step_event_ms(lambda: step(state, x, y), 3)
        state, metrics = step(state, x, y)
        check(np.isfinite(float(metrics["loss"]))
              and np.isfinite(float(metrics["d_loss"])),
              f"bf16-mixed GAN step losses {metrics}")
    finally:
        apply_precision_policy("32")
    del state, step, model, disc
    gc.collect()
    torch.cuda.empty_cache()

    train_ms = [e["ms"] for e in first_run]
    emit({"phase": "gan", "images": GAN_TRAIN_IMAGES,
          "val_images": GAN_VAL_IMAGES, "batch_size": GAN_BATCH,
          "steps": n_steps, "channel_mults": FULL_MULTS,
          "parameters": {"generator": n_g, "discriminator": n_d},
          "fit_seconds": fit_seconds, "step_ms": train_ms,
          "step_ms_median_warm": statistics.median(train_ms[1:]),
          "step_enqueue_ms": [e["enqueue_ms"] for e in first_run],
          "images_per_second_training": GAN_BATCH * len(train_ms[1:])
              / (sum(train_ms[1:]) / 1e3),
          "launches_per_step": [e["launches"] for e in first_run],
          "validation": validations, "checkpoint_saves": saves,
          "max_memory_allocated_bytes_fit": peak_fit,
          "max_memory_allocated_bytes_step": peak_step,
          "losses": [e["loss"] for e in first_run],
          "d_losses": [e["d_loss"] for e in first_run],
          "resumed_steps": [e["step"] for e in steps],
          "lean_step_ms": step_ms, "lean_step_enqueue_ms": enqueue_ms,
          "lean_step_device_ms": busy_ms, "lean_step_device_span_ms":
              span_ms, "lean_step_conv_device_ms": conv_ms,
          "lean_step_conv_share": conv_ms / busy_ms if busy_ms else None,
          "step_top_device_events_us": [[name[:80], us]
                                        for name, us in top_events],
          "report_seconds": report_seconds,
          "report_launches": report_launches,
          "report_mean_ssim": float(best_ssim.mean()),
          "other_losses": others, "card_vs_cpu": card_cpu,
          "card_vs_cpu_limit": GAN_CARD_CPU_TOL,
          "bf16_mixed_step_ms": bf16_ms,
          "bf16_mixed_step_device_ms": bf16_busy,
          "launches": launches, "summary": summary})
    return launches


# The other generator families at their published widths (float32, batch
# 8, 256x256): parameter counts from tests/test_param_parity.py.
FAMILY_PARAMETERS = {"attention_unet": 55_556_662, "res18_unet": 55_667_137,
                     "res50_unet": 7_814_593, "resv2_unet": 55_677_121,
                     "resnext_unet": 3_954_817, "trans_unet": 1_026_822_465}
FAMILY_MULTS = {name: FULL_MULTS for name in FAMILY_PARAMETERS}
FAMILY_MULTS["trans_unet"] = "1,2,2,4,4"
FAMILY_TIMED_STEPS = 3
# the residual U-Nets' small step, card vs CPU: a ReLU input or a max-pool
# window within float noise of a tie at full resolution moves a gradient
# element by a few percent of its tensor's largest (the CPU tests'
# RES_MOMENT_TOL, tests/test_torch_port_families_train.py; ResUNet-18's
# small step read 7.8e-2 card vs CPU on an H100), so their parameters are
# held to GAN_CARD_CPU_TOL where the gradient is at least this share of the
# largest, where Adam's first step cannot change sign; every element to two
# learning rates, as for every family
RES_LARGE_GRADIENT = 0.2
# float32 weights and Adam's two moments of both networks (no EMA)
TRANS_SLOT_BYTES = 3 * 4 * (FAMILY_PARAMETERS["trans_unet"]
                            + PATCHGAN_PARAMETERS)


def family_steps(device, family, x, y, dtype=torch.float32):
    """One family at its published width: the parameter count, an eval
    forward, and ``FAMILY_TIMED_STEPS`` warm lean ``gan`` steps (CUDA-event
    ms and host enqueue ms each; device busy time of one more, profiled).
    ``dtype`` bfloat16, under the bf16-mixed precision policy (the caller
    sets it): both networks at that compute dtype, and besides the
    parameters float32, a convolution's input bfloat16 (a forward hook on
    the generator's second convolution) and every gradient finite."""
    import gc

    from pai_tpu_torch import kernels
    from pai_tpu_torch.models import Discriminator, build_generator
    from pai_tpu_torch.ops import Conv
    from pai_tpu_torch.train import steps as steps_lib
    from pai_tpu_torch.utils.flops import parameter_count

    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(11)
    torch.cuda.reset_peak_memory_stats()
    model = build_generator(family, channel_mults=[
        int(m) for m in FAMILY_MULTS[family].split(",")], dtype=dtype,
        generator=gen, device=device)
    n_params = parameter_count(model)
    check(n_params == FAMILY_PARAMETERS[family],
          f"{family}: {n_params} parameters, the reference has "
          f"{FAMILY_PARAMETERS[family]}")
    conv = [m for m in model.modules() if isinstance(m, Conv)][1]
    seen = []
    hook = conv.register_forward_hook(
        lambda m, args, out: seen.append((args[0].dtype, out.dtype)))
    with torch.inference_mode():
        out = model.eval()(x)
    hook.remove()
    check(tuple(out.shape) == tuple(x.shape) and bool(out.isfinite().all())
          and float(out.abs().max()) <= 1.0,
          f"{family}: eval forward {tuple(out.shape)}")
    disc = Discriminator(dtype=dtype, generator=gen, device=device)
    parameter_dtypes = sorted({str(p.dtype) for net in (model, disc)
                               for p in net.parameters()})
    if bf16:
        check(parameter_dtypes == ["torch.float32"] and
              seen[0][0] == torch.bfloat16,
              f"{family} at bf16-mixed: parameters {parameter_dtypes}, a "
              f"convolution's input and output {seen[0]}")
    state = steps_lib.init_gan_state(model, disc, "gan", use_ema=False)
    lean = steps_lib.make_gan_train_step(model, disc, "gan",
                                         compute_metrics=False)
    events, busy_ms, span_ms = device_profile(lambda: lean(state, x, y),
                                              calls=1)
    kernels.reset_launch_counts()
    step_ms, enqueue_ms, losses = [], [], []
    for _ in range(FAMILY_TIMED_STEPS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host = time.perf_counter()
        start.record()
        _, metrics = lean(state, x, y)
        enqueue_ms.append((time.perf_counter() - host) * 1e3)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append((float(metrics["loss"]), float(metrics["d_loss"])))
    check(all(np.isfinite(v) for pair in losses for v in pair),
          f"{family}: losses {losses}")
    check(not any(kernels.launch_counts.values()),
          f"{family}: a lean gan step launched {kernels.launch_counts}")
    if bf16:
        grads = [p.grad for net in (model, disc) for p in net.parameters()]
        check(all(g is not None and bool(g.isfinite().all())
                  for g in grads),
              f"{family} at bf16-mixed: a gradient missing or not finite")
    conv = re.compile(r"conv|cudnn|sm90_|sm80_|xmma|implicit_gemm|wgrad|"
                      r"dgrad|fprop|fft|nhwc", re.I)
    conv_ms = sum(us for key, us in events.items() if conv.search(key)) / 1e3
    top = sorted(events.items(), key=lambda kv: -kv[1])[:8]
    entry = {"parameters": n_params, "channel_mults": FAMILY_MULTS[family],
             "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
             "step_enqueue_ms": enqueue_ms, "step_device_ms": busy_ms,
             "step_device_span_ms": span_ms, "conv_device_ms": conv_ms,
             "conv_share": conv_ms / busy_ms if busy_ms else None,
             "top_device_events_us": [[k[:80], us] for k, us in top],
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
             "losses": losses, "parameter_dtypes": parameter_dtypes,
             "conv_input_output_dtypes": [str(d) for d in seen[0]]}
    del model, disc, state, lean, out
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def max_pool_ties_card_vs_cpu(device):
    """``max_pool_2x``'s backward on a ``channels_last`` CUDA tensor holding
    the zeros of a ReLU (tied windows): the gradient goes to the same
    element as on the CPU, the first of the window."""
    from pai_tpu_torch.ops import max_pool_2x

    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.maximum(rng.normal(0, 1, (2, 64, 32, 32)), 0)
                         .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 64, 16, 16)).astype(np.float32))
    grads = {}
    for where in ("cuda", "cpu"):
        xt = x.to(where).contiguous(memory_format=torch.channels_last)
        xt.requires_grad_(True)
        (max_pool_2x(xt) * g.to(where)).sum().backward()
        grads[where] = xt.grad.cpu()
    windows = x.reshape(2, 64, 16, 2, 16, 2)
    tied = int((windows == 0).all(dim=(3, 5)).sum())
    check(tied > 0, "no tied window in the max-pool check")
    check(torch.equal(grads["cuda"], grads["cpu"]),
          "max_pool_2x's gradient at tied windows differs card vs CPU")
    return {"tied_windows": tied, "equal": True}


def phase_families(device, workdir):
    """The six other generator families at their published widths: per
    family the parameter count, an eval forward, timed warm lean ``gan``
    steps, and a small ``gan`` step card vs CPU; then ``python -m
    pai_tpu_torch.main smoke -m trans_unet --channel-mults 1,2,2,4,4
    --loss-type gan --batch-size 8 --precision 32`` through 10 steps, a
    validation, best and last slots and ``--resume`` to a second epoch, and
    the report CLI on the best slot. Returns the launch counts of the
    TransUNet CLI's training run and of its report."""
    import gc

    from pai_tpu_torch import kernels, report
    from pai_tpu_torch import main as train_main
    from pai_tpu_torch.data import BatchLoader, ImageDataset
    from pai_tpu_torch.train import loop
    from pai_tpu_torch.utils import checkpoint as ckpt_lib

    free = shutil.disk_usage(workdir).free
    need = 3 * TRANS_SLOT_BYTES + 2 * 10 ** 9
    check(free >= need, f"{free / 1e9:.1f} GB free under {workdir}: the "
          f"families phase writes a best and a last TransUNet slot of "
          f"~{TRANS_SLOT_BYTES / 1e9:.1f} GB and rewrites last beside "
          f"itself, {need / 1e9:.1f} GB in all")
    train = write_pairs(os.path.join(workdir, "train"), GAN_TRAIN_IMAGES, 5)
    val = write_pairs(os.path.join(workdir, "val"), GAN_VAL_IMAGES, 6)
    loader = BatchLoader(ImageDataset(train, SIZE), GAN_BATCH, shuffle=True,
                         pad_mode="cycle", device="cuda")
    batch = next(iter(loader))

    families, card_cpu = {}, {}
    for family in FAMILY_PARAMETERS:
        families[family] = family_steps(device, family, batch.x, batch.y)
        large = RES_LARGE_GRADIENT if family.startswith("res") else 1e-3
        card_cpu[family] = gan_card_vs_cpu(device, family, ("gan",),
                                           large)["gan"]
    ties = max_pool_ties_card_vs_cpu(device)

    # ---- the TransUNet CLI: the main path of the phase, counted ----------
    logs, ckpts = (os.path.join(workdir, d) for d in ("flogs", "fckpt"))
    argv = ["smoke", "-d", train, "-vd", val, "-m", "trans_unet",
            "--channel-mults", FAMILY_MULTS["trans_unet"], "--loss-type",
            "gan", "--batch-size", str(GAN_BATCH), "--val-epochs", "1",
            "--precision", "32", "--device", "cuda", "--log-dir", logs,
            "--ckpt-dir", ckpts]
    saves, validations = [], []
    real_write = ckpt_lib._write_slot
    real_validate = loop.Trainer.validate

    def timed_write(slot_dir, flat, meta):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real_write(slot_dir, flat, meta)
        saves.append({"slot": os.path.basename(slot_dir),
                      "seconds": time.perf_counter() - start,
                      "bytes": os.path.getsize(os.path.join(slot_dir,
                                                            "state.pt"))})
        return out

    def timed_validate(self, state, epoch):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = real_validate(self, state, epoch)
        torch.cuda.synchronize()
        validations.append(time.perf_counter() - start)
        return out

    ckpt_lib._write_slot = timed_write
    loop.Trainer.validate = timed_validate
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        summary = train_main.main(argv + ["--epochs", "1"])
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - start
        train_launches = dict(kernels.launch_counts)
        peak_fit = torch.cuda.max_memory_allocated()
        # ---- end of the counted window -------------------------------
        gc.collect()
        torch.cuda.empty_cache()
        start = time.perf_counter()
        resumed = train_main.main(argv + ["--epochs", "2", "--resume"])
        torch.cuda.synchronize()
        resume_seconds = time.perf_counter() - start
    finally:
        ckpt_lib._write_slot = real_write
        loop.Trainer.validate = real_validate
    gc.collect()
    torch.cuda.empty_cache()

    n_steps = GAN_TRAIN_IMAGES // GAN_BATCH
    n_val = GAN_VAL_IMAGES // GAN_BATCH
    check(summary["steps"] == n_steps and resumed["steps"] == 2 * n_steps,
          f"TransUNet CLI: steps {summary['steps']}, then {resumed['steps']}")
    check(all(np.isfinite(summary[k]) for k in ("val_ssim", "val_psnr",
                                                  "val_rmse")),
          f"TransUNet validation metrics: {summary}")
    check(train_launches["ssim_scalar"] == n_val + 1,
          f"ssim_scalar launched {train_launches['ssim_scalar']} times on "
          f"the TransUNet training path, expected {n_val + 1} (one log row, "
          f"one per validation batch)")
    check(sorted(os.listdir(os.path.join(ckpts, "smoke"))) == ["best",
                                                               "last"],
          "TransUNet checkpoint slots")
    check([s["slot"] for s in saves[:3]] == ["best", "last", "last"],
          f"TransUNet saves {saves}")

    best = os.path.join(ckpts, "smoke", "best")
    reports_dir = os.path.join(workdir, "freports")
    kernels.reset_launch_counts()
    start = time.perf_counter()
    stats = report.main(["trans", "-c", best, "-d", val, "-m", "trans_unet",
                         "-bs", str(GAN_BATCH), "--device", "cuda",
                         "--reports-dir", reports_dir])
    torch.cuda.synchronize()
    report_seconds = time.perf_counter() - start
    report_launches = dict(kernels.launch_counts)
    check(report_launches["ssim_map"] == SSIM_MAP_LAUNCHES_PER_BATCH * n_val,
          f"the TransUNet slot's report launched {report_launches}")
    check(stats["params"] == FAMILY_PARAMETERS["trans_unet"],
          f"the report's parameter count {stats['params']}")
    ssim = read_csv_column(os.path.join(reports_dir, "trans",
                                        "ssim_per_image.csv"), "image,ssim")
    check(len(ssim) == GAN_VAL_IMAGES and np.isfinite(ssim).all(),
          "TransUNet report SSIM")
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families", "batch_size": GAN_BATCH, "image_size": SIZE,
          "precision": "32", "families": families, "card_vs_cpu": card_cpu,
          "card_vs_cpu_limit": GAN_CARD_CPU_TOL,
          "res_large_gradient": RES_LARGE_GRADIENT,
          "max_pool_ties_card_vs_cpu": ties,
          "trans_unet_cli": {
              "fit_seconds": fit_seconds, "resume_seconds": resume_seconds,
              "validation_seconds": validations, "checkpoint_saves": saves,
              "max_memory_allocated_bytes_fit": peak_fit,
              "train_launches": train_launches, "summary": summary,
              "resumed": resumed, "report_seconds": report_seconds,
              "report_launches": report_launches,
              "report_mean_ssim": float(ssim.mean()),
              "report_stats": stats}})
    return train_launches, report_launches


# bf16-mixed for the six families (phase_families_bf16). Card vs CPU: a
# small model of each family (small_generator, every tensor drawn from a
# seed) in eval mode at 32x32, bf16 and float32 on both; the card's bf16
# output against the CPU's must reach BF16_FAMILY_EQUAL and BF16_FAMILY_CORR
# (card_cpu_readings) and its float32 control must not reach both. The
# share bit-equal is lower than the UNet's (BF16_CARD_EQUAL): a family's
# output is the float32 tanh of a float32 sum, whose last bit the two
# libraries round differently, and the residual U-Nets' full-resolution
# 3x3 stacks spread a value that float32 order moved across a rounding
# point (tools/bf16_family_agreement.py reads 0.05-0.47 bit-equal against
# pai_tpu on the CPU).
BF16_FAMILY_EQUAL = 0.02
BF16_FAMILY_CORR = 0.5
# the live progress line: 20 GAN steps of Pix2Pix, the window of off-row
# steps read by the profiler (after the log row at step 10, before the one
# at step 20), and the runtime calls that make the host wait for the device
LIVE_STEPS = 20
LIVE_WINDOW = (11, 19)
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
LIVE_DRAW = re.compile(r"\[pai_tpu_torch\] epoch (\d+) step (\d+)(.*?)\x1b\[K")


def family_bf16_card_vs_cpu(device, family):
    """A small ``family`` model's eval forward on the card against the CPU
    at bf16 and float32 (card_cpu_readings)."""
    import copy

    cpu_model, _ = gan_small_models(3, family)
    card_model = copy.deepcopy(cpu_model).to(device).to(
        memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(13).uniform(
        -1, 1, (2, 32, 32, 1)).astype(np.float32))
    outs = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for where, model in (("cpu", cpu_model), ("card", card_model)):
                model.eval().compute_dtype = dtype
                outs[where, dtype] = model(x.to(
                    next(model.parameters()).device)).cpu().double()
    readings = card_cpu_readings(outs, f"small {family}")

    def passes(r):
        return (r["equal"] >= BF16_FAMILY_EQUAL
                and r["corr"] >= BF16_FAMILY_CORR)

    check(passes(readings["card_bf16"])
          and not passes(readings["card_float32_control"]),
          f"small {family} at bf16, card vs CPU: {readings} (limits equal "
          f">= {BF16_FAMILY_EQUAL}, corr >= {BF16_FAMILY_CORR}; the float32 "
          f"control must fail them)")
    return readings


def live_line(workdir, train):
    """``python -m pai_tpu_torch.main live -m pix2pix --precision
    bf16-mixed`` for LIVE_STEPS GAN steps at the published width with
    ``sys.stderr`` a pseudo-terminal (the live line redrawn and its loss
    fetched at every step: both intervals set to 0 here). A profiler window
    over the off-row steps LIVE_WINDOW must hold none of HOST_WAITS from the
    CUDA runtime (the profiler's own synchronisation at its stop lies after
    the window); every loss the line shows is one a step returned, and an
    off-row line shows the step before it (the device is idle behind a
    bf16-mixed Pix2Pix step, so the copy has landed)."""
    import pty
    import threading

    from torch.profiler import ProfilerActivity, profile, record_function

    from pai_tpu_torch import main as train_main
    from pai_tpu_torch.train import loop
    from pai_tpu_torch.train import steps as steps_lib

    master, follower = pty.openpty()
    received = []

    def drain():
        while True:
            try:
                data = os.read(master, 1 << 16)
            except OSError:  # the follower side is closed
                return
            if not data:
                return
            received.append(data)

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    terminal = os.fdopen(follower, "w")
    losses, window = {}, {}
    real_make = steps_lib.make_gan_train_step

    def instrumented(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def run(state, x, y):
            n = state.step + 1
            if n == LIVE_WINDOW[0]:
                window["profile"] = profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA])
                window["profile"].start()
                window["range"] = record_function("live_window")
                window["range"].__enter__()
            elif n == LIVE_WINDOW[1] + 1 and "range" in window:
                window.pop("range").__exit__(None, None, None)
                window["profile"].stop()
            state, metrics = step(state, x, y)
            losses[n] = metrics["loss"]  # read after the run
            return state, metrics
        return run

    logs = os.path.join(workdir, "live_logs")
    argv = ["live", "-d", train, "-m", "pix2pix", "--loss-type", "gan",
            "--batch-size", str(GAN_BATCH), "--precision", "bf16-mixed",
            "--steps", str(LIVE_STEPS), "--epochs", "3", "--device", "cuda",
            "--log-dir", logs, "--ckpt-dir",
            os.path.join(workdir, "live_ckpt")]
    real_stderr = sys.stderr
    intervals = (loop._Progress._MIN_INTERVAL,
                 loop._Progress._FETCH_INTERVAL)
    steps_lib.make_gan_train_step = instrumented
    loop._Progress._MIN_INTERVAL = loop._Progress._FETCH_INTERVAL = 0.0
    sys.stderr = terminal
    try:
        check(sys.stderr.isatty(), "the pseudo-terminal is not a TTY")
        start = time.perf_counter()
        summary = train_main.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        sys.stderr = real_stderr
        steps_lib.make_gan_train_step = real_make
        loop._Progress._MIN_INTERVAL, loop._Progress._FETCH_INTERVAL = \
            intervals
        terminal.close()
        reader.join(timeout=10)
        os.close(master)
    check(summary["steps"] == LIVE_STEPS and "range" not in window,
          f"live line run: {summary['steps']} steps, window {window}")
    losses = {n: float(v) for n, v in losses.items()}
    text = b"".join(received).decode()

    # the profiler window: the runtime's calls inside the marked range
    with tempfile.TemporaryDirectory(prefix="pai_smoke_live_") as tmp:
        path = os.path.join(tmp, "trace.json")
        window["profile"].export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    marks = [e for e in trace if e.get("name") == "live_window"
             and e.get("cat") == "user_annotation"]
    check(len(marks) == 1, f"{len(marks)} live_window ranges in the trace")
    lo, hi = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    runtime = {}
    for e in trace:
        if e.get("cat") == "cuda_runtime" and lo <= e.get("ts", -1) <= hi:
            runtime[e["name"]] = runtime.get(e["name"], 0) + 1
    waits = {name: n for name, n in runtime.items() if name in HOST_WAITS}
    check(runtime and not waits,
          f"the host waited for the device on the off-row steps "
          f"{LIVE_WINDOW}: {waits} (runtime calls {runtime})")

    # the line: one draw per step, every loss shown one a step returned
    draws = [(int(m.group(2)), dict(re.findall(r"(\w+)=(-?[\d.]+)",
                                               m.group(3))))
             for m in LIVE_DRAW.finditer(text)]
    check([n for n, _ in draws] == list(range(1, LIVE_STEPS + 1)),
          f"live line drawn at steps {[n for n, _ in draws]}")
    previous = 0
    for n, values in draws:
        if "loss" not in values:
            continue
        shown = values["loss"]
        # a log row shows its own loss, an off-row line an earlier one
        last = n if n % 10 == 0 else n - 1
        check(any(f"{losses[k]:.4f}" == shown for k in range(1, last + 1)),
              f"the live line at step {n} shows loss={shown}, which no "
              f"step before it returned")
        if n % 10 not in (0, 1) and f"{losses[n - 1]:.4f}" == shown:
            previous += 1  # a lean step's loss, through the copy
    check(previous > 0, "no off-row line showed the loss of the lean step "
          "before it")
    row = [line for line in open(os.path.join(
        logs, "live", "version_0", "metrics.csv")).read().splitlines()[1:]]
    return {"seconds": seconds, "steps": LIVE_STEPS,
            "window_steps": list(LIVE_WINDOW),
            "window_runtime_calls": runtime, "host_waits_in_window": waits,
            "draws": len(draws), "off_row_draws_showing_previous_loss":
                previous, "log_rows": row,
            "last_draws": [[n, v] for n, v in draws[-4:]]}


def phase_families_bf16(device, workdir):
    """The six families under ``--precision bf16-mixed``: at their
    published widths (family_steps at bfloat16), a small model of each card
    vs CPU (family_bf16_card_vs_cpu); then through the CLIs ``python -m
    pai_tpu_torch.main smoke -m attention_unet --loss-type ssim`` (10
    steps, a validation, best and last slots) and ``-m trans_unet
    --channel-mults 1,2,2,4,4`` (``gan``; 10 steps, a validation, the best
    slot: its last slot, 12.4 GB, gathered but not written), the report CLI
    on each best slot, with ``ssim_scalar`` and ``ssim_map`` counted per
    run; and the live progress line (live_line). Returns the launches of
    the training and report runs."""
    import gc

    from pai_tpu_torch import kernels, report
    from pai_tpu_torch import main as train_main
    from pai_tpu_torch.config import apply_precision_policy
    from pai_tpu_torch.data import BatchLoader, ImageDataset
    from pai_tpu_torch.train import loop
    from pai_tpu_torch.train import steps as steps_lib
    from pai_tpu_torch.utils import checkpoint as ckpt_lib

    free = shutil.disk_usage(workdir).free
    need = TRANS_SLOT_BYTES + 4 * 10 ** 9
    check(free >= need, f"{free / 1e9:.1f} GB free under {workdir}: the "
          f"bf16 families phase writes a TransUNet slot of "
          f"~{TRANS_SLOT_BYTES / 1e9:.1f} GB and the attention U-Net's, "
          f"{need / 1e9:.1f} GB in all")
    train = write_pairs(os.path.join(workdir, "train"), GAN_TRAIN_IMAGES, 7)
    val = write_pairs(os.path.join(workdir, "val"), GAN_VAL_IMAGES, 8)
    n_steps = GAN_TRAIN_IMAGES // GAN_BATCH
    n_val = GAN_VAL_IMAGES // GAN_BATCH
    seconds = {}
    try:
        apply_precision_policy("bf16-mixed")
        loader = BatchLoader(ImageDataset(train, SIZE), GAN_BATCH,
                             shuffle=True, pad_mode="cycle", device="cuda")
        batch = next(iter(loader))
        start = time.perf_counter()
        families = {family: family_steps(device, family, batch.x, batch.y,
                                         torch.bfloat16)
                    for family in FAMILY_PARAMETERS}
        seconds["published_widths"] = time.perf_counter() - start
        start = time.perf_counter()
        card_cpu = {family: family_bf16_card_vs_cpu(device, family)
                    for family in FAMILY_PARAMETERS}
        seconds["card_vs_cpu"] = time.perf_counter() - start

        # ---- through the CLIs, counted run by run ----------------------
        runs = {}
        saves, steps = [], []
        real_write = ckpt_lib._write_slot
        real_make = steps_lib.make_gan_train_step
        skip_last = {"on": False}

        def timed_write(slot_dir, flat, meta):
            torch.cuda.synchronize()
            if skip_last["on"] and os.path.basename(slot_dir) == "last":
                saves.append({"slot": "last", "written": False})
                return slot_dir
            begin = time.perf_counter()
            out = real_write(slot_dir, flat, meta)
            saves.append({"slot": os.path.basename(slot_dir),
                          "written": True,
                          "seconds": time.perf_counter() - begin,
                          "bytes": os.path.getsize(os.path.join(
                              slot_dir, "state.pt"))})
            return out

        def instrumented(*args, **kwargs):
            step = real_make(*args, **kwargs)

            def counted(state, x, y):
                before = dict(kernels.launch_counts)
                state, metrics = step(state, x, y)
                steps.append({"log_row": "train_ssim" in metrics,
                              "launches": {k: kernels.launch_counts[k]
                                           - before[k] for k in before},
                              "loss": metrics["loss"]})
                return state, metrics
            return counted

        ckpt_lib._write_slot = timed_write
        steps_lib.make_gan_train_step = instrumented
        try:
            for tag, family, loss_type, extra in (
                    ("attention_unet_ssim", "attention_unet", "ssim", []),
                    ("trans_unet_gan", "trans_unet", "gan",
                     ["--channel-mults", FAMILY_MULTS["trans_unet"]])):
                logs, ckpts = (os.path.join(workdir, f"{d}_{tag}")
                               for d in ("logs", "ckpt"))
                argv = ["smoke", "-d", train, "-vd", val, "-m", family,
                        "--loss-type", loss_type, "--batch-size",
                        str(GAN_BATCH), "--epochs", "1", "--val-epochs", "1",
                        "--precision", "bf16-mixed", "--device", "cuda",
                        "--log-dir", logs, "--ckpt-dir", ckpts, *extra]
                skip_last["on"] = family == "trans_unet"
                saves.clear()
                steps.clear()
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                start = time.perf_counter()
                summary = train_main.main(argv)
                torch.cuda.synchronize()
                fit_seconds = time.perf_counter() - start
                train_launches = dict(kernels.launch_counts)
                peak = torch.cuda.max_memory_allocated()
                # ---- end of the counted training run -------------------
                ssim_loss = loss_type == "ssim"
                for i, entry in enumerate(steps):
                    want = int(ssim_loss) + int(entry["log_row"])
                    check(entry["launches"]["ssim_scalar"] == want
                          and entry["launches"]["ssim_map"] == 0,
                          f"{tag} step {i + 1} launched "
                          f"{entry['launches']}, expected {want} "
                          f"ssim_scalar")
                    check(np.isfinite(float(entry["loss"])),
                          f"{tag} step {i + 1}: loss not finite")
                want = n_steps * int(ssim_loss) + 1 + n_val
                check(summary["steps"] == n_steps and len(steps) == n_steps
                      and [e["log_row"] for e in steps]
                      == [False] * (n_steps - 1) + [True],
                      f"{tag}: {summary['steps']} steps, log rows "
                      f"{[e['log_row'] for e in steps]}")
                check(train_launches["ssim_scalar"] == want
                      and train_launches["ssim_map"] == 0,
                      f"{tag} launched {train_launches} on its training "
                      f"path, expected {want} ssim_scalar (one per step "
                      f"for an SSIM loss, 1 for train_ssim, {n_val} for "
                      f"the validation)")
                check(all(np.isfinite(summary[k]) for k in (
                    "val_ssim", "val_psnr", "val_rmse")),
                      f"{tag} validation metrics: {summary}")
                slots = sorted(os.listdir(os.path.join(ckpts, "smoke")))
                written = [e["slot"] for e in saves if e["written"]]
                check(slots == (["best"] if family == "trans_unet"
                                else ["best", "last"])
                      and written[0] == "best",
                      f"{tag}: slots {slots}, saves {saves}")
                reports_dir = os.path.join(workdir, f"reports_{tag}")
                kernels.reset_launch_counts()
                start = time.perf_counter()
                stats = report.main([tag, "-c", os.path.join(
                    ckpts, "smoke", "best"), "-d", val, "-m", family, "-bs",
                    str(GAN_BATCH), "--device", "cuda", "--reports-dir",
                    reports_dir])
                torch.cuda.synchronize()
                report_seconds = time.perf_counter() - start
                report_launches = dict(kernels.launch_counts)
                # ---- end of the counted report run ---------------------
                check(report_launches["ssim_map"]
                      == SSIM_MAP_LAUNCHES_PER_BATCH * n_val
                      and report_launches["ssim_scalar"] == 0,
                      f"the {tag} slot's report launched {report_launches}")
                check(stats["params"] == FAMILY_PARAMETERS[family],
                      f"{tag} report: {stats['params']} parameters")
                ssim = read_csv_column(os.path.join(
                    reports_dir, tag, "ssim_per_image.csv"), "image,ssim")
                check(len(ssim) == GAN_VAL_IMAGES
                      and np.isfinite(ssim).all(), f"{tag} report SSIM")
                runs[tag] = {
                    "fit_seconds": fit_seconds, "summary": summary,
                    "train_launches": train_launches,
                    "launches_per_step": [e["launches"] for e in steps],
                    "losses": [float(e["loss"]) for e in steps],
                    "checkpoint_saves": list(saves),
                    "max_memory_allocated_bytes_fit": peak,
                    "report_seconds": report_seconds,
                    "report_launches": report_launches,
                    "report_mean_ssim": float(ssim.mean())}
                shutil.rmtree(ckpts)
        finally:
            ckpt_lib._write_slot = real_write
            steps_lib.make_gan_train_step = real_make
        gc.collect()
        torch.cuda.empty_cache()
        start = time.perf_counter()
        live = live_line(workdir, train)
        seconds["live_line"] = time.perf_counter() - start
    finally:
        apply_precision_policy("32")
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "families_bf16", "precision": "bf16-mixed",
          "batch_size": GAN_BATCH, "image_size": SIZE, "families": families,
          "card_vs_cpu": card_cpu,
          "card_vs_cpu_limits": {"equal": BF16_FAMILY_EQUAL,
                                 "corr": BF16_FAMILY_CORR},
          "cli": runs, "live_line": live, "seconds": seconds})
    return ({tag: r["train_launches"] for tag, r in runs.items()},
            {tag: r["report_launches"] for tag, r in runs.items()})


# the interop phase: a reference-layout Lightning .ckpt through the port
INTEROP_STEP, INTEROP_EPOCH, INTEROP_EMA_UPDATES = 1000, 4, 500
INTEROP_RESUME_STEPS = 10
CODEC_THREADS = 8
# the extra files of the decode check: PNG colour type, bit depth, samples
# per pixel; each written at 256x256 (read at its own size) and at 300x200
# (resized)
CODEC_KINDS = {"rgb": (2, 8, 3), "palette": (3, 8, 1), "gray16": (0, 16, 1),
               "rgba16": (6, 16, 4)}
CODEC_SHAPES = ((SIZE, SIZE), (200, 300))
# the report's wall time on the pure-Python decoder and writer before the
# native codec (H100 80GB HBM3 at 700 W; PERF.md section 5), printed beside
# this run's
REPORT_SECONDS_BEFORE = (0.48, 0.57)


def encode_png(path, samples, colour, depth, palette=None):
    """Write ``samples`` ([H, W, C] uint8 or uint16; palette indices for
    colour type 3) as a PNG whose row y is filtered with type y % 5 (None,
    Sub, Up, Average, Paeth), zlib level 6."""
    from pai_tpu_torch.utils.images import _chunk

    h, w, c = samples.shape
    raw = np.ascontiguousarray(samples.astype(
        ">u2" if depth == 16 else np.uint8)).view(np.uint8).reshape(h, -1)
    raw = raw.astype(np.int32)
    bpp = c * depth // 8
    rows, prev = [], np.zeros_like(raw[0])
    for y, row in enumerate(raw):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ftype = y % 5
        pred = [np.zeros_like(row), a, prev, (a + prev) // 2, None][ftype]
        if ftype == 4:
            p = a + prev - up_left
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, up_left))
        rows.append(bytes([ftype]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prev = row
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                    0))]
    if palette is not None:
        chunks.append((b"PLTE", palette.tobytes()))
    chunks += [(b"IDAT", zlib.compress(b"".join(rows), 6)), (b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + b"".join(_chunk(kind, body) for kind, body in chunks))


def write_codec_files(directory):
    """The decode check's extra files (``CODEC_KINDS`` x ``CODEC_SHAPES``),
    random content from a seed."""
    rng = np.random.default_rng(11)
    paths = []
    for name, (colour, depth, channels) in CODEC_KINDS.items():
        for h, w in CODEC_SHAPES:
            top = 255 if depth == 8 else 65535
            samples = rng.integers(0, top + 1, (h, w, channels)).astype(
                np.uint8 if depth == 8 else np.uint16)
            palette = None
            if colour == 3:
                samples = (samples % 64).astype(np.uint8)
                palette = rng.integers(0, 256, (64, 3), dtype=np.uint8)
            path = os.path.join(directory, f"{name}_{h}x{w}.png")
            encode_png(path, samples, colour, depth, palette)
            paths.append(path)
    return paths


def codec_check(workdir, manifest):
    """The native batch decoder against the plain version over the report's
    32 pairs and the extra files; ms per 32 pairs, native against plain."""
    from pai_tpu_torch.data.manifest import load_manifest
    from pai_tpu_torch.data.pipeline import decode_u8, decode_u8_plain
    from pai_tpu_torch.utils.images import read_png_gray, read_png_gray_plain

    pair_paths = [p for pair in load_manifest(manifest) for p in pair]
    extras = write_codec_files(workdir)
    decoded = decode_u8(pair_paths + extras, SIZE, CODEC_THREADS)
    native_size, resized = 0, []
    for path, got in zip(pair_paths + extras, decoded):
        want = decode_u8_plain(path, SIZE)
        if read_png_gray_plain(path).shape == (SIZE, SIZE):
            check(np.array_equal(got, want),
                  f"{path}: native decode differs from the plain version")
            native_size += 1
        else:
            check(np.array_equal(read_png_gray(path),
                                 read_png_gray_plain(path)),
                  f"{path}: native gray read differs from the plain version")
            resized.append(np.abs(got.astype(int) - want.astype(int)))
    resized = np.stack(resized)
    max_diff = int(resized.max())
    check(max_diff <= 1, f"resized files: native vs plain differ by "
          f"{max_diff} levels (limit 1)")

    def median_ms(fn, repeats):
        times = []
        for _ in range(repeats):
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times)

    native_ms = median_ms(
        lambda: decode_u8(pair_paths, SIZE, CODEC_THREADS), 7)
    native_1_ms = median_ms(lambda: decode_u8(pair_paths, SIZE, 1), 5)
    plain_ms = median_ms(
        lambda: [decode_u8_plain(p, SIZE) for p in pair_paths], 3)
    return {"files_at_native_size": native_size,
            "files_resized": len(resized),
            "resized_exact_share": float((resized == 0).mean()),
            "resized_max_abs_diff_levels": max_diff,
            "ms_per_32_pairs": {f"native_{CODEC_THREADS}_threads": native_ms,
                                "native_1_thread": native_1_ms,
                                "plain": plain_ms},
            "plain_over_native": plain_ms / native_ms}


def reference_checkpoint(path, device):
    """A reference-layout Lightning ``.ckpt``: a full-width Pix2Pix
    (``seeded_pix2pix``) and a seeded PatchGAN under ``unet.`` and
    ``discriminator.`` in the modules' order, the reference's
    ``hyper_parameters``, ``epoch`` and ``global_step``, and a torch_ema
    payload whose shadow weights are the raw ones moved at random by 2 % of
    themselves. Returns (state dict, shadow weights by name)."""
    from pai_tpu_torch.interop.lightning import _is_buffer
    from pai_tpu_torch.models import Discriminator

    model = seeded_pix2pix(device, 5)
    gen = torch.Generator(device=device).manual_seed(6)
    disc = Discriminator(2, generator=gen, device=device)
    sd = {"unet." + k: v.detach().cpu()
          for k, v in model.state_dict().items()}
    sd.update({"discriminator." + k: v.detach().cpu()
               for k, v in disc.state_dict().items()})
    noise = torch.Generator().manual_seed(7)
    shadow = {k: v * (1 + 0.02 * torch.randn(v.shape, generator=noise))
              for k, v in sd.items() if not _is_buffer(k)}
    torch.save({
        "state_dict": sd, "epoch": INTEROP_EPOCH,
        "global_step": INTEROP_STEP,
        "hyper_parameters": {"in_channels": 1, "out_channels": 1,
                             "channel_mults": (1, 2, 4, 8, 8, 8, 8, 8),
                             "dropout": 0.0, "loss_type": "gan"},
        "callbacks": {"EMA": {"shadow_params": list(shadow.values()),
                              "num_updates": INTEROP_EMA_UPDATES,
                              "decay": 0.9999, "collected_params": None}},
    }, path)
    return sd, shadow


def phase_interop(device, workdir):
    """The native codec (build seconds; the batch decoder against the plain
    version; ms per 32 pairs), then a reference-layout Lightning ``.ckpt``
    of Pix2Pix at the published widths with the PatchGAN and an EMA payload
    through ``python -m pai_tpu_torch.interop.lightning import --slot best``,
    the report CLI over 32 images at batch 8 (launch counts set to 0 just
    before and read just after; cuDNN set deterministic for it and for what
    it is held against, bit for bit: the shadow weights loaded directly),
    ``api.Pix2Pix.from_lightning_checkpoint``,
    ``import --slot last`` and ``pai_tpu_torch.main --resume`` for 10 steps,
    and ``export`` of the best slot."""
    from pai_tpu_torch import kernels, native, report
    from pai_tpu_torch import main as train_main
    from pai_tpu_torch.api import Pix2Pix
    from pai_tpu_torch.data import BatchLoader, ImageDataset
    from pai_tpu_torch.interop import lightning
    from pai_tpu_torch.models import build_generator
    from pai_tpu_torch.reporting import chunk_metrics, unpack_chunk
    from pai_tpu_torch.utils.checkpoint import load_checkpoint
    from pai_tpu_torch.utils.images import (afmhot_rgb, denormalize, read_png,
                                            to_int)

    seconds = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return out

    manifest = timed("write_dataset", write_dataset, workdir)
    codec = timed("codec_check", codec_check, workdir, manifest)

    ckpt = os.path.join(workdir, "reference.ckpt")
    sd, shadow = timed("write_reference_ckpt", reference_checkpoint, ckpt,
                       device)
    n_gen = sum(v.numel() for k, v in shadow.items()
                if k.startswith("unet."))
    n_disc = sum(v.numel() for k, v in shadow.items()
                 if k.startswith("discriminator."))
    check(n_gen == PIX2PIX_PARAMETERS and n_disc == PATCHGAN_PARAMETERS,
          f"parameters {n_gen} + {n_disc}, expected {PIX2PIX_PARAMETERS} + "
          f"{PATCHGAN_PARAMETERS}")
    ckdir, logdir = (os.path.join(workdir, d) for d in ("ick", "ilogs"))
    best = timed("import_best", lightning.main, [
        "import", ckpt, "-m", "pix2pix", "-o", ckdir, "--name", "interop",
        "--slot", "best"])

    # the shadow weights loaded directly into the module
    direct = build_generator("pix2pix", channel_mults=(1, 2, 4, 8, 8, 8, 8, 8),
                             device="meta")
    direct.load_state_dict({k[len("unet."):]: shadow.get(k, v)
                            for k, v in sd.items() if k.startswith("unet.")},
                           strict=True, assign=True)
    direct = direct.to(device).to(memory_format=torch.channels_last)
    direct = direct.eval().requires_grad_(False)
    loader = BatchLoader(ImageDataset(manifest, SIZE), BATCH, pad_mode="zero",
                         device="cuda")
    # cuDNN's default forward is not bit-reproducible at these shapes: the
    # same module on the same batch twice differs (read here). The report
    # and what it is held against run with deterministic algorithms.
    with torch.inference_mode():
        x0 = next(iter(loader)).x
        rerun_diff = float((direct(x0) - direct(x0)).abs().max())
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # ---- the interop path, counted ----------------------------------
        reports_dir = os.path.join(workdir, "ireports")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        report.main(["interop", "-c", best, "-d", manifest, "-m", "pix2pix",
                     "-bs", str(BATCH), "--device", "cuda", "--reports-dir",
                     reports_dir])
        torch.cuda.synchronize()
        seconds["report"] = time.perf_counter() - start
        launches = dict(kernels.launch_counts)
        # ---- end of the counted window ----------------------------------
        n_batches = N_IMAGES // BATCH
        check(launches["ssim_map"] == SSIM_MAP_LAUNCHES_PER_BATCH * n_batches
              and launches["ssim_scalar"] == 0,
              f"the interop report launched {launches}, expected "
              f"{n_batches} ssim_map")

        # the report's outputs and numbers, and both API routes, against
        # the shadow weights' own predictions
        api_best = Pix2Pix.load_from_checkpoint(best, device="cuda")
        api_ckpt = timed("from_lightning_checkpoint",
                         Pix2Pix.from_lightning_checkpoint, ckpt, "cuda")
        check(api_ckpt.hparams["ema"] is True, "the API did not find the EMA")
        rdir = os.path.join(reports_dir, "interop")
        columns = {name: read_csv_column(
            os.path.join(rdir, f"{name}_per_image.csv"), f"image,{name}")
            for name in ("ssim", "psnr", "mse")}
        index = 0
        with torch.inference_mode():
            for batch in loader:
                pred = direct(batch.x)
                check(torch.equal(api_best.predict(batch.x), pred)
                      and torch.equal(api_ckpt.predict(batch.x), pred),
                      "an API prediction differs from the shadow weights' "
                      "own")
                host = unpack_chunk(chunk_metrics(
                    denormalize(pred), denormalize(batch.y)).cpu().numpy(),
                    pred.shape)
                for k in range(batch.n_valid):
                    stem = f"{str(index).zfill(5)}.png"
                    check(np.array_equal(
                        read_png(os.path.join(rdir, "outputs", stem)),
                        to_int(afmhot_rgb(host["pred"][k, ..., 0]))),
                        f"report output {stem} is not the shadow weights' "
                        "prediction")
                    for name in ("ssim", "psnr", "mse"):
                        check(np.float32(columns[name][index])
                              == host[name][k],
                              f"report {name} of image {index} differs from "
                              "the shadow weights'")
                    index += 1
        check(index == N_IMAGES, f"compared {index} images")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del direct, api_best, api_ckpt
    # the same report with cuDNN's default algorithms, timed only
    torch.cuda.synchronize()
    start = time.perf_counter()
    report.main(["interop_default", "-c", best, "-d", manifest, "-m",
                 "pix2pix", "-bs", str(BATCH), "--device", "cuda",
                 "--reports-dir", reports_dir])
    torch.cuda.synchronize()
    seconds["report_default_cudnn"] = time.perf_counter() - start

    # --resume from an imported last slot
    timed("import_last", lightning.main, [
        "import", ckpt, "-m", "pix2pix", "-o", ckdir, "--name", "interop",
        "--slot", "last"])
    target = INTEROP_STEP + INTEROP_RESUME_STEPS
    summary = timed("resume", train_main.main, [
        "interop", "-d", manifest, "-m", "pix2pix", "--loss-type", "gan",
        "--ema", "--resume", "--batch-size", str(BATCH), "--epochs",
        str(INTEROP_EPOCH + 4), "--steps", str(target), "--precision", "32",
        "--device", "cuda", "--ckpt-dir", ckdir, "--log-dir", logdir])
    _, meta = load_checkpoint(os.path.join(ckdir, "interop", "last"))
    check(summary["steps"] == target and meta["step"] == target,
          f"resumed to step {meta['step']}, expected {target}")
    check(meta["ema_num_updates"]
          == INTEROP_EMA_UPDATES + INTEROP_RESUME_STEPS,
          f"EMA updates {meta['ema_num_updates']}, expected "
          f"{INTEROP_EMA_UPDATES + INTEROP_RESUME_STEPS}")
    logged = read_csv_steps(os.path.join(logdir, "interop", "version_0",
                                         "metrics.csv"))
    check(logged == [target], f"log rows at steps {logged}, expected "
          f"[{target}]: the run did not start at the checkpoint's step")

    # export of the best slot: the shadow weights and the PatchGAN
    out = os.path.join(workdir, "exported.ckpt")
    timed("export", lightning.main, ["export", best, "-o", out])
    back = torch.load(out, map_location="cpu", weights_only=False)
    check(back["state_dict"].keys() == sd.keys(),
          "the export's tensor names are not the reference's")
    for key, value in sd.items():
        want = shadow.get(key, value) if key.startswith("unet.") else value
        check(torch.equal(back["state_dict"][key], want),
              f"exported {key} is not the source's shadow or PatchGAN value")

    emit({"phase": "interop", "nvidia_smi": nvidia_smi_line(),
          "codec_build_seconds": native.build_seconds,
          "codec_library": os.path.basename(native.library_path()),
          "decode": codec,
          "parameters": {"generator": n_gen, "patchgan": n_disc},
          "reference_ckpt_bytes": os.path.getsize(ckpt),
          "images": N_IMAGES, "batch_size": BATCH,
          "report_seconds_deterministic_cudnn": seconds["report"],
          "report_seconds": seconds["report_default_cudnn"],
          "report_images_per_second":
              N_IMAGES / seconds["report_default_cudnn"],
          "report_seconds_pure_python_codec": REPORT_SECONDS_BEFORE,
          "launches": launches,
          "default_cudnn_rerun_max_abs_diff": rerun_diff,
          "resumed_to_step": meta["step"],
          "ema_num_updates": meta["ema_num_updates"],
          "exported_tensors_bit_equal": len(sd), "seconds": seconds})
    return launches


# ---------------------------------------------------------------------------
# parallel: the multi-device layer on one card (ranks over gloo)
# ---------------------------------------------------------------------------
# NCCL refuses two ranks of one communicator on one card ("Duplicate GPU
# detected", tools/torch_gloo_cuda_probe.py), so the multi-rank checks run
# their ranks on this card over gloo with CUDA tensors, through the code
# NCCL would run; the probe found that gloo carries all-reduce, broadcast,
# all-gather, reduce-scatter and FSDP2's collectives on CUDA tensors but not
# point-to-point, which the ring stages through host memory (it reads the
# group's backend). The world of one runs over NCCL. FSDP2's step over gloo
# with CUDA tensors ends its process (SIGSEGV, the probe's fsdp2_step), so
# ``--fsdp`` with 2 ranks does not run here: the phase says so, and the
# multi-rank FSDP math is held by the CPU tests
# (tests/test_torch_port_parallel.py).
RING_CASES = (((2, 4, 16384, 64), torch.float32),
              ((2, 4, 16384, 64), torch.bfloat16),
              ((2, 4, 4096, 128), torch.float32))
RING_WORLDS = (2, 4)
RANK_JOB_TIMEOUT = 600
PARALLEL_GAN_TRAIN, PARALLEL_GAN_STEPS = 16, 2
PARALLEL_PALETTE_BATCH, PARALLEL_PALETTE_STEPS = 2, 2
# the --sp 2 validation's sampling chain (the CLI's: 100 steps); each step
# runs the UNet's 15 rings through host memory
PARALLEL_PALETTE_CHAIN = 5
GAN_LR = 2e-4
# one process under --fsdp on a world of one (NCCL): 10 steps at batch 8, a
# validation, --resume to step 20; bit-equal to the plain run
FSDP1_TRAIN, FSDP1_VAL = 80, 16


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(job, world, workdir, spec, nccl_world_of_one=False):
    """Run ``chip_smoke.py --rank-job job`` in ``world`` processes on this
    card, all started together, and return each rank's JSON result. They
    must end within RANK_JOB_TIMEOUT seconds; any that does not is
    killed."""
    port = free_port()
    spec_path = os.path.join(workdir, f"{job}_{world}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    if nccl_world_of_one:  # a launcher's environment: the Trainer starts it
        env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
    logs, procs = [], []
    for rank in range(world):
        log = open(os.path.join(workdir, f"{job}_{world}_rank{rank}.log"),
                   "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-job", job,
             str(rank), str(world), str(port), spec_path],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    start = time.perf_counter()
    try:
        for proc in procs:
            left = RANK_JOB_TIMEOUT - (time.perf_counter() - start)
            proc.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    results = []
    for rank, proc in enumerate(procs):
        log_path = os.path.join(workdir, f"{job}_{world}_rank{rank}.log")
        if proc.returncode != 0:
            with open(log_path) as f:
                tail = f.read()[-3000:]
            raise SmokeFailure(f"rank {rank} of {job} (world {world}) "
                               f"exited {proc.returncode}:\n{tail}")
        with open(spec_path + f".rank{rank}") as f:
            results.append(json.load(f))
    return results


def rank_ring(rank, world, spec):
    """Ring attention over sp=world ranks at the Palette's shapes, against
    the one-process FlashAttention on the card."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa
    from pai_tpu_torch.parallel.mesh import make_mesh
    from pai_tpu_torch.parallel.ring_attention import (
        flash_hop_eligible, sequence_sharded_attention)

    device = torch.device("cuda", 0)
    mesh = make_mesh(world, sp=world, device_type="cuda")
    out = []
    for shape, dtype in RING_CASES:
        q, k, v = random_qkv(shape, 300, device, dtype)
        g = random_qkv(shape, 301, device, dtype)[0]

        def ring():
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = sequence_sharded_attention(mesh, *leaves)
            o.backward(g)
            return o.detach(), [x.grad for x in leaves]

        ring()  # warm: connections, staging buffers
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        got, grads = ring()
        torch.cuda.synchronize()
        ring_ms = (time.perf_counter() - start) * 1e3
        launches = dict(kernels.launch_counts)

        def one():
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = fa.FlashAttention.apply(*leaves)
            o.backward(g)
            return o.detach(), [x.grad for x in leaves]

        one()
        torch.cuda.synchronize()
        start = time.perf_counter()
        want, want_grads = one()
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - start) * 1e3
        entry = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                 "world": world,
                 "hop": "flash" if flash_hop_eligible(shape[2] // world,
                                                      shape[3]) else "einsum",
                 "launches": {k: launches[k] for k in
                              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
                 "ring_fwd_bwd_ms": ring_ms, "one_process_fwd_bwd_ms": one_ms,
                 "finite": bool(torch.isfinite(got.float()).all()) and all(
                     bool(torch.isfinite(x.float()).all()) for x in grads)}
        scale = float(want.float().abs().max())
        entry["out_max_abs_err"] = float((got.float() - want.float())
                                         .abs().max())
        if dtype == torch.float32:
            entry["out_limit"] = FLASH_TOL
        else:  # 2^-8 plus one bf16 unit at the largest output
            unit = 2.0 ** (np.floor(np.log2(scale)) - 7)
            entry["out_limit"] = FLASH_BF16_REL_TOL * max(1.0, scale) + unit
        for tag, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
            scale = float(b.float().abs().max())
            entry[f"{tag}_max_abs_err"] = float((a.float() - b.float())
                                                .abs().max())
            if dtype == torch.float32:
                entry[f"{tag}_limit"] = FLASH_BWD_TOL * scale
            else:  # 2^-8 plus one bf16 unit: each hop's gradient is rounded
                # to bf16 (the kernels' output type) before the float32
                # sum over hops, as in the JAX package's ring
                unit = 2.0 ** (np.floor(np.log2(scale)) - 7)
                entry[f"{tag}_limit"] = FLASH_BWD_BF16_REL_TOL * scale + unit
        out.append(entry)
        del q, k, v, g, got, grads, want, want_grads
    return {"cases": out}


def _instrument_steps(record, snapshot=False):
    """Wrap the train-step factories so that every step records its loss
    and its time (synchronised), and with ``snapshot`` the whole state
    after the first step (``_state_on_host``: collective on a mesh) as
    ``record["first"]``; returns a function that undoes it."""
    from pai_tpu_torch.train import steps as steps_lib

    real = {name: getattr(steps_lib, name) for name in
            ("make_gan_train_step", "make_palette_train_step")}

    def wrap(factory):
        def make(*args, **kwargs):
            step = factory(*args, **kwargs)

            def timed(state, *batch):
                torch.cuda.synchronize()
                start = time.perf_counter()
                state, metrics = step(state, *batch)
                loss = float(metrics["loss"])
                record["steps"].append(
                    {"ms": (time.perf_counter() - start) * 1e3, "loss": loss})
                record["state"] = state
                if snapshot and len(record["steps"]) == 1:
                    record["first"] = _state_on_host(state)
                return state, metrics
            return timed
        return make

    for name, factory in real.items():
        setattr(steps_lib, name, wrap(factory))

    def undo():
        for name, factory in real.items():
            setattr(steps_lib, name, factory)
    return undo


def _shorten_sampling_chain(steps):
    """Have the Trainer's validation sample with a cosine chain of ``steps``
    steps instead of 100 (a cut of depth: every step runs the same UNet)."""
    from pai_tpu_torch.diffusion import make_schedule
    from pai_tpu_torch.train import steps as steps_lib

    real = steps_lib.make_palette_sample_step

    def make(unet, sched_inf, learn_var):
        return real(unet, make_schedule("cosine", steps,
                                        device=sched_inf.gammas.device),
                    learn_var)
    steps_lib.make_palette_sample_step = make


def _state_on_host(state):
    """The whole parameters, running statistics and Adam moments (gathered:
    collective on a mesh) of a train state, on the host."""
    from pai_tpu_torch.train import loop

    flat = loop.full_train_state_dict(state)
    return {k: v.cpu() for k, v in flat.items()
            if not k.startswith("ema.") and not k.endswith(".step")}


def adam_agreement(got, want, device):
    """How far a train state ``got`` lies from ``want`` after the same
    steps. Adam's first step moves every element by one learning rate
    whatever its gradient, so parameters alone cannot show a wrong
    gradient: the moments are read against the largest of their chain
    (generator or discriminator) and kind (``exp_avg``, ``exp_avg_sq``).
    Parameters are read where the first moment is at least 1e-3 of its
    tensor's largest ("held") and elsewhere ("noise"); a tensor whose first
    moment is below 1e-3 of its chain's largest (the biases a BatchNorm
    takes away) is noise as a whole: Adam's step there follows the sign of
    float noise. Each pair of tensors is read on ``device``."""
    def kind(key, moment):
        return ("discriminator" if key.startswith("opt.discriminator.")
                else "generator") + "." + moment

    top, moments = {}, {}
    for key, value in want.items():
        if key.startswith("opt."):
            k = kind(key, key.rsplit(".", 1)[1])
            top[k] = max(top.get(k, 0.0),
                         float(value.to(device).abs().max()))
    for key, value in want.items():
        if key.startswith("opt."):
            k = kind(key, key.rsplit(".", 1)[1])
            err = float((got[key].to(device) - value.to(device)).abs().max()
                        ) / max(top[k], 1e-30)
            if err >= moments.get(k, (-1.0,))[0]:
                moments[k] = (err, key)
    held, noise = (0.0, None), (0.0, None)
    for key, value in want.items():
        mu = want.get(f"opt.{key}.exp_avg")
        if mu is None:  # running statistics, counts, moments
            continue
        mu = mu.to(device).abs()
        diff = (got[key].to(device) - value.to(device)).abs()
        scale = float(mu.max())
        large = mu >= 1e-3 * scale
        if scale < 1e-3 * top[kind("opt." + key, "exp_avg")]:
            large = torch.zeros_like(large)
        if large.any() and float(diff[large].max()) >= held[0]:
            held = (float(diff[large].max()), key)
        if (~large).any() and float(diff[~large].max()) >= noise[0]:
            noise = (float(diff[~large].max()), key)
    running = [float((got[k].to(device) - want[k].to(device)).abs().max())
               for k in want if "running" in k]
    return {"moment_rel_err": {k: v[0] for k, v in moments.items()},
            "moment_worst": {k: v[1] for k, v in moments.items()},
            "held_param_diff": held[0], "held_param_diff_at": held[1],
            "noise_param_diff": noise[0], "noise_param_diff_at": noise[1],
            "max_running_diff": max(running, default=0.0),
            "same_keys": sorted(got) == sorted(want)}


def _no_slot_writes():
    """Have the checkpoint manager gather every slot but write none;
    returns a function that undoes it."""
    from pai_tpu_torch.utils import checkpoint as ckpt_lib

    real = ckpt_lib._write_slot
    ckpt_lib._write_slot = lambda slot_dir, flat, meta: slot_dir

    def undo():
        ckpt_lib._write_slot = real
    return undo


def rank_cli(rank, world, spec):
    """``pai_tpu_torch.main.main(argv)`` on this rank (and the runs after
    it; with ``write_slots`` false, the slots gathered but not written);
    with ``reference``, rank 0 then trains the same run on one process from
    the same state (its slots not written) and compares."""
    import torch.distributed as dist

    from pai_tpu_torch import kernels
    from pai_tpu_torch import main as train_main

    torch.backends.cudnn.deterministic = spec.get("deterministic", False)
    torch.backends.cudnn.benchmark = False
    if spec.get("sample_steps"):
        _shorten_sampling_chain(spec["sample_steps"])
    result = {"runs": []}
    for argv in spec["argvs"]:
        record = {"steps": []}
        undo = _instrument_steps(record, bool(spec.get("reference")))
        undo_slots = (lambda: None) if spec.get("write_slots", True) \
            else _no_slot_writes()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        try:
            summary = train_main.main(argv)
        finally:
            undo()
            undo_slots()
        torch.cuda.synchronize()
        result["runs"].append({
            "summary": summary, "steps": record["steps"],
            "seconds": time.perf_counter() - start,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": dict(kernels.launch_counts)})
    if spec.get("reference"):
        first = record["first"]
        del record
        dist.destroy_process_group()
        if rank == 0:
            import gc

            gc.collect()
            torch.cuda.empty_cache()
            record = {"steps": []}
            undo = _instrument_steps(record, snapshot=True)
            undo_slots = _no_slot_writes()
            start = time.perf_counter()
            try:
                train_main.main(spec["reference"])
            finally:
                undo()
                undo_slots()
            result["reference"] = {
                "steps": record["steps"],
                "seconds": time.perf_counter() - start,
                **adam_agreement(first, record["first"],
                                 torch.device("cuda", 0))}
    return result


def rank_job_main(argv):
    """``chip_smoke.py --rank-job JOB RANK WORLD PORT SPEC``: one rank of a
    parallel-phase job on this card (gloo; a world of one started by the
    Trainer from the launcher's environment over NCCL)."""
    import datetime

    import torch.distributed as dist

    job, rank, world, port, spec_path = (argv[0], int(argv[1]),
                                          int(argv[2]), int(argv[3]), argv[4])
    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    from pai_tpu_torch.config import apply_precision_policy

    apply_precision_policy("32")
    if world > 1:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=300))
    result = {"ring": rank_ring, "cli": rank_cli}[job](rank, world, spec)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    with open(spec_path + f".rank{rank}", "w") as f:
        json.dump(result, f)
    return 0


def _steps_equal(a, b):
    return [s["loss"] for s in a] == [s["loss"] for s in b]


def phase_parallel(device, workdir):
    """The multi-device layer on this card: ring attention over 2 and 4
    ranks against the one-process kernels; ``--fsdp`` on a world of one over
    NCCL bit-equal to the plain run; ``--tp 2`` Pix2Pix GAN and ``--sp 2``
    Palette at the CLI-default width with 2 ranks, each against a
    one-process run from the same state; a line saying ``--fsdp`` with 2
    ranks is not run here."""
    from pai_tpu_torch.train.state import palette_lr
    from pai_tpu_torch.utils.checkpoint import load_checkpoint

    out = {"phase": "parallel", "backend_multi_rank": "gloo (CUDA tensors)",
           "backend_world_of_one": "nccl"}
    seconds = {}
    # ---- ring attention -------------------------------------------------
    start = time.perf_counter()
    ring = []
    for world in RING_WORLDS:
        results = spawn_ranks("ring", world, workdir, {})
        for index, entry in enumerate(results[0]["cases"]):
            for rank, res in enumerate(results):
                case = res["cases"][index]
                tag = f"ring {case['shape']} {case['dtype']} sp={world} " \
                      f"rank {rank}"
                check(case["finite"], f"{tag}: not finite")
                check(case["out_max_abs_err"] <= case["out_limit"],
                      f"{tag}: forward {case['out_max_abs_err']} > "
                      f"{case['out_limit']}")
                for g in ("dq", "dk", "dv"):
                    check(case[f"{g}_max_abs_err"] <= case[f"{g}_limit"],
                          f"{tag}: {g} {case[f'{g}_max_abs_err']} > "
                          f"{case[f'{g}_limit']}")
                want = world if case["hop"] == "flash" else 0
                check(case["launches"] == {"flash_fwd": want,
                                           "flash_bwd_dq": want,
                                           "flash_bwd_dkv": want},
                      f"{tag}: launches {case['launches']}, expected "
                      f"{want} of each")
            ring.append({**entry, "ranks": world, "max_over_ranks": {
                k: max(res["cases"][index][k] for res in results)
                for k in ("out_max_abs_err", "dq_max_abs_err",
                          "dk_max_abs_err", "dv_max_abs_err",
                          "ring_fwd_bwd_ms")}})
    out["ring"] = ring
    seconds["ring"] = time.perf_counter() - start

    # ---- --fsdp on a world of one (NCCL) against the plain run ----------
    start = time.perf_counter()
    train = write_pairs(os.path.join(workdir, "fsdp1_train"), FSDP1_TRAIN, 40)
    val = write_pairs(os.path.join(workdir, "fsdp1_val"), FSDP1_VAL, 41)

    def gan_argv(name, root, extra=()):
        return ["smoke", "-d", train, "-vd", val, "-m", "pix2pix",
                "--loss-type", "gan", "--batch-size", str(GAN_BATCH),
                "--val-epochs", "1", "--precision", "32", "--device",
                "cuda", "--log-dir", os.path.join(root, "logs"),
                "--ckpt-dir", os.path.join(root, "ckpt"), *extra]

    runs = {}
    for mode in ("plain", "fsdp"):
        root = os.path.join(workdir, f"fsdp1_{mode}")
        flags = ["--fsdp"] if mode == "fsdp" else []
        spec = {"deterministic": True, "argvs": [
            gan_argv(mode, root, flags + ["--epochs", "1"]),
            gan_argv(mode, root, flags + ["--epochs", "2", "--resume"])]}
        if mode == "plain":  # in this process, which has no process group
            deterministic = torch.backends.cudnn.deterministic
            try:
                runs[mode] = rank_cli(0, 1, spec)
            finally:
                torch.backends.cudnn.deterministic = deterministic
        else:
            runs[mode] = spawn_ranks("cli", 1, workdir, spec,
                                     nccl_world_of_one=True)[0]
        runs[mode]["root"] = root
    seconds["fsdp_world_of_one"] = time.perf_counter() - start
    plain, fsdp = runs["plain"], runs["fsdp"]
    for index in range(2):
        check(_steps_equal(plain["runs"][index]["steps"],
                           fsdp["runs"][index]["steps"]),
              f"--fsdp on a world of one: run {index} losses differ from the "
              "plain run's")
        check(plain["runs"][index]["summary"] == {
            **fsdp["runs"][index]["summary"],
            "images_per_sec": plain["runs"][index]["summary"][
                "images_per_sec"]},
            "--fsdp on a world of one: validation differs")
    n_equal = 0
    for slot in ("best", "last"):
        a, meta_a = load_checkpoint(os.path.join(plain["root"], "ckpt",
                                                 "smoke", slot))
        b, meta_b = load_checkpoint(os.path.join(fsdp["root"], "ckpt",
                                                 "smoke", slot))
        check(a.keys() == b.keys() and meta_a["step"] == meta_b["step"],
              f"--fsdp on a world of one: {slot} slot differs in layout")
        for key in a:
            check(torch.equal(a[key], b[key]),
                  f"--fsdp on a world of one: {slot} {key} differs")
            n_equal += 1
    step_ms = {mode: statistics.median(
        s["ms"] for s in runs[mode]["runs"][0]["steps"][1:])
        for mode in runs}
    out["fsdp_world_of_one"] = {
        "steps": len(plain["runs"][0]["steps"])
        + len(plain["runs"][1]["steps"]),
        "losses_bit_equal": True, "slot_tensors_bit_equal": n_equal,
        "step_ms_median": step_ms, "cudnn_deterministic": True}

    # ---- multi-rank runs through the CLI against one process ------------
    def held(name, world, argv, reference, lr, **spec):
        results = spawn_ranks("cli", world, workdir,
                              {"argvs": [argv], "reference": reference,
                               **spec})
        ref = results[0]["reference"]
        runs = [r["runs"][0] for r in results]
        got = [s["loss"] for s in runs[0]["steps"]]
        want = [s["loss"] for s in ref["steps"]]
        check(len(got) == len(want) and len(got) > 0,
              f"{name}: {len(got)} steps against {len(want)}")
        for r in runs[1:]:
            check([s["loss"] for s in r["steps"]] == got,
                  f"{name}: the ranks' losses differ")
        rel_err = max(abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(got, want))
        check(rel_err <= 1e-3, f"{name}: losses {got} against {want}")
        check(ref["same_keys"], f"{name}: state names differ")
        for kind, err in ref["moment_rel_err"].items():
            check(err <= 1e-3, f"{name}: Adam {kind} {err} of the largest "
                  f"from the one-process run's ({ref['moment_worst'][kind]})")
        # the state after the first step: from there on two runs part by
        # float noise alone (PERF.md), so later states are read by their
        # losses
        held_bound, noise_bound = 1e-2 * lr, 2 * lr
        check(ref["held_param_diff"] <= held_bound,
              f"{name}: parameters {ref['held_param_diff']} from the "
              f"one-process run's ({ref['held_param_diff_at']}), bound "
              f"{held_bound}")
        check(ref["noise_param_diff"] <= noise_bound,
              f"{name}: parameters at float-noise gradients "
              f"{ref['noise_param_diff']} from the one-process run's "
              f"({ref['noise_param_diff_at']}), bound {noise_bound}")
        return {"ranks": world, "steps": len(got), "losses": got,
                "one_process_losses": want, "loss_rel_err": rel_err,
                "adam_moment_rel_err": ref["moment_rel_err"],
                "held_param_diff": ref["held_param_diff"],
                "held_param_diff_at": ref["held_param_diff_at"],
                "held_param_bound": held_bound,
                "noise_param_diff": ref["noise_param_diff"],
                "noise_param_diff_at": ref["noise_param_diff_at"],
                "noise_param_bound": noise_bound,
                "max_running_stat_diff": ref["max_running_diff"],
                "step_ms_median": statistics.median(
                    s["ms"] for s in runs[0]["steps"]),
                "one_process_step_ms_median": statistics.median(
                    s["ms"] for s in ref["steps"]),
                "peak_bytes_per_rank": [r["peak_bytes"] for r in runs],
                "run_seconds": runs[0]["seconds"],
                "one_process_seconds": ref["seconds"],
                "launches_rank0": runs[0]["launches"],
                "summary": runs[0]["summary"]}

    gan_train = write_pairs(os.path.join(workdir, "par_train"),
                            PARALLEL_GAN_TRAIN, 42)

    def par_argv(root, extra, data=gan_train, val=None):
        argv = ["smoke", "-d", data, "-m", "pix2pix", "--loss-type", "gan",
                "--batch-size", str(GAN_BATCH), "--epochs", "1",
                "--val-epochs", "1", "--precision", "32", "--device", "cuda",
                "--log-dir", os.path.join(root, "logs"),
                "--ckpt-dir", os.path.join(root, "ckpt"), *extra]
        return argv + (["-vd", val] if val else [])

    emit({"phase": "parallel", "fsdp2": "not run on the card: FSDP2's "
          "collectives over gloo on CUDA tensors end the process "
          "(tools/torch_gloo_cuda_probe.py), and NCCL refuses two ranks "
          "on one card; --fsdp with several ranks is held by "
          "tests/test_torch_port_parallel.py on the CPU"})
    start = time.perf_counter()
    root = os.path.join(workdir, "tp2")
    # cuDNN deterministic in both: with its algorithms free, the PatchGAN's
    # weight gradients differ from run to run by enough to move a held
    # parameter by 1.2 % of the learning rate in some runs of either side
    # (tools/tp2_agreement_probe.py)
    out["tp2"] = held("tp2", 2, par_argv(root, ["--tp", "2"]),
                      par_argv(root + "_one", []), GAN_LR,
                      deterministic=True)
    seconds["tp2"] = time.perf_counter() - start
    start = time.perf_counter()
    # ---- --sp 2 Palette at the CLI-default width ------------------------
    pal_train = write_pairs(os.path.join(workdir, "sp_train"),
                            PARALLEL_PALETTE_BATCH * PARALLEL_PALETTE_STEPS,
                            43)
    pal_val = write_pairs(os.path.join(workdir, "sp_val"),
                          PARALLEL_PALETTE_BATCH, 44)
    root = os.path.join(workdir, "sp2")

    def pal_argv(root, extra, val=None):
        argv = ["smoke", "-d", pal_train, "-m", "palette", "--batch-size",
                str(PARALLEL_PALETTE_BATCH), "--epochs", "1",
                "--val-epochs", "1", "--precision", "32", "--device", "cuda",
                "--log-dir", os.path.join(root, "logs"),
                "--ckpt-dir", os.path.join(root, "ckpt"), *extra]
        return argv + (["-vd", val] if val else [])

    out["sp2_palette"] = held("sp2 palette", 2,
                              pal_argv(root, ["--sp", "2"], pal_val),
                              pal_argv(root + "_one", []), palette_lr(0),
                              sample_steps=PARALLEL_PALETTE_CHAIN,
                              write_slots=False)
    launches = out["sp2_palette"]["launches_rank0"]
    check(launches["flash_fwd"] > 0 and launches["flash_bwd_dq"] > 0
          and launches["flash_bwd_dkv"] > 0,
          f"sp2 palette: the ring launched {launches}")
    check(np.isfinite(out["sp2_palette"]["summary"]["val_ssim"]),
          "sp2 palette: validation not finite")
    seconds["sp2_palette"] = time.perf_counter() - start
    ring_launches = {k: ring[0]["launches"][k] for k in ring[0]["launches"]}
    emit({**out, "seconds": seconds})
    return {"ring": ring_launches, "palette_sp2": launches}


# ---------------------------------------------------------------- graphs
GRAPH_K = 5
# 80 pairs at batch 8: 10 steps per epoch, so two chunks of K = 5 (one of
# K = 10) per epoch; 20 steps of Pix2Pix, 10 of the attention U-Net
GRAPH_IMAGES, GRAPH_BATCH = 80, 8
GRAPH_PIX2PIX_EPOCHS, GRAPH_ATTENTION_EPOCHS = 2, 1
GRAPH_PALETTE_BATCH, GRAPH_PALETTE_STEPS = 4, 10
GRAPH_CHAIN_BATCH = 2
# one captured launch each, at the Palette paths' shapes (in bfloat16 and
# float32)
GRAPH_FLASH_SHAPES = {"forward": (2, 4, 16384, 64),
                      "backward": (4, 4, 4096, 128)}


def record_train_calls(steps_lib):
    """Patch ``TrainStep`` and ``TrainScan`` so that every outermost call
    is recorded: its kind, first step and step count, its host time and a
    CUDA event before and after it. Returns (calls, restore)."""
    calls, depth = [], [0]
    real = {cls: cls.__call__ for cls in (steps_lib.TrainStep,
                                          steps_lib.TrainScan)}

    def wrap(cls):
        def call(self, state, *args, **kwargs):
            if depth[0]:
                return real[cls](self, state, *args, **kwargs)
            depth[0] += 1
            first = state.step
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            host = time.perf_counter()
            out = real[cls](self, state, *args, **kwargs)
            host_ms = (time.perf_counter() - host) * 1e3
            end.record()
            depth[0] -= 1
            calls.append({"scan": cls is steps_lib.TrainScan, "obj": self,
                          "state": out[0], "first": first,
                          "steps": out[0].step - first, "host_ms": host_ms,
                          "start": start, "end": end})
            return out
        return call

    for cls in real:
        cls.__call__ = wrap(cls)

    def restore():
        for cls, fn in real.items():
            cls.__call__ = fn
    return calls, restore


def window_figures(calls, first_step):
    """Per-step host enqueue ms and CUDA-event ms over the calls from step
    ``first_step`` to the run's end (synchronised here)."""
    torch.cuda.synchronize()
    window = [c for c in calls if c["first"] >= first_step]
    steps = sum(c["steps"] for c in window)
    return {"steps": steps,
            "enqueue_ms_per_step": sum(c["host_ms"] for c in window) / steps,
            "event_ms_per_step": window[0]["start"].elapsed_time(
                window[-1]["end"]) / steps}


def graph_cli_run(workdir, tag, argv, k):
    """``pai_tpu_torch.main`` with ``--scan-steps k`` in this process, the
    kernels' launch counts set to 0 just before and read just after: the
    run's last slot (cloned on the card, not written), its CSV, the
    recorded calls, the scan's graph figures and the peak memory."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch import main as train_main
    from pai_tpu_torch.train import steps as steps_lib
    from pai_tpu_torch.utils import checkpoint as ckpt_lib

    slots = {}
    real_write = ckpt_lib._write_slot

    def keep_slot(slot_dir, flat, meta):
        slots[os.path.basename(slot_dir)] = (
            {key: v.detach().clone() for key, v in flat.items()}, dict(meta))
        return slot_dir

    logs = os.path.join(workdir, f"logs_{tag}_k{k}")
    calls, restore = record_train_calls(steps_lib)
    ckpt_lib._write_slot = keep_slot
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        summary = train_main.main(argv + [
            "--scan-steps", str(k), "--log-dir", logs,
            "--ckpt-dir", os.path.join(workdir, f"ckpt_{tag}_k{k}")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = dict(kernels.launch_counts)
    finally:
        ckpt_lib._write_slot = real_write
        restore()
    with open(os.path.join(logs, "smoke", "version_0", "metrics.csv")) as f:
        csv_text = f.read()
    scans = [c["obj"] for c in calls if c["scan"]]
    graph = scans[-1].graph.stats() if scans else None
    return {"summary": summary, "slot": slots["last"][0], "csv": csv_text,
            "calls": calls, "launches": launches, "seconds": seconds,
            "graph": graph, "peak_bytes": torch.cuda.max_memory_allocated()}


def states_equal(a, b, what):
    """Every tensor of two flat train states bit-equal; the count of
    tensors."""
    check(a.keys() == b.keys(), f"{what}: slot keys differ")
    unequal = [key for key in a if not torch.equal(a[key], b[key])]
    check(not unequal, f"{what}: {len(unequal)} of {len(a)} tensors differ, "
          f"e.g. {unequal[:4]}")
    kinds = {"ema": sum(key.startswith("ema.") for key in a),
             "adam": sum(key.startswith("opt.") for key in a),
             "running": sum("running_" in key for key in a)}
    check(all(kinds.values()), f"{what}: the slot lacks a kind: {kinds}")
    return {"tensors": len(a), **kinds}


def chunk_profile(device, run, k):
    """Device busy and span per step, torch.profiler over one chunk of
    ``k`` steps of a finished run's own state and step objects: on the
    ``k = 1`` side k ordinary lean steps, on the others one replay of the
    scan and one ordinary step (lean where the run had one; at K = 10 every
    ordinary step is a logged one). Random batches of the run's shapes."""
    ordinary = [c for c in run["calls"] if not c["scan"]]
    lean = [c for c in ordinary if (c["first"] + 1) % 10] or ordinary
    step_fn, state = lean[-1]["obj"], lean[-1]["state"]
    scans = [c["obj"] for c in run["calls"] if c["scan"]]
    gen = torch.Generator(device=device).manual_seed(77)
    shape = (GRAPH_BATCH, SIZE, SIZE, 1)
    xs = [torch.rand(shape, generator=gen, device=device) * 2 - 1
          for _ in range(2 * k)]

    def chunk():
        if scans:
            scans[-1](state, xs[:k - 1], xs[k:2 * k - 1])
            step_fn(state, xs[k - 1], xs[2 * k - 1])
        else:
            for i in range(k):
                step_fn(state, xs[i], xs[k + i])

    _, busy, span = device_profile(chunk, calls=1)
    return {"device_busy_ms_per_step": busy / k,
            "device_span_ms_per_step": span / k}


def graph_flash_launches(device):
    """One flash_fwd, and one dq and dkv, each recorded alone in a CUDA
    graph and replayed: bit-equal to the eager launch, within the flash
    gates of the plain version, one launch counted per replay; in bfloat16
    and in float32 (whose forward and backward record their split pass
    too)."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa
    from pai_tpu_torch.utils.graphs import CapturedGraph, GraphStream

    out = {}
    q, k, v = random_qkv(GRAPH_FLASH_SHAPES["forward"], 910, device,
                         torch.bfloat16)
    side = GraphStream()
    with side:
        fa.flash_attention(q, k, v, emit_lse=True)
    graph = CapturedGraph(lambda: fa.flash_attention(q, k, v, emit_lse=True),
                          side.stream)
    before = kernels.launch_counts["flash_fwd"]
    graph.replay()
    check(kernels.launch_counts["flash_fwd"] == before + 1,
          "a replay of a captured flash_fwd did not count one launch")
    o_eager, lse_eager = fa.flash_attention(q, k, v, emit_lse=True)
    o_graph, lse_graph = graph.output
    torch.cuda.synchronize()
    check(torch.equal(o_graph, o_eager) and torch.equal(lse_graph, lse_eager),
          "captured flash_fwd differs from its eager launch")
    want_o, want_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
    ulps = bf16_ulps(o_graph, want_o)
    lse_err = float((lse_graph - want_lse).abs().max())
    check(ulps <= FLASH_BF16_ULPS and lse_err <= FLASH_LSE_TOL,
          f"captured flash_fwd against plain: {ulps} bf16 units, lse "
          f"{lse_err}")
    out["flash_fwd"] = {"shape": list(q.shape), "bf16_ulps": ulps,
                        "lse_max_abs_err": lse_err, "eager_bit_equal": True,
                        **graph.stats()}
    del graph, o_graph, lse_graph, want_o, want_lse

    shape = GRAPH_FLASH_SHAPES["backward"]
    q, k, v = random_qkv(shape, 911, device, torch.bfloat16)
    do = random_qkv(shape, 912, device, torch.bfloat16)[0]
    o, lse = fa.flash_attention(q, k, v, emit_lse=True)
    with side:
        fa.flash_attention_backward(q, k, v, o, lse, do)
    graph = CapturedGraph(
        lambda: fa.flash_attention_backward(q, k, v, o, lse, do),
        side.stream)
    before = dict(kernels.launch_counts)
    graph.replay()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(kernels.launch_counts[name] == before[name] + 1,
              f"a replay of a captured {name} did not count one launch")
    eager = fa.flash_attention_backward(q, k, v, o, lse, do)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    entry = {"shape": list(shape), "eager_bit_equal": True, **graph.stats()}
    for tag, g, e, w in zip(("dq", "dk", "dv"), graph.output, eager, want):
        check(torch.equal(g, e), f"captured flash backward {tag} differs "
              "from its eager launch")
        ulps = bf16_ulps(g, w)
        err = float((g.float() - w.float()).abs().max())
        limit = FLASH_BWD_BF16_REL_TOL * float(w.float().abs().max())
        check(ulps <= FLASH_BF16_ULPS and err <= limit,
              f"captured flash backward {tag} against plain: {ulps} bf16 "
              f"units, {err} > {limit}")
        entry[f"{tag}_bf16_ulps"] = ulps
        entry[f"{tag}_max_abs_err"] = err
    out["flash_backward"] = entry
    out.update(graph_flash_launches_float32(device, side))
    return out


def graph_flash_launches_float32(device, side):
    """graph_flash_launches' checks in float32 at the float32 Palette paths'
    shapes (GRAPH_FLASH_SHAPES): the forward, dq and dkv on wgmma, the
    forward and the backward each after their split pass, recorded in the
    graph with it."""
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa
    from pai_tpu_torch.utils.graphs import CapturedGraph

    out = {}
    q, k, v = random_qkv(GRAPH_FLASH_SHAPES["forward"], 913, device)
    with side:
        fa.flash_attention(q, k, v, emit_lse=True)
    graph = CapturedGraph(lambda: fa.flash_attention(q, k, v, emit_lse=True),
                          side.stream)
    before = dict(kernels.launch_counts)
    graph.replay()
    for name in ("flash_fwd", "flash_split"):
        check(kernels.launch_counts[name] == before[name] + 1,
              f"a replay of a captured float32 {name} did not count one "
              "launch")
    o_eager, lse_eager = fa.flash_attention(q, k, v, emit_lse=True)
    o_graph, lse_graph = graph.output
    torch.cuda.synchronize()
    check(torch.equal(o_graph, o_eager) and torch.equal(lse_graph, lse_eager),
          "captured float32 flash_fwd differs from its eager launch")
    want_o, want_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
    err = float((o_graph - want_o).abs().max())
    lse_err = float((lse_graph - want_lse).abs().max())
    check(err <= FLASH_TOL and lse_err <= FLASH_LSE_TOL,
          f"captured float32 flash_fwd against plain: {err}, lse {lse_err}")
    out["flash_fwd_float32"] = {
        "shape": list(q.shape), "max_abs_err": err,
        "lse_max_abs_err": lse_err, "eager_bit_equal": True,
        **graph.stats()}
    del graph, o_graph, lse_graph, want_o, want_lse, q, k, v

    shape = GRAPH_FLASH_SHAPES["backward"]
    q, k, v = random_qkv(shape, 914, device)
    do = random_qkv(shape, 915, device)[0]
    o, lse = fa.flash_attention(q, k, v, emit_lse=True)
    with side:
        fa.flash_attention_backward(q, k, v, o, lse, do)
    graph = CapturedGraph(
        lambda: fa.flash_attention_backward(q, k, v, o, lse, do),
        side.stream)
    before = dict(kernels.launch_counts)
    graph.replay()
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_split"):
        check(kernels.launch_counts[name] == before[name] + 1,
              f"a replay of a captured float32 backward did not count one "
              f"{name} launch")
    eager = fa.flash_attention_backward(q, k, v, o, lse, do)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    entry = {"shape": list(shape), "eager_bit_equal": True, **graph.stats()}
    for tag, g, e, w in zip(("dq", "dk", "dv"), graph.output, eager, want):
        check(torch.equal(g, e), f"captured float32 flash backward {tag} "
              "differs from its eager launch")
        err = float((g - w).abs().max())
        limit = FLASH_BWD_TOL * float(w.abs().max())
        check(err <= limit, f"captured float32 flash backward {tag} against "
              f"plain: {err} > {limit}")
        entry[f"{tag}_max_abs_err"] = err
    out["flash_backward_float32"] = entry
    return out


def phase_graphs(device, workdir):
    """``--scan-steps 5`` against 1 (the K-1 lean steps of a chunk as one
    replayed CUDA graph), and the 100-step chain as one graph against the
    eager loop, with cuDNN deterministic on both sides; see ``main``'s
    list."""
    import gc

    from pai_tpu_torch import kernels
    from pai_tpu_torch.config import TRAIN_DEFAULTS, apply_precision_policy
    from pai_tpu_torch.diffusion import make_schedule
    from pai_tpu_torch.diffusion import sampler
    from pai_tpu_torch.reporting import palette_predictor
    from pai_tpu_torch.restore import build_generator_from_hparams
    from pai_tpu_torch.train import steps as steps_lib
    from pai_tpu_torch.train.loop import train_state_dict

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    result = {"phase": "graphs", "k": GRAPH_K, "cudnn_deterministic": True}
    try:
        data = write_pairs(os.path.join(workdir, "pairs"), GRAPH_IMAGES, 11)
        base = ["smoke", "-d", data, "--batch-size", str(GRAPH_BATCH),
                "--device", "cuda", "--ema", "--seed", "5"]
        # (tag, arguments, the K held against K = 1, first step of the
        # timed window: the first chunk warms the graph up and records it)
        cases = [
            ("pix2pix_32", ["-m", "pix2pix", "--loss-type", "gan",
                            "--precision", "32", "--dropout", "0.5", "-e",
                            str(GRAPH_PIX2PIX_EPOCHS)], (GRAPH_K,), 10),
            ("pix2pix_bf16", ["-m", "pix2pix", "--loss-type", "gan",
                              "--precision", "bf16-mixed", "-e",
                              str(GRAPH_PIX2PIX_EPOCHS)], (GRAPH_K, 10), 10),
            ("attention_ssim_bf16", ["-m", "attention_unet", "--loss-type",
                                     "ssim", "--precision", "bf16-mixed",
                                     "-e", str(GRAPH_ATTENTION_EPOCHS)],
             (GRAPH_K,), GRAPH_K)]
        for tag, argv, ks, window in cases:
            runs = {k: graph_cli_run(workdir, tag, base + argv, k)
                    for k in (1,) + ks}
            one = runs[1]
            entry = {"steps": one["summary"]["steps"]}
            for k in ks:
                scanned = runs[k]
                entry[f"equal_k{k}"] = states_equal(
                    one["slot"], scanned["slot"], f"{tag} K = {k}")
                check(one["summary"]["steps"] == scanned["summary"]["steps"],
                      f"{tag}: step counts differ")
                check(one["csv"] == scanned["csv"],
                      f"{tag}: the logged rows differ:\n{one['csv']}\n"
                      f"{scanned['csv']}")
                check(one["launches"] == scanned["launches"],
                      f"{tag}: launch counts differ {one['launches']} "
                      f"{scanned['launches']}")
                check(scanned["graph"] is not None
                      and scanned["graph"]["replays"] >= 1,
                      f"{tag}: no chunk replayed a graph at K = {k}")
            if "ssim" in tag:
                check(one["launches"]["ssim_scalar"] > 0,
                      f"{tag}: ssim_scalar was not launched")
            for k, run in runs.items():
                entry[f"k{k}"] = {
                    **window_figures(run["calls"], window),
                    "seconds": run["seconds"],
                    "peak_bytes": run["peak_bytes"],
                    "launches": run["launches"], "graph": run["graph"]}
                entry[f"k{k}"].update(chunk_profile(device, run,
                                                    max(k, GRAPH_K)))
            result[tag] = entry
            del runs, one, scanned
            gc.collect()
            torch.cuda.empty_cache()

        # ---- Palette at the CLI defaults, bf16-mixed, batch 4 -----------
        apply_precision_policy("bf16-mixed")
        h = dict(TRAIN_DEFAULTS, model="palette", precision="bf16-mixed")
        rng = np.random.default_rng(12)
        batches = [tuple(torch.from_numpy(rng.uniform(
            -1, 1, (GRAPH_PALETTE_BATCH, SIZE, SIZE, 1)).astype(np.float32)
        ).to(device) for _ in range(2)) for _ in range(GRAPH_PALETTE_STEPS)]
        sides, kept = {}, None
        # K = 5 first: its state is kept on the card, its graph pool freed,
        # before the K = 1 side runs
        for k in (GRAPH_K, 1):
            gen = torch.Generator(device=device).manual_seed(5)
            unet = build_generator_from_hparams(h, SIZE, generator=gen,
                                                device=device)
            sched = make_schedule(h["schedule_type"], 2000, 1e-6, 0.01,
                                  device=device)
            step = steps_lib.make_palette_train_step(
                unet, sched, False, warmup_steps_per_epoch=3,
                generator=gen, seed=5)
            state = steps_lib.init_palette_state(unet, use_ema=True)
            scan = steps_lib.make_palette_train_scan(
                unet, sched, False, warmup_steps_per_epoch=3, generator=gen,
                seed=5)
            calls, restore = record_train_calls(steps_lib)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            try:
                i = 0
                while i < GRAPH_PALETTE_STEPS:
                    if k > 1:
                        head = batches[i:i + k - 1]
                        scan(state, [b[0] for b in head],
                             [b[1] for b in head])
                        i += k - 1
                    step(state, *batches[i])
                    i += 1
                torch.cuda.synchronize()
            finally:
                restore()
            side = {**window_figures(calls, GRAPH_K),
                    "launches": dict(kernels.launch_counts),
                    "peak_bytes": torch.cuda.max_memory_allocated()}
            if k > 1:
                side["graph"] = scan.graph.stats()
            flat = train_state_dict(state)
            if kept is None:
                kept = {key: v.detach().clone() for key, v in flat.items()}
            else:
                result["palette_bf16_equal"] = states_equal(
                    kept, flat, "palette bf16-mixed")
            check(state.step == GRAPH_PALETTE_STEPS, "palette step count")
            sides[f"k{k}"] = side
            # the UNet of the last side samples the chain below
            del state, step, scan, flat, calls
            if k > 1:
                del unet
            gc.collect()
            torch.cuda.empty_cache()
        del kept
        per_step = {k: {name: side["launches"][name] / GRAPH_PALETTE_STEPS
                        for name in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")}
                    for k, side in sides.items()}
        check(per_step["k1"] == per_step[f"k{GRAPH_K}"]
              and all(v > 0 for v in per_step["k1"].values()),
              f"palette flash launches per step: {per_step}")
        result["palette_bf16"] = {"flash_launches_per_step": per_step["k1"],
                                  **sides}

        # ---- the chain, graph against the eager loop -------------------
        unet.eval()
        x = torch.from_numpy(np.random.default_rng(13).uniform(
            -1, 1, (GRAPH_CHAIN_BATCH, SIZE, SIZE, 1)).astype(np.float32)
        ).to(device)
        predict = palette_predictor(unet, False, True, device)
        sched_inf = make_schedule("cosine", 100, device=device)
        chain = {}
        for run in ("graph", "graph_again", "eager"):
            gen = torch.Generator(device=device).manual_seed(0)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            with torch.inference_mode():
                if run == "eager":
                    y_0, frames = sampler.ddpm_loop(
                        sched_inf, unet, x, gen, False,
                        capture_every=sched_inf.timesteps // 7)
                else:
                    y_0, frames = predict(x, gen)
            torch.cuda.synchronize()
            chain[run] = {"seconds": time.perf_counter() - start,
                          "launches": dict(kernels.launch_counts),
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "y_0": y_0, "frames": frames,
                          "offset": gen.get_offset()}
            if run != "eager":
                entry = sampler.chain_graphs[unet][1]
                chain[run]["graph"] = entry.graph.stats()
                chain[run]["graph_object"] = id(entry)
        # the recording call runs one warm-up UNet evaluation before it
        # records: its launches ran and are counted
        recording = dict(chain["eager"]["launches"])
        recording["flash_fwd"] += FLASH_LAUNCHES_PER_FORWARD
        for run, want in (("graph", recording),
                          ("graph_again", chain["eager"]["launches"])):
            check(torch.equal(chain[run]["y_0"], chain["eager"]["y_0"])
                  and torch.equal(chain[run]["frames"],
                                  chain["eager"]["frames"]),
                  f"the chain's graph ({run}) differs from the eager loop")
            check(chain[run]["launches"] == want,
                  f"chain launches ({run}): {chain[run]['launches']} "
                  f"against {want}")
            check(chain[run]["offset"] == chain["eager"]["offset"],
                  "the chain's graph left the generator elsewhere")
        check(chain["graph"]["graph_object"]
              == chain["graph_again"]["graph_object"]
              and chain["graph_again"]["graph"]["replays"] == 2,
              "the second chain call recorded the graph again")
        check(chain["eager"]["launches"]["flash_fwd"] > 0,
              "the chain launched no flash_fwd")
        result["chain_bf16"] = {
            "batch": GRAPH_CHAIN_BATCH, "bit_equal": True,
            **{run: {key: value for key, value in entry.items()
                     if key not in ("y_0", "frames", "graph_object")}
               for run, entry in chain.items()}}
        del chain, predict, unet
        sampler.chain_graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        apply_precision_policy("32")

        result.update(graph_flash_launches(device))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit(result)
    return result


def read_csv_steps(path):
    """The ``step`` column of a metrics CSV."""
    with open(path) as f:
        lines = f.read().splitlines()
    column = lines[0].split(",").index("step")
    return [int(float(line.split(",")[column])) for line in lines[1:]]


def kernels_line(cases, report_batch, launches, flash_cases,
                 palette_launches, bwd_cases, train_launches, gan_launches,
                 family_launches, family_report_launches,
                 interop_launches, parallel_launches, bf16_family_launches,
                 bf16_family_report_launches, graph_launches, split_cases):
    described = {
        "ssim_map": ("pai_tpu_torch/kernels/csrc/ssim.cu",
                     "pai_tpu/kernels/ssim_pallas.py:137"),
        "ssim_scalar": ("pai_tpu_torch/kernels/csrc/ssim.cu",
                        "pai_tpu/kernels/ssim_pallas.py:172")}
    out = []
    for name, (source, replaces) in described.items():
        # (8,256,256,1): the report batch; ssim_map as the report calls it
        # (ssim_report_fused: map, per-image SSIM and 16 bands)
        main = report_batch[0] if name == "ssim_map" else cases[name][0]
        errs = [e.get("max_abs_err_map", 0.0) for e in cases[name]] + \
            [e["max_abs_err_per_image"] for e in cases[name]]
        if name == "ssim_map":
            errs += [e[k] for e in report_batch for k in (
                "max_abs_err_map", "max_abs_err_per_image",
                "max_abs_err_bands")]
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
                for e in cases[name][name != "ssim_map":]]})
        if name == "ssim_map":
            out[-1]["launches_palette_path"] = palette_launches[name]
            out[-1]["launches_trans_unet_report_path"] = \
                family_report_launches[name]
            out[-1]["launches_interop_report_path"] = interop_launches[name]
            out[-1]["launches_bf16_family_report_paths"] = {
                tag: c[name] for tag, c in bf16_family_report_launches.items()}
        else:  # validation batches and log rows of GAN training
            out[-1]["launches_gan_training_path"] = gan_launches[name]
            out[-1]["launches_trans_unet_training_path"] = \
                family_launches[name]
            out[-1]["launches_bf16_family_training_paths"] = {
                tag: c[name] for tag, c in bf16_family_launches.items()}
            # attention U-Net ssim, bf16-mixed, --scan-steps 5: 10 steps
            out[-1]["launches_graph_training_path"] = graph_launches[name]
    main = flash_cases[0]  # (2,4,16384,64): the longer of the Palette path's
    out.append({
        "name": "flash_fwd", "route": "cuda",
        "source": "pai_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "pai_tpu/kernels/flash_attention.py:148",
        "launches": palette_launches["flash_fwd"],
        "max_abs_err": max(e["max_abs_err"] for e in flash_cases
                           if e["dtype"] == "float32" and e["peak"] == 1.0),
        "max_abs_err_bfloat16": max(e["max_abs_err"] for e in flash_cases
                                    if e["dtype"] == "bfloat16"
                                    and e["peak"] == 1.0),
        "max_abs_err_peaked": max(e["max_abs_err"] for e in flash_cases
                                  if e["dtype"] == "float32"
                                  and e["peak"] != 1.0),
        "arith_route": main["arith_route"],
        "shape": main["shape"], "dtype": main["dtype"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "bound_ms_cuda_cores": main["bound_ms_cuda_cores"],
        "library_ms": main["library_ms"],
        "kernel_us": main["kernel_us"], "tflops": main["tflops"],
        "other_shapes": flash_cases[1:]})
    out[-1]["launches_training_path"] = train_launches["flash_fwd"]
    out[-1]["launches_ring_path"] = parallel_launches["ring"]["flash_fwd"]
    out[-1]["launches_sp2_palette_path"] = \
        parallel_launches["palette_sp2"]["flash_fwd"]
    # bf16-mixed Palette, --scan-steps 5: 10 steps; one chain as a graph
    out[-1]["launches_graph_training_path"] = graph_launches["flash_fwd"]
    out[-1]["launches_graph_chain"] = graph_launches["flash_fwd_chain"]
    main = bwd_cases[0]  # (4,4,16384,64): the longer of the training path's
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        out.append({
            "name": name, "route": "cuda",
            "source": "pai_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "pai_tpu/kernels/flash_attention.py:"
                        + ("290" if name == "flash_bwd_dq" else "316"),
            "launches": train_launches[name],
            "max_abs_err": max(e[f"{g}_max_abs_err"] for e in bwd_cases
                               if e["dtype"] == "float32"
                               and e["peak"] == 1.0
                               for g in ("dq", "dk", "dv")),
            "max_abs_err_bfloat16": max(
                e[f"{g}_max_abs_err"] for e in bwd_cases
                if e["dtype"] == "bfloat16" and e["peak"] == 1.0
                for g in ("dq", "dk", "dv")),
            "max_abs_err_peaked": max(
                e[f"{g}_max_abs_err"] for e in bwd_cases
                if e["dtype"] == "float32" and e["peak"] != 1.0
                for g in ("dq", "dk", "dv")),
            "arith_route": main[name]["arith_route"],
            "shape": main["shape"], "dtype": main["dtype"],
            "ms": main[name]["ms"],
            # the plain version and the library call compute dq, dk and dv
            # together: their times are those of the whole backward
            "plain_ms": main["plain_ms"], "bound_ms": main[name]["bound_ms"],
            "bound_by": main[name]["bound_by"],
            "bound_ms_cuda_cores": main[name].get("bound_ms_cuda_cores"),
            "library_ms": main["library_ms"],
            "kernel_us": main[name]["kernel_us"],
            "backward_ms": main["backward_ms"],
            "other_shapes": [
                {"shape": e["shape"], "dtype": e["dtype"], **e[name],
                 "plain_ms": e.get("plain_ms"),
                 "library_ms": e.get("library_ms")}
                for e in bwd_cases[1:]]})
        out[-1]["launches_ring_path"] = parallel_launches["ring"][name]
        out[-1]["launches_sp2_palette_path"] = \
            parallel_launches["palette_sp2"][name]
        out[-1]["launches_graph_training_path"] = graph_launches[name]
    main = split_cases[0]  # the forward's operands at (2,4,16384,64)
    out.append({
        "name": "flash_split", "route": "cuda",
        "source": "pai_tpu_torch/kernels/csrc/flash_split.cu",
        "replaces": "none: the port's own split of float32 operands into "
                    "TF32 hi and lo planes for the wgmma kernels that "
                    "replace pai_tpu/kernels/flash_attention.py:148, :290 "
                    "and :316",
        "launches": palette_launches["flash_split"],
        "max_abs_err": max(e["max_abs_err"] for e in split_cases),
        "shape": main["shape"], "for": main["for"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call writes these planes
        "kernel_us": main["kernel_us"],
        "launches_training_path": train_launches["flash_split"],
        "other_shapes": split_cases[1:]})
    return {"kernels": out}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1

    from pai_tpu_torch import kernels, native
    from pai_tpu_torch.config import apply_precision_policy

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    flags = apply_precision_policy("32")
    seconds = {}
    start = time.perf_counter()
    kernels.load_library("ssim")  # builds every source, in parallel
    native.load_library()  # the PNG codec, with the host's C++ compiler
    tmp = tempfile.gettempdir()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "precision": "32", **flags,
          "kernel_build_seconds": kernels.build_seconds,
          "codec_build_seconds": native.build_seconds,
          "tmpdir": tmp, "tmpdir_free_bytes": shutil.disk_usage(tmp).free})
    seconds["device"] = time.perf_counter() - start

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - start
        return out

    build, routes = timed("build", phase_build)
    emit(build)
    cases, report_batch = timed("kernels", phase_kernels, device)
    flash_cases = timed("flash", phase_flash, device, routes)
    split_cases = timed("flash_split", phase_split, device)
    bwd_cases = timed("flash_backward", phase_flash_backward, device, routes)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_") as workdir:
        launches = timed("report", phase_report, device, workdir)
        palette_launches = timed("palette", phase_palette, device, workdir)
    timed("gradcheck", phase_gradcheck, device)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_train_") as workdir:
        train_launches = timed("train", phase_train, device, workdir)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_bf16_") as workdir:
        timed("bf16", phase_bf16, device, workdir)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_gan_") as workdir:
        gan_launches = timed("gan", phase_gan, device, workdir)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_families_") as workdir:
        family_launches, family_report_launches = timed(
            "families", phase_families, device, workdir)
    with tempfile.TemporaryDirectory(
            prefix="pai_smoke_families_bf16_") as workdir:
        bf16_family_launches, bf16_family_report_launches = timed(
            "families_bf16", phase_families_bf16, device, workdir)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_interop_") as workdir:
        interop_launches = timed("interop", phase_interop, device, workdir)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_parallel_") as workdir:
        parallel_launches = timed("parallel", phase_parallel, device,
                                  workdir)
    with tempfile.TemporaryDirectory(prefix="pai_smoke_graphs_") as workdir:
        graphs = timed("graphs", phase_graphs, device, workdir)
    graph_launches = {
        "ssim_scalar": graphs["attention_ssim_bf16"][f"k{GRAPH_K}"][
            "launches"]["ssim_scalar"],
        **{name: graphs["palette_bf16"][f"k{GRAPH_K}"]["launches"][name]
           for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}}
    graph_launches["flash_fwd_chain"] = \
        graphs["chain_bf16"]["graph_again"]["launches"]["flash_fwd"]
    for name in ("ssim_map", "ssim_scalar"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the Pix2Pix path")
    for name in ("flash_fwd", "flash_split", "ssim_map"):
        check(palette_launches[name] > 0,
              f"kernel {name} was not launched on the Palette path")
    check(train_launches["flash_split"] > 0,
          "kernel flash_split was not launched on the training path")
    check(gan_launches["ssim_scalar"] > 0,
          "kernel ssim_scalar was not launched on the GAN training path")
    check(family_launches["ssim_scalar"] > 0,
          "kernel ssim_scalar was not launched on the TransUNet training "
          "path")
    check(family_report_launches["ssim_map"] > 0,
          "kernel ssim_map was not launched on the TransUNet report path")
    check(interop_launches["ssim_map"] > 0,
          "kernel ssim_map was not launched on the interop report path")
    for tag in bf16_family_launches:
        check(bf16_family_launches[tag]["ssim_scalar"] > 0,
              f"kernel ssim_scalar was not launched on the {tag} bf16-mixed "
              "training path")
        check(bf16_family_report_launches[tag]["ssim_map"] > 0,
              f"kernel ssim_map was not launched on the {tag} bf16-mixed "
              "report path")

    for name, count in graph_launches.items():
        check(count > 0, f"kernel {name} was not launched on a graph path")

    emit({"phase": "seconds", **seconds})
    emit(kernels_line(cases, report_batch, launches, flash_cases,
                      palette_launches, bwd_cases, train_launches,
                      gan_launches, family_launches, family_report_launches,
                      interop_launches, parallel_launches,
                      bf16_family_launches, bf16_family_report_launches,
                      graph_launches, split_cases))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:
        sys.exit(rank_job_main(sys.argv[2:]))
    try:
        sys.exit(main())
    except SmokeFailure as failure:
        print(f"chip_smoke FAILED: {failure}", file=sys.stderr)
        sys.exit(1)
