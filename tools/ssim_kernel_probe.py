"""SSIM per report batch and per scalar call, device and wrapper time, for the
``pai_tpu_torch`` of one checkout: what a report batch asks of SSIM (the
map, the per-image SSIM and the 16 depth bands) and what a validation batch
asks (the per-image SSIM alone), at (8, 256, 256, 1).

    python3 tools/ssim_kernel_probe.py [--tree DIR] [--label NAME]

``--tree`` imports ``pai_tpu_torch`` from another checkout (an unpacked
``git archive`` of an earlier commit), so two versions can be compared in one
call on one card, in turns. Before timing, the card is kept busy for a second
so that its clocks have risen. Per entry: the CUDA-event time of one call
(median of 25 samples of 20 calls) and the profiler's device time per call,
summed over every kernel the call launches, with the per-kernel split. Needs
one NVIDIA GPU; builds the kernels of the tree it imports. Prints one JSON
line, then the card's name and power limit."""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def event_ms(fn, samples=25, calls=20):
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


def device_us(fn, calls=50):
    """{kernel name: device µs per call} of every kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        us = float(getattr(event, "self_device_time_total", 0.0))
        if us > 0:
            out[event.key[:90]] = us / calls
    return out


def warm_clocks(seconds=1.0):
    a = torch.randn(4096, 4096, device="cuda")
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def sm_clock():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="this")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    from pai_tpu_torch.utils import metrics

    rng = np.random.default_rng(0)
    shape = (8, 256, 256, 1)
    p = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).cuda()
    t = torch.from_numpy(np.clip(0.6 * p.cpu().numpy() + 0.4 * rng.uniform(
        0, 1, shape), 0, 1).astype(np.float32)).cuda()
    if hasattr(metrics, "ssim_report"):  # one launch for everything
        def report():
            return metrics.ssim_report(p, t)
    else:                                # the whole image, then 16 bands
        def report():
            return metrics.ssim_parts(p, t), metrics.depth_ssim_per_image(p, t)

    def scalar():
        return metrics.ssim_per_image(p, t)

    out = {"label": args.label, "tree": os.path.abspath(args.tree),
           "shape": list(shape)}
    with torch.inference_mode():
        for name, fn in (("report_batch", report), ("scalar", scalar)):
            warm_clocks()
            kernels = device_us(fn)
            out[name] = {"ms": event_ms(fn), "sm_clock": sm_clock(),
                         "device_us": sum(kernels.values()),
                         "kernels_us": kernels}
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
