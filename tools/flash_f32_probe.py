"""float32 flash_fwd, flash_bwd_dq and flash_bwd_dkv at D = 64 and 128
(their wgmma routes, on the split pass's planes) on one card: ptxas's
report, agreement with the plain versions, and times beside another
checkout's.

    python3 tools/flash_f32_probe.py [--quick] [--tree DIR]

Prints one JSON line with ptxas's resource lines of the float32 wgmma
instantiations and the split pass (and any ptxas line that says wgmma was
serialised); then per case (the Palette paths' shapes, float32, and small
ones) the largest difference of o and lse (forward) or dq, dk and dv
(backward, from the plain forward's o and lse) from the plain version,
whether two launches are bit-equal, and whether the split pass's planes
equal its plain version's bit for bit. ``--quick`` stops there (a first
check of a build: small shapes only). Otherwise it times, by CUDA events
(the median of 5 samples of 3 calls, as ``chip_smoke.py`` times them), the
forward wrapper, the whole backward, ``launch_dq``, ``launch_dkv`` (a
checkout that splits in ``launch_dkv`` counts its split pass there; this
one splits once in ``prepare_backward``) and the split pass alone at the
Palette paths' float32 shapes; with ``--tree`` the same wrappers of
another checkout (an unpacked ``git archive`` of an earlier commit) in
processes of their own, in the order tree, this, this, tree. Then the
card's name and power limit. Needs one NVIDIA GPU."""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_SHAPES = ((2, 4, 16384, 64), (2, 4, 4096, 128))
BWD_SHAPES = ((4, 4, 16384, 64), (4, 4, 4096, 128))
SMALL = ((1, 1, 256, 64), (1, 2, 512, 128), (2, 2, 1024, 64))


def operands(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(np.float32)
                             ).cuda() for _ in range(n)]


def time_ms(fn, samples=5, calls=3):
    import statistics
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def backward_split(fa):
    """The split modes of a backward call (before one split per backward,
    dkv's alone)."""
    return getattr(fa, "BACKWARD_SPLIT", None) or fa.DKV_SPLIT


def timings(fa):
    """{what: ms} of the forward and backward wrappers (and the split pass,
    where this checkout has one) at the Palette paths' float32 shapes."""
    out = {}
    for shape in FWD_SHAPES:
        q, k, v = operands(shape, 1, 3)
        out[f"flash_fwd {shape}"] = time_ms(lambda: fa.flash_attention(q, k, v))
        if hasattr(fa, "flash_split"):
            out[f"flash_split fwd {shape}"] = time_ms(
                lambda: fa.flash_split((q, k, v), fa.FORWARD_SPLIT))
        del q, k, v
    for shape in BWD_SHAPES:
        q, k, v, do = operands(shape, 2)
        o, lse = fa.flash_attention(q, k, v, emit_lse=True)
        call = fa.prepare_backward(q, k, v, o, lse, do)
        out[f"flash_backward {shape}"] = time_ms(
            lambda: fa.flash_attention_backward(q, k, v, o, lse, do))
        out[f"flash_bwd_dq {shape}"] = time_ms(lambda: fa.launch_dq(call))
        out[f"flash_bwd_dkv {shape}"] = time_ms(lambda: fa.launch_dkv(call))
        if hasattr(fa, "flash_split"):
            out[f"flash_split backward {shape}"] = time_ms(
                lambda: fa.flash_split((q, k, v, do), backward_split(fa)))
        del q, k, v, do, o, lse, call
    torch.cuda.empty_cache()
    return out


def ptxas(kernels):
    """ptxas's lines of the float32 wgmma instantiations and the split pass,
    and every line that mentions wgmma serialisation."""
    out, warnings = {}, []
    for lib in ("flash_attention", "flash_attention_bwd", "flash_split"):
        name = None
        for line in kernels.build_log(lib).splitlines():
            if "wgmma" in line.lower() and "serializ" in line.lower():
                warnings.append(line.strip())
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                mangled = m.group(1)
                name = mangled if ("split" in mangled or (
                    "wgmma" in mangled and "IfLi" in mangled)) else None
                continue
            if name and ("registers" in line or "spill" in line):
                out[name] = (out.get(name, "") + " "
                             + line.split(":", 1)[-1]).strip()
    return {"ptxas": out, "wgmma_serialised": warnings}


def check_case(fa, shape, seed):
    q, k, v, do = operands(shape, seed)
    want_o, want_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
    o, lse = fa.flash_attention(q, k, v, emit_lse=True)
    o2, lse2 = fa.flash_attention(q, k, v, emit_lse=True)
    torch.cuda.synchronize()
    entry = {"shape": list(shape),
             "o_err": float((o - want_o).abs().max()),
             "lse_err": float((lse - want_lse).abs().max()),
             "fwd_bit_equal": bool(torch.equal(o, o2)
                                   and torch.equal(lse, lse2))}
    want = fa.flash_attention_backward_plain(q, k, v, want_o, want_lse, do)
    got = fa.flash_attention_backward(q, k, v, want_o, want_lse, do)
    again = fa.flash_attention_backward(q, k, v, want_o, want_lse, do)
    torch.cuda.synchronize()
    for tag, g, w in zip(("dq", "dk", "dv"), got, want):
        entry[f"{tag}_rel_err"] = float((g - w).abs().max() / w.abs().max())
    entry["backward_bit_equal"] = all(torch.equal(a, b)
                                      for a, b in zip(got, again))
    for tag, xs, modes in (("fwd", (q, k, v), fa.FORWARD_SPLIT),
                           ("backward", (q, k, v, do), backward_split(fa))):
        entry[f"split_{tag}_bit_equal"] = bool(torch.equal(
            fa.flash_split(xs, modes), fa.flash_split_plain(xs, modes)))
    return entry


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--tree", default=None)
    parser.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    parser.add_argument("--time-only", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa
    if args.time_only:
        print(json.dumps(timings(fa)), flush=True)
        return 0
    kernels.load_library("flash_split")
    print(json.dumps({"build_seconds": kernels.build_seconds,
                      **ptxas(kernels)}), flush=True)
    shapes = SMALL if args.quick else SMALL + BWD_SHAPES
    for seed, shape in enumerate(shapes):
        print(json.dumps(check_case(fa, shape, 10 + seed)), flush=True)
        torch.cuda.empty_cache()
    if not args.quick:
        runs = []
        order = ["tree", "this", "this", "tree"] if args.tree else ["this"]
        for which in order:
            if which == "this":
                runs.append({"tree": which, **timings(fa)})
                continue
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time-only",
                 "--root", os.path.abspath(args.tree)],
                check=True, capture_output=True, text=True, timeout=900)
            runs.append({"tree": which,
                         **json.loads(out.stdout.strip().splitlines()[-1])})
        for run in runs:
            print(json.dumps(run), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
