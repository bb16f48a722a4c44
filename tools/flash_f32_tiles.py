"""The float32 flash_fwd and flash_bwd_dkv on wgmma (D = 64 and 128) at
other tiles than the ones ``launch_for_d`` picks, timed beside this
checkout's on one card in one process.

    python3 tools/flash_f32_tiles.py [--variants fwd:64:64:4,dkv:64:64:1:1]

A variant ``fwd:D:BK:SLOTS`` is a copy of this checkout's ``csrc/`` with that
D's ``launch_wgmma_tf32<D, BK, SLOTS>`` rewritten in
``flash_attention.cu``'s ``launch_for_d``; ``dkv:D:BQ:S1:S2`` rewrites
``launch_dkv_wgmma_tf32<D, BQ, S1, S2>`` in ``flash_attention_bwd.cu``'s.
All are built at once with the port's nvcc flags. Prints one JSON line per
library: ptxas's registers and spills of every flash instantiation and
whether ptxas serialised a kernel's wgmmas (C7520). Then each variant is
launched through the port's own wrappers (the forward, or ``launch_dkv``
with its split pass) at the Palette paths' float32 shape of its D: its
output compared bit for bit with this checkout's kernel and with the plain
version, and timed by CUDA events (the median of 5 samples of 3 calls, as
``chip_smoke.py`` times it), in turns: this checkout, the variants, this
checkout again. Then the card's name and power limit. Needs one NVIDIA
GPU."""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {("fwd", 64): (2, 4, 16384, 64), ("fwd", 128): (2, 4, 4096, 128),
          ("dkv", 64): (4, 4, 16384, 64), ("dkv", 128): (4, 4, 4096, 128)}
SOURCE = {"fwd": "flash_attention.cu", "dkv": "flash_attention_bwd.cu"}
LIBRARY = {"fwd": "flash_attention", "dkv": "flash_attention_bwd"}
LAUNCH = {"fwd": "launch_wgmma_tf32", "dkv": "launch_dkv_wgmma_tf32"}
DEFAULT_VARIANTS = ("fwd:64:64:4,fwd:64:32:8,fwd:64:128:2,"
                    "dkv:64:32:1:1,dkv:64:64:1:1,dkv:64:16:3:3")


def ptxas(log):
    """{instantiation: ptxas's resource line} of the flash kernels in a
    build log, and the instantiations whose wgmmas ptxas serialised."""
    out, name, serialised = {}, None, []
    for line in log.splitlines():
        m = re.search(r"serialized .* in the function '(\S+)'", line)
        if m:
            serialised.append(m.group(1))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "flash_" in m.group(1) else None
            continue
        if name and ("registers" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1]
                         ).strip()
    return {"ptxas": out, "wgmma_serialised": serialised}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", default=DEFAULT_VARIANTS)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_f32_tiles: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    csrc_dir = os.path.join(ROOT, "pai_tpu_torch", "kernels", "csrc")
    variants = {}
    for spec in args.variants.split(","):
        kind, d, *tiles = spec.split(":")
        with open(os.path.join(csrc_dir, SOURCE[kind])) as f:
            own = f.read()
        pattern = rf"{LAUNCH[kind]}<{d}(, \d+)+>"
        if len(re.findall(pattern, own)) != 1:
            raise SystemExit(f"no single {kind} launch at D = {d}")
        variants[spec.replace(":", "_")] = (kind, int(d), re.sub(
            pattern, f"{LAUNCH[kind]}<{d}, {', '.join(tiles)}>", own))

    fa._library()
    fa._backward_library()
    fa._split_library()
    own = {kind: kernels._libraries[LIBRARY[kind]] for kind in LIBRARY}
    for kind in LIBRARY:
        print(json.dumps({"library": f"own {kind}",
                          **ptxas(kernels.build_log(LIBRARY[kind]))}),
              flush=True)
    libs = {}
    with tempfile.TemporaryDirectory(prefix="pai_f32_tiles_") as workdir:
        jobs = {}
        for tag, (kind, _, source) in variants.items():
            csrc = os.path.join(workdir, tag)
            shutil.copytree(csrc_dir, csrc)
            with open(os.path.join(csrc, SOURCE[kind]), "w") as f:
                f.write(source)
            out = os.path.join(csrc, "lib.so")
            jobs[tag] = (out, subprocess.Popen(
                [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", out,
                 os.path.join(csrc, SOURCE[kind])], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for tag, (path, proc) in jobs.items():
            _, log = proc.communicate()
            if proc.returncode != 0:
                print(json.dumps({"library": tag, "nvcc_failed": log[-3000:]}),
                      flush=True)
                continue
            kind = variants[tag][0]
            kernels._libraries[LIBRARY[kind]] = ctypes.CDLL(path)
            libs[tag] = (fa._library() if kind == "fwd"
                         else fa._backward_library())
            kernels._libraries[LIBRARY[kind]] = own[kind]
            print(json.dumps({"library": tag, **ptxas(log)}), flush=True)

        for (kind, d), shape in SHAPES.items():
            tags = [t for t in libs if variants[t][:2] == (kind, d)]
            if not tags:
                continue
            q, k, v = chip_smoke.random_qkv(shape, 600 + d, "cuda")
            do = chip_smoke.random_qkv(shape, 700 + d, "cuda")[0]
            row = {"kind": kind, "shape": list(shape)}
            if kind == "fwd":
                want = fa.flash_attention_plain(q, k, v)
                ref = fa.flash_attention(q, k, v)

                def run(lib):
                    kernels._libraries["flash_attention"] = lib
                    return fa.flash_attention(q, k, v)
            else:
                o, lse = fa.flash_attention(q, k, v, emit_lse=True)
                want = fa.flash_attention_backward_plain(q, k, v, o, lse,
                                                         do)[1]
                call = fa.prepare_backward(q, k, v, o, lse, do)
                fa.launch_dkv(call)
                ref = call.dk.clone()

                def run(lib):
                    mine = call._replace(lib=lib)
                    fa.launch_dkv(mine)
                    return mine.dk
            for tag in ["own", *tags, "own_again"]:
                lib = own[kind] if tag.startswith("own") else libs[tag]
                got = run(lib).clone()
                torch.cuda.synchronize()
                row[tag] = {
                    "ms": chip_smoke.time_ms(lambda: run(lib), samples=5,
                                             calls=3),
                    "bit_equal_own": bool(torch.equal(got, ref)),
                    "max_abs_err": float((got - want).abs().max())}
            kernels._libraries["flash_attention"] = own["fwd"]
            print(json.dumps(row), flush=True)
            del q, k, v, do, want, ref
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
