"""The float32 flash_fwd, flash_bwd_dq and flash_bwd_dkv on wgmma (D = 64
and 128) at other tiles than the ones ``launch_for_d`` picks, timed beside
this checkout's on one card in one process.

    python3 tools/flash_f32_tiles.py [--variants fwd:64:64:4,dkv:64:64:1:1]

A variant ``fwd:D:BK:SLOTS`` is a copy of this checkout's ``csrc/`` with that
D's ``launch_wgmma_tf32<D, BK, SLOTS>`` rewritten in
``flash_attention.cu``'s ``launch_for_d``; ``dkv:D:BQ:S1:S2`` rewrites
``launch_dkv_wgmma_tf32<D, BQ, S1, S2>`` in ``flash_attention_bwd.cu``'s;
``dq:D:BK:SLOTS:WGS`` puts ``launch_dq_wgmma_tf32<D, BK, SLOTS, WGS>`` in
place of that D's float32 dq launch (whichever route it is), and
``dq:D:mma:BQ:BK`` puts the ``mma.sync`` kernel ``launch_dq<T, D, BQ, BK>``
there.
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
          ("dq", 64): (4, 4, 16384, 64), ("dq", 128): (4, 4, 4096, 128),
          ("dkv", 64): (4, 4, 16384, 64), ("dkv", 128): (4, 4, 4096, 128)}
SOURCE = {"fwd": "flash_attention.cu", "dq": "flash_attention_bwd.cu",
          "dkv": "flash_attention_bwd.cu"}
LIBRARY = {"fwd": "flash_attention", "dq": "flash_attention_bwd",
           "dkv": "flash_attention_bwd"}
LAUNCH = {"fwd": "launch_wgmma_tf32", "dkv": "launch_dkv_wgmma_tf32"}
DEFAULT_VARIANTS = "dq:64:32:6:2,dq:64:mma:128:64,dq:128:32:3:1"


def rewrite(kind, d, tiles, own):
    """``own`` (a source's text) with the float32 launch of `kind` at head
    dim `d` rewritten to the variant's tiles."""
    if kind == "dq":
        # the float32 dq launch at d: launch_dq_wgmma_tf32<d, ...>(p,
        # planes, batch, stream) or the mma.sync launch_dq<T, d, ...>
        pattern = (rf"launch_dq(?:_wgmma_tf32<{d}|<T, {d})(?:, \d+)+>"
                   r"\(p, (?:planes, )?batch,\s*stream\)")
        if tiles[0] == "mma":
            new = (f"launch_dq<T, {d}, {', '.join(tiles[1:])}>(p, batch, "
                   "stream)")
        else:
            new = (f"launch_dq_wgmma_tf32<{d}, {', '.join(tiles)}>(p, planes, "
                   "batch, stream)")
    else:
        pattern = rf"{LAUNCH[kind]}<{d}(, \d+)+>"
        new = f"{LAUNCH[kind]}<{d}, {', '.join(tiles)}>"
    if len(re.findall(pattern, own)) != 1:
        raise SystemExit(f"no single float32 {kind} launch at D = {d}")
    return re.sub(pattern, new, own)


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
        variants[spec.replace(":", "_")] = (kind, int(d),
                                            rewrite(kind, d, tiles, own))

    fa._library()
    fa._backward_library()
    fa._split_library()
    own = {kind: kernels._libraries[LIBRARY[kind]] for kind in LIBRARY}
    for lib in sorted(set(LIBRARY.values())):
        print(json.dumps({"library": f"own {lib}",
                          **ptxas(kernels.build_log(lib))}), flush=True)
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
                # dq, or dk of dkv, from the call's split planes (made once
                # by prepare_backward, as the backward makes them)
                o, lse = fa.flash_attention(q, k, v, emit_lse=True)
                want = fa.flash_attention_backward_plain(
                    q, k, v, o, lse, do)[0 if kind == "dq" else 1]
                call = fa.prepare_backward(q, k, v, o, lse, do)
                launch = fa.launch_dq if kind == "dq" else fa.launch_dkv

                def run(lib):
                    mine = call._replace(lib=lib)
                    launch(mine)
                    return mine.dq if kind == "dq" else mine.dk
                ref = run(own[kind]).clone()
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
