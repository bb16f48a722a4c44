"""flash_bwd_dq in bfloat16 at D = 64 and 128 (the wgmma route) at other
tiles than the ones ``launch_for_d`` picks, and another checkout's kernel
beside this one's, timed on one card in one process.

    python3 tools/flash_dq_tiles.py [--variants 64:64:4,128:64:4] [--tree DIR]

Each variant ``D:BK:STAGES`` is a copy of this checkout's ``csrc/`` with that
D's ``launch_dq_wgmma<D, BK, STAGES>`` rewritten in ``launch_for_d``;
``--tree`` adds the ``flash_attention_bwd.cu`` of another checkout (an
unpacked ``git archive`` of an earlier commit) as it is. All are built at
once with the port's nvcc flags, then each is launched through the port's
own ``launch_dq`` at the bf16-mixed Palette path's shapes and at
(2,4,4096,64): its dq is compared bit for bit with this checkout's kernel
and in bf16 units with the plain version, and timed by CUDA events (the
median of 5 samples of 3 calls, as ``chip_smoke.py`` times it), in turns:
this checkout, the variants, this checkout again. Prints one JSON line per
library (ptxas's registers and spills of its dq instantiations) and per
shape, then the card's name and power limit. Needs one NVIDIA GPU."""

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
SHAPES = ((4, 4, 16384, 64), (4, 4, 4096, 128), (2, 4, 4096, 64))
DEFAULT_VARIANTS = "64:64:3,64:64:4,64:128:2,128:64:4,128:128:2"


def ptxas_dq(log):
    """{instantiation: ptxas's resource line} of the dq kernels in a build
    log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "flash_bwd_dq" in m.group(1) else None
            continue
        if name and ("registers" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1]
                         ).strip()
    return out


def make_variant(workdir, tag, source):
    """A csrc/ copy under workdir/tag with flash_attention_bwd.cu replaced
    by `source` (text); returns its directory."""
    csrc = os.path.join(workdir, tag)
    shutil.copytree(os.path.join(ROOT, "pai_tpu_torch", "kernels", "csrc"),
                    csrc)
    with open(os.path.join(csrc, "flash_attention_bwd.cu"), "w") as f:
        f.write(source)
    return csrc


def build(csrc, nvcc, flags):
    out = os.path.join(csrc, "libdq.so")
    cmd = [nvcc, *flags, "-o", out,
           os.path.join(csrc, "flash_attention_bwd.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", default=DEFAULT_VARIANTS)
    parser.add_argument("--tree", default=None)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pai_tpu_torch import kernels
    from pai_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_dq_tiles: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    with open(os.path.join(ROOT, "pai_tpu_torch", "kernels", "csrc",
                           "flash_attention_bwd.cu")) as f:
        own = f.read()
    sources = {}
    for spec in args.variants.split(","):
        d, bk, stages = (int(x) for x in spec.split(":"))
        pattern = rf"launch_dq_wgmma<{d}, \d+, \d+>"
        if len(re.findall(pattern, own)) != 1:
            raise SystemExit(f"no single dq launch at D = {d} to rewrite")
        sources[f"D{d}_BK{bk}_S{stages}"] = re.sub(
            pattern, f"launch_dq_wgmma<{d}, {bk}, {stages}>", own)
    if args.tree:
        with open(os.path.join(args.tree, "pai_tpu_torch", "kernels", "csrc",
                               "flash_attention_bwd.cu")) as f:
            sources["tree"] = f.read()

    fa._backward_library()  # this checkout's libraries, built as usual
    own_lib = kernels._libraries["flash_attention_bwd"]
    libs = {"own": (own_lib, kernels.build_log("flash_attention_bwd"))}
    with tempfile.TemporaryDirectory(prefix="pai_dq_tiles_") as workdir:
        if args.tree:  # the tree's own headers with its source
            tree_csrc = os.path.join(workdir, "tree")
            shutil.copytree(os.path.join(args.tree, "pai_tpu_torch",
                                         "kernels", "csrc"), tree_csrc)
        jobs = {}
        for tag, source in sources.items():
            csrc = (tree_csrc if tag == "tree"
                    else make_variant(workdir, tag, source))
            jobs[tag] = build(csrc, kernels.find_nvcc(), kernels.NVCC_FLAGS)
        for tag, (path, proc) in jobs.items():
            _, log = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{tag}: nvcc failed\n{log}")
            kernels._libraries["flash_attention_bwd"] = ctypes.CDLL(path)
            libs[tag] = (fa._backward_library(), log)
        kernels._libraries["flash_attention_bwd"] = own_lib
        for tag, (_, log) in libs.items():
            print(json.dumps({"library": tag, "ptxas": ptxas_dq(log)}),
                  flush=True)

        order = ["own", *sources, "own_again"]
        for seed, shape in enumerate(SHAPES):
            q, k, v = chip_smoke.random_qkv(shape, 400 + seed, "cuda",
                                            torch.bfloat16)
            do = chip_smoke.random_qkv(shape, 500 + seed, "cuda",
                                       torch.bfloat16)[0]
            o, lse = fa.flash_attention(q, k, v, emit_lse=True)
            want = fa.flash_attention_backward_plain(q, k, v, o, lse, do)[0]
            call = fa.prepare_backward(q, k, v, o, lse, do)
            fa.launch_dq(call)
            torch.cuda.synchronize()
            ref = call.dq.clone()
            row = {"shape": list(shape), "dtype": "bfloat16",
                   "bound_ms": chip_smoke.flash_bwd_bounds(
                       shape, torch.bfloat16)["flash_bwd_dq"]["bound_ms"]}
            for tag in order:
                lib = libs["own" if tag == "own_again" else tag][0]
                mine = call._replace(lib=lib)
                mine.dq.zero_()
                fa.launch_dq(mine)
                torch.cuda.synchronize()
                row[tag] = {
                    "ms": chip_smoke.time_ms(lambda: fa.launch_dq(mine),
                                             samples=5, calls=3),
                    "bit_equal_own": bool(torch.equal(mine.dq, ref)),
                    "bf16_ulps": chip_smoke.bf16_ulps(mine.dq, want)}
            print(json.dumps(row), flush=True)
            del q, k, v, do, o, lse, want, call, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
