"""The ``--tp 2`` Pix2Pix GAN comparison of ``chip_smoke.py``'s parallel
phase alone, repeated: two ranks on the one card over gloo against one
process, read by ``chip_smoke.adam_agreement`` after the first step, with
cuDNN's algorithms left free or set deterministic in both.

    python3 tools/tp2_agreement_probe.py [--tree DIR] [--repeat N]
        [--deterministic]

``--tree`` is another checkout (an unpacked ``git archive``) whose
``chip_smoke.py`` and ``pai_tpu_torch`` run instead of this one's. Prints one
JSON line per run (the held and float-noise parameter differences with
their bounds, Adam's moment errors, the losses), then the card's name and
power limit. Needs one NVIDIA GPU."""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--deterministic", action="store_true")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import torch
    from pai_tpu_torch import kernels
    from pai_tpu_torch.config import apply_precision_policy

    if not torch.cuda.is_available():
        print("tp2_agreement_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    apply_precision_policy("32")
    kernels.load_library("ssim")  # builds every source once
    for run in range(args.repeat):
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="pai_tp2_probe_") as wd:
            train = cs.write_pairs(os.path.join(wd, "par_train"),
                                   cs.PARALLEL_GAN_TRAIN, 42)

            def argv(root, extra):
                return ["smoke", "-d", train, "-m", "pix2pix", "--loss-type",
                        "gan", "--batch-size", str(cs.GAN_BATCH), "--epochs",
                        "1", "--val-epochs", "1", "--precision", "32",
                        "--device", "cuda", "--log-dir",
                        os.path.join(root, "logs"), "--ckpt-dir",
                        os.path.join(root, "ckpt"), *extra]

            root = os.path.join(wd, "tp2")
            results = cs.spawn_ranks(
                "cli", 2, wd, {"argvs": [argv(root, ["--tp", "2"])],
                               "reference": argv(root + "_one", []),
                               "deterministic": args.deterministic})
        ref = results[0]["reference"]
        print(json.dumps({
            "tree": tree, "run": run, "deterministic": args.deterministic,
            "held_param_diff": ref["held_param_diff"],
            "held_param_diff_at": ref["held_param_diff_at"],
            "held_param_bound": 1e-2 * cs.GAN_LR,
            "noise_param_diff": ref["noise_param_diff"],
            "noise_param_bound": 2 * cs.GAN_LR,
            "moment_rel_err": ref["moment_rel_err"],
            "losses": [s["loss"] for s in results[0]["runs"][0]["steps"]],
            "one_process_losses": [s["loss"] for s in ref["steps"]],
            "seconds": time.perf_counter() - start}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
