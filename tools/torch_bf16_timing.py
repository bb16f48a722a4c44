"""The bf16-mixed Palette forward (batch 2) and training step (batch 4) at
the CLI-default width, timed by the ``bf16`` phase of the ``chip_smoke.py`` of
one checkout, with that checkout's ``pai_tpu_torch``.

    python3 tools/torch_bf16_timing.py [--tree DIR]

``--tree`` is another checkout (an unpacked ``git archive`` of an earlier
commit holding ``chip_smoke.py`` and ``pai_tpu_torch/``), so two versions can
be timed in one call on one card, in turns. Needs one NVIDIA GPU. Prints one
JSON line (``unet_forward_ms_batch_2``, ``step_ms_batch_4``, device busy
times; a checkout without ``bf16_path`` prints its whole ``bf16`` phase),
then the card's name and power limit."""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(parser.parse_args().tree)
    sys.path.insert(0, tree)
    import chip_smoke
    from pai_tpu_torch.config import apply_precision_policy

    print(f"tree {tree}", flush=True)
    apply_precision_policy("32")
    with tempfile.TemporaryDirectory(prefix="pai_bf16_timing_") as workdir:
        if hasattr(chip_smoke, "bf16_path"):  # the timed part alone
            print(json.dumps(chip_smoke.bf16_path(torch.device("cuda", 0),
                                                  workdir)), flush=True)
        else:  # a checkout from before bf16_path: the whole phase
            chip_smoke.phase_bf16(torch.device("cuda", 0), workdir)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
