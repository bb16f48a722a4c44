"""The small card-vs-CPU ``gan`` step of ``chip_smoke.py``'s ``families``
phase, per family, at three shares of a tensor's largest gradient from
which its parameters are held to ``GAN_CARD_CPU_TOL`` (1e-3, 5e-2 and the
residual families' 0.2): prints each reading, or the failure it gives,
with the gradients' largest and L2 differences card vs CPU. The reading
that set ``chip_smoke.RES_LARGE_GRADIENT``.

    python3 tools/torch_families_card_probe.py    # on a host with one GPU
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pai_tpu_torch.config import apply_precision_policy  # noqa: E402

KEYS = ("max_rel_err", "worst_tensor", "gradient_max_rel_err",
        "gradient_worst_tensor", "gradient_l2_rel_err")


def main():
    if not torch.cuda.is_available():
        print("needs one NVIDIA GPU", file=sys.stderr)
        return 1
    apply_precision_policy("32")
    print(cs.nvidia_smi_line(), flush=True)
    device = torch.device("cuda", 0)
    for family in cs.FAMILY_PARAMETERS:
        for large in (1e-3, 5e-2, cs.RES_LARGE_GRADIENT):
            try:
                out = cs.gan_card_vs_cpu(device, family, ("gan",),
                                         large)["gan"]
                print(family, large, json.dumps({k: out[k] for k in KEYS}),
                      flush=True)
            except cs.SmokeFailure as failure:
                print(family, large, "FAILED", failure, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
