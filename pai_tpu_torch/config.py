"""Run configuration: a plain dict pinned to the reference CLI surface, the
dtype and precision policy of the port, and device resolution."""

from __future__ import annotations

from typing import Dict, Union

import torch

# Verbatim flag defaults of the train CLI (identical to pai_tpu.config).
TRAIN_DEFAULTS: Dict = {
    "data": None,
    "val_data": None,
    "epochs": 200,
    "steps": -1,
    "batch_size": 8,
    "val_epochs": 10,
    "precision": "32",
    "ema": False,
    "channel_mults": "1,2,4,8,8,8,8,8",
    "attention_res": "8,4,2",
    "dropout": 0.0,
    "loss_type": "gan",
    "schedule_type": "linear",
    "learn_variance": False,
    "model": "pix2pix",
    # rebuild extensions (not in the reference CLI)
    "seed": 0,
    "resume": False,
    "log_dir": "logs",
    "ckpt_dir": "checkpoints",
    "tp": 1,
    "sp": 1,
    "scan_steps": 1,
    "profile_dir": None,
    "warmup_unit": "epoch",
}

_SIXTEEN_BIT = ("16", "16-mixed", "bf16", "bf16-mixed", "bf16-true")


def parse_int_list(spec) -> tuple:
    """\"1,2,4,8\" -> (1, 2, 4, 8); a sequence of ints passes through."""
    if isinstance(spec, (list, tuple)):
        return tuple(int(x) for x in spec)
    return tuple(int(x) for x in str(spec).split(","))


def compute_dtype(precision: str) -> torch.dtype:
    """The reference ``--precision`` strings as a compute dtype: "32" ->
    float32; any 16-bit spec -> bfloat16 compute (autocast) with float32
    parameters and float32 BatchNorm."""
    if str(precision) in _SIXTEEN_BIT:
        return torch.bfloat16
    return torch.float32


def apply_precision_policy(precision: str) -> Dict[str, bool]:
    """The one place the port's matmul/convolution precision is set.

    On a CUDA device a float32 ``torch.matmul`` is full float32 by default but
    a float32 cuDNN convolution runs in TF32 by default. The port states and
    sets both switches from ``--precision``:

    * "32" -> both False: true float32, so the card reproduces what the CPU
      tests pin (TF32 keeps about three decimal digits);
    * a 16-bit spec -> both True: the convolutions run in bfloat16 under
      autocast anyway, and what stays float32 may use TF32.

    The SSIM kernels are float32 FMAs whatever this says. Returns the flags
    as set."""
    allow = compute_dtype(precision) != torch.float32
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    return {"matmul_allow_tf32": allow, "cudnn_allow_tf32": allow}


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; without
    one this raises instead of carrying on on the CPU — a caller that wants
    the CPU (the tests) passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"pai_tpu_torch was asked for device '{device}' but no CUDA "
            "device is available; pass device='cpu' explicitly to run the "
            "plain PyTorch versions on the CPU")
    return dev


def sanitize_hparams(hparams: Dict) -> Dict:
    """JSON-safe copy (paths -> str) for checkpoint persistence."""
    out = {}
    for k, v in hparams.items():
        if v is None or isinstance(v, (bool, int, float, str, list)):
            out[k] = v
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = str(v)
    return out
