"""Evaluation checkpoints of the port, counterpart of the slot layout of
``pai_tpu/utils/checkpoint.py``.

Layout: ``<root>/<name>/best/`` and ``<root>/<name>/last/``, each a slot
directory holding

* ``state.pt`` — ``torch.save`` of a plain flat ``state_dict`` (name ->
  tensor): the generator's tensors under their own names and, where a run
  kept an exponential moving average, its shadow weights under ``ema.<name>``;
* ``meta.json`` — ``hparams`` (the model is rebuilt from these alone),
  ``step``, ``epoch`` and ``monitor_value``. JSON where the JAX package
  writes YAML, because ``yaml`` need not be installed beside the card.

Same slot and meta semantics as the Orbax layout. The training-time
``CheckpointManager`` (best-val-SSIM selection, resume) arrives with the
training slice.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping, Optional, Tuple

import torch

from pai_tpu_torch.config import sanitize_hparams

EMA_PREFIX = "ema."


def save_eval_checkpoint(root: str, name: str, state_dict: Mapping,
                         hparams: Mapping, slot: str = "best", step: int = 0,
                         epoch: int = 0,
                         monitor_value: Optional[float] = None,
                         ema_state_dict: Optional[Mapping] = None) -> str:
    """Write ``<root>/<name>/<slot>/{state.pt, meta.json}`` and return the
    slot path. The slot is written beside itself and renamed into place, so a
    reader never sees half a checkpoint."""
    slot_dir = os.path.abspath(os.path.join(root, name, slot))
    tmp = slot_dir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: v.detach().cpu() for k, v in state_dict.items()}
    if ema_state_dict is not None:
        flat.update({EMA_PREFIX + k: v.detach().cpu()
                     for k, v in ema_state_dict.items()})
    torch.save(flat, os.path.join(tmp, "state.pt"))
    meta = {
        "hparams": sanitize_hparams(dict(hparams)),
        "step": int(step), "epoch": int(epoch),
        "monitor_value": None if monitor_value is None
        else float(monitor_value),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    if os.path.exists(slot_dir):
        shutil.rmtree(slot_dir)
    os.rename(tmp, slot_dir)
    return slot_dir


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``(state_dict, meta)`` from an explicit slot path (``.../best`` or
    ``.../last``); tensors arrive on the CPU."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state_dict = torch.load(os.path.join(path, "state.pt"),
                            map_location="cpu", weights_only=True)
    return state_dict, meta
