"""Checkpoints of the port, counterpart of ``pai_tpu/utils/checkpoint.py``.

Layout: ``<root>/<name>/best/``, ``<root>/<name>/last/`` and (after a
non-finite loss) ``<root>/<name>/diverged/``, each a slot directory holding

* ``state.pt`` — ``torch.save`` of a plain flat ``state_dict`` (name ->
  tensor): the generator's tensors (parameters and BatchNorm running
  statistics) under their own names; in a GAN training slot the PatchGAN's
  under ``discriminator.<name>``; where a run kept an exponential moving
  average, its shadow weights under ``ema.<name>`` (both networks'); in a
  training slot also Adam's moments and step count under
  ``opt.<name>.<exp_avg|exp_avg_sq|step>`` (both chains);
* ``meta.json`` — ``hparams`` (the model is rebuilt from these alone),
  ``step``, ``epoch`` and ``monitor_value`` (and ``ema_num_updates`` in a
  training slot). JSON where the JAX package writes YAML, because ``yaml``
  need not be installed beside the card.

Same slot and meta semantics as the Orbax layout. An evaluation slot
(``save_eval_checkpoint``) and a training slot (``CheckpointManager``) load
alike through ``load_checkpoint``; ``restore.eval_state_dict`` leaves the
optimizer's and the discriminator's tensors out. ``CheckpointManager`` keeps
``best`` on the largest ``val_ssim``, ``last`` at every validation and at the
end of training, and ``diverged`` apart from ``last``, which ``--resume``
reads. A slot is written
beside itself and renamed into place, so a reader never sees half of one.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping, Optional, Tuple

import torch

from pai_tpu_torch.config import sanitize_hparams

EMA_PREFIX = "ema."
OPT_PREFIX = "opt."
DISCRIMINATOR_PREFIX = "discriminator."


def _write_slot(slot_dir: str, flat: Mapping[str, torch.Tensor],
                meta: Mapping) -> str:
    """``state.pt`` + ``meta.json`` into ``slot_dir`` through a temporary
    directory beside it, renamed into place. Tensors on the card are written
    from where they lie (``torch.save`` copies one storage at a time), so no
    host copy of the whole state is made."""
    tmp = slot_dir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(dict(flat), os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(dict(meta), f, indent=1, sort_keys=True)
    if os.path.exists(slot_dir):
        shutil.rmtree(slot_dir)
    os.rename(tmp, slot_dir)
    return slot_dir


def _meta(hparams: Mapping, step: int, epoch: int,
          monitor_value: Optional[float], **extra) -> Dict:
    return {"hparams": sanitize_hparams(dict(hparams)), "step": int(step),
            "epoch": int(epoch),
            "monitor_value": None if monitor_value is None
            else float(monitor_value), **extra}


def save_eval_checkpoint(root: str, name: str, state_dict: Mapping,
                         hparams: Mapping, slot: str = "best", step: int = 0,
                         epoch: int = 0,
                         monitor_value: Optional[float] = None,
                         ema_state_dict: Optional[Mapping] = None) -> str:
    """Write ``<root>/<name>/<slot>/{state.pt, meta.json}`` and return the
    slot path. The slot is written beside itself and renamed into place, so a
    reader never sees half a checkpoint."""
    slot_dir = os.path.abspath(os.path.join(root, name, slot))
    flat = {k: v.detach().cpu() for k, v in state_dict.items()}
    if ema_state_dict is not None:
        flat.update({EMA_PREFIX + k: v.detach().cpu()
                     for k, v in ema_state_dict.items()})
    return _write_slot(slot_dir, flat,
                       _meta(hparams, step, epoch, monitor_value))


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``(state_dict, meta)`` from an explicit slot path (``.../best`` or
    ``.../last``); tensors arrive on the CPU."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state_dict = torch.load(os.path.join(path, "state.pt"),
                            map_location="cpu", weights_only=True)
    return state_dict, meta


class CheckpointManager:
    """Best / last / diverged slots of one run under ``<root>/<name>/``. The
    state it saves is a flat ``state_dict`` (``train.loop.train_state_dict``)
    with the meta fields beside it.

    On a mesh every rank keeps a manager and calls its saves with the whole
    state (the caller gathers it: ``train.loop.full_train_state_dict``), so
    that every rank takes the same best-slot decisions; only the one made
    with ``writer=True`` (rank zero) writes. Every rank reads a slot to
    resume."""

    def __init__(self, root: str, name: str, writer: bool = True):
        self.dir = os.path.abspath(os.path.join(root, name))
        self.writer = writer
        if writer:
            os.makedirs(self.dir, exist_ok=True)
        self.best_value: Optional[float] = None
        best = self._read_meta("best")
        if best:
            self.best_value = best.get("monitor_value")

    def slot(self, which: str) -> str:
        return os.path.join(self.dir, which)

    def _read_meta(self, which: str) -> Optional[Dict]:
        path = os.path.join(self.slot(which), "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save(self, which: str, flat: Mapping[str, torch.Tensor],
             hparams: Mapping, step: int, epoch: int,
             monitor_value: Optional[float] = None, **extra) -> str:
        """Write slot ``which`` whatever it holds (the writer only); returns
        its path."""
        if not self.writer:
            return self.slot(which)
        return _write_slot(self.slot(which), flat, _meta(
            hparams, step, epoch, monitor_value, **extra))

    def save_last(self, flat: Mapping[str, torch.Tensor], hparams: Mapping,
                  step: int, epoch: int,
                  monitor_value: Optional[float] = None, **extra) -> str:
        return self.save("last", flat, hparams, step, epoch, monitor_value,
                         **extra)

    def save_diverged(self, flat: Mapping[str, torch.Tensor],
                      hparams: Mapping, step: int, epoch: int,
                      **extra) -> str:
        """Postmortem slot of a state whose loss went non-finite; kept apart
        from ``last`` (its weights are typically NaN), which ``--resume``
        recovers from."""
        return self.save("diverged", flat, hparams, step, epoch, **extra)

    def maybe_save_best(self, flat: Mapping[str, torch.Tensor],
                        hparams: Mapping, step: int, epoch: int,
                        monitor_value: float, **extra) -> bool:
        """Save to ``best`` iff ``monitor_value`` (val_ssim) improved."""
        if self.best_value is None or monitor_value > self.best_value:
            self.save("best", flat, hparams, step, epoch, monitor_value,
                      **extra)
            self.best_value = float(monitor_value)
            return True
        return False

    def restore(self, which: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """``(state_dict, meta)`` of a slot, tensors on the CPU; raises
        ``FileNotFoundError`` when the slot does not exist."""
        if self._read_meta(which) is None:
            raise FileNotFoundError(f"no checkpoint at {self.slot(which)}")
        return load_checkpoint(self.slot(which))
