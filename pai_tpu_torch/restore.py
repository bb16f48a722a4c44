"""Shared checkpoint -> eval-model reconstruction, counterpart of
``pai_tpu/restore.py``.

Used by the report CLI (``reporting.py``) and the class API (``api.py``):
builds the generator from the hyperparameters embedded in the checkpoint,
loads the evaluation weights — the exponential-moving-average shadow weights
when the run kept them (``hparams["ema"]`` and ``ema.*`` tensors present) —
and returns the module in ``eval()`` on the device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import torch

from pai_tpu_torch.config import (apply_precision_policy, compute_dtype,
                                  parse_int_list, resolve_device)
from pai_tpu_torch.models import build_generator
from pai_tpu_torch.utils.checkpoint import EMA_PREFIX

DEFAULT_IMAGE_SIZE = 256


def build_generator_from_hparams(h: Mapping, image_size: int,
                                 generator: torch.Generator = None,
                                 device=None) -> torch.nn.Module:
    return build_generator(
        h["model"],
        int(h.get("in_channels", 1)), int(h.get("out_channels", 1)),
        channel_mults=parse_int_list(h["channel_mults"]),
        attention_res=parse_int_list(h["attention_res"]),
        dropout=h.get("dropout", 0.0),
        learn_var=h.get("learn_variance", False),
        image_size=image_size,
        dtype=compute_dtype(h.get("precision", "32")),
        generator=generator, device=device)


def eval_state_dict(state_dict: Mapping, h: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """The tensors evaluation runs with: the EMA shadow weights over the raw
    ones where the run kept them (buffers, which the average does not span,
    stay the raw ones)."""
    raw = {k: v for k, v in state_dict.items()
           if not k.startswith(EMA_PREFIX)}
    if h.get("ema", False):
        raw.update({k[len(EMA_PREFIX):]: v for k, v in state_dict.items()
                    if k.startswith(EMA_PREFIX)})
    return raw


def rebuild_eval_model(state_dict: Mapping, h: Mapping,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Tuple[torch.nn.Module, int]:
    """``(generator in eval() on the device, image_size)`` from a loaded
    checkpoint ``state_dict`` and its hparams. Also applies the precision
    policy the checkpoint's ``precision`` asks for."""
    device = resolve_device(device)
    apply_precision_policy(h.get("precision", "32"))
    image_size = int(h.get("image_size") or DEFAULT_IMAGE_SIZE)
    # built without storage, then given the checkpoint's tensors: no init
    # pass over weights that are about to be replaced
    module = build_generator_from_hparams(h, image_size, device="meta")
    module.load_state_dict(eval_state_dict(state_dict, h), strict=True,
                           assign=True)
    module = module.to(device).to(memory_format=torch.channels_last)
    return module.eval().requires_grad_(False), image_size
