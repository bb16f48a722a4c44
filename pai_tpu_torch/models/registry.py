"""CLI-name -> generator registry, counterpart of ``pai_tpu/models/registry.py``.

Every generator is built with ``in_channels=1, out_channels=1`` by the CLIs
(grayscale photoacoustic data); the modules are channel-count agnostic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from pai_tpu_torch.models.diffusion_unet import DiffusionUNet
from pai_tpu_torch.models.pix2pix import Pix2PixUnet

GENERATOR_NAMES = (
    "pix2pix",
    "attention_unet",
    "res18_unet",
    "res50_unet",
    "resv2_unet",
    "resnext_unet",
    "trans_unet",
    "palette",
)

# Where ROADMAP.md queues each family that is not ported yet.
_QUEUED = {
    "attention_unet": "Queue A item 5 (other generator families)",
    "res18_unet": "Queue A item 5 (other generator families)",
    "res50_unet": "Queue A item 5 (other generator families)",
    "resv2_unet": "Queue A item 5 (other generator families)",
    "resnext_unet": "Queue A item 5 (other generator families)",
    "trans_unet": "Queue A item 5 (other generator families)",
}


def build_generator(
    name: str,
    in_channels: int = 1,
    out_channels: int = 1,
    channel_mults: Sequence[int] = (1, 2, 4, 8, 8, 8, 8, 8),
    attention_res: Sequence[int] = (8, 4, 2),
    dropout: float = 0.0,
    learn_var: bool = False,
    image_size: int = 256,
    dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """The generator module for a CLI model name, with the JAX function's
    arguments plus the init ``generator`` and the ``device`` to build on."""
    if name == "pix2pix":
        return Pix2PixUnet(in_channels=in_channels, out_channels=out_channels,
                           channel_mults=tuple(channel_mults),
                           dropout=dropout, dtype=dtype, generator=generator,
                           device=device)
    if name == "palette":
        return DiffusionUNet(
            in_channels=in_channels * 2,
            out_channels=out_channels * 2 if learn_var else out_channels,
            inner_channel=128, res_blocks=2,
            channel_mults=tuple(channel_mults),
            attn_res=tuple(attention_res), num_heads=4, dropout=dropout,
            dtype=dtype, generator=generator, device=device)
    if name in _QUEUED:
        raise NotImplementedError(
            f"model '{name}' is not ported to pai_tpu_torch yet: ROADMAP.md "
            f"{_QUEUED[name]}")
    raise ValueError(f"Incorrect model name ({name})")
