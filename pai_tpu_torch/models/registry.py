"""CLI-name -> generator registry, counterpart of ``pai_tpu/models/registry.py``.

Every generator is built with ``in_channels=1, out_channels=1`` by the CLIs
(grayscale photoacoustic data); the modules are channel-count agnostic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from pai_tpu_torch.models.attention_unet import AttentionUnet
from pai_tpu_torch.models.diffusion_unet import DiffusionUNet
from pai_tpu_torch.models.pix2pix import Pix2PixUnet
from pai_tpu_torch.models.res_unet import ResUnet
from pai_tpu_torch.models.trans_unet import TransUnet

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

RES_TYPES = {
    "res18_unet": "18",
    "res50_unet": "50",
    "resv2_unet": "v2",
    "resnext_unet": "next",
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
    arguments plus the init ``generator`` and the ``device`` to build on.
    TransUNet takes ``image_size`` (its ViT's number of patches) and raises
    ``ValueError`` where its innermost map cannot be cut into patches."""
    mults = tuple(channel_mults)
    common = dict(in_channels=in_channels, out_channels=out_channels,
                  channel_mults=mults, dropout=dropout, dtype=dtype,
                  generator=generator, device=device)
    if name == "pix2pix":
        return Pix2PixUnet(**common)
    if name == "attention_unet":
        return AttentionUnet(**common)
    if name in RES_TYPES:
        return ResUnet(res_type=RES_TYPES[name], **common)
    if name == "trans_unet":
        return TransUnet(image_size=image_size, patch_size=4, num_heads=8,
                         **common)
    if name == "palette":
        return DiffusionUNet(
            in_channels=in_channels * 2,
            out_channels=out_channels * 2 if learn_var else out_channels,
            inner_channel=128, res_blocks=2, channel_mults=mults,
            attn_res=tuple(attention_res), num_heads=4, dropout=dropout,
            dtype=dtype, generator=generator, device=device)
    raise ValueError(f"Incorrect model name ({name})")
