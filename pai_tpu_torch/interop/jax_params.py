"""pai_tpu flax trees <-> pai_tpu_torch ``state_dict``.

The JAX package keeps a generator's weights as two nested dicts, ``params``
and ``batch_stats``, NHWC/HWIO. The port's modules carry the reference's torch
names and layouts. This module maps one to the other on numpy arrays:

* conv kernel ``HWIO`` <-> torch ``OIHW``;
* transposed-conv kernel ``(kh, kw, in, out)`` <-> torch ``(in, out, kh, kw)``
  — a transpose only: the JAX package flips the kernel when it applies it;
* dense kernel ``(in, out)`` <-> torch ``(out, in)``; the attention blocks'
  ``qkv``/``proj`` kernels ``(in, out)`` <-> torch conv1d ``(out, in, 1)``;
* BatchNorm ``scale``/``bias`` <-> ``weight``/``bias``; ``batch_stats``
  ``mean``/``var`` <-> ``running_mean``/``running_var`` (plus a zero
  ``num_batches_tracked``, which torch's BatchNorm owns and JAX does not).

The trees are taken and returned as nested dicts of numpy arrays (anything
``np.asarray`` accepts), so this module imports no JAX. Every generator
family of the registry has its name map, built from ``channel_mults`` (and
for Palette, the guided_diffusion UNet, ``attention_res``), and so has the
PatchGAN (``model_name="discriminator"``; no ``batch_stats``). TransUNet's
ViT has the registry's ``VIT_LAYERS`` layers; a model built with fewer maps
through the same table.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, Iterator, Mapping, Sequence,
                    Tuple)

import numpy as np
import torch

from pai_tpu_torch.config import parse_int_list
from pai_tpu_torch.models.registry import RES_TYPES
from pai_tpu_torch.models.trans_unet import VIT_LAYERS

_BN_LEAF = {"scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
_BN_LEAF_INV = {v: k for k, v in _BN_LEAF.items()}

# torch layout <- JAX layout, and back, per tensor kind
_TO_TORCH = {"conv": (3, 2, 0, 1), "convt": (2, 3, 0, 1)}
_TO_JAX = {"conv": (2, 3, 1, 0), "convt": (2, 3, 0, 1)}


def _to_torch(value: np.ndarray, kind: str) -> np.ndarray:
    if kind in _TO_TORCH:
        return np.transpose(value, _TO_TORCH[kind])
    if kind == "linear":      # (in, out) -> (out, in)
        return value.T
    if kind == "qkv1d":       # (in, out) -> conv1d (out, in, 1)
        return value.T[:, :, None]
    return value


def _to_jax(value: np.ndarray, kind: str) -> np.ndarray:
    if kind in _TO_JAX:
        return np.transpose(value, _TO_JAX[kind])
    if kind == "linear":
        return value.T
    if kind == "qkv1d":
        return value[:, :, 0].T
    return value


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _set_path(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


# --------------------------------------------------------------------------
# name tables: (flax module path, torch module, what it is) -> every leaf
# --------------------------------------------------------------------------
# what -> (flax leaf path under the module, torch leaf, tensor kind). The JAX
# package wraps its BatchNorm, Dense and LayerNorm in modules of its own,
# hence the inner ``BatchNorm_0`` / ``Dense_0`` / ``LayerNorm_0``; ``proj``
# is a bare flax Dense; ``in_proj`` is torch ``nn.MultiheadAttention``'s
# packed in-projection; ``raw`` is a bare parameter.
_LEAVES = {
    "conv": ((("kernel",), "weight", "conv"), (("bias",), "bias", "1d")),
    "convt": ((("kernel",), "weight", "convt"), (("bias",), "bias", "1d")),
    "bn": tuple((("BatchNorm_0", leaf), name, "1d")
                for leaf, name in _BN_LEAF.items()),
    "dense": ((("Dense_0", "kernel"), "weight", "linear"),
              (("Dense_0", "bias"), "bias", "1d")),
    "qkv_dense": ((("Dense_0", "kernel"), "weight", "qkv1d"),
                  (("Dense_0", "bias"), "bias", "1d")),
    "proj": ((("kernel",), "weight", "qkv1d"), (("bias",), "bias", "1d")),
    "ln": ((("LayerNorm_0", "scale"), "weight", "1d"),
           (("LayerNorm_0", "bias"), "bias", "1d")),
    "in_proj": ((("Dense_0", "kernel"), "in_proj_weight", "linear"),
                (("Dense_0", "bias"), "in_proj_bias", "1d")),
    "raw": (((), None, "raw"),),
}

Entry = Tuple[Tuple[str, ...], str, str]


def _tables(entries: Iterable[Entry]):
    """``(by_path, by_name)``: flax leaf path -> (torch name, kind) and
    torch name -> (tree, flax leaf path, kind). A table may hold leaves a
    given model lacks (a bias-free convolution's bias, an identity skip's
    projection): they are never looked up."""
    by_path, by_name = {}, {}
    for prefix, module, what in entries:
        for leaf_path, leaf, kind in _LEAVES[what]:
            path = prefix + leaf_path
            name = module if leaf is None else f"{module}.{leaf}"
            tree = "batch_stats" if path[-1] in ("mean", "var") else "params"
            by_path[path] = (name, kind)
            by_name[name] = (tree, path, kind)
    return by_path, by_name


def _pix2pix_entries(n_levels: int) -> Iterator[Entry]:
    """``stem`` is ``encoders.0``; ``enc_L`` is ``encoders.L.encode`` =
    [LeakyReLU, Conv, BN]; ``dec_i`` is ``decoders.i.decode`` = [ReLU, ConvT,
    BN, Dropout]; ``head`` is the plain ConvT ``decoders.{n_levels-1}``."""
    yield ("stem",), "encoders.0", "conv"
    for level in range(1, n_levels):
        yield (f"enc_{level}", "Conv_0"), f"encoders.{level}.encode.1", "conv"
        yield (f"enc_{level}", "BatchNorm_0"), f"encoders.{level}.encode.2", \
            "bn"
    for i in range(n_levels - 1):
        yield (f"dec_{i}", "ConvTranspose_0"), f"decoders.{i}.decode.1", \
            "convt"
        yield (f"dec_{i}", "BatchNorm_0"), f"decoders.{i}.decode.2", "bn"
    yield ("head",), f"decoders.{n_levels - 1}", "convt"


def _attention_entries(n_levels: int) -> Iterator[Entry]:
    """Pix2Pix's, plus the gates ``gate_j`` = ``attention_blocks.j``, each
    of ``input_gate``, ``signal_gate`` and ``attention`` = [Conv, BN]."""
    yield from _pix2pix_entries(n_levels)
    for j in range(n_levels - 1):
        for k, member in enumerate(("input_gate", "signal_gate",
                                    "attention")):
            base = f"attention_blocks.{j}.{member}"
            yield (f"gate_{j}", member), f"{base}.0", "conv"
            yield (f"gate_{j}", f"BatchNorm_{k}"), f"{base}.1", "bn"


# flax member of a residual block -> its torch module, per block type (the
# flax modules are numbered in call order: the branch, then the skip)
_RES_MEMBERS = {
    "18": {"Conv_0": "conv_block.0", "BatchNorm_0": "conv_block.1",
           "Conv_1": "conv_block.3", "BatchNorm_1": "conv_block.4",
           "Conv_2": "conv_skip.0", "BatchNorm_2": "conv_skip.1"},
    "50": {"Conv_0": "conv_block.0", "BatchNorm_0": "conv_block.1",
           "Conv_1": "conv_block.3", "BatchNorm_1": "conv_block.4",
           "Conv_2": "conv_block.6", "BatchNorm_2": "conv_block.7",
           "Conv_3": "conv_skip.0", "BatchNorm_3": "conv_skip.1"},
    "v2": {"BatchNorm_0": "conv_block.0", "Conv_0": "conv_block.2",
           "BatchNorm_1": "conv_block.3", "Conv_1": "conv_block.5",
           "BatchNorm_2": "conv_skip.0", "Conv_2": "conv_skip.2"},
}
_RES_MEMBERS["next"] = _RES_MEMBERS["50"]


def _members(prefix: Tuple[str, ...], block: str, members: Mapping
             ) -> Iterator[Entry]:
    for flax_name, torch_name in members.items():
        yield prefix + (flax_name,), f"{block}.{torch_name}", \
            "conv" if flax_name.startswith("Conv") else "bn"


def _res_entries(n_levels: int, res_type: str) -> Iterator[Entry]:
    """``stem`` is ``in_conv``, ``head`` ``out.0``; the blocks ``enc_L`` =
    ``encoders.L.encode.0``, ``dec_i`` = ``decoders.i.decode.0`` and
    ``dec_final`` = ``decoders.{n_levels-1}.decode.0``."""
    yield ("stem",), "in_conv", "conv"
    yield ("head",), "out.0", "conv"
    blocks = [(f"enc_{level}", f"encoders.{level}.encode.0")
              for level in range(n_levels)]
    blocks += [(f"dec_{i}", f"decoders.{i}.decode.0")
               for i in range(n_levels - 1)]
    blocks.append(("dec_final", f"decoders.{n_levels - 1}.decode.0"))
    for top, block in blocks:
        yield from _members((top,), block, _RES_MEMBERS[res_type])


_TRANS_ENCODER = {"Conv_0": "decode.0", "BatchNorm_0": "decode.1",
                  "Conv_1": "decode.3", "BatchNorm_1": "decode.4",
                  "Conv_2": "decode.6", "BatchNorm_2": "decode.7",
                  "Conv_3": "skip.0", "BatchNorm_3": "skip.1"}
_TRANS_DECODER = {"Conv_0": "decode.0", "BatchNorm_0": "decode.1",
                  "Conv_1": "decode.3", "BatchNorm_1": "decode.4"}
_TRANS_LAYER = (("in_proj", "self_attn", "in_proj"),
                ("out_proj", "self_attn.out_proj", "dense"),
                ("ffn1", "linear1", "dense"), ("ffn2", "linear2", "dense"),
                ("LayerNorm_0", "norm1", "ln"), ("LayerNorm_1", "norm2", "ln"))


def _trans_entries(n_levels: int, vit_layers: int) -> Iterator[Entry]:
    """``stem`` is ``in_conv``, ``head`` ``out.0``; ``enc_L`` =
    ``encoders.L`` (the bias-free bottleneck ``decode`` and ``skip``);
    ``dec_i`` = ``decoders.i``, ``dec_final`` = ``decoders.{n_levels-1}``;
    ``vit`` = ``vit_bottleneck`` (``to_patch_embedding.{1,2,3}``,
    ``pos_embedding``, ``layer_i`` = ``transformer.layers.i``)."""
    yield ("stem",), "in_conv", "conv"
    yield ("head",), "out.0", "conv"
    for level in range(n_levels):
        yield from _members((f"enc_{level}",), f"encoders.{level}",
                            _TRANS_ENCODER)
    for i, top in enumerate([f"dec_{i}" for i in range(n_levels - 1)]
                            + ["dec_final"]):
        yield from _members((top,), f"decoders.{i}", _TRANS_DECODER)
    vit = "vit_bottleneck"
    yield ("vit", "pos_embedding"), f"{vit}.pos_embedding", "raw"
    yield ("vit", "LayerNorm_0"), f"{vit}.to_patch_embedding.1", "ln"
    yield ("vit", "Dense_0"), f"{vit}.to_patch_embedding.2", "dense"
    yield ("vit", "LayerNorm_1"), f"{vit}.to_patch_embedding.3", "ln"
    for i in range(vit_layers):
        for flax_name, torch_name, what in _TRANS_LAYER:
            yield ("vit", f"layer_{i}", flax_name), \
                f"{vit}.transformer.layers.{i}.{torch_name}", what


def _discriminator_entries() -> Iterator[Entry]:
    """``DiscriminatorBlock_i/Conv_0`` is ``discriminator.i.block.0``, the
    bare head ``Conv_0`` is ``discriminator.4`` (no bias)."""
    for i in range(4):
        yield (f"DiscriminatorBlock_{i}", "Conv_0"), \
            f"discriminator.{i}.block.0", "conv"
    yield ("Conv_0",), "discriminator.4", "conv"


# --------------------------------------------------------------------------
# Palette: the guided_diffusion UNet
# --------------------------------------------------------------------------
def _gd_index_map(channel_mults: Sequence[int], attention_res: Sequence[int],
                  res_blocks: int = 2) -> Dict[str, str]:
    """flax module name -> torch block root, by re-running the reference's
    construction arithmetic (``resblock_updown=True``)."""
    attn = set(attention_res)
    mapping = {
        "in_conv": "input_blocks.0.0",
        "mid_res_0": "middle_block.0",
        "mid_attn": "middle_block.1",
        "mid_res_1": "middle_block.2",
        "out_norm": "out.0",
        "out_conv": "out.2",
        "cond_embed_0": "cond_embed.0",
        "cond_embed_1": "cond_embed.2",
    }
    idx, blk, ds = 1, 0, 1
    for level in range(len(channel_mults)):
        for _ in range(res_blocks):
            mapping[f"in_res_{blk}"] = f"input_blocks.{idx}.0"
            if ds in attn:
                mapping[f"in_attn_{blk}"] = f"input_blocks.{idx}.1"
            blk += 1
            idx += 1
        if level != len(channel_mults) - 1:
            mapping[f"down_{level}"] = f"input_blocks.{idx}.0"
            idx += 1
            ds *= 2
    idx, blk = 0, 0
    for level in reversed(range(len(channel_mults))):
        for i in range(res_blocks + 1):
            mapping[f"out_res_{blk}"] = f"output_blocks.{idx}.0"
            sub = 1
            if ds in attn:
                mapping[f"out_attn_{blk}"] = f"output_blocks.{idx}.1"
                sub = 2
            if level and i == res_blocks:
                mapping[f"up_{level}"] = f"output_blocks.{idx}.{sub}"
                ds //= 2
            blk += 1
            idx += 1
    return mapping


# flax member -> (torch member, what it is)
_GD_RES_SUB = {"norm_in": ("in_layers.0", "bn"),
               "conv_in": ("in_layers.2", "conv"),
               "emb_proj": ("emb_layers.1", "dense"),
               "norm_out": ("out_layers.0", "bn"),
               "conv_out": ("out_layers.3", "conv"),
               "skip": ("skip_connection", "conv")}
_GD_ATTN_SUB = {"norm": ("norm", "bn"), "qkv": ("qkv", "qkv_dense"),
                "proj": ("proj_out", "proj")}


def _palette_entries(channel_mults: Sequence[int],
                     attention_res: Sequence[int]) -> Iterator[Entry]:
    for top, block in _gd_index_map(channel_mults, attention_res).items():
        if top.startswith("cond_embed"):
            yield (top,), block, "dense"
        elif top in ("in_conv", "out_conv"):
            yield (top,), block, "conv"
        elif top == "out_norm":
            yield (top,), block, "bn"
        else:
            subs = _GD_ATTN_SUB if "attn" in top else _GD_RES_SUB
            for sub, (member, what) in subs.items():
                yield (top, sub), f"{block}.{member}", what


# --------------------------------------------------------------------------
# both directions
# --------------------------------------------------------------------------
_MODULES = {"pix2pix": "Pix2PixUnet", "attention_unet": "AttentionUnet",
            **{name: "ResUnet" for name in RES_TYPES},
            "trans_unet": "TransUnet", "palette": "DiffusionUNet",
            "discriminator": "Discriminator"}


def _entries(model_name: str, hparams: Mapping) -> Iterator[Entry]:
    if model_name == "discriminator":
        return _discriminator_entries()
    mults = parse_int_list(hparams["channel_mults"])
    if model_name == "pix2pix":
        return _pix2pix_entries(len(mults))
    if model_name == "attention_unet":
        return _attention_entries(len(mults))
    if model_name in RES_TYPES:
        return _res_entries(len(mults), RES_TYPES[model_name])
    if model_name == "trans_unet":
        return _trans_entries(len(mults), VIT_LAYERS)
    if model_name == "palette":
        return _palette_entries(mults,
                                parse_int_list(hparams["attention_res"]))
    raise ValueError(f"no name map for model '{model_name}'")


def _mappers(model_name: str, hparams: Mapping
             ) -> Tuple[Callable, Callable]:
    """``(name_of(path) -> (torch name, kind), path_of(name) -> (tree, flax
    path, kind))`` for one family built with ``hparams``."""
    by_path, by_name = _tables(_entries(model_name, hparams))
    module = _MODULES[model_name]

    def lookup(table, key, what):
        if key not in table:
            raise KeyError(f"not a {module} {what}: {key}")
        return table[key]

    return (lambda path: lookup(by_path, path, "parameter path"),
            lambda name: lookup(by_name, name, "tensor name"))


def state_dict_from_jax(model_name: str, params: Mapping,
                        batch_stats: Mapping, hparams: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32 CPU tensors) from the JAX package's
    ``params`` and ``batch_stats`` trees of a generator built with
    ``hparams`` (the name maps need ``channel_mults`` and, for palette,
    ``attention_res``)."""
    name_of, _ = _mappers(model_name, hparams)
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _flatten(tree):
            name, kind = name_of(path)
            value = _to_torch(np.asarray(leaf, np.float32), kind)
            sd[name] = torch.from_numpy(np.ascontiguousarray(value))
    for name in list(sd):
        if name.endswith("running_mean"):
            sd[name[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    return sd


def jax_from_state_dict(model_name: str, state_dict: Mapping,
                        hparams: Mapping) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` as nested dicts of float32 numpy arrays in
    the JAX package's layout, from a port ``state_dict``."""
    _, path_of = _mappers(model_name, hparams)
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, tensor in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        tree, path, kind = path_of(name)
        value = _to_jax(tensor.detach().cpu().numpy().astype(np.float32),
                        kind)
        _set_path(trees[tree], path, np.ascontiguousarray(value))
    return trees["params"], trees["batch_stats"]
