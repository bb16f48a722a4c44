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
``np.asarray`` accepts), so this module imports no JAX. Pix2Pix, the PatchGAN
(``model_name="discriminator"``; no ``batch_stats``) and Palette (the
guided_diffusion UNet, whose block numbering is recomputed from
``channel_mults`` and ``attention_res``) so far; each later slice adds its
family's name map here.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

from pai_tpu_torch.config import parse_int_list

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


def _conv_name(mod: str, leaf: str, kind: str) -> Tuple[str, str]:
    return (f"{mod}.weight", kind) if leaf == "kernel" else (f"{mod}.bias", "1d")


def _pix2pix_name(path: Tuple[str, ...], n_levels: int) -> Tuple[str, str]:
    """flax path -> (torch name, tensor kind). ``stem`` is ``encoders.0``;
    ``enc_L`` is ``encoders.L.encode`` = [LeakyReLU, Conv, BN]; ``dec_i`` is
    ``decoders.i.decode`` = [ReLU, ConvT, BN, Dropout]; ``head`` is the plain
    ConvT ``decoders.{n_levels-1}``."""
    top, leaf = path[0], path[-1]
    if top == "stem":
        return _conv_name("encoders.0", leaf, "conv")
    if top == "head":
        return _conv_name(f"decoders.{n_levels - 1}", leaf, "convt")
    kind, index = top.rsplit("_", 1)
    if kind == "enc":
        base = f"encoders.{index}.encode"
        if path[1] == "Conv_0":
            return _conv_name(f"{base}.1", leaf, "conv")
        return f"{base}.2.{_BN_LEAF[leaf]}", "1d"
    if kind == "dec":
        base = f"decoders.{index}.decode"
        if path[1] == "ConvTranspose_0":
            return _conv_name(f"{base}.1", leaf, "convt")
        return f"{base}.2.{_BN_LEAF[leaf]}", "1d"
    raise KeyError(f"not a Pix2PixUnet parameter path: {path}")


def _pix2pix_path(name: str, n_levels: int
                  ) -> Tuple[str, Tuple[str, ...], str]:
    """torch name -> (tree, flax path, tensor kind); the inverse of
    ``_pix2pix_name``. ``tree`` is "params" or "batch_stats"."""
    parts = name.split(".")
    group, index, leaf = parts[0], int(parts[1]), parts[-1]
    conv_leaf = "kernel" if leaf == "weight" else "bias"
    if len(parts) == 3:  # bare stem conv / head transposed conv
        if group == "encoders" and index == 0:
            return "params", ("stem", conv_leaf), \
                "conv" if leaf == "weight" else "1d"
        if group == "decoders" and index == n_levels - 1:
            return "params", ("head", conv_leaf), \
                "convt" if leaf == "weight" else "1d"
        raise KeyError(f"not a Pix2PixUnet tensor name: {name}")
    top = f"{'enc' if group == 'encoders' else 'dec'}_{index}"
    member = int(parts[3])
    if member == 1:
        sub = "Conv_0" if group == "encoders" else "ConvTranspose_0"
        kind = "conv" if group == "encoders" else "convt"
        return "params", (top, sub, conv_leaf), \
            kind if leaf == "weight" else "1d"
    tree = "batch_stats" if leaf.startswith("running_") else "params"
    return tree, (top, "BatchNorm_0", "BatchNorm_0", _BN_LEAF_INV[leaf]), "1d"


def _discriminator_name(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax path -> (torch name, tensor kind) of the PatchGAN:
    ``DiscriminatorBlock_i/Conv_0`` is ``discriminator.i.block.0``, the bare
    head ``Conv_0`` is ``discriminator.4`` (no bias)."""
    top, leaf = path[0], path[-1]
    if top.startswith("DiscriminatorBlock_"):
        index = top.rsplit("_", 1)[1]
        return _conv_name(f"discriminator.{index}.block.0", leaf, "conv")
    if top == "Conv_0" and leaf == "kernel":
        return "discriminator.4.weight", "conv"
    raise KeyError(f"not a Discriminator parameter path: {path}")


def _discriminator_path(name: str) -> Tuple[str, Tuple[str, ...], str]:
    """torch name -> (tree, flax path, tensor kind); the inverse of
    ``_discriminator_name``."""
    parts = name.split(".")
    kind = "conv" if parts[-1] == "weight" else "1d"
    leaf = "kernel" if parts[-1] == "weight" else "bias"
    if parts[:2] == ["discriminator", "4"] and leaf == "kernel":
        return "params", ("Conv_0", "kernel"), kind
    if parts[0] == "discriminator" and parts[2:4] == ["block", "0"]:
        return "params", (f"DiscriminatorBlock_{parts[1]}", "Conv_0",
                          leaf), kind
    raise KeyError(f"not a Discriminator tensor name: {name}")


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


def _palette_entries(top: str, block: str
                     ) -> Iterator[Tuple[Tuple[str, ...], str, str]]:
    """Every (flax path, torch name, tensor kind) one flax module of the UNet
    can hold. The JAX package wraps its BatchNorm and Dense in modules of its
    own, hence the ``BatchNorm_0`` / ``Dense_0`` path members; ``proj`` is a
    bare flax Dense."""
    def member(prefix, mod, what):
        if what == "bn":
            for leaf, name in _BN_LEAF.items():
                yield prefix + ("BatchNorm_0", leaf), f"{mod}.{name}", "1d"
            return
        inner, kind = {"conv": ((), "conv"), "dense": (("Dense_0",), "linear"),
                       "qkv_dense": (("Dense_0",), "qkv1d"),
                       "proj": ((), "qkv1d")}[what]
        yield prefix + inner + ("kernel",), f"{mod}.weight", kind
        yield prefix + inner + ("bias",), f"{mod}.bias", "1d"

    if top.startswith("cond_embed"):
        yield from member((top,), block, "dense")
    elif top in ("in_conv", "out_conv"):
        yield from member((top,), block, "conv")
    elif top == "out_norm":
        yield from member((top,), block, "bn")
    else:
        subs = _GD_ATTN_SUB if "attn" in top else _GD_RES_SUB
        for sub, (mod, what) in subs.items():
            yield from member((top, sub), f"{block}.{mod}", what)


def _palette_tables(hparams: Mapping):
    index_map = _gd_index_map(parse_int_list(hparams["channel_mults"]),
                              parse_int_list(hparams["attention_res"]))
    by_path, by_name = {}, {}
    for top, block in index_map.items():
        for path, name, kind in _palette_entries(top, block):
            tree = "batch_stats" if path[-1] in ("mean", "var") else "params"
            by_path[path] = (name, kind)
            by_name[name] = (tree, path, kind)
    return by_path, by_name


# --------------------------------------------------------------------------
# both directions
# --------------------------------------------------------------------------
def _mappers(model_name: str, hparams: Mapping
             ) -> Tuple[Callable, Callable]:
    """``(name_of(path) -> (torch name, kind), path_of(name) -> (tree, flax
    path, kind))`` for one family built with ``hparams``."""
    if model_name == "pix2pix":
        n_levels = len(parse_int_list(hparams["channel_mults"]))
        return (lambda path: _pix2pix_name(path, n_levels),
                lambda name: _pix2pix_path(name, n_levels))
    if model_name == "discriminator":
        return _discriminator_name, _discriminator_path
    if model_name == "palette":
        by_path, by_name = _palette_tables(hparams)

        def lookup(table, key, what):
            if key not in table:
                raise KeyError(f"not a DiffusionUNet {what}: {key}")
            return table[key]

        return (lambda path: lookup(by_path, path, "parameter path"),
                lambda name: lookup(by_name, name, "tensor name"))
    raise NotImplementedError(
        f"weights of '{model_name}' cannot be carried across yet: its "
        "name map arrives with the slice that ports the model "
        "(ROADMAP.md Queue A)")


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
