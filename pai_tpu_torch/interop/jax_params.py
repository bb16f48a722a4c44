"""pai_tpu flax trees <-> pai_tpu_torch ``state_dict``.

The JAX package keeps a generator's weights as two nested dicts, ``params``
and ``batch_stats``, NHWC/HWIO. The port's modules carry the reference's torch
names and layouts. This module maps one to the other on numpy arrays:

* conv kernel ``HWIO`` <-> torch ``OIHW``;
* transposed-conv kernel ``(kh, kw, in, out)`` <-> torch ``(in, out, kh, kw)``
  — a transpose only: the JAX package flips the kernel when it applies it;
* BatchNorm ``scale``/``bias`` <-> ``weight``/``bias``; ``batch_stats``
  ``mean``/``var`` <-> ``running_mean``/``running_var`` (plus a zero
  ``num_batches_tracked``, which torch's BatchNorm owns and JAX does not).

The trees are taken and returned as nested dicts of numpy arrays (anything
``np.asarray`` accepts), so this module imports no JAX. Pix2Pix for now; each
later slice adds its family's name map here.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from pai_tpu_torch.config import parse_int_list

_BN_LEAF = {"scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
_BN_LEAF_INV = {v: k for k, v in _BN_LEAF.items()}

# torch layout <- JAX layout, and back, per tensor kind
_TO_TORCH = {"conv": (3, 2, 0, 1), "convt": (2, 3, 0, 1)}
_TO_JAX = {"conv": (2, 3, 1, 0), "convt": (2, 3, 0, 1)}


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


def _n_levels(model_name: str, hparams: Mapping) -> int:
    if model_name != "pix2pix":
        raise NotImplementedError(
            f"weights of '{model_name}' cannot be carried across yet: its "
            "name map arrives with the slice that ports the model "
            "(ROADMAP.md Queue A)")
    return len(parse_int_list(hparams["channel_mults"]))


def state_dict_from_jax(model_name: str, params: Mapping,
                        batch_stats: Mapping, hparams: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32 CPU tensors) from the JAX package's
    ``params`` and ``batch_stats`` trees of a generator built with
    ``hparams`` (``channel_mults`` is what the name map needs)."""
    n_levels = _n_levels(model_name, hparams)
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _flatten(tree):
            name, kind = _pix2pix_name(path, n_levels)
            value = np.asarray(leaf, np.float32)
            if kind in _TO_TORCH:
                value = np.transpose(value, _TO_TORCH[kind])
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
    n_levels = _n_levels(model_name, hparams)
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, tensor in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        tree, path, kind = _pix2pix_path(name, n_levels)
        value = tensor.detach().cpu().numpy().astype(np.float32)
        if kind in _TO_JAX:
            value = np.transpose(value, _TO_JAX[kind])
        _set_path(trees[tree], path, np.ascontiguousarray(value))
    return trees["params"], trees["batch_stats"]
