"""PyTorch Lightning ``.ckpt`` files in and out of the port, counterpart of
``pai_tpu/interop/torch_import.py`` and of the JAX package's converters
``tools/import_reference_ckpt.py`` / ``tools/export_reference_ckpt.py``.

The reference saves Lightning checkpoints (``main.py:113-119``) whose
``state_dict`` holds the generator under ``unet.`` (``wrapper.py:29``,
``palette.py:50``), the PatchGAN under ``discriminator.``
(``wrapper.py:32-34``) and, for Palette, the two noise schedules as buffers
under ``diffusion.`` and ``diffusion_inf.`` (``palette.py:202-212``); the
torch_ema callback's payload (``callbacks/ema.py:54-62``) holds the
exponential moving average as a list ``shadow_params``. The port's modules
carry the reference's tensor names and layouts, so the mapping is:

* strip the ``unet.`` prefix (generator) or keep ``discriminator.`` (the
  port's slots name the PatchGAN so too), and add them back on export;
* BatchNorm's ``num_batches_tracked`` is carried (a zero where a file lacks
  it);
* the schedule buffers are written on export and, on import, checked
  against the port's own schedules (``schedule_type``, 2000 steps; cosine,
  100 steps);
* ``shadow_params`` is the checkpoint's own ``state_dict`` order minus the
  buffers (torch_ema's ``model.parameters()`` order), never the order of the
  port's ``named_parameters()``.

A ``.ckpt`` is read with ``torch.load(weights_only=False)``, as the JAX
package reads it: that runs the file's pickle, so load only files you trust.
A file that pickles Lightning's own classes needs Lightning installed to
load, and the error says so.

CLI (the two converters)::

    python -m pai_tpu_torch.interop.lightning import best.ckpt -m pix2pix \\
        -o checkpoints --name run [--slot last|best] [--image-size 256]
    python -m pai_tpu_torch.interop.lightning export checkpoints/run/best \\
        -o run_best.ckpt

``import`` writes a complete training slot (``utils.checkpoint.
CheckpointManager``): weights, running statistics, the PatchGAN, the EMA
shadow weights and their update count, the checkpoint's step and epoch, and
fresh Adam moments (none are stored: the optimizer starts from zero), so
``python -m pai_tpu_torch.report`` evaluates it and ``python -m
pai_tpu_torch.main ... --resume`` continues it at the checkpoint's step with
the EMA's decay ramp continued. A ``gan`` checkpoint without PatchGAN
tensors becomes ``loss_type="mse"``. ``export`` writes a slot's evaluation
weights (the EMA's where the run kept one: ``restore.eval_state_dict``) and
its PatchGAN with the reference's ``hyper_parameters``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional, Tuple

import torch

from pai_tpu_torch.config import parse_int_list
from pai_tpu_torch.models.registry import RES_TYPES
from pai_tpu_torch.utils.checkpoint import DISCRIMINATOR_PREFIX, EMA_PREFIX

UNET_PREFIX = "unet."
SCHEDULE_PREFIXES = ("diffusion.", "diffusion_inf.")
SCHEDULE_TOL = 1e-6  # a schedule buffer against the port's, absolute

StateDict = Dict[str, torch.Tensor]


def _is_buffer(name: str) -> bool:
    return (name.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))
            or name.startswith(SCHEDULE_PREFIXES))


def lightning_schedules(hparams: Mapping) -> StateDict:
    """Palette's schedule buffers as the reference registers them: the
    training schedule under ``diffusion.``, the 100-step cosine inference
    schedule under ``diffusion_inf.``."""
    from pai_tpu_torch.diffusion import make_schedule

    scheds = (("diffusion", make_schedule(
        hparams.get("schedule_type", "linear"), 2000, 1e-6, 0.01)),
        ("diffusion_inf", make_schedule("cosine", 100)))
    return {f"{prefix}.{name}": getattr(sched, name)
            for prefix, sched in scheds
            for name in ("alphas", "gammas", "gammas_prev")}


def _modules(model_name: str, hparams: Mapping):
    """The generator and the PatchGAN the checkpoint must fill, built on the
    ``meta`` device (shapes only, no storage)."""
    from pai_tpu_torch.models import Discriminator
    from pai_tpu_torch.restore import build_generator_from_hparams

    h = dict(hparams, model=model_name)
    generator = build_generator_from_hparams(
        h, int(h.get("image_size") or 256), device="meta")
    disc = Discriminator(int(h.get("in_channels", 1))
                         + int(h.get("out_channels", 1)), device="meta")
    return generator, disc


def _take(sd: Mapping[str, torch.Tensor], prefix: str,
          module: torch.nn.Module, what: str) -> StateDict:
    """``module``'s tensors out of ``sd`` under ``prefix``, names stripped;
    raises on a missing tensor, a wrong shape or a tensor under ``prefix``
    the module does not own."""
    want = module.state_dict()
    out = {}
    for name, ref in want.items():
        key = prefix + name
        if key not in sd:
            if name.endswith("num_batches_tracked"):
                out[name] = torch.zeros((), dtype=torch.int64)
                continue
            raise KeyError(f"{what}: checkpoint tensor {key} is missing")
        value = sd[key]
        if name.endswith("num_batches_tracked") and value.numel() == 1:
            value = value.reshape(())  # the JAX package writes shape (1,)
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{what}: {key} has shape {tuple(value.shape)}, "
                             f"the model's is {tuple(ref.shape)}")
        out[name] = value
    extra = [k for k in sd if k.startswith(prefix)
             and k[len(prefix):] not in want]
    if extra:
        raise ValueError(f"{what}: the checkpoint holds tensors the model "
                         f"does not own: {extra[:4]}")
    return out


def import_lightning_state_dict(
        model_name: str, sd: Mapping, hparams: Mapping,
        ema_state: Optional[Mapping] = None
) -> Tuple[StateDict, Optional[StateDict], Optional[StateDict]]:
    """Map a reference Lightning ``state_dict`` (tensors or arrays, in the
    file's order) onto the port. Returns ``(generator state_dict,
    PatchGAN state_dict or None, EMA or None)``: the EMA maps a training
    slot's parameter names (the generator's own, the PatchGAN's under
    ``discriminator.``) to their shadow weights."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    generator, disc = _modules(model_name, hparams)
    gen_sd = _take(sd, UNET_PREFIX, generator, model_name)
    disc_sd = None
    if any(k.startswith(DISCRIMINATOR_PREFIX) for k in sd):
        disc_sd = _take(sd, DISCRIMINATOR_PREFIX, disc, "PatchGAN")
    if model_name == "palette":
        for key, want in lightning_schedules(hparams).items():
            if key in sd and not (
                    sd[key].shape == want.shape
                    and float((sd[key].float() - want).abs().max())
                    <= SCHEDULE_TOL):
                raise ValueError(
                    f"{key} is not the port's "
                    f"{hparams.get('schedule_type', 'linear')!r} schedule "
                    "(check schedule_type)")

    ema = None
    if ema_state is not None:
        names = [k for k in sd if not _is_buffer(k)]
        shadow = list(ema_state["shadow_params"])
        if len(names) != len(shadow):
            raise ValueError(f"EMA shadow_params length {len(shadow)} != "
                             f"model parameter count {len(names)}")
        by_name = dict(zip(names, shadow))
        ema = {}
        for prefix, module, slot_prefix in (
                (UNET_PREFIX, generator, ""),
                (DISCRIMINATOR_PREFIX, disc if disc_sd is not None else None,
                 DISCRIMINATOR_PREFIX)):
            if module is None:
                continue
            for name, param in module.named_parameters():
                value = torch.as_tensor(by_name[prefix + name])
                if value.shape != param.shape:
                    raise ValueError(
                        f"EMA shadow of {prefix + name}: shape "
                        f"{tuple(value.shape)} != {tuple(param.shape)}")
                ema[slot_prefix + name] = value
    return gen_sd, disc_sd, ema


def find_ema_state(ckpt: Mapping) -> Optional[Mapping]:
    """The torch_ema state dict (the one with ``shadow_params``) anywhere in
    the checkpoint's ``callbacks`` payloads (Lightning versions differ in
    where they put it)."""
    def walk(node):
        if isinstance(node, Mapping):
            if "shadow_params" in node:
                return node
            for value in node.values():
                found = walk(value)
                if found is not None:
                    return found
        return None

    return walk(ckpt.get("callbacks", {}))


def import_lightning_checkpoint(path: str, model_name: str,
                                hparams_override: Optional[Mapping] = None):
    """Load a reference ``.ckpt`` (``torch.load``: runs the file's pickle)
    and map it. Returns ``(trees, hparams, meta)``: ``trees`` is
    ``import_lightning_state_dict``'s triple, ``hparams`` the port's
    hyperparameters assembled from the file's ``hyper_parameters`` (with
    ``ema``: whether it holds an average), ``meta`` its ``step``, ``epoch``
    and, with an average, ``ema_num_updates`` (torch_ema's decay ramp
    ``min(decay, (1 + n) / (10 + n))`` continues from it)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    hp = dict(ckpt.get("hyper_parameters", {}))
    hparams = {
        "model": model_name,
        "in_channels": int(hp.get("in_channels", 1)),
        "out_channels": int(hp.get("out_channels", 1)),
        "channel_mults": ",".join(
            str(m) for m in hp.get("channel_mults", (1, 2, 4, 8, 8, 8, 8, 8))),
        "attention_res": ",".join(
            str(a) for a in hp.get("attention_res", (8, 4, 2))),
        "dropout": float(hp.get("dropout", 0.0)),
        "loss_type": hp.get("loss_type", "mse"),
        "schedule_type": hp.get("schedule_type", "linear"),
        "learn_variance": bool(hp.get("learn_var", False)),
        "precision": "32",
        "image_size": 256,
    }
    hparams.update(hparams_override or {})
    ema_state = find_ema_state(ckpt)
    hparams["ema"] = ema_state is not None
    trees = import_lightning_state_dict(model_name, ckpt["state_dict"],
                                        hparams, ema_state)
    meta = {"step": int(ckpt.get("global_step", 0) or 0),
            "epoch": int(ckpt.get("epoch", 0) or 0)}
    if ema_state is not None:
        meta["ema_num_updates"] = int(ema_state.get("num_updates") or 0)
    return trees, hparams, meta


def export_lightning_state_dict(
        model_name: str, state_dict: Mapping[str, torch.Tensor],
        hparams: Mapping,
        discriminator: Optional[Mapping[str, torch.Tensor]] = None
) -> StateDict:
    """The reference-layout ``state_dict`` of a generator's tensors (and the
    PatchGAN's): ``unet.``/``discriminator.`` names and, for Palette, the
    schedule buffers, so the reference's ``load_state_dict(strict=True)``
    takes it."""
    sd = {UNET_PREFIX + k: v for k, v in state_dict.items()}
    if discriminator is not None:
        sd.update({DISCRIMINATOR_PREFIX + k: v
                   for k, v in discriminator.items()})
    if model_name == "palette":
        sd.update(lightning_schedules(hparams))
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}


def export_lightning_checkpoint(
        path: str, model_name: str, state_dict: Mapping[str, torch.Tensor],
        hparams: Mapping,
        discriminator: Optional[Mapping[str, torch.Tensor]] = None,
        epoch: int = 0, step: int = 0) -> None:
    """``torch.save`` a Lightning-format ``.ckpt`` that the reference's
    ``load_from_checkpoint`` (``report.py:26-43``) takes: the state dict and
    the ``hyper_parameters`` its constructors read."""
    hp = {"in_channels": int(hparams.get("in_channels", 1)),
          "out_channels": int(hparams.get("out_channels", 1)),
          "channel_mults": parse_int_list(hparams["channel_mults"]),
          "dropout": float(hparams.get("dropout", 0.0))}
    if model_name == "palette":
        hp.update(attention_res=parse_int_list(hparams["attention_res"]),
                  schedule_type=hparams.get("schedule_type", "linear"),
                  learn_var=bool(hparams.get("learn_variance", False)))
    else:
        hp["loss_type"] = hparams.get("loss_type", "mse")
        if model_name in RES_TYPES:
            hp["res_type"] = RES_TYPES[model_name]
        if model_name == "trans_unet":
            hp["patch_size"] = 4
    torch.save({"state_dict": export_lightning_state_dict(
        model_name, state_dict, hparams, discriminator),
        "hyper_parameters": hp, "epoch": int(epoch),
        "global_step": int(step)}, path)


def slot_state_dict(gen_sd: StateDict, disc_sd: Optional[StateDict],
                    ema: Optional[StateDict]) -> StateDict:
    """``import_lightning_state_dict``'s triple as a slot's flat state
    (``utils/checkpoint.py``'s names)."""
    flat = dict(gen_sd)
    if disc_sd is not None:
        flat.update({DISCRIMINATOR_PREFIX + k: v for k, v in disc_sd.items()})
    if ema is not None:
        flat.update({EMA_PREFIX + k: v for k, v in ema.items()})
    return flat


# --------------------------------------------------------------------------
# the converters
# --------------------------------------------------------------------------
def _import(args) -> str:
    from pai_tpu_torch.utils.checkpoint import CheckpointManager

    (gen_sd, disc_sd, ema), hparams, meta = import_lightning_checkpoint(
        args.checkpoint, args.model, {"image_size": args.image_size})
    if disc_sd is None and hparams["loss_type"] == "gan":
        # a gan run without its PatchGAN cannot take the two-optimizer step
        hparams["loss_type"] = "mse"
    slot = CheckpointManager(args.ckpt_dir, args.name).save(
        args.slot, slot_state_dict(gen_sd, disc_sd, ema), hparams,
        meta["step"], meta["epoch"],
        ema_num_updates=meta.get("ema_num_updates", 0))
    print(f"[pai_tpu_torch] imported {args.checkpoint} -> {slot} "
          f"(model={args.model}, ema={hparams['ema']}, "
          f"loss_type={hparams['loss_type']}, epoch={meta['epoch']}, "
          f"step={meta['step']})", flush=True)
    return slot


def _export(args) -> str:
    from pai_tpu_torch.restore import eval_state_dict
    from pai_tpu_torch.utils.checkpoint import load_checkpoint

    state_dict, meta = load_checkpoint(args.slot)
    h = meta["hparams"]
    disc = {k[len(DISCRIMINATOR_PREFIX):]: v for k, v in state_dict.items()
            if k.startswith(DISCRIMINATOR_PREFIX)}
    export_lightning_checkpoint(
        args.output, h["model"], eval_state_dict(state_dict, h), h,
        disc if h.get("loss_type") == "gan" and disc else None,
        epoch=meta.get("epoch", 0), step=meta.get("step", 0))
    print(f"[pai_tpu_torch] exported {args.slot} -> {args.output} "
          f"(model={h['model']}, ema={bool(h.get('ema'))})", flush=True)
    return args.output


def build_parser() -> argparse.ArgumentParser:
    from pai_tpu_torch.models.registry import GENERATOR_NAMES

    parser = argparse.ArgumentParser(
        prog="python -m pai_tpu_torch.interop.lightning",
        description="Convert between reference Lightning .ckpt files and "
                    "pai_tpu_torch checkpoint slots.")
    sub = parser.add_subparsers(dest="command", required=True)
    imp = sub.add_parser("import", help="a Lightning .ckpt -> a port slot")
    imp.add_argument("checkpoint", help="Lightning .ckpt file")
    imp.add_argument("-m", "--model", required=True,
                     choices=GENERATOR_NAMES)
    imp.add_argument("-o", "--ckpt-dir", default="checkpoints")
    imp.add_argument("--name", required=True,
                     help="run name: the slot goes to <ckpt-dir>/<name>/")
    imp.add_argument("--slot", default="last", choices=("last", "best"),
                     help="slot to write (default: last, which --resume "
                          "reads)")
    imp.add_argument("--image-size", default=256, type=int)
    exp = sub.add_parser("export", help="a port slot -> a Lightning .ckpt")
    exp.add_argument("slot", help="checkpoint slot (.../best or .../last)")
    exp.add_argument("-o", "--output", required=True,
                     help="output .ckpt path")
    return parser


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    return _import(args) if args.command == "import" else _export(args)


if __name__ == "__main__":
    main()
