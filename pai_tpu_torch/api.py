"""Library facade mirroring the reference's Python class surface, counterpart
of ``pai_tpu/api.py``.

    model = Pix2Pix.load_from_checkpoint("checkpoints/run1/best")
    pred = model.predict(x)                      # NHWC in [-1, 1]

    model = Pix2Pix(loss_type="gan")
    summary = model.fit("run1", "train.yaml", "val.yaml", epochs=10)

The five class names and their constructor vocabulary are those of the JAX
package: ``Pix2Pix``, ``AttentionUnetGAN``, ``ResUnetGAN`` (``res_type`` "18",
"50", "v2" or "next" selects ``res{type}_unet``), ``TransUnetGAN`` and
``Palette``, each with ``fit`` (train with ``train.loop.Trainer`` and adopt
the run's ``last`` weights), ``load_from_checkpoint`` (an evaluation slot or
a training slot; the family is the slot's) and ``predict``/``__call__``
(Palette's runs the 100-step DDPM chain), and ``from_lightning_checkpoint``
(a reference Lightning ``.ckpt``, mapped by ``interop.lightning``; the
model evaluates with the file's EMA weights where it holds an average).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from pai_tpu_torch.config import TRAIN_DEFAULTS, resolve_device


class _Experiment:
    """Shared engine-facing logic for the five public classes."""

    model_name: str = ""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8, 8, 8, 8),
                 attention_res: Sequence[int] = (8, 4, 2),
                 dropout: float = 0.0, loss_type: str = "gan",
                 schedule_type: str = "linear", learn_var: bool = False,
                 precision: str = "32", image_size: int = 256,
                 res_type: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        if res_type is not None:
            self.model_name = f"res{res_type}_unet"
        self.hparams: Dict = dict(
            TRAIN_DEFAULTS,
            model=self.model_name,
            in_channels=in_channels,
            out_channels=out_channels,
            channel_mults=",".join(str(m) for m in channel_mults),
            attention_res=",".join(str(a) for a in attention_res),
            dropout=dropout, loss_type=loss_type,
            schedule_type=schedule_type, learn_variance=learn_var,
            precision=precision, image_size=image_size,
        )
        self.device = resolve_device(device)
        self._module = None

    @property
    def image_size(self) -> int:
        return int(self.hparams.get("image_size") or 256)

    # -- training -------------------------------------------------------
    def fit(self, name: str, data: str, val_data: Optional[str] = None,
            **overrides) -> Dict[str, float]:
        """Train with ``train.loop.Trainer`` (``overrides`` are train-CLI
        hparams, e.g. ``epochs``, ``batch_size``, ``ckpt_dir``, and the
        multi-device ``tp``, ``sp``, ``fsdp``, each rank of a launched world
        calling ``fit``; they become part of this model's configuration) and
        adopt the weights of the run's ``last`` slot."""
        from pai_tpu_torch.restore import rebuild_eval_model
        from pai_tpu_torch.train.loop import Trainer

        self.hparams.update(overrides)
        h = dict(self.hparams, name=name, data=str(data),
                 val_data=str(val_data) if val_data else None,
                 device=str(self.device))
        trainer = Trainer(h)
        summary = trainer.fit()
        state_dict, _ = trainer.ckpt.restore("last")
        self._module, _ = rebuild_eval_model(state_dict, h, self.device)
        return summary

    @classmethod
    def load_from_checkpoint(cls, path: str,
                             device: Union[str, torch.device] = "cuda"):
        """Rebuild the model purely from a checkpoint slot directory."""
        from pai_tpu_torch.restore import rebuild_eval_model
        from pai_tpu_torch.utils.checkpoint import load_checkpoint

        state_dict, meta = load_checkpoint(str(path))
        # the checkpoint's hyperparameters are authoritative (a ResUnetGAN
        # slot knows its block type)
        h = dict(TRAIN_DEFAULTS, **meta["hparams"])
        obj = cls.__new__(cls)
        obj.model_name = h["model"]
        obj.hparams = h
        obj.device = resolve_device(device)
        obj._module, _ = rebuild_eval_model(state_dict, h, obj.device)
        return obj

    @classmethod
    def from_lightning_checkpoint(cls, path: str,
                                  device: Union[str, torch.device] = "cuda",
                                  **hparams_override):
        """Rebuild the model from a reference Lightning ``.ckpt`` (weights,
        BatchNorm statistics and the torch_ema average, mapped as
        ``python -m pai_tpu_torch.interop.lightning import`` maps them; the
        file's pickle runs). ``hparams_override`` overrides what the file's
        ``hyper_parameters`` say, ``model=`` the family (e.g.
        ``ResUnetGAN.from_lightning_checkpoint(p, model="res50_unet")``)."""
        from pai_tpu_torch.interop.lightning import (
            import_lightning_checkpoint, slot_state_dict)
        from pai_tpu_torch.restore import rebuild_eval_model

        device = resolve_device(device)
        model_name = hparams_override.pop("model", None) or cls.model_name
        trees, h, _ = import_lightning_checkpoint(
            str(path), model_name, hparams_override=hparams_override)
        obj = cls.__new__(cls)
        obj.model_name = model_name
        obj.hparams = dict(TRAIN_DEFAULTS, **h)
        obj.device = device
        obj._module, _ = rebuild_eval_model(slot_state_dict(*trees),
                                            obj.hparams, obj.device)
        return obj

    # -- inference ------------------------------------------------------
    def _input(self, x) -> torch.Tensor:
        if self._module is None:
            raise ValueError("no weights: call load_from_checkpoint")
        return torch.as_tensor(
            np.asarray(x) if not isinstance(x, torch.Tensor) else x,
            dtype=torch.float32, device=self.device)

    def predict(self, x, output_process: bool = False) -> torch.Tensor:
        """Eval-mode prediction on an NHWC batch in [-1, 1] (tensor or
        array); the result is a float32 tensor on the model's device."""
        xb = self._input(x)
        if output_process:
            raise ValueError("output_process is only supported by Palette")
        with torch.inference_mode():
            return self._module(xb)

    __call__ = predict


class Pix2Pix(_Experiment):
    model_name = "pix2pix"


class AttentionUnetGAN(_Experiment):
    model_name = "attention_unet"


class ResUnetGAN(_Experiment):
    model_name = "res18_unet"  # default; res_type kwarg selects the block


class TransUnetGAN(_Experiment):
    model_name = "trans_unet"


class Palette(_Experiment):
    model_name = "palette"

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 channel_mults: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 attention_res: Sequence[int] = (16, 8),
                 dropout: float = 0.1, schedule_type: str = "linear",
                 learn_var: bool = False, precision: str = "32",
                 image_size: int = 256,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(in_channels, out_channels, channel_mults,
                         attention_res, dropout, "mse", schedule_type,
                         learn_var, precision, image_size, device=device)

    def predict(self, x, generator: Optional[torch.Generator] = None,
                output_process: bool = False):
        """The 100-step DDPM chain conditioned on ``x``. ``generator`` (on
        the model's device; seeded 0 when omitted) draws y_T and the steps'
        noise. ``output_process=True`` returns ``(y_0, process[N, F, H, W,
        C])``: y_T plus every (timesteps // 7)-th intermediate, F = 9."""
        from pai_tpu_torch.reporting import palette_predictor

        xb = self._input(x)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        # kept per (model, output_process): its schedule, and so the
        # chain's CUDA graph, serve every later call with these weights
        key = (id(self._module), output_process)
        kept = self.__dict__.get("_predictor")
        if kept is None or kept[0] != key:
            self._predictor = kept = (key, palette_predictor(
                self._module, bool(self.hparams.get("learn_variance", False)),
                output_process, self.device))
        return kept[1](xb, generator)

    __call__ = predict
