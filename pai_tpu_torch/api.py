"""Library facade mirroring the reference's Python class surface, counterpart
of ``pai_tpu/api.py``.

    model = Pix2Pix.load_from_checkpoint("checkpoints/run1/best")
    pred = model.predict(x)                      # NHWC in [-1, 1]

The five class names and their constructor vocabulary are those of the JAX
package. Ported so far: ``Pix2Pix`` and ``Palette`` with
``load_from_checkpoint`` and ``predict``/``__call__`` (Palette's runs the
100-step DDPM chain). ``fit`` and the other three classes raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from pai_tpu_torch.config import TRAIN_DEFAULTS, resolve_device


class _Experiment:
    """Shared engine-facing logic for the five public classes."""

    model_name: str = ""
    _roadmap_item: Optional[str] = None  # set on classes not ported yet
    _fit_roadmap_item = "item 3 (GAN training)"

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8, 8, 8, 8),
                 attention_res: Sequence[int] = (8, 4, 2),
                 dropout: float = 0.0, loss_type: str = "gan",
                 schedule_type: str = "linear", learn_var: bool = False,
                 precision: str = "32", image_size: int = 256,
                 res_type: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self._require_ported()
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

    @classmethod
    def _require_ported(cls) -> None:
        if cls._roadmap_item is not None:
            raise NotImplementedError(
                f"{cls.__name__} is not ported to pai_tpu_torch yet: "
                f"ROADMAP.md {cls._roadmap_item}")

    @property
    def image_size(self) -> int:
        return int(self.hparams.get("image_size") or 256)

    # -- training -------------------------------------------------------
    def fit(self, name: str, data: str, val_data: Optional[str] = None,
            **overrides) -> Dict[str, float]:
        raise NotImplementedError(
            "training is not ported to pai_tpu_torch yet: ROADMAP.md Queue A "
            f"{self._fit_roadmap_item}")

    @classmethod
    def load_from_checkpoint(cls, path: str,
                             device: Union[str, torch.device] = "cuda"):
        """Rebuild the model purely from a checkpoint slot directory."""
        from pai_tpu_torch.restore import rebuild_eval_model
        from pai_tpu_torch.utils.checkpoint import load_checkpoint

        cls._require_ported()
        state_dict, meta = load_checkpoint(str(path))
        # the checkpoint's hyperparameters are authoritative
        h = dict(TRAIN_DEFAULTS, **meta["hparams"])
        obj = cls.__new__(cls)
        obj.model_name = h["model"]
        obj.hparams = h
        obj.device = resolve_device(device)
        obj._module, _ = rebuild_eval_model(state_dict, h, obj.device)
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
    _roadmap_item = "Queue A item 5 (other generator families)"


class ResUnetGAN(_Experiment):
    model_name = "res18_unet"  # default; res_type kwarg selects the block
    _roadmap_item = "Queue A item 5 (other generator families)"


class TransUnetGAN(_Experiment):
    model_name = "trans_unet"
    _roadmap_item = "Queue A item 5 (other generator families)"


class Palette(_Experiment):
    model_name = "palette"
    _fit_roadmap_item = "item 4 (Palette training)"

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
        sample = palette_predictor(
            self._module, bool(self.hparams.get("learn_variance", False)),
            output_process, self.device)
        return sample(xb, generator)

    __call__ = predict
