"""Evaluation / report generation, counterpart of ``pai_tpu/reporting.py``.

Given a checkpoint and a data manifest, produces under
``<reports_dir>/<name>/``:

* ``stats.txt`` — mean SSIM (over per-image values), mean PSNR, whole-set
  RMSE, FLOPs, parameter count;
* ``depth_ssim.csv`` — mean/std SSIM over 16 depth bands (std with ddof=1);
* ``outputs/*.png`` — predictions colormapped with afmhot;
* ``ssim_images/*.png`` — full-resolution SSIM maps;
* ``ssim_per_image.csv`` / ``psnr_per_image.csv`` / ``mse_per_image.csv``.

The model is rebuilt purely from the hyperparameters embedded in the
checkpoint; ``identity`` evaluates the data against itself without one.
``palette`` predicts by the 100-step cosine DDPM chain (one generator seeded
0 for the whole report) and, with ``output_process``, also writes the kept
frames of the reverse process to ``process/<index>_<k>.png``.

One decode pass, streaming batch by batch. Prediction and every metric run on
the device under ``torch.inference_mode()``; per batch the predictions, the
SSIM maps and the per-image numbers come back to the host in one copy. FLOPs
are PyTorch's ``FlopCounterMode`` count of one real (1, size, size, C)
forward — for palette one UNet evaluation ``(probe, probe, gamma=1)``, not
the chain (see ``utils/flops.py`` for how that differs from XLA's cost model
and how the flash-attention kernel's operations are included).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from pai_tpu_torch.config import resolve_device
from pai_tpu_torch.data import BatchLoader, ImageDataset
from pai_tpu_torch.diffusion import ddpm_sample, make_schedule
from pai_tpu_torch.utils import metrics
from pai_tpu_torch.utils.checkpoint import load_checkpoint
from pai_tpu_torch.utils.flops import count_flops, parameter_count
from pai_tpu_torch.utils.images import (afmhot_rgb, denormalize, to_int,
                                        write_png)

IMAGE_SIZE = 256


SAMPLING_STEPS = 100  # the inference schedule: cosine, 100 steps


def _rebuild_from_checkpoint(model_name: str, ckpt_path: str, device):
    """``(eval-mode generator, image_size, learn_variance)`` from a
    checkpoint alone."""
    from pai_tpu_torch.restore import rebuild_eval_model

    if not ckpt_path:
        raise ValueError(f"model '{model_name}' needs a checkpoint (-c)")
    state_dict, meta = load_checkpoint(ckpt_path)
    h = dict(meta["hparams"], model=model_name)
    generator, image_size = rebuild_eval_model(state_dict, h, device)
    return generator, image_size, bool(h.get("learn_variance", False))


def palette_predictor(unet: torch.nn.Module, learn_var: bool,
                      output_process: bool, device):
    """``predict(x, generator)`` running the reverse chain of the inference
    schedule; with ``output_process`` it returns ``(y_0, frames)``, the
    frames being y_T plus every (timesteps // 7)-th step."""
    sched = make_schedule("cosine", SAMPLING_STEPS, device=device)
    capture = sched.timesteps // 7 if output_process else None

    def predict(x: torch.Tensor, generator: torch.Generator):
        return ddpm_sample(sched, unet, x, generator, learn_var,
                           capture_every=capture)

    return predict


def chunk_metrics(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Everything the report keeps of one batch, as one (B, K) float32 tensor
    on the device: the prediction and the SSIM map, flattened, then per-image
    SSIM, PSNR, MSE and the per-band SSIMs. ``unpack_chunk`` splits it."""
    per_image, full = metrics.ssim_parts(p, t)
    cols = [p.flatten(1), full.flatten(1), per_image[:, None],
            metrics.psnr_per_image(p, t)[:, None],
            metrics.mse_per_image(p, t)[:, None],
            metrics.depth_ssim_per_image(p, t)]
    return torch.cat(cols, dim=1)


def unpack_chunk(packed: np.ndarray, shape) -> Dict[str, np.ndarray]:
    """Split a host copy of ``chunk_metrics``' tensor; ``shape`` is the
    (B, H, W, C) of the batch."""
    n = int(np.prod(shape[1:]))
    return {"pred": packed[:, :n].reshape(-1, *shape[1:]),
            "map": packed[:, n:2 * n].reshape(-1, *shape[1:]),
            "ssim": packed[:, 2 * n], "psnr": packed[:, 2 * n + 1],
            "mse": packed[:, 2 * n + 2], "bands": packed[:, 2 * n + 3:]}


def run_report(name: str, checkpoint: Optional[str], data: str,
               model_name: str, batch_size: int = 2,
               reports_dir: str = "reports", output_process: bool = False,
               device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, float]:
    """Write the report and return ``{"ssim", "psnr", "rmse", "flops",
    "params"}``. ``output_process`` (the reverse-diffusion frames) exists for
    palette only."""
    if output_process and model_name != "palette":
        raise ValueError("--output-process is only supported by palette")
    device = resolve_device(device)
    image_size = IMAGE_SIZE
    generator = None
    learn_var = False
    if model_name != "identity":
        generator, image_size, learn_var = _rebuild_from_checkpoint(
            model_name, checkpoint, device)
    if model_name == "palette":
        sample = palette_predictor(generator, learn_var, output_process,
                                   device)
        noise_source = torch.Generator(device=device).manual_seed(0)

        def predict(x):
            return sample(x, noise_source)
    elif generator is None:
        def predict(x):
            return x
    else:
        predict = generator

    dataset = ImageDataset(data, image_size)
    loader = BatchLoader(dataset, batch_size, shuffle=False, pad_mode="zero",
                         device=device)

    report_dir = os.path.join(reports_dir, name)
    outputs_dir = os.path.join(report_dir, "outputs")
    maps_dir = os.path.join(report_dir, "ssim_images")
    process_dir = os.path.join(report_dir, "process")
    for d in (report_dir, outputs_dir, maps_dir) + (
            (process_dir,) if output_process else ()):
        os.makedirs(d, exist_ok=True)

    # Each batch is predicted, measured and written out before the next is
    # used: host memory stays O(batch), not O(dataset).
    ssims, psnrs, mses, bands = [], [], [], []
    index = 0
    try:
        with torch.inference_mode():
            for batch in loader:
                pred = predict(batch.x)
                process = None
                if output_process:
                    pred, process = pred
                p = denormalize(pred)
                t = denormalize(batch.y)
                host = unpack_chunk(chunk_metrics(p, t).cpu().numpy(),
                                    p.shape)
                nv = batch.n_valid
                first = index
                if process is not None:  # (n, F, H, W, C)
                    process = denormalize(process)[:nv].cpu().numpy()
                ssims.append(host["ssim"][:nv])
                psnrs.append(host["psnr"][:nv])
                mses.append(host["mse"][:nv])
                bands.append(host["bands"][:nv])
                for img, m in zip(host["pred"][:nv], host["map"][:nv]):
                    stem = f"{str(index).zfill(5)}.png"
                    write_png(to_int(afmhot_rgb(img[..., 0])),
                              os.path.join(outputs_dir, stem))
                    write_png(to_int(np.clip(m, 0.0, 1.0)),
                              os.path.join(maps_dir, stem))
                    if process is not None:
                        frames = process[index - first]
                        for k, frame in enumerate(frames):
                            write_png(
                                to_int(afmhot_rgb(frame[..., 0])),
                                os.path.join(
                                    process_dir,
                                    f"{str(index).zfill(5)}_{k}.png"))
                    index += 1
    finally:
        loader.close()
    ssims = np.concatenate(ssims)
    psnrs = np.concatenate(psnrs)
    mses = np.concatenate(mses)
    bands = np.concatenate(bands)  # (N, num_depths)

    # SSIM over depth: mean/std over images per band.
    with open(os.path.join(report_dir, "depth_ssim.csv"), "w") as f:
        f.write("depth,mean,std\n")
        for d in range(bands.shape[1]):
            mean = float(bands[:, d].mean())
            std = float(bands[:, d].std(ddof=1)) if bands.shape[0] > 1 \
                else 0.0
            f.write(f"{d + 1},{mean},{std}\n")

    # All images share one resolution, so sqrt(mean(per-image MSEs)) is the
    # whole-set RMSE: no second pass over pixels.
    ssim_stat = float(ssims.mean())
    psnr_stat = float(psnrs.mean())
    rmse_stat = float(np.sqrt(mses.mean()))

    flops = 0
    n_params = 0
    if generator is not None:
        n_params = parameter_count(generator)
        probe = torch.zeros((1, image_size, image_size, 1),
                            dtype=torch.float32, device=device)
        if model_name == "palette":
            flops = count_flops(generator, probe, probe,
                                torch.ones((1,), device=device))
        else:
            flops = count_flops(generator, probe)

    with open(os.path.join(report_dir, "stats.txt"), "w") as f:
        f.write(f"SSIM: {ssim_stat}\n")
        f.write(f"PSNR: {psnr_stat}\n")
        f.write(f"RMSE: {rmse_stat}\n")
        f.write(f"FLOPs: {flops}\n")
        f.write(f"Parameter count: {n_params}\n")

    for metric_name, values in (("ssim", ssims), ("psnr", psnrs),
                                ("mse", mses)):
        with open(os.path.join(report_dir, f"{metric_name}_per_image.csv"),
                  "w") as f:
            f.write(f"image,{metric_name}\n")
            for i, v in enumerate(values):
                f.write(f"{str(i).zfill(5)},{v}\n")

    return {"ssim": ssim_stat, "psnr": psnr_stat, "rmse": rmse_stat,
            "flops": flops, "params": n_params}
