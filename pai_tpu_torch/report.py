"""Report CLI of the port — the flag surface of the root ``report.py`` plus
``--device`` and ``--reports-dir``.

Usage:
    python -m pai_tpu_torch.report <name> -c checkpoints/<run>/best \\
        -d data.yaml -m pix2pix

Loads the checkpoint (model rebuilt from its embedded hyperparameters), runs
prediction over the whole dataset on the device, and writes per-image
SSIM/PSNR/MSE, mean stats + RMSE, SSIM-over-depth, FLOPs, parameter count,
afmhot output PNGs and SSIM-map PNGs under ``<reports-dir>/<name>/``.
``-m identity`` evaluates the data against itself without a checkpoint. Runs
on the card unless ``--device cpu`` is given.
"""

import os
import pathlib
from argparse import ArgumentParser

MODEL_CHOICES = [
    "pix2pix",
    "attention_unet",
    "res18_unet",
    "res50_unet",
    "resv2_unet",
    "resnext_unet",
    "trans_unet",
    "palette",
    "identity",
]


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(prog="python -m pai_tpu_torch.report")
    parser.add_argument("name")
    parser.add_argument("-c", "--checkpoint", type=pathlib.Path,
                        help="Path to checkpoint")
    parser.add_argument("-d", "--data", type=pathlib.Path,
                        help="YAML file of all data points")
    parser.add_argument("-bs", "--batch-size", default=2, type=int)
    parser.add_argument("-m", "--model", default="pix2pix",
                        choices=MODEL_CHOICES)
    # palette only: also write the reverse-diffusion process frames
    parser.add_argument("--output-process", default=False,
                        action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("--reports-dir", default="reports",
                        help="directory the report folder is written under")
    return parser


def main(argv=None):
    from pai_tpu_torch.reporting import run_report

    hparams = build_parser().parse_args(argv)
    stats = run_report(
        hparams.name,
        str(hparams.checkpoint) if hparams.checkpoint else None,
        str(hparams.data),
        hparams.model,
        batch_size=hparams.batch_size,
        reports_dir=hparams.reports_dir,
        output_process=hparams.output_process,
        device=hparams.device,
    )
    print(f"[pai_tpu_torch] report written to "
          f"{os.path.join(hparams.reports_dir, hparams.name)}: {stats}")
    return stats


if __name__ == "__main__":
    main()
