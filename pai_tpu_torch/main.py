"""Train CLI of the port — the flag surface of the root ``main.py`` (names,
defaults and choices verbatim) plus ``--device``.

Usage:
    python -m pai_tpu_torch.main <name> -d train.yaml -vd val.yaml
        [-m pix2pix] [--loss-type gan|ssim|psnr|ssim+psnr|mse]

Every ``-m`` trains: ``pix2pix`` (the default), ``attention_unet``,
``res18_unet``, ``res50_unet``, ``resv2_unet``, ``resnext_unet`` and
``trans_unet`` under the five losses (``gan`` with the PatchGAN; TransUNet
needs a mults list its ViT can cut into patches, e.g. ``--channel-mults
1,2,2,4,4``), and ``palette`` (DDPM training, validation with the 100-step
chain), validated and checkpointed (best/last) on validation SSIM.
Runs on the card unless ``--device cpu`` is given.

Multi-device: one process per rank, e.g. ``torchrun --nproc-per-node 4 -m
pai_tpu_torch.main run -d train.yaml -vd val.yaml --tp 2`` (NCCL on CUDA
ranks, gloo on CPU ranks; ``train.loop.Trainer``): ``--tp N`` splits the
large convolution kernels on their output channels over N ranks, ``--sp N``
runs the diffusion UNet's attention as ring attention over N ranks, and
``--fsdp`` shards both networks over the data-parallel ranks (FSDP2); the
remaining factor of the world is data parallel. A world that ``tp * sp``
does not divide raises ``ValueError``, as in the JAX package.
"""

import argparse
import pathlib
from argparse import ArgumentParser

from pai_tpu_torch.train.losses import LOSS_TYPES

MODEL_CHOICES = [
    "pix2pix",
    "attention_unet",
    "res18_unet",
    "res50_unet",
    "resv2_unet",
    "resnext_unet",
    "trans_unet",
    "palette",
]


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(prog="python -m pai_tpu_torch.main")
    parser.add_argument("name")
    parser.add_argument("-d", "--data", type=pathlib.Path,
                        help="YAML file containing filenames of images that "
                             "make up the training data.")
    parser.add_argument("-vd", "--val-data", type=pathlib.Path,
                        help="YAML file containing filenames of images that "
                             "make up the validation data.")
    parser.add_argument("-e", "--epochs", default=200, type=int)
    parser.add_argument("-s", "--steps", default=-1, type=int)
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--val-epochs", default=10, type=int,
                        help="Validation run every n epochs.")
    parser.add_argument("--precision", default="32",
                        help="Floating-point precision")
    parser.add_argument("--ema", default=False,
                        action=argparse.BooleanOptionalAction,
                        help="Whether to use EMA weight updating.")
    parser.add_argument("--channel-mults", default="1,2,4,8,8,8,8,8",
                        help="Defines the U-net architecture's depth and "
                             "width. Should be comma-separated powers of 2.")
    parser.add_argument("--attention-res", default="8,4,2",
                        help="At what downsample multiples attention should "
                             "be used, if the model supports it. Should be "
                             "comma-separated powers of 2.")
    parser.add_argument("--dropout", default=0.0, type=float)
    parser.add_argument("--loss-type", default="gan", choices=LOSS_TYPES)
    parser.add_argument("--schedule-type", default="linear",
                        choices=["linear", "cosine"])
    parser.add_argument("--learn-variance", default=False,
                        action=argparse.BooleanOptionalAction)
    parser.add_argument("-m", "--model", default="pix2pix",
                        choices=MODEL_CHOICES)
    # extensions of the JAX package's CLI
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--resume", default=False,
                        action=argparse.BooleanOptionalAction,
                        help="Resume from the last checkpoint of this run.")
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--ckpt-dir", default="checkpoints")
    parser.add_argument("--profile-dir", default=None,
                        help="Write a torch.profiler trace of the first "
                             "training steps to this directory.")
    parser.add_argument("--tp", default=1, type=int,
                        help="Tensor-parallel degree: convolution kernels "
                             "split on their output channels.")
    parser.add_argument("--scan-steps", default=1, type=int,
                        help="Fold K-1 lean steps into one dispatch, then "
                             "one ordinary step (K divides the 10-step log "
                             "cadence): on the card one replay of a CUDA "
                             "graph; on the CPU and under a mesh ordinary "
                             "steps.")
    parser.add_argument("--sp", default=1, type=int,
                        help="Sequence-parallel degree: ring attention over "
                             "the tokens.")
    parser.add_argument("--fsdp", default=False,
                        action=argparse.BooleanOptionalAction,
                        help="Shard parameters and optimizer state over the "
                             "data-parallel ranks (FSDP2).")
    parser.add_argument("--warmup-unit", default="epoch",
                        choices=("epoch", "step"),
                        help="Palette LinearLR warmup unit: 'epoch' matches "
                             "the reference (Lightning steps the scheduler "
                             "per epoch); 'step' warms up per optimizer "
                             "step.")
    # the port's own
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser


def main(argv=None):
    from pai_tpu_torch.train.loop import fit

    hparams = build_parser().parse_args(argv)
    summary = fit(vars(hparams))
    print(f"[pai_tpu_torch] done: {summary}")
    return summary


if __name__ == "__main__":
    main()
