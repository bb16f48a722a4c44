"""pai_tpu_torch — the PyTorch/CUDA port of ``pai_tpu`` for one NVIDIA Hopper
card.

Same directory layout and module names as the JAX package, so a reader finds
each counterpart; PyTorch idiom inside. Ported so far: the Pix2Pix and the
Palette (100-step DDPM sampling) serving paths (``python -m
pai_tpu_torch.report``, ``pai_tpu_torch.api.Pix2Pix`` / ``Palette``) with both
fused-SSIM kernels and the flash-attention forward kernel written in CUDA C++
(``pai_tpu_torch/kernels``).

The package imports ``torch``, numpy and the standard library only — never
``jax``, ``flax``, ``orbax`` or anything of ``pai_tpu`` — and its entry points
run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
