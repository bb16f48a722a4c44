"""Shared numerics and host-side utilities of the port (metrics, images,
checkpoints, FLOP counting)."""

from pai_tpu_torch.utils.images import denormalize, to_int
